"""COLMAP seed points (counterpart of ``gstex_tpu/data/colmap.py``, whose
numpy code this module copies): ``points3D.bin`` and ``points3D.txt``,
the subset the reference reads for a dataset's seed points
(``nerfstudio_dataparser.py:358-427``, ``_load_3D_points``).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def read_points3d_bin(path) -> tuple[np.ndarray, np.ndarray]:
    """Read COLMAP points3D.bin -> (xyz (P,3) f64, rgb (P,3) u8)."""
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            data = struct.unpack("<QdddBBBd", f.read(8 + 24 + 3 + 8))
            xyzs.append(data[1:4])
            rgbs.append(data[4:7])
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.seek(8 * track_len, 1)
    return np.array(xyzs, np.float64), np.array(rgbs, np.uint8)


def read_points3d_text(path) -> tuple[np.ndarray, np.ndarray]:
    """Read COLMAP points3D.txt -> (xyz (P,3) f64, rgb (P,3) u8)."""
    xyzs, rgbs = [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        xyzs.append([float(v) for v in el[1:4]])
        rgbs.append([int(v) for v in el[4:7]])
    return np.array(xyzs, np.float64), np.array(rgbs, np.uint8)


def read_points3d(colmap_dir) -> tuple[np.ndarray, np.ndarray]:
    """``points3D.bin``, else ``points3D.txt``, of a COLMAP model
    directory."""
    colmap_dir = Path(colmap_dir)
    if (colmap_dir / "points3D.bin").exists():
        return read_points3d_bin(colmap_dir / "points3D.bin")
    if (colmap_dir / "points3D.txt").exists():
        return read_points3d_text(colmap_dir / "points3D.txt")
    raise FileNotFoundError(f"no points3D in {colmap_dir}")
