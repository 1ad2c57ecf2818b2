"""Blender synthetic dataset cameras from ``transforms_<split>.json``
(counterpart of ``gstex_tpu/data/blender.py``): focal from
``camera_angle_x``, principal point at the image center, poses as given
(OpenGL c2w), ``scale_factor`` applied to camera origins.

Only the cameras are parsed; the image size comes from the first frame's
PNG header, so no image library is needed.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


@dataclass
class ParsedDataset:
    image_filenames: list
    c2ws: np.ndarray      # (M,3,4) float32
    fx: np.ndarray        # (M,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    heights: np.ndarray   # (M,) int
    widths: np.ndarray


def png_size(path) -> tuple[int, int]:
    """(height, width) from a PNG file's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def parse_blender(data_dir, split: str = "train",
                  scale_factor: float = 1.0) -> ParsedDataset:
    data_dir = Path(data_dir)
    meta = json.loads((data_dir / f"transforms_{split}.json").read_text())
    filenames, poses = [], []
    for frame in meta["frames"]:
        filenames.append(data_dir / (frame["file_path"].replace("./", "")
                                     + ".png"))
        poses.append(np.array(frame["transform_matrix"], np.float32))
    poses = np.stack(poses)[:, :3, :4]
    poses[:, :, 3] *= scale_factor

    h, w = png_size(filenames[0])
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    m = len(filenames)
    return ParsedDataset(
        image_filenames=filenames,
        c2ws=poses,
        fx=np.full(m, focal, np.float32),
        fy=np.full(m, focal, np.float32),
        cx=np.full(m, w / 2.0, np.float32),
        cy=np.full(m, h / 2.0, np.float32),
        heights=np.full(m, h, np.int64),
        widths=np.full(m, w, np.int64),
    )
