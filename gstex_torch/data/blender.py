"""Blender synthetic datasets from ``transforms_<split>.json``
(counterpart of ``gstex_tpu/data/blender.py``): focal from
``camera_angle_x``, principal point at the image center, poses as given
(OpenGL c2w), ``scale_factor`` applied to camera origins.

The image size comes from the first frame's PNG or JPEG header (a
frame's name ends in ``.png`` as the format has it, whatever its bytes)
and images are decoded by ``data/png.py:read_image`` (PNG, or JPEG
through ``data/jpeg.py``), so no image library is needed.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .jpeg import SIGNATURE as JPEG_SIGNATURE
from .jpeg import jpeg_size
from .png import SIGNATURE, read_image


@dataclass
class ParsedDataset:
    """A parsed split: the JAX package's ``ParsedDataset`` fields, and what
    its nerfstudio parser sets on it (distortion, camera type)."""

    image_filenames: list
    c2ws: np.ndarray      # (M,3,4) float32
    fx: np.ndarray        # (M,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    heights: np.ndarray   # (M,) int
    widths: np.ndarray
    points_xyz: np.ndarray | None = None   # (P,3) seed points
    points_rgb: np.ndarray | None = None   # (P,3) 0-255
    mask_filenames: list | None = None     # per-frame masks (or None)
    # the pose normalization the parser applied (identity, 1 for Blender)
    dataparser_transform: np.ndarray | None = None  # (3,4)
    dataparser_scale: float = 1.0
    distortion: np.ndarray | None = None   # (M,6) k1 k2 k3 k4 p1 p2, or 12
    camera_type: str = "perspective"       # | fisheye | fisheye624 | ...
    fisheye_crop_radius: float = 0.0       # fisheye624 (0: min(h, w) / 2)

    def save_dataparser_transform(self, path) -> None:
        """Write the pose normalization the parser applied, as the JAX
        package's ``ParsedDataset.save_dataparser_transform`` writes it:
        ``{"transform": (3, 4) rows, "scale": s}``, indented by 4."""
        tf = (self.dataparser_transform if self.dataparser_transform
              is not None else np.eye(4)[:3])
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            {"transform": np.asarray(tf).tolist(),
             "scale": float(self.dataparser_scale)}, indent=4))


def png_size(path) -> tuple[int, int]:
    """(height, width) from a PNG file's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def image_size(path) -> tuple[int, int]:
    """(height, width) of a PNG or JPEG file, by its signature."""
    with open(path, "rb") as f:
        head = f.read(3)
    return jpeg_size(path) if head == JPEG_SIGNATURE else png_size(path)


def load_image_u8(path) -> np.ndarray:
    """A PNG or JPEG frame as uint8 (H, W, C), as the JAX package's
    ``convert("RGBA" if RGBA else "RGB")`` gives it: RGBA stays RGBA (the
    trainer composites it over the background); grey and grey-alpha
    become RGB."""
    img = read_image(path)
    if img.shape[-1] <= 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return img


def load_image(path) -> np.ndarray:
    """``load_image_u8`` as float32 in [0, 1] (k / 255)."""
    return load_image_u8(path).astype(np.float32) / 255.0


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

    h, w = image_size(filenames[0])
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
