"""Depth map -> point map -> normal map (counterpart of
``gstex_tpu/ops/normals.py``), for the ``use_normal_loss`` path.

View-z depths are unprojected along normalized world rays; the normals
are the normalized cross products of central differences, zero on the
one-pixel border.
"""

from __future__ import annotations

import torch

from .camera import Camera, camera_origin, pixel_ray_dirs


def depths_to_points(depths: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(H, W) view-z depth map -> (H, W, 3) world points."""
    dev = depths.device
    py, px = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=dev),
        torch.arange(cam.width, dtype=torch.float32, device=dev),
        indexing="ij")
    dirs = pixel_ray_dirs(px, py, cam)
    # the rays have unit view z: normalize them, and scale the ray
    # parameter so that the view depth matches
    norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    unit = dirs / (norm + 1e-9)
    view_z = 1.0 / (norm[..., 0] + 1e-9)
    ts = depths / torch.clamp(view_z, min=1e-9)
    return camera_origin(cam.c2w) + ts[..., None] * unit


def depth_to_normal(depths: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) estimated normals (zero border)."""
    points = depths_to_points(depths, cam)
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
    out = torch.zeros_like(points)
    out[1:-1, 1:-1] = n
    return out
