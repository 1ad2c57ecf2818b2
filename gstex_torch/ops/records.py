"""Per-splat intersection records and camera info for the eval kernel
(counterpart of ``gstex_tpu/ops/rasterize_pallas.py`` ``build_records``,
``assemble_records`` and ``_cam_info``).

Record layout (F_REC = 32 floats per gaussian):
  0-2  n          surfel normal
  3    a_n        n·(μ−o)
  4-6  b1         ax1/l0          7   a1 = (o−μ)·ax1/l0
  8-10 b2         ax2/l1          11  a2 = (o−μ)·ax2/l1
  12-14 b1u       m0·ax1          15  a1u = (o−μ)·b1u   (chart uv frame)
  16-18 b2u       m1·ax2          19  a2u = (o−μ)·b2u
  20   opacity    21-23 rgb       24-25 xy (projected center)
  26   h          27 w            28-31 reserved (zero)

Camera info (18 floats): fx, fy, cx, cy, px_offset (2), origin (3), and
the gsplat camera-to-world rotation R = c2w[:3,:3]·diag(1,−1,−1)
row-major (9).
"""

from __future__ import annotations

import torch

from .camera import Camera, camera_rotation_gsplat
from .surfel import SplatGeom

F_REC = 32


def build_records(geom: SplatGeom, origin: torch.Tensor) -> torch.Tensor:
    """Per-splat precomputed intersection coefficients (N, F_REC-6)."""
    om = origin - geom.mean
    b1 = geom.ax1 / geom.l0[:, None]
    b2 = geom.ax2 / geom.l1[:, None]
    b1u = geom.uv_scale[:, 0:1] * geom.ax1
    b2u = geom.uv_scale[:, 1:2] * geom.ax2
    dot = lambda a, b: (a * b).sum(-1, keepdim=True)
    return torch.cat([
        geom.normal, -dot(om, geom.normal),
        b1, dot(om, b1),
        b2, dot(om, b2),
        b1u, dot(om, b1u),
        b2u, dot(om, b2u),
        geom.opacity[:, None], geom.rgb, geom.xy,
    ], dim=-1)


def assemble_records(geom: SplatGeom, origin: torch.Tensor,
                     texture_hw: torch.Tensor) -> torch.Tensor:
    """(N, F_REC) records: ``build_records`` plus the active chart dims."""
    rec = build_records(geom, origin)
    pad = torch.zeros((rec.shape[0], F_REC - rec.shape[-1] - 2),
                      dtype=rec.dtype, device=rec.device)
    return torch.cat([rec, texture_hw.to(rec.dtype), pad],
                     dim=-1).contiguous()


def cam_info(cam: Camera, px_offset=None) -> torch.Tensor:
    """(18,) float32 camera block the kernel reads."""
    dev = cam.c2w.device
    if px_offset is None:
        px_offset = (0.0, 0.0)
    return torch.cat([
        torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]),
        torch.as_tensor(px_offset, dtype=torch.float32,
                        device=dev).reshape(2),
        cam.c2w[:3, 3].reshape(3),
        camera_rotation_gsplat(cam.c2w).reshape(9),
    ]).to(torch.float32).contiguous()
