"""Renderer API over the kernels (counterpart of
``gstex_tpu/ops/rasterize_pallas_api.py``)."""

from __future__ import annotations

import torch

from .binning import FlatBins, TileGrid
from .camera import Camera
from .rasterize_eval import rasterize_eval
from .records import assemble_records, cam_info
from .surfel import SplatGeom


def rasterize_pl5_eval(geom: SplatGeom, texture: torch.Tensor,
                       texture_hw: torch.Tensor, fbins: FlatBins,
                       cam: Camera, grid: TileGrid, s_cap: int,
                       px_offset=None, background=None) -> dict:
    """Flat-path forward-only render: ``img`` and ``texture_rgb`` (H, W, 3),
    ``depth`` and ``alpha`` (H, W), and, given a ``background`` (3,),
    ``rgb`` = clip(img + tex + (1−α)·bg, 0, 1)."""
    records = assemble_records(geom, cam.c2w[:3, 3], texture_hw)
    maps = rasterize_eval(records, fbins.gids, fbins.starts, fbins.counts,
                          texture.contiguous(), cam_info(cam, px_offset),
                          grid, s_cap)
    out = {
        "img": maps[0:3].permute(1, 2, 0),
        "texture_rgb": maps[3:6].permute(1, 2, 0),
        "depth": maps[6],
        "alpha": maps[7],
    }
    if background is not None:
        rgb = maps[0:3] + maps[3:6] + (1.0 - maps[7]) * background[:, None,
                                                                   None]
        out["rgb"] = torch.clamp(rgb, 0.0, 1.0).permute(1, 2, 0)
    return out
