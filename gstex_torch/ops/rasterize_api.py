"""Renderer API over the kernels (counterpart of
``gstex_tpu/ops/rasterize_pallas_api.py``)."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .binning import FlatBins, TileGrid
from .camera import Camera
from .rasterize_bwd import rasterize_bwd
from .rasterize_eval import rasterize_eval
from .rasterize_fwd import NG, rasterize_fwd
from .records import assemble_records, cam_info
from .surfel import SplatGeom


def _compose(maps: torch.Tensor, background) -> dict:
    """The named (H, W, ·) maps of the first eight planes and, given a
    ``background`` (3,), ``rgb`` = clip(img + tex + (1−α)·bg, 0, 1)."""
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


def rasterize_pl5_eval(geom: SplatGeom, texture: torch.Tensor,
                       texture_hw: torch.Tensor, fbins: FlatBins,
                       cam: Camera, grid: TileGrid, s_cap: int,
                       px_offset=None, background=None) -> dict:
    """Flat-path forward-only render: ``img`` and ``texture_rgb`` (H, W, 3),
    ``depth`` and ``alpha`` (H, W), and, given a ``background`` (3,),
    ``rgb`` = clip(img + tex + (1−α)·bg, 0, 1)."""
    with record_function("gstex.records"):
        records = assemble_records(geom, cam.c2w[:3, 3], texture_hw)
        info = cam_info(cam, px_offset)
    with record_function("gstex.eval_kernel"):
        maps = rasterize_eval(records, fbins.gids, fbins.starts,
                              fbins.counts, texture.contiguous(), info, grid,
                              s_cap)
    with record_function("gstex.compose"):
        return _compose(maps, background)


class _Rasterize5(torch.autograd.Function):
    """(records, charts) -> (14, H, W) maps, ncontrib; the backward runs
    ``rasterize_bwd`` on the cotangents of the first 12 maps (the
    counterpart of ``_core5``'s custom VJP)."""

    @staticmethod
    def forward(ctx, records, charts, gids, starts, counts, info, grid,
                s_cap, lean):
        maps, ncon = rasterize_fwd(records, gids, starts, counts, charts,
                                   info, grid, s_cap, lean=lean)
        ctx.save_for_backward(records, charts, gids, starts, counts, info,
                              maps, ncon)
        ctx.grid, ctx.s_cap, ctx.lean = grid, s_cap, lean
        ctx.mark_non_differentiable(ncon)
        return maps, ncon

    @staticmethod
    def backward(ctx, g_maps, g_ncon):
        records, charts, gids, starts, counts, info, maps, ncon = \
            ctx.saved_tensors
        d_rec, d_ch = rasterize_bwd(
            records, gids, starts, counts, charts, info, maps, ncon,
            g_maps[:NG].contiguous(), ctx.grid, ctx.s_cap, lean=ctx.lean)
        return d_rec, d_ch, None, None, None, None, None, None, None


def rasterize_pl5(geom: SplatGeom, texture: torch.Tensor,
                  texture_hw: torch.Tensor, fbins: FlatBins, cam: Camera,
                  grid: TileGrid, s_cap: int, px_offset=None,
                  lean: bool = False, background=None) -> dict:
    """Flat-path training render, differentiable in ``geom`` and
    ``texture``: the maps of ``rasterize_pl5_eval`` plus ``normal``
    (H, W, 3) and ``reg`` (H, W). ``lean=True`` (only where the reg and
    normal loss terms are statically zero) skips their compute chains in
    both kernels; those maps come back as zeros."""
    with record_function("gstex.records"):
        records = assemble_records(geom, cam.c2w[:3, 3], texture_hw)
        info = cam_info(cam, px_offset)
    with record_function("gstex.fwd_kernel"):
        maps, _ = _Rasterize5.apply(records, texture.contiguous(),
                                    fbins.gids, fbins.starts, fbins.counts,
                                    info, grid, s_cap, lean)
    with record_function("gstex.compose"):
        out = _compose(maps, background)
        out["normal"] = maps[8:11].permute(1, 2, 0)
        out["reg"] = maps[11]
    return out
