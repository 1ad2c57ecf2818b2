"""Renderer API over the kernels (counterpart of
``gstex_tpu/ops/rasterize_pallas_api.py``): the flat pair-list path
(``rasterize_pl5``, ``rasterize_pl5_eval``), the dense-list path
(``rasterize_pl``, ``rasterize_pl_eval``; ``rasterize_pl`` also trains on
the pair-space v3, v2 and v1 kernels over the same lists) and the rule that
chooses between flat and dense (``use_flat_path``, ``flat_pad_rule``,
``dense_pallas_fits``)."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .binning import FlatBins, TileBins, TileGrid
from .camera import Camera
from .pair_inputs import check_pair_shapes, pair_inputs
from .rasterize_bwd import rasterize_bwd
from .rasterize_dense import (rasterize_dense_bwd, rasterize_dense_eval,
                              rasterize_dense_fwd)
from .rasterize_eval import rasterize_eval
from .rasterize_fwd import MAX_TILE_PIXELS, NG, rasterize_fwd, tile_order
from .rasterize_v1 import rasterize_v1_bwd, rasterize_v1_fwd
from .rasterize_v2 import rasterize_v2_bwd, rasterize_v2_fwd
from .rasterize_v3 import rasterize_v3_bwd, rasterize_v3_fwd
from .records import F_REC, assemble_records, cam_info
from .surfel import SplatGeom

# renderers that name the flat pair-list kernel path; "_interpret" is the
# JAX package's CPU mode of the same path, which here is the plain version
# any CPU tensor takes
FLAT_RENDERERS = ("pallas", "pallas5", "pallas_interpret",
                  "pallas5_interpret")


# the flat tier's chart-pad rule (``flat_pad_rule``): the bytes a flat
# backward block of the first port staged, against the card's shared
# memory per block
FLAT_RULE_SMEM = 227 * 1024
FLAT_RULE_PIXEL_PLANES = 14


def flat_pad_rule(chart_pad, tile_pixels: int) -> bool:
    """Does ``renderer="pallas"`` keep this chart pad on the flat tier?

    A dispatch rule, no longer a limit of the kernels: all three flat
    kernels (eval, training forward and backward) stage records only and
    take any pad. The first port's flat backward staged one splat's whole
    chart and its gradient beside the tile's planes, ``(14 · pixels + 2 ·
    (32 + 3·Ch·Cw)) · 4 B <= 227 KB`` (about (80, 88) at 32 x 32 tiles),
    and the pads above went to the dense tier. The rule is kept as it was,
    so that each pad takes the tier it took before, until ``PERF.md`` §7's
    open question (should the flat tier stay the default?) is decided by
    measurement."""
    per_splat = (2 * F_REC + 6 * chart_pad[0] * chart_pad[1]) * 4
    return (FLAT_RULE_PIXEL_PLANES * tile_pixels * 4 + per_splat
            <= FLAT_RULE_SMEM)


def use_flat_path(renderer: str, chart_pad, tile_pixels: int) -> bool:
    """Route ``renderer="pallas"`` to the flat path where the flat kernels
    take the tile size and ``flat_pad_rule`` keeps the chart pad there.
    One decision per (renderer, chart pad, tile size), the same for
    training and eval, so a scene trained on one tier is served by it.

    The JAX package's rule bounds a pair-space gradient buffer in TPU HBM;
    the flat CUDA kernels have no such buffer."""
    if renderer not in FLAT_RENDERERS:
        return False
    return (tile_pixels <= MAX_TILE_PIXELS
            and flat_pad_rule(chart_pad, tile_pixels))


def dense_pallas_fits(chart_pad, s_max: int) -> bool:
    """Can the dense-list kernels take these shapes? Where they cannot,
    ``models.gstex.render`` falls back to the pure-torch tier.

    The JAX package's rule bounds the TPU backward's per-tile chart-gradient
    window in VMEM. The dense CUDA kernels hold nothing in pair space and
    nothing chart-sized on chip: records are staged a chunk at a time,
    texels are read from and texel gradients added to the ``(N, Ch, Cw,
    3)`` tensors in device memory. So every pad and every ``s_max`` fits;
    what bounds a scene on the H100 is device memory for the charts
    themselves (with gradient and Adam moments, 48 · N · Ch · Cw bytes) and
    for the ``num_tiles x s_max`` int32 id list."""
    return True


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
    ``rgb`` = clip(img + tex + (1−α)·bg, 0, 1). The kernel takes the tiles
    longest first, in an order computed once a frame."""
    with record_function("gstex.records"):
        records = assemble_records(geom, cam.c2w[:3, 3], texture_hw)
        info = cam_info(cam, px_offset)
    with record_function("gstex.eval_kernel"):
        order = tile_order(fbins.counts, s_cap)
        maps = rasterize_eval(records, fbins.gids, fbins.starts,
                              fbins.counts, texture.contiguous(), info, grid,
                              s_cap, order=order)
    with record_function("gstex.compose"):
        return _compose(maps, background)


class _Rasterize5(torch.autograd.Function):
    """(records, charts) -> (14, H, W) maps, ncontrib; the backward runs
    ``rasterize_bwd`` on the cotangents of the first 12 maps (the
    counterpart of ``_core5``'s custom VJP). Both kernels take the tiles in
    one order, computed once."""

    @staticmethod
    def forward(ctx, records, charts, gids, starts, counts, info, grid,
                s_cap, lean):
        order = tile_order(counts, s_cap)
        maps, ncon = rasterize_fwd(records, gids, starts, counts, charts,
                                   info, grid, s_cap, lean=lean, order=order)
        ctx.save_for_backward(records, charts, gids, starts, counts, info,
                              maps, ncon, order)
        ctx.grid, ctx.s_cap, ctx.lean = grid, s_cap, lean
        ctx.mark_non_differentiable(ncon)
        return maps, ncon

    @staticmethod
    def backward(ctx, g_maps, g_ncon):
        records, charts, gids, starts, counts, info, maps, ncon, order = \
            ctx.saved_tensors
        d_rec, d_ch = rasterize_bwd(
            records, gids, starts, counts, charts, info, maps, ncon,
            g_maps[:NG].contiguous(), ctx.grid, ctx.s_cap, lean=ctx.lean,
            order=order)
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


def rasterize_pl_eval(geom: SplatGeom, texture: torch.Tensor,
                      texture_hw: torch.Tensor, bins: TileBins, cam: Camera,
                      grid: TileGrid, px_offset=None,
                      background=None) -> dict:
    """Dense-path forward-only render: the maps of ``rasterize_pl5_eval``
    from the dense per-tile lists. The kernel takes the tiles longest
    first, in an order computed once a frame."""
    with record_function("gstex.records"):
        records = assemble_records(geom, cam.c2w[:3, 3], texture_hw)
        info = cam_info(cam, px_offset)
    with record_function("gstex.eval_kernel"):
        order = tile_order(bins.counts, bins.ids.shape[1])
        maps = rasterize_dense_eval(records, bins.ids, bins.counts,
                                    texture.contiguous(), info, grid,
                                    order=order)
    with record_function("gstex.compose"):
        return _compose(maps, background)


class _Rasterize4(torch.autograd.Function):
    """(records, charts) -> (14, H, W) maps, ncontrib over the dense lists;
    the backward runs ``rasterize_dense_bwd`` on the cotangents of the
    first 12 maps (the counterpart of ``_core4``'s custom VJP, with its
    segment sums inside the kernel). Both kernels take the tiles longest
    first, in one order computed once, in the forward."""

    @staticmethod
    def forward(ctx, records, charts, ids, counts, info, grid, lean):
        order = tile_order(counts, ids.shape[1])
        maps, ncon = rasterize_dense_fwd(records, ids, counts, charts, info,
                                         grid, lean=lean, order=order)
        ctx.save_for_backward(records, charts, ids, counts, info, maps, ncon,
                              order)
        ctx.grid, ctx.lean = grid, lean
        ctx.mark_non_differentiable(ncon)
        return maps, ncon

    @staticmethod
    def backward(ctx, g_maps, g_ncon):
        records, charts, ids, counts, info, maps, ncon, order = \
            ctx.saved_tensors
        d_rec, d_ch = rasterize_dense_bwd(
            records, ids, counts, charts, info, maps, ncon,
            g_maps[:NG].contiguous(), ctx.grid, lean=ctx.lean, order=order)
        return d_rec, d_ch, None, None, None, None, None


_PAIR_IMPLS = {3: (rasterize_v3_fwd, rasterize_v3_bwd),
               2: (rasterize_v2_fwd, rasterize_v2_bwd),
               1: (rasterize_v1_fwd, rasterize_v1_bwd)}


class _RasterizePairs(torch.autograd.Function):
    """(records_t, charts_g) -> (14, H, W) maps, ncontrib over the
    pair-space inputs, by the v3, v2 or v1 kernels; the backward returns their
    pair-space gradients, which autograd reduces through the gathers of
    ``pair_inputs`` (the counterpart of ``_core`` with ``_impls``). Each
    version's forward and backward take the tiles longest first, in one
    order computed once, in the forward."""

    @staticmethod
    def forward(ctx, records_t, charts_g, counts, info, grid, version, lean):
        order = tile_order(counts, records_t.shape[1])
        fwd, _ = _PAIR_IMPLS[version]
        maps, ncon = fwd(records_t, charts_g, counts, info, grid, lean=lean,
                         order=order)
        ctx.save_for_backward(records_t, charts_g, counts, info, maps, ncon,
                              order)
        ctx.grid, ctx.version, ctx.lean = grid, version, lean
        ctx.mark_non_differentiable(ncon)
        return maps, ncon

    @staticmethod
    def backward(ctx, g_maps, g_ncon):
        records_t, charts_g, counts, info, maps, ncon, order = \
            ctx.saved_tensors
        _, bwd = _PAIR_IMPLS[ctx.version]
        d_rec, d_ch = bwd(records_t, charts_g, counts, info, maps, ncon,
                          g_maps[:NG].contiguous(), ctx.grid, lean=ctx.lean,
                          order=order)
        return d_rec, d_ch, None, None, None, None, None


def rasterize_pl(geom: SplatGeom, texture: torch.Tensor,
                 texture_hw: torch.Tensor, bins: TileBins, cam: Camera,
                 grid: TileGrid, px_offset=None, version: int = 4,
                 lean: bool = False, background=None,
                 pair_cap=None) -> dict:
    """Dense-path training render, differentiable in ``geom`` and
    ``texture``; same outputs as ``rasterize.rasterize`` (and ``rgb``,
    given a ``background``). ``lean`` as in ``rasterize_pl5``.
    ``version`` 4 runs the dense-list kernels; 3, 2 and 1 the pair-space
    kernels on per-slot copies of the records and charts (32x32 tiles;
    charts of at most 40, 42 and 42 rows), ``pair_cap`` bounding the
    copies' gathers (``pair_inputs``)."""
    if version not in (1, 2, 3, 4):
        raise ValueError(f"unknown kernel version {version}")
    if version != 4:
        check_pair_shapes(version, texture.shape[1:3], grid)
    with record_function("gstex.records"):
        records = assemble_records(geom, cam.c2w[:3, 3], texture_hw)
        info = cam_info(cam, px_offset)
    if version == 4:
        with record_function("gstex.fwd_kernel"):
            maps, _ = _Rasterize4.apply(records, texture.contiguous(),
                                        bins.ids, bins.counts, info, grid,
                                        lean)
    else:
        # the per-slot copies that v4 does without
        with record_function("gstex.pair_gather"):
            pairs = pair_inputs(records, texture, bins, pair_cap)
        with record_function("gstex.fwd_kernel"):
            maps, _ = _RasterizePairs.apply(pairs.records_t, pairs.charts_g,
                                            pairs.counts, info, grid,
                                            version, lean)
    with record_function("gstex.compose"):
        out = _compose(maps, background)
        out["normal"] = maps[8:11].permute(1, 2, 0)
        out["reg"] = maps[11]
    return out
