"""The v2 pair-space kernels: training forward and backward over the
per-(tile, slot) copies of ``ops/pair_inputs.py``. The CUDA kernels
``csrc/rasterize_v2_fwd.cu`` and ``csrc/rasterize_v2_bwd.cu``, their
wrappers, and their plain PyTorch versions.

Counterpart of ``gstex_tpu/ops/rasterize_pallas2.py``:
``rasterize_pallas2_fwd`` (``_fwd_kernel2``) and ``rasterize_pallas2_bwd``
(``_bwd_kernel2``). The blend is the serial walk of the other tiers, one
splat after another per pixel, with the distortion depth by
reciprocal-multiply; what sets v2 apart is where it reads and writes: each
slot's own record and chart copy, and pair-space gradients ``d_records_t
(T, S, 32)`` and ``d_charts_g (T, S, Ch, Cw, 3)``, which autograd reduces
through the gathers.

The plain version is that serial walk on the pair-space view: records
``(T·S, 32)``, ids ``arange(T·S).view(T, S)`` and charts ``(T·S, Ch, Cw,
3)`` through ``rasterize.forward_scan`` and ``rasterize.backward_walk``.
"""

from __future__ import annotations

import torch

from . import rasterize as plain
from .binning import TileGrid
from .launch_counts import counted
from .pair_inputs import (check_bwd_inputs, check_inputs, launch_bwd,
                          launch_fwd)
from .rasterize_fwd import tile_order
from .records import F_REC


def pair_view(records_t, charts_g):
    """The pair-space inputs as dense lists over ``T·S`` gaussians:
    ``(records (T·S, 32), ids (T, S) int32, charts (T·S, Ch, Cw, 3))``."""
    nt, s_max = records_t.shape[:2]
    ids = torch.arange(nt * s_max, dtype=torch.int32,
                       device=records_t.device).view(nt, s_max)
    return (records_t.reshape(nt * s_max, F_REC), ids,
            charts_g.reshape(nt * s_max, *charts_g.shape[2:]))


def rasterize_v2_fwd_reference(records_t, charts_g, counts, cam_info,
                               grid: TileGrid, lean: bool = False):
    """Plain PyTorch version of the forward kernel: ``(maps (14, H, W),
    ncontrib (H, W) int32)``."""
    records, ids, charts = pair_view(records_t, charts_g)
    return plain.forward_scan(records, ids, counts, charts, cam_info, grid,
                              lean=lean)


def rasterize_v2_bwd_reference(records_t, charts_g, counts, cam_info, maps,
                               ncontrib, gmaps, grid: TileGrid,
                               lean: bool = False):
    """Plain PyTorch version of the backward kernel: the pair-space
    ``(d_records_t (T, S, 32), d_charts_g (T, S, Ch, Cw, 3))``."""
    records, ids, charts = pair_view(records_t, charts_g)
    d_rec, d_ch = plain.backward_walk(records, ids, counts, charts, cam_info,
                                      maps, ncontrib, gmaps, grid, lean=lean)
    return d_rec.view(records_t.shape), d_ch.view(charts_g.shape)


def rasterize_v2_fwd(records_t, charts_g, counts, cam_info, grid: TileGrid,
                     lean: bool = False, order=None):
    """Training forward; returns ``(maps (14, H, W), ncontrib (H, W)
    int32)``, ncontrib being ``S`` where a pixel's walk never broke.

    Args:
        records_t: (T, S, 32) float32 ``pair_inputs(...).records_t``.
        charts_g: (T, S, Ch, Cw, 3) float32 per-slot charts, Ch <= 42.
        counts: (T,) int32 (clamped to S here and in the kernel).
        cam_info: (18,) float32.
        lean: skip the normal and reg chains; their planes stay zero.
        order: the tiles longest first, ``tile_order(counts, S)``,
            computed here if not given. The tile order changes no pixel's
            operations: the maps and ncontrib are bit-equal to the plain
            version's under any order.

    ``records_t`` must be 16-byte aligned: the kernel copies it 16 B at a
    time. CPU tensors run the plain version; CUDA tensors launch the
    kernel (and raise if it cannot launch).
    """
    check_inputs(2, records_t, charts_g, counts, cam_info, grid, order)
    if records_t.device.type == "cpu":
        return rasterize_v2_fwd_reference(records_t, charts_g, counts,
                                          cam_info, grid, lean=lean)
    if order is None:
        order = tile_order(counts, records_t.shape[1])
    out = launch_fwd("rasterize_v2_fwd", records_t, charts_g, counts,
                     cam_info, grid, lean, order)
    rasterize_v2_fwd.launches += 1
    return out


def rasterize_v2_bwd(records_t, charts_g, counts, cam_info, maps, ncontrib,
                     gmaps, grid: TileGrid, lean: bool = False, order=None):
    """Gradients of the training forward's first 12 maps under the
    cotangents ``gmaps`` (12, H, W): the pair-space ``(d_records_t (T, S,
    32), d_charts_g (T, S, Ch, Cw, 3))``. ``maps`` and ``ncontrib`` are
    ``rasterize_v2_fwd``'s outputs for the same inputs. The kernel takes
    its tiles longest first, in ``order`` (``tile_order(counts, S)``,
    computed here if not given), and copies ``records_t``, which must be
    16-byte aligned, 16 B at a time. The tile order changes nothing a
    tile computes; its texel gradients' atomics add in no fixed order
    under any."""
    check_bwd_inputs(2, records_t, charts_g, counts, cam_info, maps,
                     ncontrib, gmaps, grid, order)
    if records_t.device.type == "cpu":
        return rasterize_v2_bwd_reference(records_t, charts_g, counts,
                                          cam_info, maps, ncontrib, gmaps,
                                          grid, lean=lean)
    out = launch_bwd("rasterize_v2_bwd", records_t, charts_g, counts,
                     cam_info, maps, ncontrib, gmaps, grid, lean, order)
    rasterize_v2_bwd.launches += 1
    return out


# kernel launches since the last reset (CPU calls do not count;
# ``launch_counts``)
counted(rasterize_v2_fwd)
counted(rasterize_v2_bwd)

