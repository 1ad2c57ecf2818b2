"""The v1 pair-space kernels: training forward and backward over the
per-(tile, slot) copies of ``ops/pair_inputs.py``. The CUDA kernels
``csrc/rasterize_v1_fwd.cu`` and ``csrc/rasterize_v1_bwd.cu``, their
wrappers, and their plain PyTorch versions.

Counterpart of ``gstex_tpu/ops/rasterize_pallas.py`` ``rasterize_pallas_fwd``
(``_fwd_kernel``) and ``gstex_tpu/ops/rasterize_pallas_bwd.py``
``rasterize_pallas_bwd`` (``_bwd_kernel``). v1 is v2's serial walk over
the same pair-space inputs (``ops/rasterize_v2.py``) with its own
rounding: the falloff is the larger of two exps, and the distortion depth
``m = KFAC·(1 − NEAR / max(t, NEAR))`` is a divide, as are the backward's
m chain ``KFAC·NEAR / tc²`` and ``d_a_n = d_t / n·d``, where v2 multiplies
by reciprocals. So alpha, T, ncontrib and every map but ``reg`` and ``m1``
equal v2's bit for bit.

The plain version is that serial walk on the pair-space view, through
``rasterize.forward_scan`` and ``rasterize.backward_walk`` with ``v1=True``.
"""

from __future__ import annotations

from . import rasterize as plain
from .binning import TileGrid
from .launch_counts import counted
from .pair_inputs import (check_bwd_inputs, check_inputs, launch_bwd,
                          launch_fwd)
from .rasterize_fwd import tile_order
from .rasterize_v2 import pair_view


def rasterize_v1_fwd_reference(records_t, charts_g, counts, cam_info,
                               grid: TileGrid, lean: bool = False):
    """Plain PyTorch version of the forward kernel: ``(maps (14, H, W),
    ncontrib (H, W) int32)``."""
    records, ids, charts = pair_view(records_t, charts_g)
    return plain.forward_scan(records, ids, counts, charts, cam_info, grid,
                              lean=lean, v1=True)


def rasterize_v1_bwd_reference(records_t, charts_g, counts, cam_info, maps,
                               ncontrib, gmaps, grid: TileGrid,
                               lean: bool = False):
    """Plain PyTorch version of the backward kernel: the pair-space
    ``(d_records_t (T, S, 32), d_charts_g (T, S, Ch, Cw, 3))``."""
    records, ids, charts = pair_view(records_t, charts_g)
    d_rec, d_ch = plain.backward_walk(records, ids, counts, charts, cam_info,
                                      maps, ncontrib, gmaps, grid, lean=lean,
                                      v1=True)
    return d_rec.view(records_t.shape), d_ch.view(charts_g.shape)


def rasterize_v1_fwd(records_t, charts_g, counts, cam_info, grid: TileGrid,
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
    check_inputs(1, records_t, charts_g, counts, cam_info, grid, order)
    if records_t.device.type == "cpu":
        return rasterize_v1_fwd_reference(records_t, charts_g, counts,
                                          cam_info, grid, lean=lean)
    if order is None:
        order = tile_order(counts, records_t.shape[1])
    out = launch_fwd("rasterize_v1_fwd", records_t, charts_g, counts,
                     cam_info, grid, lean, order)
    rasterize_v1_fwd.launches += 1
    return out


def rasterize_v1_bwd(records_t, charts_g, counts, cam_info, maps, ncontrib,
                     gmaps, grid: TileGrid, lean: bool = False, order=None):
    """Gradients of the training forward's first 12 maps under the
    cotangents ``gmaps`` (12, H, W): the pair-space ``(d_records_t (T, S,
    32), d_charts_g (T, S, Ch, Cw, 3))``. ``maps`` and ``ncontrib`` are
    ``rasterize_v1_fwd``'s outputs for the same inputs. Tile ``order`` and
    the 16-byte alignment of ``records_t`` as
    ``rasterize_v2.rasterize_v2_bwd``."""
    check_bwd_inputs(1, records_t, charts_g, counts, cam_info, maps,
                     ncontrib, gmaps, grid, order)
    if records_t.device.type == "cpu":
        return rasterize_v1_bwd_reference(records_t, charts_g, counts,
                                          cam_info, maps, ncontrib, gmaps,
                                          grid, lean=lean)
    out = launch_bwd("rasterize_v1_bwd", records_t, charts_g, counts,
                     cam_info, maps, ncontrib, gmaps, grid, lean, order)
    rasterize_v1_bwd.launches += 1
    return out


# kernel launches since the last reset (CPU calls do not count;
# ``launch_counts``)
counted(rasterize_v1_fwd)
counted(rasterize_v1_bwd)
