"""The pair-space inputs of the v3, v2 and v1 kernels: every (tile, slot) of
the dense lists gets its own copy of its splat's record and chart.

Counterpart of ``gstex_tpu/ops/rasterize_pallas.py`` ``PallasInputs`` /
``prepare_pallas_inputs`` and of the chart-pad limits of its lane packing
(``pack_charts``, ``rasterize_pallas3.pack_charts_cmajor``). The charts
keep the port's ``(Ch, Cw, 3)`` layout; the TPU's lane packing and its
``Cw`` padding are not carried over.

Both gathers are differentiable: autograd's scatter-add through them is
the reduction of the kernels' pair-space gradients to per-gaussian ones,
which XLA does through the transpose of the same gathers in the JAX
package. The pair buffer and its gradient take ``2 · T · s_max · Ch · Cw
· 12`` bytes; the dense-list kernels (``ops/rasterize_dense.py``) have no
such buffer.

Also here, what the v3, v2 and v1 wrappers share: their input checks and
their launches. Every pair-space kernel takes its tiles longest first (an
``order``) and copies its records 16 B at a time, so it needs
16-byte-aligned records.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .binning import TileBins, TileGrid
from .rasterize_bwd import check_residuals
from .rasterize_dense import _launch
from .rasterize_fwd import NCH, tile_order
from .records import F_REC

# the JAX package's limits on the chart height: v3 packs charts c-major
# into 128 lanes (3 · ceil8(Ch) <= 128), v1 and v2 a-major (3 · Ch <= 128)
MAX_CHART_H = {3: 40, 2: 42, 1: 42}
TILE = (32, 32)


class PairInputs(NamedTuple):
    records_t: torch.Tensor   # (T, S, 32) records[bins.ids]
    charts_g: torch.Tensor    # (T, S, Ch, Cw, 3) texture[bins.ids]
    counts: torch.Tensor      # (T,) int32, clamped to S


def check_pair_shapes(version: int, chart_pad, grid: TileGrid) -> None:
    """Raise ``ValueError`` on the shapes the JAX package's v1-v3 kernels
    refuse: tiles other than 32 x 32, and charts taller than their lane
    packing takes."""
    if version not in MAX_CHART_H:
        raise ValueError(f"unknown pair-space kernel version {version}")
    if (grid.tile_h, grid.tile_w) != TILE:
        raise ValueError(f"the v{version} kernels need 32x32 tiles, not "
                         f"{grid.tile_h}x{grid.tile_w}; renderer 'pallas4' "
                         f"takes every tile size")
    limit = MAX_CHART_H[version]
    if chart_pad[0] > limit:
        raise ValueError(f"the v{version} kernels take charts of at most "
                         f"{limit} rows, not {chart_pad[0]}; renderer "
                         f"'pallas4' takes every pad")


class _PairCopies(torch.autograd.Function):
    """(records, texture) -> their (T·S, ...) per-slot copies: slot i is
    row ``rows[i]``, or zero where that is N. The backward gathers the
    copies' gradients from the real slots (``slot``, with their rows
    ``gid``; ``n``, past the lists, marks an unused entry) and adds them
    into the rows, as autograd's scatter-add through a gather does."""

    @staticmethod
    def forward(ctx, records, texture, rows, gid, slot, n):
        ctx.save_for_backward(gid, slot)
        ctx.n, ctx.shapes = n, (records.shape, texture.shape)

        def place(src):
            zero = src.new_zeros((1, *src.shape[1:]))
            return torch.cat([src, zero]).index_select(0, rows)
        return place(records), place(texture)

    @staticmethod
    def backward(ctx, g_records, g_texture):
        gid, slot = ctx.saved_tensors
        dropped = slot >= ctx.n

        def gather(g, shape):
            rows = g.reshape(ctx.n, *shape[1:]).index_select(
                0, torch.clamp(slot, max=ctx.n - 1))
            rows.masked_fill_(dropped.view(-1, *[1] * (rows.dim() - 1)), 0.0)
            return rows.new_zeros(shape).index_put_((gid,), rows,
                                                    accumulate=True)
        return (gather(g_records, ctx.shapes[0]),
                gather(g_texture, ctx.shapes[1]), None, None, None, None)


def pair_inputs(records: torch.Tensor, texture: torch.Tensor,
                bins: TileBins, pair_cap=None) -> PairInputs:
    """``records`` (N, 32) and ``texture`` (N, Ch, Cw, 3) gathered to the
    (tile, slot) pairs of ``bins``; slots past a tile's count are zero.

    No host sync (a CUDA graph can hold the call): one gather fills every
    slot, the padding from a zero row. The backward reduces the real
    slots only: tile by tile they are the first ones of ``pair_cap``
    (default: every slot of the lists; the binning's ``pair_cap`` bounds
    them), each found by a binary search of the tiles' cumulative counts.
    The lists pad every tile's row with id 0, and a reduction over the
    padding would send all of its (zero) gradient rows to gaussian 0,
    where the scatter-add serializes on them, so the unused searches add
    their zeros to row k mod N instead."""
    ids = bins.ids
    nt, s_max = ids.shape
    n, n_rows = nt * s_max, records.shape[0]
    p = n if pair_cap is None else min(int(pair_cap), n)
    counts = torch.clamp(bins.counts, max=s_max)
    rows = torch.where(
        torch.arange(s_max, device=ids.device)[None] < counts[:, None],
        ids, n_rows).reshape(-1)
    ends = torch.cumsum(counts.long(), 0)
    k = torch.arange(p, device=ids.device)
    tile = torch.clamp(torch.searchsorted(ends, k, right=True), max=nt - 1)
    real = k < ends[-1]
    slot = torch.where(real, tile * s_max + k - (ends - counts)[tile], n)
    gid = torch.where(real, ids.reshape(-1)[torch.clamp(slot, max=n - 1)],
                      k % max(n_rows, 1))
    records_t, charts_g = _PairCopies.apply(records, texture, rows, gid,
                                            slot, n)
    return PairInputs(records_t.reshape(nt, s_max, *records.shape[1:]),
                      charts_g.reshape(nt, s_max, *texture.shape[1:]),
                      counts.to(torch.int32))


def check_inputs(version: int, records_t, charts_g, counts, cam_info,
                 grid: TileGrid, order=None) -> None:
    """Raise on inputs the v3, v2 or v1 kernels do not take: ``order``
    (given) must be an int32 ``(num_tiles,)`` tile order, and the records
    16-byte aligned (the kernels copy them by cp.async)."""
    check_pair_shapes(version, charts_g.shape[2:4], grid)
    dev = records_t.device
    if records_t.dim() != 3 or records_t.shape[0] != grid.num_tiles \
            or records_t.shape[2] != F_REC:
        raise ValueError(f"records_t must be (num_tiles={grid.num_tiles}, "
                         f"s_max, {F_REC}), got {tuple(records_t.shape)}")
    if charts_g.dim() != 5 or charts_g.shape[:2] != records_t.shape[:2] \
            or charts_g.shape[4] != 3:
        raise ValueError(f"charts_g must be (T, S, Ch, Cw, 3) with (T, S) = "
                         f"{tuple(records_t.shape[:2])}, got "
                         f"{tuple(charts_g.shape)}")
    spec = {"records_t": (records_t, torch.float32, None),
            "charts_g": (charts_g, torch.float32, None),
            "counts": (counts, torch.int32, (grid.num_tiles,)),
            "cam_info": (cam_info, torch.float32, (18,))}
    if order is not None:
        spec["order"] = (order, torch.int32, (grid.num_tiles,))
    for name, (x, dtype, shape) in spec.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, records_t on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the v{version} kernels run on cpu or cuda, not "
                         f"{dev}")
    if records_t.data_ptr() % 16:
        raise ValueError("records_t must be 16-byte aligned")


def check_bwd_inputs(version: int, records_t, charts_g, counts, cam_info,
                     maps, ncontrib, gmaps, grid: TileGrid, order) -> None:
    """Raise on inputs the v3, v2 or v1 backward does not take: those of
    ``check_inputs`` and residuals of the wrong shape."""
    check_inputs(version, records_t, charts_g, counts, cam_info, grid,
                 order)
    check_residuals(maps, ncontrib, gmaps, records_t.device, grid)


def _geometry(grid: TileGrid, charts_g):
    return (grid.num_tiles, grid.ntx, grid.tile_h, grid.tile_w, grid.height,
            grid.width, charts_g.shape[2], charts_g.shape[3],
            charts_g.shape[1])


def launch_fwd(name: str, records_t, charts_g, counts, cam_info,
               grid: TileGrid, lean: bool, order):
    """Launch the forward kernel ``gstex_<name>`` on CUDA inputs; returns
    ``(maps (14, H, W), ncontrib (H, W) int32)``. The kernel takes its
    tiles in ``order``, after ``ncontrib``."""
    dev = records_t.device
    out = torch.empty((NCH, grid.height, grid.width), dtype=torch.float32,
                      device=dev)
    ncon = torch.empty((grid.height, grid.width), dtype=torch.int32,
                       device=dev)
    pointers = (records_t, charts_g, counts, cam_info, out, ncon, order)
    _launch(name, len(pointers), pointers,
            (*_geometry(grid, charts_g), int(lean)), dev)
    return out, ncon


def launch_bwd(name: str, records_t, charts_g, counts, cam_info, maps,
               ncontrib, gmaps, grid: TileGrid, lean: bool, order=None):
    """Launch the backward kernel ``gstex_<name>`` on CUDA inputs; returns
    the pair-space ``(d_records_t, d_charts_g)``. Every slot belongs to one
    tile, so one block writes it: the kernels need no atomics across
    blocks. The kernel takes its tiles in ``order``, after ``d_charts_g``
    (``tile_order(counts, S)`` where none is given)."""
    dev = records_t.device
    if order is None:
        order = tile_order(counts, records_t.shape[1])
    d_rec = torch.zeros_like(records_t)
    d_ch = torch.zeros_like(charts_g)
    pointers = (records_t, charts_g, counts, cam_info, maps, ncontrib, gmaps,
                d_rec, d_ch, order)
    _launch(name, len(pointers), pointers,
            (*_geometry(grid, charts_g), int(lean)), dev)
    return d_rec, d_ch


def bwd_launch_smem(version: int, tile_h: int, tile_w: int, ch: int,
                    cw: int) -> int:
    """Bytes of shared memory a launch of the v3, v2 or v1 backward takes
    at ``tile_h x tile_w`` tiles and ``(ch, cw)`` charts: its static arrays
    and the tile's 14 per-pixel planes (v2's C entry also takes the pad,
    for its staged option; no pad enters the others)."""
    import ctypes

    from . import _build

    fn = getattr(_build.load(f"rasterize_v{version}_bwd"),
                 f"gstex_rasterize_v{version}_bwd_smem")
    dims = (tile_h, tile_w, ch, cw) if version == 2 else (tile_h, tile_w)
    fn.argtypes = [ctypes.c_int] * len(dims)
    fn.restype = ctypes.c_int
    return fn(*dims)
