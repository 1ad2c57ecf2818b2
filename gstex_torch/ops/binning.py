"""Tile binning: pair expansion, cull, (tile, depth, id) order, and the two
list layouts built from it: the flat pair-major slots (``FlatBins``) and
the dense ``(num_tiles, s_max)`` lists (``TileBins``). Counterpart of
``gstex_tpu/ops/binning.py``.

As there, every buffer is sized by ``pair_cap``, and no step of the
binning reads a value back to the host: the pair count, the overflow and
the hottest tile's count are 0-d device tensors, so that a CUDA graph can
hold a whole training step (``train/step.py:make_train_scan``). Pairs
past ``pair_cap`` are dropped, tile segments are clamped to ``s_cap``
(``s_max`` for the dense lists), and both are counted in ``overflow``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TileGrid(NamedTuple):
    height: int
    width: int
    tile_h: int
    tile_w: int

    @property
    def ntx(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def nty(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.ntx * self.nty


# each tile's segment in the flat slot array starts at a multiple of this
SLOT_ALIGN = 16


class TileBins(NamedTuple):
    """Dense per-tile splat lists, front-to-back within each tile."""

    ids: torch.Tensor            # (num_tiles, s_max) int32 gaussian ids (0 where invalid)
    mask: torch.Tensor           # (num_tiles, s_max) bool
    counts: torch.Tensor         # (num_tiles,) int32 true per-tile counts (pre-truncation)
    num_tiles_hit: torch.Tensor  # (N,) int32 per-gaussian tile counts
    total_pairs: torch.Tensor    # () int64 true pair count (pre-cap, pre-cull)
    overflow: torch.Tensor       # () int32 pairs dropped by pair_cap/s_max


class FlatBins(NamedTuple):
    """Flat pair-major splat lists: pairs ordered (tile, depth, id) in one
    slot array, each tile's segment start aligned to SLOT_ALIGN."""

    gids: torch.Tensor           # (slot_cap,) int32 pair gaussian ids (0 in pad slots)
    slot_valid: torch.Tensor     # (slot_cap,) bool — real pair (not alignment pad)
    starts: torch.Tensor         # (num_tiles,) int32 SLOT_ALIGN-aligned segment starts
    counts: torch.Tensor         # (num_tiles,) int32 true per-tile counts (pre-clamp)
    num_tiles_hit: torch.Tensor  # (N,) int32 per-gaussian tile counts
    total_pairs: torch.Tensor    # () int64 true pair count (pre-cap, pre-cull)
    overflow: torch.Tensor       # () int32 pairs dropped by pair_cap/s_cap


def tile_ranges(centers, extents, grid: TileGrid, valid, origin=(0, 0)):
    """Clamped tile index ranges per gaussian: (tx0, ty0, width in tiles,
    tile count). ``origin`` (x, y), in tiles, places the grid inside a
    larger frame whose pixel coordinates ``centers`` are in (a band of
    the tile-row mesh): each range is the frame's, less the origin, so
    that the bands of a frame hold exactly the frame's pairs."""
    def rng(lo, hi, size, n, o):
        a = torch.clamp(torch.floor(lo / size) - o, 0, n).to(torch.int32)
        b = torch.clamp(torch.floor(hi / size) + 1 - o, 0, n).to(
            torch.int32)
        return a, b

    tx0, tx1 = rng(centers[:, 0] - extents[:, 0],
                   centers[:, 0] + extents[:, 0], grid.tile_w, grid.ntx,
                   origin[0])
    ty0, ty1 = rng(centers[:, 1] - extents[:, 1],
                   centers[:, 1] + extents[:, 1], grid.tile_h, grid.nty,
                   origin[1])
    w = torch.clamp(tx1 - tx0, min=0)
    h = torch.clamp(ty1 - ty0, min=0)
    counts = torch.where(valid, w * h, torch.zeros_like(w)).to(torch.int32)
    return tx0, ty0, w, counts


def flat_slot_cap(pair_cap: int, num_tiles: int) -> int:
    """Flat-buffer capacity: every real pair plus worst-case per-tile
    alignment padding."""
    return pair_cap + SLOT_ALIGN * num_tiles


def settle_caps(total_pairs: int, max_tile_count: int) -> tuple[int, int]:
    """Demand-based capacities for a scene with the measured pair demand:
    1.5x / 1.25x headroom, quantized."""
    pair_cap = max(1 << 16, -(-int(1.5 * total_pairs) // 65536) * 65536)
    s_cap = max(256, -(-int(1.25 * max_tile_count) // 256) * 256)
    return min(pair_cap, 1 << 23), min(s_cap, 4096)


class SortedPairs(NamedTuple):
    """The ``pair_cap`` pair slots in (tile, depth, id) order: the kept
    pairs first, then the slots past the true count or dropped by the
    cull, whose tile is the sentinel ``num_tiles``."""

    tile: torch.Tensor           # (pair_cap,) int64 tile of each slot, ascending
    gid: torch.Tensor            # (pair_cap,) int64 gaussian of each slot
    rank: torch.Tensor           # (pair_cap,) int64 rank of the pair in its tile
    tile_counts: torch.Tensor    # (num_tiles,) int64 pairs per tile
    num_tiles_hit: torch.Tensor  # (N,) int32
    total: torch.Tensor          # () int64 true pair count (pre-cap, pre-cull)


def _pair_owner(ends: torch.Tensor, pair_cap: int) -> torch.Tensor:
    """Owning gaussian of each pair slot 0..pair_cap-1: the first gaussian
    whose segment ends past the slot, by a binary search of the segment
    ends. The JAX package's ``_pair_owner`` takes the running max of the
    gaussians' indices marked at their segment starts instead, cheaper
    on a TPU; on the H100 that scan over the slots took 0.9 ms of a
    step's 1.76 of cull and binning (``PERF.md`` §6). Both give
    every slot below the true count its owner; slots past it stay in
    range. ``ends`` is the inclusive cumsum of the per-gaussian counts."""
    k = torch.arange(pair_cap, device=ends.device)
    return torch.clamp(torch.searchsorted(ends, k, right=True),
                       max=ends.shape[0] - 1)


def sorted_pairs(centers, extents, depths, valid, grid: TileGrid,
                 pair_cap: int, cull_fn, origin=(0, 0)) -> SortedPairs:
    """Expand (gaussian, tile) pairs into ``pair_cap`` slots, mark the ones
    past the true count or that ``cull_fn(gid, tx, ty)`` proves dead with
    the sentinel tile, and order all slots by (tile, depth, id). Static
    shapes and no host sync, as the JAX package's binning: a CUDA graph
    can hold it. ``origin`` as in ``tile_ranges``."""
    if pair_cap > 1 << 24:
        raise ValueError("pair_cap must be <= 2^24 (the JAX reference packs "
                         "pair offsets into float32)")
    dev = centers.device
    n = centers.shape[0]
    nt = grid.num_tiles
    tx0, ty0, tw, counts = tile_ranges(centers, extents, grid, valid,
                                       origin)
    counts = torch.where(depths > 1e-6, counts, torch.zeros_like(counts))
    counts64 = counts.long()
    ends = torch.cumsum(counts64, 0)
    offsets = ends - counts64
    total = counts64.sum()
    k = torch.arange(pair_cap, device=dev)
    if n == 0:
        tile = torch.full((pair_cap,), nt, dtype=torch.int64, device=dev)
        zeros = torch.zeros(nt, dtype=torch.int64, device=dev)
        return SortedPairs(tile, torch.zeros_like(tile), k, zeros, counts,
                           total)

    # slot k -> owning gaussian (ascending in k), its place in the
    # gaussian's tile rect
    gid = _pair_owner(ends, pair_cap)
    local = k - offsets[gid]
    w_g = torch.clamp(tw[gid].long(), min=1)
    ty = ty0[gid].long() + local // w_g
    tx = tx0[gid].long() + local % w_g
    keep = k < total
    if cull_fn is not None:
        keep = keep & cull_fn(gid, tx, ty)
    tile = torch.where(keep, ty * grid.ntx + tx, nt)   # sentinel sorts last

    # (tile, depth, id) in one stable sort of the key tile·2^32 + the
    # depth's float bits: kept depths are > 1e-6, whose bits order as the
    # floats do, and ties keep the ascending slot, so the ascending id
    depth_bits = depths[gid].view(torch.int32).long() & 0xFFFFFFFF
    order = torch.sort((tile << 32) | depth_bits, stable=True).indices
    tile_s = tile[order]
    ids = torch.arange(nt, device=dev)
    seg0 = torch.searchsorted(tile_s, ids)
    tile_counts = torch.searchsorted(tile_s, ids, right=True) - seg0
    rank = k - seg0[torch.clamp(tile_s, max=nt - 1)]
    return SortedPairs(tile_s, gid[order], rank, tile_counts, counts, total)


def _overflow(pairs: SortedPairs, pair_cap: int,
              s_cap: int) -> torch.Tensor:
    return (torch.clamp(pairs.total - pair_cap, min=0)
            + torch.clamp(pairs.tile_counts - s_cap, min=0).sum()
            ).to(torch.int32)


def build_tile_bins(centers, extents, depths, valid, grid: TileGrid,
                    pair_cap: int, s_max: int, method: str = "auto",
                    cull_fn=None, origin=(0, 0)) -> TileBins:
    """Dense per-tile lists: the pairs of ``sorted_pairs``, each tile's
    first ``s_max`` laid out in its row of ``ids`` / ``mask``.

    ``method`` is the JAX package's switch between two TPU-cost variants
    with one output ("sort", "coverage", "auto"); here every value takes
    the same path. As there, ``"coverage"`` refuses a ``cull_fn``.
    ``origin`` as in ``tile_ranges``.
    """
    if method not in ("auto", "sort", "coverage"):
        raise ValueError(f"unknown binning method {method!r}")
    if method == "coverage" and cull_fn is not None:
        raise ValueError("cull_fn requires method='sort' (coverage ranks "
                         "assume un-culled pair sets)")
    pairs = sorted_pairs(centers, extents, depths, valid, grid, pair_cap,
                         cull_fn, origin)
    dev = centers.device
    nt = grid.num_tiles
    # the slots that do not land in a list go to the dropped entry
    # nt · s_max
    in_range = (pairs.tile < nt) & (pairs.rank < s_max)
    flat_idx = torch.where(in_range, pairs.tile * s_max + pairs.rank,
                           nt * s_max)
    ids = torch.zeros(nt * s_max + 1, dtype=torch.int32, device=dev)
    ids.scatter_(0, flat_idx, pairs.gid.to(torch.int32))
    mask = torch.zeros(nt * s_max + 1, dtype=torch.bool, device=dev)
    mask.scatter_(0, flat_idx, in_range)
    return TileBins(
        ids=ids[:-1].reshape(nt, s_max),
        mask=mask[:-1].reshape(nt, s_max),
        counts=pairs.tile_counts.to(torch.int32),
        num_tiles_hit=pairs.num_tiles_hit,
        total_pairs=pairs.total,
        overflow=_overflow(pairs, pair_cap, s_max),
    )


def build_tile_bins_flat(centers, extents, depths, valid, grid: TileGrid,
                         pair_cap: int, s_cap: int, cull_fn=None,
                         origin=(0, 0)) -> FlatBins:
    """Flat pair-major lists: the pairs of ``sorted_pairs`` laid out in
    SLOT_ALIGN-aligned per-tile segments clamped to ``s_cap``. ``origin``
    as in ``tile_ranges``."""
    pairs = sorted_pairs(centers, extents, depths, valid, grid, pair_cap,
                         cull_fn, origin)
    dev = centers.device
    nt = grid.num_tiles
    clamped = torch.clamp(pairs.tile_counts, max=s_cap)
    padded = -(-clamped // SLOT_ALIGN) * SLOT_ALIGN
    starts = torch.cumsum(padded, 0) - padded

    # one scatter of gid + 1, so that 0 marks an empty slot; the slots
    # that do not land go to the dropped entry slot_cap
    slot_cap = flat_slot_cap(pair_cap, nt)
    in_range = (pairs.tile < nt) & (pairs.rank < s_cap)
    slot = torch.where(
        in_range, starts[torch.clamp(pairs.tile, max=nt - 1)] + pairs.rank,
        slot_cap)
    g1 = torch.zeros(slot_cap + 1, dtype=torch.int32, device=dev)
    g1.scatter_(0, slot, (pairs.gid + 1).to(torch.int32))
    g1 = g1[:slot_cap]
    return FlatBins(
        gids=torch.clamp(g1 - 1, min=0),
        slot_valid=g1 > 0,
        starts=starts.to(torch.int32),
        counts=pairs.tile_counts.to(torch.int32),
        num_tiles_hit=pairs.num_tiles_hit,
        total_pairs=pairs.total,
        overflow=_overflow(pairs, pair_cap, s_cap),
    )
