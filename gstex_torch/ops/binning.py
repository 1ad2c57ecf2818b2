"""Tile binning: pair expansion, cull, (tile, depth, id) order and the flat
pair-major slot layout (counterpart of ``gstex_tpu/ops/binning.py``).

PyTorch runs eagerly, so the pair buffers are sized from the true pair
count after one host sync instead of from ``pair_cap``. The meaning of
``pair_cap``, ``s_cap`` and ``overflow`` is unchanged, and so are the
outputs, to the last integer: pairs past ``pair_cap`` are dropped, tile
segments are clamped to ``s_cap``, and both are counted in ``overflow``.
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


class FlatBins(NamedTuple):
    """Flat pair-major splat lists: pairs ordered (tile, depth, id) in one
    slot array, each tile's segment start aligned to SLOT_ALIGN."""

    gids: torch.Tensor           # (slot_cap,) int32 pair gaussian ids (0 in pad slots)
    slot_valid: torch.Tensor     # (slot_cap,) bool — real pair (not alignment pad)
    starts: torch.Tensor         # (num_tiles,) int32 SLOT_ALIGN-aligned segment starts
    counts: torch.Tensor         # (num_tiles,) int32 true per-tile counts (pre-clamp)
    num_tiles_hit: torch.Tensor  # (N,) int32 per-gaussian tile counts
    total_pairs: int             # true pair count (pre-cap, pre-cull)
    overflow: int                # pairs dropped by pair_cap/s_cap


def tile_ranges(centers, extents, grid: TileGrid, valid):
    """Clamped tile index ranges per gaussian: (tx0, ty0, width in tiles,
    tile count)."""
    def rng(lo, hi, size, n):
        a = torch.clamp(torch.floor(lo / size), 0, n).to(torch.int32)
        b = torch.clamp(torch.floor(hi / size) + 1, 0, n).to(torch.int32)
        return a, b

    tx0, tx1 = rng(centers[:, 0] - extents[:, 0],
                   centers[:, 0] + extents[:, 0], grid.tile_w, grid.ntx)
    ty0, ty1 = rng(centers[:, 1] - extents[:, 1],
                   centers[:, 1] + extents[:, 1], grid.tile_h, grid.nty)
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


def build_tile_bins_flat(centers, extents, depths, valid, grid: TileGrid,
                         pair_cap: int, s_cap: int,
                         cull_fn=None) -> FlatBins:
    """Expand (gaussian, tile) pairs, drop the ones ``cull_fn(gid, tx, ty)``
    proves dead, order them by (tile, depth, id) and lay them out in
    SLOT_ALIGN-aligned per-tile segments clamped to ``s_cap``."""
    if pair_cap > 1 << 24:
        raise ValueError("pair_cap must be <= 2^24 (the JAX reference packs "
                         "pair offsets into float32)")
    dev = centers.device
    n = centers.shape[0]
    nt = grid.num_tiles
    tx0, ty0, tw, counts = tile_ranges(centers, extents, grid, valid)
    counts = torch.where(depths > 1e-6, counts, torch.zeros_like(counts))
    counts64 = counts.long()
    offsets = torch.cumsum(counts64, 0) - counts64
    total = int(counts64.sum()) if n > 0 else 0
    npair = min(total, pair_cap)

    # pair k -> owning gaussian (ascending gid, so the sorts below can be
    # stable two-key passes), its rank inside the gaussian's tile rect
    gid = torch.repeat_interleave(torch.arange(n, device=dev), counts64,
                                  output_size=total)[:npair]
    local = torch.arange(npair, device=dev) - offsets[gid]
    w_g = torch.clamp(tw[gid].long(), min=1)
    ty = ty0[gid].long() + local // w_g
    tx = tx0[gid].long() + local % w_g
    if cull_fn is not None:
        keep = cull_fn(gid, tx, ty)
        gid, tx, ty = gid[keep], tx[keep], ty[keep]
    tile = ty * grid.ntx + tx

    # lexicographic (tile, depth, id): gid is ascending, so a stable sort by
    # depth and then a stable sort by tile gives the three-key order
    order = torch.sort(depths[gid], stable=True).indices
    order = order[torch.sort(tile[order], stable=True).indices]
    tile_s = tile[order]
    gid_s = gid[order]

    tile_counts = torch.bincount(tile_s, minlength=nt)
    seg0 = torch.cumsum(tile_counts, 0) - tile_counts
    clamped = torch.clamp(tile_counts, max=s_cap)
    padded = -(-clamped // SLOT_ALIGN) * SLOT_ALIGN
    starts = torch.cumsum(padded, 0) - padded

    rank = torch.arange(tile_s.shape[0], device=dev) - seg0[tile_s]
    in_range = rank < s_cap
    slot = (starts[tile_s] + rank)[in_range]
    slot_cap = flat_slot_cap(pair_cap, nt)
    gids = torch.zeros(slot_cap, dtype=torch.int32, device=dev)
    gids[slot] = gid_s[in_range].to(torch.int32)
    slot_valid = torch.zeros(slot_cap, dtype=torch.bool, device=dev)
    slot_valid[slot] = True

    overflow = (max(total - pair_cap, 0)
                + int(torch.clamp(tile_counts - s_cap, min=0).sum()))
    return FlatBins(
        gids=gids,
        slot_valid=slot_valid,
        starts=starts.to(torch.int32),
        counts=tile_counts.to(torch.int32),
        num_tiles_hit=counts,
        total_pairs=total,
        overflow=overflow,
    )
