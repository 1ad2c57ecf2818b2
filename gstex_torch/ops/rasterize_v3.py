"""The v3 pair-space kernels: the chunk-scan blend over the per-(tile,
slot) copies of ``ops/pair_inputs.py``. The CUDA kernels
``csrc/rasterize_v3_fwd.cu`` and ``csrc/rasterize_v3_bwd.cu``, their
wrappers, and their plain PyTorch versions.

Counterpart of ``gstex_tpu/ops/rasterize_pallas3.py``:
``rasterize_pallas3_fwd`` (``_fwd_kernel3``) and ``rasterize_pallas3_bwd``
(``_bwd_kernel3``). Inputs, outputs and blend semantics are v2's
(``ops/rasterize_v2.py``); the transmittance is not a serial product.
Within a chunk of ``CHUNK`` = 16 slots, per pixel:

  incl_k = T_in · Π_{j<=k} (1 − α_j),  excl_k = incl_{k−1} (excl_0 = T_in)
  applied_k = α_k > 0 ∧ incl_k > T_EPS,  w_k = α_k · excl_k

with the product a log-step scan (strides 1, 2, 4, 8), so it rounds
otherwise than the serial walk: a pixel whose T lands within an ulp of
T_EPS can break one splat apart from the other tiers. ncontrib is the
first k with α_k > 0, incl_k <= T_EPS < excl_k; ``t_final`` the least
``incl > T_EPS``; the reg term uses the exclusive prefix sums of ``w`` and
``w·m``. The backward walks the chunks back to front and recovers
``T_k = t_end / Π_{j>=k} q_j`` (``q = 1 − α`` where applied, else 1) from
the chunk's end, with the suffix sums E, D and Bs as exclusive suffix
scans, and then the per-pair chain rule of the other tiers
(``rasterize_bwd.texel_terms``, ``record_terms``).

The plain versions run the scans in the JAX helpers' order
(``_cumprod_incl``, ``_cumsum_excl``, ``_sufprod_incl``, ``_sufsum_excl``)
over (tiles, 16, pixels) tensors. The forward kernel streams the product
scan through each pixel's slots in the same association, so its T,
``t_final`` and ncontrib match the plain version bit for bit; its sums are
running sums, which round otherwise than the plain version's per-chunk
sums and prefix scans. The backward kernel recovers T by serial divides
and sums serially (``csrc/rasterize_v3_bwd.cu``).
"""

from __future__ import annotations

import torch

from .binning import TileGrid
from .launch_counts import counted
from .pair_inputs import (check_bwd_inputs, check_inputs, launch_bwd,
                          launch_fwd)
from .rasterize_bwd import (direct_terms, record_terms, texel_terms,
                            tile_planes, walk_starts)
from .rasterize_fwd import (NCH, fetch, pixel_grid, response, tile_order,
                            untile)
from .records import F_REC
from .surfel import T_EPS

CHUNK = 16


def cumprod_incl(q):
    """Inclusive product along dim 1, strides 1, 2, 4, ..."""
    s = 1
    while s < q.shape[1]:
        q = q * torch.cat([torch.ones_like(q[:, :s]), q[:, :-s]], 1)
        s *= 2
    return q


def cumsum_excl(x):
    """Exclusive sum along dim 1: a shift by one, then strides 1, 2, ..."""
    x = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
    s = 1
    while s < x.shape[1]:
        x = x + torch.cat([torch.zeros_like(x[:, :s]), x[:, :-s]], 1)
        s *= 2
    return x


def sufprod_incl(q):
    """Inclusive suffix product along dim 1, strides 1, 2, 4, ..."""
    s = 1
    while s < q.shape[1]:
        q = q * torch.cat([q[:, s:], torch.ones_like(q[:, :s])], 1)
        s *= 2
    return q


def sufsum_excl(x):
    """Exclusive suffix sum along dim 1: a shift by one, then strides 1,
    2, ..."""
    x = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], 1)
    s = 1
    while s < x.shape[1]:
        x = x + torch.cat([x[:, s:], torch.zeros_like(x[:, :s])], 1)
        s *= 2
    return x


def _chunk(records, act, base, s_max, n_valid, dirs, gx, gy):
    """One chunk of the active tiles: slot ids (A, K), the validity mask
    (A, K), records with fields on dim 1 (A, F, K, 1), and the response
    over (A, K, P)."""
    slot = base + torch.arange(CHUNK, device=records.device)
    valid = slot[None] < n_valid[act, None]
    ids = act[:, None] * s_max + torch.clamp(slot, max=s_max - 1)
    r = records[ids].permute(0, 2, 1)[..., None]
    resp = response(r, [d[act][:, None] for d in dirs], gx[act][:, None],
                    gy[act][:, None])
    return slot, valid, ids, r, resp


def rasterize_v3_fwd_reference(records_t, charts_g, counts, cam_info,
                               grid: TileGrid, lean: bool = False):
    """Plain PyTorch version of the forward kernel: ``(maps (14, H, W),
    ncontrib (H, W) int32)``."""
    dev = records_t.device
    nt, s_max = records_t.shape[:2]
    ch, cw = charts_g.shape[2], charts_g.shape[3]
    records = records_t.reshape(nt * s_max, F_REC)
    charts_flat = charts_g.reshape(-1, 3)
    gx, gy, dirs, inside = pixel_grid(grid, cam_info)
    pix = gx.shape[1]
    n_walk = torch.clamp(counts.long(), max=s_max)
    t_plain = torch.ones((nt, pix), dtype=torch.float32, device=dev)
    t_fin = torch.ones_like(t_plain)
    ncon = torch.full((nt, pix), s_max, dtype=torch.int64, device=dev)
    acc = torch.zeros((NCH, nt, pix), dtype=torch.float32, device=dev)
    max_walk = int(n_walk.max()) if nt > 0 else 0
    for base in range(0, max_walk, CHUNK):
        live = (inside & (t_plain > T_EPS)).any(1)
        act = torch.nonzero(live & (n_walk > base)).flatten()
        if act.numel() == 0:
            break
        slot, valid, ids, r, resp = _chunk(records, act, base, s_max, n_walk,
                                           dirs, gx, gy)
        a = torch.where(valid[..., None] & inside[act][:, None],
                        resp["alpha"], 0.0)                        # (A, K, P)
        tp = t_plain[act][:, None]
        incl = cumprod_incl(1.0 - a) * tp
        excl = torch.cat([tp, incl[:, :-1]], 1)
        applied = (a > 0) & (incl > T_EPS)
        w = torch.where(applied, a * excl, 0.0)
        brk = (a > 0) & (incl <= T_EPS) & (excl > T_EPS)
        ncon[act] = torch.minimum(
            ncon[act], torch.where(brk, slot[None, :, None], s_max).amin(1))
        t_fin[act] = torch.minimum(
            t_fin[act], torch.where(incl > T_EPS, incl, 2.0).amin(1))

        tex = fetch(charts_flat, ids[..., None], ch, cw, r, resp["uvu_raw"],
                    resp["uvv_raw"])                            # (A, K, P, 3)
        acc_a = acc[:, act]
        for c in range(3):
            acc_a[c] += (w * r[:, 21 + c]).sum(1)
            acc_a[3 + c] += (w * tex[..., c]).sum(1)
        acc_a[6] += (w * resp["t"]).sum(1)
        if not lean:
            m = resp["m"]
            wfl = w * resp["flip"]
            for c in range(3):
                acc_a[8 + c] += (r[:, c] * wfl).sum(1)
            pw = cumsum_excl(w)
            pwm = cumsum_excl(w * m)
            acc_a[11] += (2.0 * w * (m * (acc_a[7][:, None] + pw)
                                     - (acc_a[13][:, None] + pwm))).sum(1)
            acc_a[13] += (w * m).sum(1)
        acc_a[7] += w.sum(1)
        acc[:, act] = acc_a
        t_plain[act] = incl[:, -1]
    acc[12] = t_fin
    ncon_map = untile(ncon.to(torch.float32)[None], grid)[0]
    return untile(acc, grid), ncon_map.to(torch.int32)


def rasterize_v3_bwd_reference(records_t, charts_g, counts, cam_info, maps,
                               ncontrib, gmaps, grid: TileGrid,
                               lean: bool = False):
    """Plain PyTorch version of the backward kernel: the pair-space
    ``(d_records_t (T, S, 32), d_charts_g (T, S, Ch, Cw, 3))``."""
    dev = records_t.device
    nt, s_max = records_t.shape[:2]
    ch, cw = charts_g.shape[2], charts_g.shape[3]
    records = records_t.reshape(nt * s_max, F_REC)
    charts_flat = charts_g.reshape(-1, 3)
    gx, gy, dirs, inside = pixel_grid(grid, cam_info)
    g = tile_planes(gmaps, grid)                               # (12, T, P)
    fw = tile_planes(maps[[7, 12, 13]], grid)        # alpha, t_final, m1
    ncon = tile_planes(ncontrib[None].to(torch.float32), grid)[0]
    top = walk_starts(counts, ncontrib, grid, s_max)

    d_rec = torch.zeros((nt * s_max, F_REC), dtype=torch.float32, device=dev)
    d_ch = torch.zeros((charts_flat.numel(),), dtype=torch.float32,
                       device=dev)
    t_end = fw[1].clone()
    bs = torch.zeros_like(t_end)
    e = torch.zeros_like(t_end)
    dd = torch.zeros_like(t_end)
    n_chunks = (top + CHUNK - 1) // CHUNK
    for c in range(int(n_chunks.max()) - 1 if nt > 0 else -1, -1, -1):
        act = torch.nonzero(n_chunks > c).flatten()
        slot, valid, ids, r, resp = _chunk(records, act, c * CHUNK, s_max,
                                           top, dirs, gx, gy)
        pdirs = [d[act][:, None] for d in dirs]
        ga = g[:, act][:, :, None]                            # (12, A, 1, P)
        a = torch.where(valid[..., None], resp["alpha"], 0.0)  # (A, K, P)
        applied = (inside[act][:, None] & (a > 0)
                   & (slot[None, :, None] < ncon[act][:, None]))
        one_minus = 1.0 - a
        s_incl = sufprod_incl(torch.where(applied, one_minus, 1.0))
        te = t_end[act][:, None]
        t_k = te / s_incl                            # T before each splat
        w = torch.where(applied, a * t_k, 0.0)
        d_m = None
        if not lean:
            m = resp["m"]
            wm = w * m
            e_k = e[act][:, None] + sufsum_excl(w)
            d_k = dd[act][:, None] + sufsum_excl(wm)
            big_a = fw[0, act][:, None] - w - e_k
            big_c = fw[2, act][:, None] - wm - d_k
            d_m = 2.0 * ga[11] * w * (big_a - e_k)

        texk, d_x, d_y = texel_terms(r, resp, ids[..., None], charts_flat, ch,
                                     cw, w, ga, applied, d_ch)
        s_k = direct_terms(r, resp, ga, texk, lean)
        if not lean:
            s_k = s_k + 2.0 * ga[11] * ((m * big_a - big_c)
                                        + (d_k - m * e_k))
        sw = s_k * w
        bs_k = bs[act][:, None] + sufsum_excl(sw)
        d_alpha = torch.where(applied, t_k * s_k - bs_k / one_minus, 0.0)
        vals = record_terms(r, resp, pdirs, ga, w, d_alpha, d_m, d_x, d_y,
                            lean)                              # (26, A, K, P)
        vals = torch.where(applied, vals, 0.0).sum(-1)          # (26, A, K)
        d_rec[:, :26].index_add_(0, ids.reshape(-1),
                                 vals.reshape(26, -1).T.contiguous())
        t_end[act] = te[:, 0] / s_incl[:, 0]
        bs[act] += sw.sum(1)
        if not lean:
            e[act] += w.sum(1)
            dd[act] += wm.sum(1)
    return d_rec.view(records_t.shape), d_ch.view(charts_g.shape)


def rasterize_v3_fwd(records_t, charts_g, counts, cam_info, grid: TileGrid,
                     lean: bool = False, order=None):
    """Training forward by the chunk scan; returns ``(maps (14, H, W),
    ncontrib (H, W) int32)``. Arguments as
    ``rasterize_v2.rasterize_v2_fwd``; charts of at most 40 rows. The
    kernel takes its tiles longest first, in ``order``
    (``tile_order(counts, S)``, computed here if not given), and copies
    ``records_t``, which must be 16-byte aligned, 16 B at a time; a tile
    order changes no pixel's operations. CPU tensors run the plain
    version; CUDA tensors launch the kernel (and raise if it cannot
    launch)."""
    check_inputs(3, records_t, charts_g, counts, cam_info, grid, order)
    if records_t.device.type == "cpu":
        return rasterize_v3_fwd_reference(records_t, charts_g, counts,
                                          cam_info, grid, lean=lean)
    if order is None:
        order = tile_order(counts, records_t.shape[1])
    out = launch_fwd("rasterize_v3_fwd", records_t, charts_g, counts,
                     cam_info, grid, lean, order)
    rasterize_v3_fwd.launches += 1
    return out


def rasterize_v3_bwd(records_t, charts_g, counts, cam_info, maps, ncontrib,
                     gmaps, grid: TileGrid, lean: bool = False, order=None):
    """Gradients of the chunk-scan forward's first 12 maps: the pair-space
    ``(d_records_t (T, S, 32), d_charts_g (T, S, Ch, Cw, 3))``. Arguments,
    tile ``order`` and the 16-byte alignment of ``records_t`` as
    ``rasterize_v2.rasterize_v2_bwd``."""
    check_bwd_inputs(3, records_t, charts_g, counts, cam_info, maps,
                     ncontrib, gmaps, grid, order)
    if records_t.device.type == "cpu":
        return rasterize_v3_bwd_reference(records_t, charts_g, counts,
                                          cam_info, maps, ncontrib, gmaps,
                                          grid, lean=lean)
    out = launch_bwd("rasterize_v3_bwd", records_t, charts_g, counts,
                     cam_info, maps, ncontrib, gmaps, grid, lean, order)
    rasterize_v3_bwd.launches += 1
    return out


# kernel launches since the last reset (CPU calls do not count;
# ``launch_counts``)
counted(rasterize_v3_fwd)
counted(rasterize_v3_bwd)
