"""Backward of the training forward over the flat pair list: the CUDA
kernel ``csrc/rasterize_bwd.cu``, its wrapper and its plain PyTorch
version.

Counterpart of ``gstex_tpu/ops/rasterize_pallas5.py`` ``_bwd_kernel5`` /
``rasterize_pallas5_bwd`` together with the per-gaussian ``segment_sum``
that follows it (``rasterize_pallas_api.py:_core5_bwd``). Each tile walks
its splats back to front from ``min(count, max ncontrib + 1)``, recovers
T before each splat as ``T_{k+1} / (1 − α_k)`` from the forward's
``t_final``, keeps the suffix sums of ``s·w`` (and of ``w``, ``w·m`` when
not lean), and adds each pair's record-field and chart gradients into
``d_records (N, 32)`` and ``d_charts (N, Ch, Cw, 3)``. Fields 12-14,
16-18 (the detached uv frame) and 26-31 get no gradient.

The plain version's texel gradients use the TPU kernel's hat-function
form of the bilinear fetch: weights ``max(0, 1 − |x − a|)`` over rows
``a`` and their derivative ``−sign(x − a)`` where ``|x − a| ≤ 1``, on the
3 x 3 texels around the sample; texels outside the padded chart read as
zero. The kernel takes the forward's 2 x 2 fetch and its differences,
which is the same function (two-sided where a sample sits exactly on a
texel).

The charts are float32 or bfloat16 (the bf16 chart stream); the wrapper
picks the kernel's entry by their dtype, and bfloat16 charts' launches
count on ``rasterize_bwd_bf16``. ``d_charts`` is float32 for both: a texel
gradient does not depend on the texels, and is never rounded to bf16. The
plain version reads ``charts.float()``.
"""

from __future__ import annotations

import ctypes

import torch

from .binning import TileGrid
from .launch_counts import EntryCount, counted
from .rasterize_fwd import (KFAC_NEAR, NCH, NG, check_inputs, pixel_grid,
                            response, tile_order)
from .records import F_REC
from .surfel import AA_SIGMA2, ALPHA_CLAMP, ALPHA_CUTOFF, REG_NEAR


def check_residuals(maps, ncontrib, gmaps, dev, grid: TileGrid) -> None:
    """Raise unless the forward's maps and ncontrib and the cotangents
    have the shapes and types the backward kernels read."""
    hw = (grid.height, grid.width)
    for name, x, dtype, shape in (("maps", maps, torch.float32, (NCH, *hw)),
                                  ("ncontrib", ncontrib, torch.int32, hw),
                                  ("gmaps", gmaps, torch.float32, (NG, *hw))):
        if x.device != dev or x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on {dev}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous with shape {shape}")


def tile_planes(maps: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(C, H, W) -> (C, T, P) per-tile planes, zero outside the image."""
    c = maps.shape[0]
    th, tw = grid.tile_h, grid.tile_w
    full = maps.new_zeros((c, grid.nty * th, grid.ntx * tw))
    full[:, :grid.height, :grid.width] = maps
    full = full.reshape(c, grid.nty, th, grid.ntx, tw).permute(0, 1, 3, 2, 4)
    return full.reshape(c, grid.num_tiles, th * tw)


def walk_starts(counts, ncontrib, grid: TileGrid, s_cap: int):
    """Per tile, the rank the backward walk starts below:
    min(count, max in-image ncontrib + 1)."""
    planes = torch.stack([ncontrib.to(torch.float32),
                          torch.ones_like(ncontrib, dtype=torch.float32)])
    ncon_t, inside = tile_planes(planes, grid)
    top = torch.where(inside > 0, ncon_t, -1.0).amax(dim=1).long() + 1
    return torch.minimum(torch.clamp(counts.long(), max=s_cap), top)


def texel_terms(r, resp, ids, charts_flat, ch, cw, w, ga, applied, d_ch):
    """The bilinear fetch of a batch of pairs in its hat-function form, on
    the 3 x 3 texels around each sample: adds the texel gradients ``w ·
    g_tex · wx · wy`` of the applied pairs into ``d_ch`` (the flat
    ``(·, Ch, Cw, 3)`` buffer ``charts_flat`` indexes), and returns the
    fetched ``texk`` (three channels) and ``d_x``, ``d_y``: the gradients
    with respect to the sample's texel coordinates, zero where the
    coordinate was clamped.

    ``r`` holds record fields on dim 1, broadcasting against the response
    tensors ``resp``; ``ids`` the pairs' chart rows, shaped to broadcast
    against them; ``ga`` the twelve cotangent planes."""
    hf, wf = r[:, 26], r[:, 27]
    x_raw = torch.clamp(resp["uvu_raw"], 0.0, 1.0) * hf
    y_raw = torch.clamp(resp["uvv_raw"], 0.0, 1.0) * wf
    xg = torch.minimum(torch.clamp(x_raw, min=0.0), hf - 1.0)
    yg = torch.minimum(torch.clamp(y_raw, min=0.0), wf - 1.0)
    x0 = torch.floor(xg)
    y0 = torch.floor(yg)
    rows, wx, dwx, cols, wy, dwy = [], [], [], [], [], []
    for i in range(3):
        ai = x0 + (i - 1.0)
        dfx = xg - ai
        rows.append(ai.long())
        wx.append(torch.clamp(1.0 - dfx.abs(), min=0.0))
        dwx.append(torch.where(dfx.abs() <= 1.0, -torch.sign(dfx), 0.0))
        bi = y0 + (i - 1.0)
        dfy = yg - bi
        cols.append(bi.long())
        wy.append(torch.clamp(1.0 - dfy.abs(), min=0.0))
        dwy.append(torch.where(dfy.abs() <= 1.0, -torch.sign(dfy), 0.0))
    ok_r = [(ri >= 0) & (ri < ch) for ri in rows]
    ok_c = [(ci >= 0) & (ci < cw) for ci in cols]
    tidx = [[(ids * ch + rows[i].clamp(0, ch - 1)) * cw
             + cols[jj].clamp(0, cw - 1) for jj in range(3)]
            for i in range(3)]
    texel = [[torch.where((ok_r[i] & ok_c[jj])[..., None],
                          charts_flat[tidx[i][jj]], 0.0)
              for jj in range(3)] for i in range(3)]          # (..., 3)
    tmp = [[texel[i][0][..., c] * wy[0] + texel[i][1][..., c] * wy[1]
            + texel[i][2][..., c] * wy[2] for i in range(3)]
           for c in range(3)]
    texk = [wx[0] * tmp[c][0] + wx[1] * tmp[c][1] + wx[2] * tmp[c][2]
            for c in range(3)]
    coeff = [ga[3] * tmp[0][i] + ga[4] * tmp[1][i] + ga[5] * tmp[2][i]
             for i in range(3)]
    coeff_dx = coeff[0] * dwx[0] + coeff[1] * dwx[1] + coeff[2] * dwx[2]
    m2 = [[(wx[i] * w) * ga[3 + c] for i in range(3)] for c in range(3)]
    d_wy = []
    for jj in range(3):
        acc = torch.zeros_like(w)
        for c in range(3):
            for i in range(3):
                acc = acc + texel[i][jj][..., c] * m2[c][i]
        d_wy.append(acc)
    d_x = w * coeff_dx
    d_y = d_wy[0] * dwy[0] + d_wy[1] * dwy[1] + d_wy[2] * dwy[2]
    lanes = torch.arange(3, device=w.device)
    for i in range(3):
        for jj in range(3):
            keep = (applied & ok_r[i] & ok_c[jj])[..., None]
            vals = torch.stack([wy[jj] * m2[c][i] for c in range(3)], -1)
            vals = torch.where(keep, vals, 0.0)
            flat = tidx[i][jj][..., None] * 3 + lanes
            d_ch.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    x_pass = (x_raw >= 0.0) & (x_raw <= hf - 1.0)
    y_pass = (y_raw >= 0.0) & (y_raw <= wf - 1.0)
    return (texk, torch.where(x_pass, d_x, 0.0),
            torch.where(y_pass, d_y, 0.0))


def record_terms(r, resp, dirs, ga, w, d_alpha, d_m, d_x, d_y,
                 lean: bool) -> torch.Tensor:
    """The chain rule from a batch of pairs' ``d_alpha``, ``d_m`` (the
    reg chain's gradient of the depth map; unused when ``lean``) and
    texel-coordinate gradients to the first 26 record fields: ``(26,
    ...)`` per pair and pixel, not yet masked or summed. Fields 12-14 and
    16-18 (the detached uv frame) are zero."""
    t = resp["t"]
    hf, wf = r[:, 26], r[:, 27]
    opg = resp["opg"]
    interior = (opg <= ALPHA_CLAMP) & (opg >= ALPHA_CUTOFF) & (t > 1e-6)
    dag = torch.where(interior, d_alpha, 0.0)
    d_op = resp["g"] * dag
    d_g = r[:, 20] * d_op
    surf = resp["arg_s"] >= resp["arg_c"]
    dgs = torch.where(surf, d_g, 0.0)
    d_u = -resp["u"] * dgs
    d_v = -resp["v"] * dgs
    dgc = torch.where(surf, 0.0, d_g)
    d_xy0 = ((1.0 / AA_SIGMA2) * resp["dpx"]) * dgc
    d_xy1 = ((1.0 / AA_SIGMA2) * resp["dpy"]) * dgc
    u_pass = (resp["uvu_raw"] >= 0.0) & (resp["uvu_raw"] <= 1.0)
    v_pass = (resp["uvv_raw"] >= 0.0) & (resp["uvv_raw"] <= 1.0)
    d_uvu = torch.where(u_pass, d_x * hf, 0.0)
    d_uvv = torch.where(v_pass, d_y * wf, 0.0)
    d_t = w * ga[6]
    if not lean:
        invtc = resp["invtc"]
        d_t = d_t + torch.where(t >= REG_NEAR,
                                d_m * KFAC_NEAR * invtc * invtc, 0.0)
    d_t = d_t + d_u * resp["b1d"] + d_v * resp["b2d"]
    d_t = d_t + d_uvu * resp["b1ud"] + d_uvv * resp["b2ud"]
    nd_pass = resp["nd"].abs() >= 1e-9
    d_an = d_t * (1.0 / resp["safe_nd"])
    d_nd = torch.where(nd_pass, -t * d_an, 0.0)

    nrm = [d_nd * dirs[c] for c in range(3)]
    if not lean:
        wfl = w * resp["flip"]
        nrm = [nrm[c] + wfl * ga[8 + c] for c in range(3)]
    zero = torch.zeros_like(d_t)
    vals = (nrm + [d_an]
            + [d_u * (t * dirs[c]) for c in range(3)] + [d_u]
            + [d_v * (t * dirs[c]) for c in range(3)] + [d_v]
            + [zero] * 3 + [d_uvu] + [zero] * 3 + [d_uvv] + [d_op]
            + [w * ga[c] for c in range(3)] + [d_xy0, d_xy1])
    return torch.stack(torch.broadcast_tensors(*vals), 0)


def direct_terms(r, resp, ga, texk, lean: bool) -> torch.Tensor:
    """∂L/∂w of a pair without the reg chain: Σ_ch g_ch · y_ch over img,
    tex, depth, alpha, and the normal unless ``lean``."""
    s_k = (r[:, 21] * ga[0] + r[:, 22] * ga[1] + r[:, 23] * ga[2]
           + texk[0] * ga[3] + texk[1] * ga[4] + texk[2] * ga[5]
           + resp["t"] * ga[6] + ga[7])
    if not lean:
        s_k = s_k + resp["flip"] * (r[:, 0] * ga[8] + r[:, 1] * ga[9]
                                    + r[:, 2] * ga[10])
    return s_k


def rasterize_bwd_reference(records, gids, starts, counts, charts,
                            cam_info, maps, ncontrib, gmaps,
                            grid: TileGrid, s_cap: int, lean: bool = False):
    """Plain PyTorch version of the kernel: the back-to-front walk, one
    rank at a time, vectorized over the tiles that still walk, in the
    kernel's per-pixel arithmetic and order. Returns
    ``(d_records (N, 32), d_charts (N, Ch, Cw, 3))``."""
    dev = records.device
    n = records.shape[0]
    ch, cw = charts.shape[1], charts.shape[2]
    # bf16 charts widened as the kernel widens each texel it reads
    charts_flat = charts.float().reshape(-1, 3)
    gx, gy, (d0, d1, d2), inside = pixel_grid(grid, cam_info)
    g = tile_planes(gmaps, grid)                               # (12, T, P)
    fw = tile_planes(maps[[7, 12, 13]], grid)        # alpha, t_final, m1
    ncon = tile_planes(ncontrib[None].to(torch.float32), grid)[0]
    top = walk_starts(counts, ncontrib, grid, s_cap)
    starts = starts.long()
    gids = gids.long()

    d_rec = torch.zeros((n, F_REC), dtype=torch.float32, device=dev)
    d_ch = torch.zeros((n * ch * cw * 3,), dtype=torch.float32, device=dev)
    nt, pix = ncon.shape
    T = fw[1].clone()
    BS = torch.zeros((nt, pix), dtype=torch.float32, device=dev)
    E = torch.zeros_like(BS)
    D = torch.zeros_like(BS)
    max_top = int(top.max()) if nt > 0 else 0
    for k in range(max_top - 1, -1, -1):
        act = torch.nonzero(top > k).flatten()
        ids = gids[starts[act] + k]                                # (A,)
        r = records[ids][:, :, None]                               # (A, F, 1)
        dirs = (d0[act], d1[act], d2[act])
        resp = response(r, dirs, gx[act], gy[act])
        ga = g[:, act]
        a = resp["alpha"]
        applied = inside[act] & (a > 0) & (k < ncon[act])
        inv_q = 1.0 / torch.where(applied, 1.0 - a, 1.0)
        Ta = T[act]
        t_k = Ta * inv_q
        w = torch.where(applied, a * t_k, 0.0)
        BSa, Ea, Da = BS[act], E[act], D[act]
        d_m = None
        if not lean:
            m = resp["m"]
            wm = w * m
            big_a = fw[0, act] - w - Ea
            big_c = fw[2, act] - wm - Da
            d_m = 2.0 * ga[11] * w * (big_a - Ea)

        texk, d_x, d_y = texel_terms(r, resp, ids[:, None], charts_flat, ch,
                                     cw, w, ga, applied, d_ch)
        s_k = direct_terms(r, resp, ga, texk, lean)
        if not lean:
            s_k = s_k + 2.0 * ga[11] * ((m * big_a - big_c)
                                        + (Da - m * Ea))
        sw = s_k * w
        d_alpha = torch.where(applied, t_k * s_k - BSa * inv_q, 0.0)
        vals = record_terms(r, resp, dirs, ga, w, d_alpha, d_m, d_x, d_y,
                            lean)                                 # (26, A, P)
        vals = torch.where(applied, vals, 0.0).sum(-1)            # (26, A)
        d_rec[:, :26].index_add_(0, ids, vals.T.contiguous())

        BS[act] = BSa + sw
        if not lean:
            E[act] = Ea + w
            D[act] = Da + wm
        T[act] = t_k
    return d_rec, d_ch.reshape(charts.shape)


def rasterize_bwd(records, gids, starts, counts, charts, cam_info, maps,
                  ncontrib, gmaps, grid: TileGrid, s_cap: int,
                  lean: bool = False, order=None):
    """Gradients of the training forward's first 12 maps: returns
    ``(d_records (N, 32), d_charts (N, Ch, Cw, 3))``.

    ``maps`` (14, H, W) and ``ncontrib`` (H, W) are ``rasterize_fwd``'s
    outputs for the same inputs, ``gmaps`` (12, H, W) the cotangents of
    its first 12 channels; ``order`` is ``rasterize_fwd.tile_order``'s,
    computed here if not given. ``d_charts`` is float32 whatever the
    charts' dtype. CPU tensors run the plain version; CUDA tensors launch
    the kernel's entry for the charts' dtype (and raise if it cannot
    launch).
    """
    check_inputs(records, gids, starts, counts, charts, cam_info, grid,
                 s_cap, order)
    dev = records.device
    check_residuals(maps, ncontrib, gmaps, dev, grid)
    if dev.type == "cpu":
        return rasterize_bwd_reference(records, gids, starts, counts,
                                       charts, cam_info, maps, ncontrib,
                                       gmaps, grid, s_cap, lean=lean)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_bwd runs on cpu or cuda, not {dev}")
    from . import _build

    lib = _build.load("rasterize_bwd")
    bf16 = charts.dtype == torch.bfloat16
    fn = lib.gstex_rasterize_bwd_bf16 if bf16 else lib.gstex_rasterize_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ch, cw = charts.shape[1], charts.shape[2]
    d_rec = torch.zeros_like(records)
    d_ch = torch.zeros_like(charts, dtype=torch.float32)
    with torch.cuda.device(dev):
        if order is None:
            order = tile_order(counts, s_cap)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(records.data_ptr(), gids.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), charts.data_ptr(), cam_info.data_ptr(),
                maps.data_ptr(), ncontrib.data_ptr(), gmaps.data_ptr(),
                d_rec.data_ptr(), d_ch.data_ptr(), order.data_ptr(),
                grid.num_tiles, grid.ntx, grid.tile_h, grid.tile_w,
                grid.height, grid.width, ch, cw, s_cap, int(lean), stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_bwd kernel launch failed: "
                           f"cudaError {rc}")
    (rasterize_bwd_bf16 if bf16 else rasterize_bwd).launches += 1
    return d_rec, d_ch


# kernel launches since the last reset, one count an entry (CPU calls do
# not count; ``launch_counts``)
counted(rasterize_bwd)
# the bf16 chart entry, which ``rasterize_bwd`` launches on bfloat16 charts
rasterize_bwd_bf16 = counted(EntryCount("rasterize_bwd_bf16"))


def launch_smem(tile_h: int, tile_w: int, bf16: bool = False) -> int:
    """Bytes of shared memory a launch of the backward kernel (its bf16
    chart entry with ``bf16``) takes at ``tile_h x tile_w`` tiles: its
    static arrays and the tile's 14 per-pixel planes. The chart pad does
    not enter it."""
    from . import _build

    lib = _build.load("rasterize_bwd")
    fn = (lib.gstex_rasterize_bwd_bf16_smem if bf16
          else lib.gstex_rasterize_bwd_smem)
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(tile_h, tile_w)
