"""Training forward over the flat pair list: the CUDA kernel
``csrc/rasterize_fwd.cu``, its wrapper and its plain PyTorch version.

Counterpart of ``gstex_tpu/ops/rasterize_pallas5.py`` ``_fwd_kernel5`` /
``rasterize_pallas5_fwd``. The eval blend plus what training needs: the
camera-facing normal, the 2DGS distortion ``reg``, and the backward's
residuals ``t_final`` (T after the last applied splat), ``m1`` and the
per-pixel ``ncontrib`` (the rank of the splat at which T would fall to
T_EPS, which is not blended, else ``s_cap``). The maps come back as
``(14, H, W)`` planes in ``CH_NAMES`` order plus ``ncontrib`` ``(H, W)``
int32. ``lean=True`` skips the normal and reg chains; their planes stay
zero.

The charts are float32 or bfloat16 (the bf16 chart stream of
``GStexConfig.texel_dtype="bf16"``); the wrapper picks the kernel's entry
by their dtype, and bfloat16 charts' launches count on
``rasterize_fwd_bf16``. A bf16 texel is widened to float32 as it is read
and everything after is float32, so the plain version reads
``charts.float()``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .binning import TileGrid
from .launch_counts import EntryCount, counted
from .records import F_REC
from .surfel import (AA_SIGMA2, ALPHA_CLAMP, ALPHA_CUTOFF, EXTENT_SIGMA,
                     REG_FAR, REG_NEAR, T_EPS)

THREADS = 256
MAX_TILE_PIXELS = THREADS * 4
CH_NAMES = ("img0", "img1", "img2", "tex0", "tex1", "tex2", "depth",
            "alpha", "n0", "n1", "n2", "reg", "t_final", "m1")
NCH = len(CH_NAMES)
# the charts' dtypes the flat kernels take: float32, and bfloat16 for the
# bf16 chart stream
CHART_DTYPES = (torch.float32, torch.bfloat16)
# channels that carry a cotangent (t_final and m1 are residuals)
NG = 12
# float32 constants of the depth map m(t) = KFAC·(1 − NEAR/max(t, NEAR)),
# rounded once from double as the kernels' constants are
KFAC = float(np.float32(REG_FAR / (REG_FAR - REG_NEAR)))
KFAC_NEAR = float(np.float32(REG_FAR / (REG_FAR - REG_NEAR) * REG_NEAR))


class WalkStats(NamedTuple):
    """What one forward walk's data made it do."""

    walked: torch.Tensor     # (T,) splats the tile's walk needed
    evaluated: torch.Tensor  # () (pixel, splat) responses with T > T_EPS
    blended: torch.Tensor    # () (pixel, splat) pairs with weight > 0


def pixel_grid(grid: TileGrid, cam_info: torch.Tensor):
    """Per-tile pixel coords, world ray dirs and in-image mask, (T, P)."""
    dev = cam_info.device
    th, tw = grid.tile_h, grid.tile_w
    p = torch.arange(th * tw, device=dev)
    t = torch.arange(grid.num_tiles, device=dev)[:, None]
    ix = (t % grid.ntx) * tw + p % tw
    iy = (t // grid.ntx) * th + p // tw
    inside = (ix < grid.width) & (iy < grid.height)
    gx = ix.to(torch.float32) + cam_info[4]
    gy = iy.to(torch.float32) + cam_info[5]
    dx = (gx + 0.5 - cam_info[2]) / cam_info[0]
    dy = (gy + 0.5 - cam_info[3]) / cam_info[1]
    dirs = [cam_info[3 * i + 9] * dx + cam_info[3 * i + 10] * dy
            + cam_info[3 * i + 11] for i in range(3)]
    return gx, gy, dirs, inside


def tile_order(counts, s_cap: int) -> torch.Tensor:
    """The order in which the flat kernels' and the dense backward's blocks
    take their tiles: by count capped at ``s_cap`` (the dense lists'
    ``s_max``), longest first, so the long tiles do not trail the grid.
    int32 ``(num_tiles,)``."""
    return torch.argsort(torch.clamp(counts, max=s_cap),
                         descending=True).to(torch.int32)


def check_inputs(records, gids, starts, counts, charts, cam_info, grid,
                 s_cap, order=None):
    """Raise on inputs the flat-path kernels do not take. ``records`` must
    be 16-byte aligned: the kernels copy them 16 B at a time (cp.async)."""
    dev = records.device
    n = records.shape[0]
    if grid.tile_h * grid.tile_w > MAX_TILE_PIXELS:
        raise ValueError(f"tiles of more than {MAX_TILE_PIXELS} pixels are "
                         f"not supported")
    spec = {
        "records": (records, torch.float32, (n, F_REC)),
        "gids": (gids, torch.int32, None),
        "starts": (starts, torch.int32, (grid.num_tiles,)),
        "counts": (counts, torch.int32, (grid.num_tiles,)),
        "charts": (charts, CHART_DTYPES, None),
        "cam_info": (cam_info, torch.float32, (18,)),
    }
    if order is not None:
        spec["order"] = (order, torch.int32, (grid.num_tiles,))
    for name, (x, dtype, shape) in spec.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, records on {dev}")
        if x.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if gids.dim() != 1:
        raise ValueError("gids must be 1-D")
    if charts.dim() != 4 or charts.shape[0] != n or charts.shape[3] != 3:
        raise ValueError(f"charts must be (N, Ch, Cw, 3) with N={n}, got "
                         f"{tuple(charts.shape)}")
    if s_cap < 0:
        raise ValueError("s_cap must be >= 0")
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")


def response(r, dirs, gx, gy, v1: bool = False) -> dict:
    """One splat's response at a batch of pixels, in the kernels'
    arithmetic and order.

    ``r`` holds record fields on dim 1 (``r[:, f]`` broadcasts against the
    pixel tensors), ``dirs`` the three ray-direction components, ``gx``,
    ``gy`` the pixel coordinates. ``m`` is the distortion depth map
    ``surfel.reg_depth_map(t)`` written as the kernels compute it: 1/t is
    ``n·d / a_n``.

    ``v1`` takes the v1 kernels' arithmetic, which differs in rounding
    only: the falloff ``g`` as the larger of two exps (the surfel's, zero
    outside the 3σ ellipse, and the screen low-pass's) and ``m`` =
    KFAC·(1 − NEAR / max(t, NEAR)) by a divide. Differentiated by
    autograd, as ``rasterize.backward_walk`` does, it also gives v1's
    divides in the gradient: the m chain's KFAC·NEAR/tc² and d_t / n·d.
    """
    d0, d1, d2 = dirs

    def dot(c):
        return r[:, c] * d0 + r[:, c + 1] * d1 + r[:, c + 2] * d2

    nd = dot(0)
    tiny = torch.where(nd < 0, -1e-9, 1e-9)
    safe_nd = torch.where(nd.abs() < 1e-9, tiny, nd)
    t = r[:, 3] / safe_nd
    b1d = dot(4)
    b2d = dot(8)
    u = r[:, 7] + t * b1d
    v = r[:, 11] + t * b2d
    r2 = u * u + v * v
    arg_s = torch.where(r2 <= EXTENT_SIGMA * EXTENT_SIGMA, -0.5 * r2, -1e30)
    dpx = gx - r[:, 24]
    dpy = gy - r[:, 25]
    arg_c = (-0.5 / AA_SIGMA2) * (dpx * dpx + dpy * dpy)
    if v1:
        g_surf = torch.where(r2 <= EXTENT_SIGMA * EXTENT_SIGMA,
                             torch.exp(-0.5 * r2), 0.0)
        g_scr = torch.exp(arg_c)
        # the larger term takes the whole gradient, ties the surfel's
        g = torch.where(g_surf >= g_scr, g_surf, g_scr)
    else:
        g = torch.exp(torch.maximum(arg_s, arg_c))
    opg = r[:, 20] * g
    alpha = torch.clamp(opg, max=ALPHA_CLAMP)
    alpha = torch.where((alpha < ALPHA_CUTOFF) | ~(t > 1e-6), 0.0, alpha)
    b1ud = dot(12)
    b2ud = dot(16)
    if v1:
        # a tensor numerator: ``scalar / tensor`` is a reciprocal times
        # the scalar in torch, not a divide
        invtc = None
        near = torch.full_like(t, REG_NEAR)
        m = KFAC * (1.0 - near / torch.clamp(t, min=REG_NEAR))
    else:
        inv_t = safe_nd * (1.0 / r[:, 3])
        invtc = torch.where(t >= REG_NEAR, inv_t, 1.0 / REG_NEAR)
        m = KFAC * (1.0 - REG_NEAR * invtc)
    return {
        "nd": nd, "safe_nd": safe_nd, "t": t, "b1d": b1d, "b2d": b2d,
        "u": u, "v": v, "arg_s": arg_s, "arg_c": arg_c, "dpx": dpx,
        "dpy": dpy, "g": g, "opg": opg, "alpha": alpha, "b1ud": b1ud,
        "b2ud": b2ud, "uvu_raw": 0.5 + r[:, 15] + t * b1ud,
        "uvv_raw": 0.5 + r[:, 19] + t * b2ud, "invtc": invtc,
        "m": m,
        "flip": torch.where(nd > 0.0, -1.0, 1.0),
    }


def fetch(charts_flat, ids, ch, cw, r, uvu_raw, uvv_raw):
    """The forward's bilinear texel fetch, clamped into each splat's
    active h x w region; (..., 3)."""
    uvu = torch.clamp(uvu_raw, 0.0, 1.0)
    uvv = torch.clamp(uvv_raw, 0.0, 1.0)
    hf, wf = r[:, 26], r[:, 27]
    xf = torch.minimum(torch.clamp(uvu * hf, min=0.0), hf - 1.0)
    yf = torch.minimum(torch.clamp(uvv * wf, min=0.0), wf - 1.0)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = (xf - x0)[..., None]
    fy = (yf - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.minimum(x0i + 1, hf.long() - 1)
    y1i = torch.minimum(y0i + 1, wf.long() - 1)
    row = ids * ch
    c00 = charts_flat[(row + x0i) * cw + y0i]
    c01 = charts_flat[(row + x0i) * cw + y1i]
    c10 = charts_flat[(row + x1i) * cw + y0i]
    c11 = charts_flat[(row + x1i) * cw + y1i]
    return ((1.0 - fx) * ((1.0 - fy) * c00 + fy * c01)
            + fx * ((1.0 - fy) * c10 + fy * c11))


def untile(acc: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(C, T, P) per-tile planes -> (C, H, W)."""
    th, tw = grid.tile_h, grid.tile_w
    c = acc.shape[0]
    maps = acc.reshape(c, grid.nty, grid.ntx, th, tw).permute(0, 1, 3, 2, 4)
    maps = maps.reshape(c, grid.nty * th, grid.ntx * tw)
    return maps[:, :grid.height, :grid.width].contiguous()


def forward_walk(records, gids, starts, counts, charts, cam_info,
                 grid: TileGrid, s_cap: int, lean: bool = False,
                 chunk: int = 16, extra: bool = False, v1: bool = False):
    """The plain forward walk, vectorized over all tiles: slot rank
    0..min(count, s_cap) in chunks on (tiles, pixels) tensors, in the
    kernels' per-pixel order and arithmetic. Returns the (14, H, W) maps,
    ncontrib (H, W) int32, and the ``WalkStats``: per tile the splats the
    walk needed (the rank after which no in-image pixel had T > T_EPS,
    else the clamped count), and the counts of responses and blends.
    ``extra=True`` appends the three planes of the ``uv`` visualization
    map, Σ w·(u, v, 0.5) with the chart coordinates clamped to [0, 1].
    ``v1`` takes the v1 kernels' arithmetic (``response``)."""
    dev = records.device
    nt = grid.num_tiles
    pix = grid.tile_h * grid.tile_w
    ch, cw = charts.shape[1], charts.shape[2]
    # bf16 charts widened as the kernels widen each texel they read
    charts_flat = charts.float().reshape(-1, 3)
    gx, gy, (d0, d1, d2), inside = pixel_grid(grid, cam_info)
    n_walk = torch.clamp(counts.long(), max=s_cap)
    starts = starts.long()
    gids = gids.long()

    T = torch.ones((nt, pix), dtype=torch.float32, device=dev)
    t_fin = torch.ones((nt, pix), dtype=torch.float32, device=dev)
    ncon = torch.full((nt, pix), s_cap, dtype=torch.int32, device=dev)
    acc = torch.zeros((NCH + 3 * extra, nt, pix), dtype=torch.float32,
                      device=dev)
    walked = n_walk.clone()
    done = torch.zeros(nt, dtype=torch.bool, device=dev)
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    blended = torch.zeros((), dtype=torch.int64, device=dev)
    max_walk = int(n_walk.max()) if nt > 0 else 0
    for base in range(0, max_walk, chunk):
        act = torch.nonzero((~done) & (n_walk > base)).flatten()
        if act.numel() == 0:
            break
        k = torch.arange(chunk, device=dev)
        valid = base + k[None, :] < n_walk[act, None]              # (A, K)
        slots = torch.where(valid, starts[act, None] + base + k, 0)
        ids = torch.where(valid, gids[slots], 0)
        rec = records[ids]                                         # (A, K, F)
        Ta, tfa, nca = T[act], t_fin[act], ncon[act]
        acc_a = list(acc[:, act].unbind(0))   # rebound, never written in place
        gxa, gya = gx[act], gy[act]
        da = (d0[act], d1[act], d2[act])
        ins = inside[act]
        for j in range(chunk):
            r = rec[:, j, :, None]                                 # (A, F, 1)
            alive = ins & (Ta > T_EPS) & valid[:, j, None]
            resp = response(r, da, gxa, gya, v1=v1)
            alpha = torch.where(alive, resp["alpha"], 0.0)
            t_new = Ta * (1.0 - alpha)
            applied = (alpha > 0) & (t_new > T_EPS)
            w = torch.where(applied, alpha * Ta, 0.0)
            brk = (alpha > 0) & ~(t_new > T_EPS)
            nca = torch.where(brk, base + j, nca)
            tfa = torch.where(applied, t_new, tfa)
            Ta = t_new
            evaluated += alive.sum()
            blended += applied.sum()

            tex = fetch(charts_flat, ids[:, j, None], ch, cw, r,
                        resp["uvu_raw"], resp["uvv_raw"])          # (A, P, 3)
            t = resp["t"]
            for c in range(3):
                acc_a[c] = acc_a[c] + w * r[:, 21 + c]
                acc_a[3 + c] = acc_a[3 + c] + w * tex[..., c]
            acc_a[6] = acc_a[6] + w * t
            if not lean:
                m = resp["m"]
                wf = w * resp["flip"]
                for c in range(3):
                    acc_a[8 + c] = acc_a[8 + c] + r[:, c] * wf
                acc_a[11] = acc_a[11] + 2.0 * w * (m * acc_a[7] - acc_a[13])
                acc_a[13] = acc_a[13] + w * m
            acc_a[7] = acc_a[7] + w
            if extra:
                acc_a[NCH] = acc_a[NCH] + w * torch.clamp(resp["uvu_raw"],
                                                          0.0, 1.0)
                acc_a[NCH + 1] = acc_a[NCH + 1] + w * torch.clamp(
                    resp["uvv_raw"], 0.0, 1.0)
                acc_a[NCH + 2] = acc_a[NCH + 2] + w * 0.5

            finished = ~(ins & (Ta > T_EPS)).any(-1) & valid[:, j]
            newly = finished & ~done[act]
            walked[act[newly]] = base + j + 1
            done[act] = done[act] | finished
        T[act], t_fin[act], ncon[act] = Ta, tfa, nca
        acc[:, act] = torch.stack(acc_a)
    acc[12] = t_fin
    ncon_map = untile(ncon.to(torch.float32)[None], grid)[0]
    return (untile(acc, grid), ncon_map.to(torch.int32),
            WalkStats(walked, evaluated, blended))


def rasterize_fwd_reference(records, gids, starts, counts, charts,
                            cam_info, grid: TileGrid, s_cap: int,
                            lean: bool = False):
    """Plain PyTorch version of the kernel: ``(maps (14, H, W), ncontrib
    (H, W) int32)``."""
    return forward_walk(records, gids, starts, counts, charts, cam_info,
                        grid, s_cap, lean=lean)[:2]


def rasterize_fwd(records, gids, starts, counts, charts, cam_info,
                  grid: TileGrid, s_cap: int, lean: bool = False,
                  order=None):
    """Training forward; returns ``(maps (14, H, W), ncontrib (H, W))``.

    Arguments as ``rasterize_eval.rasterize_eval``; ``order`` is
    ``tile_order(counts, s_cap)``, computed here if not given. CPU tensors
    run the plain version; CUDA tensors launch the kernel's entry for the
    charts' dtype (and raise if it cannot launch).
    """
    check_inputs(records, gids, starts, counts, charts, cam_info, grid,
                 s_cap, order)
    dev = records.device
    if dev.type == "cpu":
        return rasterize_fwd_reference(records, gids, starts, counts,
                                       charts, cam_info, grid, s_cap,
                                       lean=lean)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_fwd runs on cpu or cuda, not {dev}")
    from . import _build

    lib = _build.load("rasterize_fwd")
    bf16 = charts.dtype == torch.bfloat16
    fn = lib.gstex_rasterize_fwd_bf16 if bf16 else lib.gstex_rasterize_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ch, cw = charts.shape[1], charts.shape[2]
    out = torch.empty((NCH, grid.height, grid.width), dtype=torch.float32,
                      device=dev)
    ncon = torch.empty((grid.height, grid.width), dtype=torch.int32,
                       device=dev)
    with torch.cuda.device(dev):
        if order is None:
            order = tile_order(counts, s_cap)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(records.data_ptr(), gids.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), charts.data_ptr(), cam_info.data_ptr(),
                out.data_ptr(), ncon.data_ptr(), order.data_ptr(),
                grid.num_tiles, grid.ntx, grid.tile_h, grid.tile_w,
                grid.height, grid.width, ch, cw, s_cap, int(lean), stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_fwd kernel launch failed: "
                           f"cudaError {rc}")
    (rasterize_fwd_bf16 if bf16 else rasterize_fwd).launches += 1
    return out, ncon


# kernel launches since the last reset, one count an entry (CPU calls do
# not count; ``launch_counts``)
counted(rasterize_fwd)
# the bf16 chart entry, which ``rasterize_fwd`` launches on bfloat16 charts
rasterize_fwd_bf16 = counted(EntryCount("rasterize_fwd_bf16"))


def launch_smem(bf16: bool = False) -> int:
    """Bytes of shared memory a launch of the forward kernel (its bf16
    chart entry with ``bf16``) takes: its static arrays, the same for every
    tile size and chart pad."""
    from . import _build

    lib = _build.load("rasterize_fwd")
    fn = (lib.gstex_rasterize_fwd_bf16_smem if bf16
          else lib.gstex_rasterize_fwd_smem)
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()
