"""Forward-only eval render over the flat pair list: the CUDA kernel
``csrc/rasterize_eval.cu``, its wrapper and its plain PyTorch version.

Counterpart of ``gstex_tpu/ops/rasterize_pallas5.py`` ``_eval_kernel5`` /
``rasterize_pallas5_eval``. The kernel reads ``FlatBins`` and the dense
``(N, Ch, Cw, 3)`` charts directly and writes the eight output maps as
``(8, H, W)`` planes: img(3), tex(3), depth, alpha.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .binning import TileGrid
from .records import F_REC
from .surfel import (AA_SIGMA2, ALPHA_CLAMP, ALPHA_CUTOFF, EXTENT_SIGMA,
                     T_EPS)

MAP_NAMES = ("img0", "img1", "img2", "tex0", "tex1", "tex2", "depth",
             "alpha")
THREADS = 256
MAX_TILE_PIXELS = THREADS * 4
MAX_CHUNK = 32
# staging budget per chunk; above 48 KB the kernel opts in to more
_SMEM_TARGET = 48 * 1024
_SMEM_MAX = 227 * 1024


class WalkStats(NamedTuple):
    """What one eval render's data made the walk do."""

    walked: torch.Tensor     # (T,) splats the tile's walk needed
    evaluated: torch.Tensor  # () (pixel, splat) responses with T > T_EPS
    blended: torch.Tensor    # () (pixel, splat) pairs with weight > 0


def _pixel_grid(grid: TileGrid, cam_info: torch.Tensor):
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


def rasterize_eval_reference(records, gids, starts, counts, charts,
                             cam_info, grid: TileGrid, s_cap: int,
                             chunk: int = 16):
    """Plain PyTorch version of the kernel, vectorized over all tiles.

    Walks slot rank 0..min(count, s_cap) in chunks on (tiles, pixels)
    tensors, in the kernel's per-pixel order and arithmetic. Returns the
    ``(8, H, W)`` maps and the ``WalkStats``: per tile, the number of
    splats the walk needed (the rank after which no in-image pixel had
    T > T_EPS, else the clamped count), and the counts of responses and
    blends the data needed.
    """
    dev = records.device
    nt = grid.num_tiles
    pix = grid.tile_h * grid.tile_w
    ch, cw = charts.shape[1], charts.shape[2]
    charts_flat = charts.reshape(-1, 3)
    gx, gy, (d0, d1, d2), inside = _pixel_grid(grid, cam_info)
    n_walk = torch.clamp(counts.long(), max=s_cap)
    starts = starts.long()
    gids = gids.long()

    T = torch.ones((nt, pix), dtype=torch.float32, device=dev)
    acc = torch.zeros((8, nt, pix), dtype=torch.float32, device=dev)
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
        Ta, acc_a = T[act], acc[:, act]
        gxa, gya = gx[act], gy[act]
        da = (d0[act], d1[act], d2[act])
        ins = inside[act]
        for j in range(chunk):
            r = rec[:, j, :, None]                                 # (A, F, 1)
            alive = ins & (Ta > T_EPS) & valid[:, j, None]

            def dot(c):
                return r[:, c] * da[0] + r[:, c + 1] * da[1] + r[:, c + 2] * da[2]

            nd = dot(0)
            tiny = torch.where(nd < 0, -1e-9, 1e-9)
            safe_nd = torch.where(nd.abs() < 1e-9, tiny, nd)
            t = r[:, 3] / safe_nd
            u = r[:, 7] + t * dot(4)
            v = r[:, 11] + t * dot(8)
            r2 = u * u + v * v
            arg_s = torch.where(r2 <= EXTENT_SIGMA * EXTENT_SIGMA, -0.5 * r2,
                                -1e30)
            dpx = gxa - r[:, 24]
            dpy = gya - r[:, 25]
            arg_c = (-0.5 / AA_SIGMA2) * (dpx * dpx + dpy * dpy)
            g = torch.exp(torch.maximum(arg_s, arg_c))
            alpha = torch.clamp(r[:, 20] * g, max=ALPHA_CLAMP)
            alpha = torch.where((alpha < ALPHA_CUTOFF) | ~(t > 1e-6), 0.0,
                                alpha)
            alpha = torch.where(alive, alpha, 0.0)

            t_new = Ta * (1.0 - alpha)
            w = torch.where((alpha > 0) & (t_new > T_EPS), alpha * Ta, 0.0)
            Ta = t_new
            evaluated += alive.sum()
            blended += (w > 0).sum()

            uvu = torch.clamp(0.5 + r[:, 15] + t * dot(12), 0.0, 1.0)
            uvv = torch.clamp(0.5 + r[:, 19] + t * dot(16), 0.0, 1.0)
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
            row = ids[:, j, None] * ch
            c00 = charts_flat[(row + x0i) * cw + y0i]
            c01 = charts_flat[(row + x0i) * cw + y1i]
            c10 = charts_flat[(row + x1i) * cw + y0i]
            c11 = charts_flat[(row + x1i) * cw + y1i]
            tex = ((1.0 - fx) * ((1.0 - fy) * c00 + fy * c01)
                   + fx * ((1.0 - fy) * c10 + fy * c11))           # (A, P, 3)
            for c in range(3):
                acc_a[c] = acc_a[c] + w * r[:, 21 + c]
                acc_a[3 + c] = acc_a[3 + c] + w * tex[..., c]
            acc_a[6] = acc_a[6] + w * t
            acc_a[7] = acc_a[7] + w

            finished = ~(ins & (Ta > T_EPS)).any(-1) & valid[:, j]
            newly = finished & ~done[act]
            walked[act[newly]] = base + j + 1
            done[act] = done[act] | finished
        T[act] = Ta
        acc[:, act] = acc_a

    th, tw = grid.tile_h, grid.tile_w
    maps = acc.reshape(8, grid.nty, grid.ntx, th, tw).permute(0, 1, 3, 2, 4)
    maps = maps.reshape(8, grid.nty * th, grid.ntx * tw)
    return (maps[:, :grid.height, :grid.width].contiguous(),
            WalkStats(walked, evaluated, blended))


def chunk_size(chart_pad) -> int:
    """Splats staged per chunk in the kernel's shared memory."""
    per = (F_REC + chart_pad[0] * chart_pad[1] * 3) * 4
    chunk = max(1, min(MAX_CHUNK, _SMEM_TARGET // per))
    if chunk * per > _SMEM_MAX:
        raise ValueError(f"chart pad {tuple(chart_pad)} needs {per} B of "
                         f"shared memory per splat; the kernel has "
                         f"{_SMEM_MAX} B")
    return chunk


def _check(records, gids, starts, counts, charts, cam_info, grid, s_cap):
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
        "charts": (charts, torch.float32, None),
        "cam_info": (cam_info, torch.float32, (18,)),
    }
    for name, (x, dtype, shape) in spec.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, records on {dev}")
        if x.dtype != dtype:
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


def rasterize_eval(records, gids, starts, counts, charts, cam_info,
                   grid: TileGrid, s_cap: int) -> torch.Tensor:
    """Forward-only blend; returns the ``(8, H, W)`` maps: img (3),
    tex (3), depth, alpha.

    Args:
        records: (N, F_REC) float32 per-gaussian records.
        gids, starts, counts: ``FlatBins`` fields (int32).
        charts: (N, Ch, Cw, 3) float32 albedo charts.
        cam_info: (18,) float32.
        s_cap: per-tile walk clamp.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch).
    """
    _check(records, gids, starts, counts, charts, cam_info, grid, s_cap)
    dev = records.device
    if dev.type == "cpu":
        return rasterize_eval_reference(records, gids, starts, counts,
                                        charts, cam_info, grid, s_cap)[0]
    if dev.type != "cuda":
        raise ValueError(f"rasterize_eval runs on cpu or cuda, not {dev}")
    from . import _build

    lib = _build.load("rasterize_eval")
    fn = lib.gstex_rasterize_eval
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ch, cw = charts.shape[1], charts.shape[2]
    out = torch.empty((8, grid.height, grid.width), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(records.data_ptr(), gids.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), charts.data_ptr(), cam_info.data_ptr(),
                out.data_ptr(), grid.num_tiles, grid.ntx, grid.tile_h,
                grid.tile_w, grid.height, grid.width, ch, cw, s_cap,
                chunk_size((ch, cw)), stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_eval kernel launch failed: "
                           f"cudaError {rc}")
    rasterize_eval.launches += 1
    return out


# kernel launches since the last reset (CPU calls do not count)
rasterize_eval.launches = 0
