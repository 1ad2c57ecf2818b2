"""Texture painting's inverse rasterisation (counterpart of
``gstex_tpu/ops/texture_edit.py``): the CUDA kernel
``csrc/texture_edit.cu``, its wrapper ``scatter_canvas`` and its plain
PyTorch version, and the API around them, ``texture_edit`` and
``apply_edit``.

An RGBA canvas seen from one camera is splatted back into the texel
charts of the surfels visible inside a per-pixel depth window. Per pixel,
the tile's dense list is walked front to back with the eval walk's
arithmetic (``rasterize_fwd.response`` on the assembled records, the break
at T_EPS, which is not applied, w = α·T); each applied pair whose depth t
lies in ``[depth_lower, depth_upper]`` adds w·(rgb, α, 1) of its pixel's
canvas to the texels of its bilinear tent max(0, 1 − |x − a|) at the
forward's clamped chart sample. The result is the ``(N, Ch, Cw, 5)``
accumulator: channels 0:3 Σ w·rgb, 3 Σ w·α, 4 Σ w; ``apply_edit``
normalises it and lerps it into the current RGB charts.

The kernel adds its terms with REDs in no fixed order, so it agrees with
the plain version to float32 rounding of the sums; the texels it reaches
are the same.
"""

from __future__ import annotations

import ctypes

import torch

from .binning import TileBins, TileGrid
from .camera import Camera
from .launch_counts import counted
from .rasterize_bwd import tile_planes
from .rasterize_fwd import MAX_TILE_PIXELS, pixel_grid, response, tile_order
from .records import F_REC, assemble_records, cam_info
from .surfel import T_EPS, SplatGeom

# the accumulator's channels: Σ w·rgb (3), Σ w·α, Σ w
ACCUM = 5
# the per-pixel inputs: canvas rgb (3), canvas alpha, depth lower, upper
PLANES = 6


def edit_planes(canvas_rgb, canvas_alpha, depth_lower,
                depth_upper) -> torch.Tensor:
    """The kernel's ``(6, H, W)`` per-pixel inputs from the canvas
    ``(H, W, 3)``, its alpha ``(H, W, 1)`` or ``(H, W)`` and the depth
    window's bounds ``(H, W)``."""
    h, w = canvas_rgb.shape[:2]
    alpha = canvas_alpha.reshape(h, w, -1)[..., 0]
    return torch.cat([canvas_rgb.permute(2, 0, 1), alpha[None],
                      depth_lower[None], depth_upper[None]]).to(
        torch.float32).contiguous()


def check_inputs(records, ids, counts, planes, cam_info, grid: TileGrid,
                 order=None):
    """Raise on inputs the kernel does not take: ``records`` must be
    16-byte aligned (the kernel copies them 16 B at a time, cp.async),
    ``order`` (given) an int32 ``(num_tiles,)`` tile order."""
    dev = records.device
    n = records.shape[0]
    if grid.tile_h * grid.tile_w > MAX_TILE_PIXELS:
        raise ValueError(f"tiles of more than {MAX_TILE_PIXELS} pixels are "
                         f"not supported")
    spec = {
        "records": (records, torch.float32, (n, F_REC)),
        "ids": (ids, torch.int32, None),
        "counts": (counts, torch.int32, (grid.num_tiles,)),
        "planes": (planes, torch.float32,
                   (PLANES, grid.height, grid.width)),
        "cam_info": (cam_info, torch.float32, (18,)),
    }
    if order is not None:
        spec["order"] = (order, torch.int32, (grid.num_tiles,))
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
    if ids.dim() != 2 or ids.shape[0] != grid.num_tiles:
        raise ValueError(f"ids must be (num_tiles={grid.num_tiles}, s_max), "
                         f"got {tuple(ids.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"texture_edit runs on cpu or cuda, not {dev}")
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")


def scatter_canvas_reference(records, ids, counts, planes, cam_info,
                             grid: TileGrid, ch: int, cw: int,
                             chunk: int = 16, stats=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the ``(N, ch, cw, 5)``
    accumulator, slot rank by rank over all tiles at once. A ``stats``
    dict, given, receives what the data made the walk do: ``responses``
    (pixel-slot pairs evaluated with T > T_EPS), ``applied`` (pairs of
    weight > 0) and ``hits`` (those inside their pixel's window)."""
    counted = dict(responses=0, applied=0, hits=0)
    dev = records.device
    n = records.shape[0]
    s_max = ids.shape[1]
    nt = grid.num_tiles
    gx, gy, (d0, d1, d2), inside = pixel_grid(grid, cam_info)
    vals = tile_planes(planes, grid)                         # (6, T, P)
    vals = torch.cat([vals[:4], torch.ones_like(vals[:1])])  # rgb, α, 1
    lo, hi = tile_planes(planes[4:6], grid)
    n_walk = torch.clamp(counts.long(), max=s_max)
    ids = ids.long()
    T = torch.ones(inside.shape, dtype=torch.float32, device=dev)
    acc = torch.zeros((n * ch * cw, ACCUM), dtype=torch.float32, device=dev)
    max_walk = int(n_walk.max()) if nt > 0 else 0
    for base in range(0, max_walk, chunk):
        live = (inside & (T > T_EPS)).any(-1)
        act = torch.nonzero(live & (n_walk > base)).flatten()
        if act.numel() == 0:
            break
        Ta = T[act]
        ins, da = inside[act], (d0[act], d1[act], d2[act])
        gxa, gya = gx[act], gy[act]
        for k in range(base, min(base + chunk, s_max)):
            valid = k < n_walk[act]
            gid = torch.where(valid, ids[act, k], 0)
            r = records[gid][:, :, None]                         # (A, F, 1)
            alive = ins & (Ta > T_EPS) & valid[:, None]
            resp = response(r, da, gxa, gya)
            alpha = torch.where(alive, resp["alpha"], 0.0)
            t_new = Ta * (1.0 - alpha)
            t = resp["t"]
            applied = (alpha > 0) & (t_new > T_EPS)
            hit = applied & (t >= lo[act]) & (t <= hi[act])
            w = alpha * Ta
            Ta = t_new
            if stats is not None:
                counted["responses"] += int(alive.sum())
                counted["applied"] += int(applied.sum())
                counted["hits"] += int(hit.sum())
            if not bool(hit.any()):
                continue
            a_i, p_i = torch.nonzero(hit, as_tuple=True)
            rr = r[a_i, :, 0]                                    # (M, F)
            wv = w[a_i, p_i, None] * vals[:, act[a_i], p_i].T    # (M, 5)
            taps = []
            for raw, dim in ((resp["uvu_raw"], 26), (resp["uvv_raw"], 27)):
                size = rr[:, dim]
                x = torch.minimum(torch.clamp(
                    torch.clamp(raw[a_i, p_i], 0.0, 1.0) * size, min=0.0),
                    size - 1.0)
                x0 = torch.floor(x)
                taps.append(((x0, 1.0 - (x - x0)),
                             (x0 + 1.0, 1.0 - (x - (x0 + 1.0)).abs())))
            row = gid[a_i] * ch
            for xa, wxa in taps[0]:
                for yb, wyb in taps[1]:
                    term = wyb[:, None] * (wxa[:, None] * wv)
                    keep = (wxa > 0) & (wyb > 0)
                    idx = (row + xa.long()) * cw + yb.long()
                    acc.index_add_(0, idx[keep], term[keep])
        T[act] = Ta
    if stats is not None:
        stats.update(counted)
    return acc.reshape(n, ch, cw, ACCUM)


def scatter_canvas(records, ids, counts, planes, cam_info, grid: TileGrid,
                   ch: int, cw: int, order=None) -> torch.Tensor:
    """The ``(N, ch, cw, 5)`` accumulator of the canvas splatted into the
    charts (see the module docstring).

    Args:
        records: (N, F_REC) float32 per-gaussian records, 16-byte aligned.
        ids: (num_tiles, s_max) int32 ``TileBins.ids``.
        counts: (num_tiles,) int32 ``TileBins.counts`` (clamped to s_max
            here and in the kernel).
        planes: (6, H, W) float32 ``edit_planes``.
        cam_info: (18,) float32.
        ch, cw: the chart pad.
        order: ``tile_order(counts, s_max)``, computed here if not given.

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    raise if it cannot launch).
    """
    check_inputs(records, ids, counts, planes, cam_info, grid, order)
    dev = records.device
    if dev.type == "cpu":
        return scatter_canvas_reference(records, ids, counts, planes,
                                        cam_info, grid, ch, cw)
    accum = torch.zeros((records.shape[0], ch, cw, ACCUM),
                        dtype=torch.float32, device=dev)
    if order is None:
        order = tile_order(counts, ids.shape[1])
    launch(records, ids, counts, planes, cam_info, accum, order, grid)
    scatter_canvas.launches += 1
    return accum


def launch(records, ids, counts, planes, cam_info, accum, order,
           grid: TileGrid) -> None:
    """Build (at first use) and launch the kernel on the current stream,
    adding into ``accum`` (N, Ch, Cw, 5) as it is; raise if the launch is
    refused. The inputs as ``scatter_canvas`` checks them."""
    from . import _build

    fn = _build.load("texture_edit").gstex_texture_edit
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = records.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in (records, ids, counts, planes,
                                          cam_info, accum, order)),
                grid.num_tiles, grid.ntx, grid.tile_h, grid.tile_w,
                grid.height, grid.width, accum.shape[1], accum.shape[2],
                ids.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"texture_edit kernel launch failed: "
                           f"cudaError {rc}")


# kernel launches since the last reset (CPU calls do not count;
# ``launch_counts``)
counted(scatter_canvas)


def texture_edit(geom: SplatGeom, texture_shape, texture_hw: torch.Tensor,
                 bins: TileBins, cam: Camera, grid: TileGrid,
                 canvas_rgb: torch.Tensor, canvas_alpha: torch.Tensor,
                 depth_lower: torch.Tensor,
                 depth_upper: torch.Tensor) -> torch.Tensor:
    """Scatter the canvas ``(H, W, 3)`` with its alpha ``(H, W, 1)`` or
    ``(H, W)`` into chart space for the surfels of ``bins`` (dense lists)
    whose depth lies in ``[depth_lower, depth_upper]`` ``(H, W)``.
    ``texture_shape`` is the charts' ``(N, Ch, Cw, ·)``. Returns the
    ``(N, Ch, Cw, 5)`` accumulator."""
    records = assemble_records(geom, cam.c2w[:3, 3], texture_hw)
    planes = edit_planes(canvas_rgb, canvas_alpha, depth_lower, depth_upper)
    return scatter_canvas(records, bins.ids, bins.counts, planes,
                          cam_info(cam), grid, int(texture_shape[1]),
                          int(texture_shape[2]))


def apply_edit(cur_texture_rgb: torch.Tensor, accum: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalise the ``(N, Ch, Cw, 5)`` accumulator and lerp it into the
    current RGB charts: weight Σw·α / (Σw + eps), colour Σw·rgb / (Σw·α +
    eps)."""
    weight = accum[..., 3:4] / (accum[..., 4:5] + eps)
    edit_rgb = accum[..., :3] / (accum[..., 3:4] + eps)
    return edit_rgb * weight + cur_texture_rgb * (1.0 - weight)
