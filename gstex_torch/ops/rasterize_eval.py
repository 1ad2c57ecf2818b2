"""Forward-only eval render over the flat pair list: the CUDA kernel
``csrc/rasterize_eval.cu``, its wrapper and its plain PyTorch version.

Counterpart of ``gstex_tpu/ops/rasterize_pallas5.py`` ``_eval_kernel5`` /
``rasterize_pallas5_eval``. The kernel reads ``FlatBins`` and the dense
``(N, Ch, Cw, 3)`` charts directly and writes the eight output maps as
``(8, H, W)`` planes: img(3), tex(3), depth, alpha. It is the flat
training forward's walk (``rasterize_fwd``) without the training outputs:
records staged in chunks through shared memory, texels read from the
charts in device memory, so no shared memory grows with the chart pad;
tiles taken longest first (``rasterize_fwd.tile_order``).

The charts are float32 or bfloat16 (the bf16 chart stream); the wrapper
picks the kernel's entry by their dtype, and bfloat16 charts' launches
count on ``rasterize_eval_bf16``. The plain version reads
``charts.float()``, so either entry is bit-equal to it.
"""

from __future__ import annotations

import ctypes

import torch

from .binning import TileGrid
from .launch_counts import EntryCount, counted
from .rasterize_fwd import check_inputs, forward_walk, tile_order


def rasterize_eval_reference(records, gids, starts, counts, charts,
                             cam_info, grid: TileGrid, s_cap: int):
    """Plain PyTorch version of the kernel: the first eight planes of the
    lean forward walk (``rasterize_fwd.forward_walk``), which computes
    them in the eval kernel's per-pixel order and arithmetic, and its
    ``WalkStats``."""
    maps, _, stats = forward_walk(records, gids, starts, counts, charts,
                                  cam_info, grid, s_cap, lean=True)
    return maps[:8].contiguous(), stats


def rasterize_eval(records, gids, starts, counts, charts, cam_info,
                   grid: TileGrid, s_cap: int, order=None) -> torch.Tensor:
    """Forward-only blend; returns the ``(8, H, W)`` maps: img (3),
    tex (3), depth, alpha.

    Args:
        records: (N, F_REC) float32 per-gaussian records.
        gids, starts, counts: ``FlatBins`` fields (int32).
        charts: (N, Ch, Cw, 3) float32 or bfloat16 albedo charts.
        cam_info: (18,) float32.
        s_cap: per-tile walk clamp.
        order: ``tile_order(counts, s_cap)``, the order in which blocks
            take the tiles; computed here if not given.

    ``records`` must be 16-byte aligned. CPU tensors run the plain
    version; CUDA tensors launch the kernel's entry for the charts' dtype
    (and raise if it cannot launch).
    """
    check_inputs(records, gids, starts, counts, charts, cam_info, grid,
                 s_cap, order)
    dev = records.device
    if dev.type == "cpu":
        return rasterize_eval_reference(records, gids, starts, counts,
                                        charts, cam_info, grid, s_cap)[0]
    if dev.type != "cuda":
        raise ValueError(f"rasterize_eval runs on cpu or cuda, not {dev}")
    from . import _build

    lib = _build.load("rasterize_eval")
    bf16 = charts.dtype == torch.bfloat16
    fn = lib.gstex_rasterize_eval_bf16 if bf16 else lib.gstex_rasterize_eval
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ch, cw = charts.shape[1], charts.shape[2]
    out = torch.empty((8, grid.height, grid.width), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        if order is None:
            order = tile_order(counts, s_cap)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(records.data_ptr(), gids.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), charts.data_ptr(), cam_info.data_ptr(),
                out.data_ptr(), order.data_ptr(), grid.num_tiles, grid.ntx,
                grid.tile_h, grid.tile_w, grid.height, grid.width, ch, cw,
                s_cap, stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_eval kernel launch failed: "
                           f"cudaError {rc}")
    (rasterize_eval_bf16 if bf16 else rasterize_eval).launches += 1
    return out


# kernel launches since the last reset, one count an entry (CPU calls do
# not count; ``launch_counts``)
counted(rasterize_eval)
# the bf16 chart entry, which ``rasterize_eval`` launches on bfloat16 charts
rasterize_eval_bf16 = counted(EntryCount("rasterize_eval_bf16"))


def launch_smem(bf16: bool = False) -> int:
    """Bytes of shared memory a launch of the eval kernel (its bf16 chart
    entry with ``bf16``) takes: its static arrays, the same for every tile
    size and chart pad."""
    from . import _build

    lib = _build.load("rasterize_eval")
    fn = (lib.gstex_rasterize_eval_bf16_smem if bf16
          else lib.gstex_rasterize_eval_smem)
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()
