"""The dense-list render kernels: eval, training forward and backward over
the ``(num_tiles, s_max)`` id lists of ``binning.build_tile_bins``. The
CUDA kernels ``csrc/rasterize_dense_eval.cu``, ``rasterize_dense_fwd.cu``
and ``rasterize_dense_bwd.cu``, their wrappers, and their plain PyTorch
versions (``ops/rasterize.py``).

Counterpart of ``gstex_tpu/ops/rasterize_pallas4.py``:
``rasterize_pallas4_eval`` (``_eval_kernel4``), ``rasterize_pallas4_fwd``
(``_fwd_kernel4``) and ``rasterize_pallas4_bwd`` (``_bwd_kernel4``)
together with the per-gaussian reduction that follows it
(``rasterize_pallas_api.py:_reduce_d_charts``). They compute what the flat
kernels compute (``ops/rasterize_eval.py``, ``ops/rasterize_fwd.py``,
``ops/rasterize_bwd.py``) on the same walk, and hold a chunk of records on
chip. Texels are fetched from the ``(N, Ch, Cw, 3)`` charts in device
memory and texel gradients are added there, so their shared memory does
not grow with the chart pad and every pad is served. All three, as the
flat kernels, copy their records through a ``cp.async`` ring (so records
must be 16-byte aligned) and take their tiles longest first
(``rasterize_fwd.tile_order`` on the counts capped at ``s_max``). Maps
come back as ``(C, H, W)`` planes in ``rasterize_fwd.CH_NAMES`` order;
ncontrib is ``s_max`` where a pixel's walk never broke.
"""

from __future__ import annotations

import ctypes

import torch

from . import rasterize as plain
from .binning import TileGrid
from .launch_counts import counted
from .rasterize_bwd import check_residuals
from .rasterize_fwd import MAX_TILE_PIXELS, NCH, tile_order
from .records import F_REC


def check_inputs(records, ids, counts, charts, cam_info, grid: TileGrid,
                 order=None):
    """Raise on inputs the dense-list kernels do not take: ``order`` (given)
    must be an int32 ``(num_tiles,)`` tile order, and ``records`` must be
    16-byte aligned (the kernels copy them 16 B at a time, cp.async)."""
    dev = records.device
    n = records.shape[0]
    if grid.tile_h * grid.tile_w > MAX_TILE_PIXELS:
        raise ValueError(f"tiles of more than {MAX_TILE_PIXELS} pixels are "
                         f"not supported")
    spec = {
        "records": (records, torch.float32, (n, F_REC)),
        "ids": (ids, torch.int32, None),
        "counts": (counts, torch.int32, (grid.num_tiles,)),
        "charts": (charts, torch.float32, None),
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
    if charts.dim() != 4 or charts.shape[0] != n or charts.shape[3] != 3:
        raise ValueError(f"charts must be (N, Ch, Cw, 3) with N={n}, got "
                         f"{tuple(charts.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the dense-list kernels run on cpu or cuda, not "
                         f"{dev}")
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")


def _launch(name: str, n_ptr: int, pointers, ints, dev):
    """Build (at first use) and launch ``gstex_<name>`` on the current
    stream of ``dev``; raise if the launch is refused."""
    from . import _build

    fn = getattr(_build.load(name), f"gstex_{name}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in pointers), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _geometry(grid: TileGrid, charts, ids):
    return (grid.num_tiles, grid.ntx, grid.tile_h, grid.tile_w, grid.height,
            grid.width, charts.shape[1], charts.shape[2], ids.shape[1])


def rasterize_dense_eval_reference(records, ids, counts, charts, cam_info,
                                   grid: TileGrid) -> torch.Tensor:
    """Plain PyTorch version of the eval kernel: the first eight planes of
    the lean forward scan."""
    maps, _ = plain.forward_scan(records, ids, counts, charts, cam_info,
                                 grid, lean=True)
    return maps[:8].contiguous()


def rasterize_dense_eval(records, ids, counts, charts, cam_info,
                         grid: TileGrid, order=None) -> torch.Tensor:
    """Forward-only blend; returns the ``(8, H, W)`` maps: img (3), tex
    (3), depth, alpha.

    Args:
        records: (N, F_REC) float32 per-gaussian records, 16-byte aligned.
        ids: (num_tiles, s_max) int32 ``TileBins.ids``.
        counts: (num_tiles,) int32 ``TileBins.counts`` (clamped to s_max
            here and in the kernel).
        charts: (N, Ch, Cw, 3) float32 albedo charts.
        cam_info: (18,) float32.
        order: ``tile_order(counts, s_max)``, computed here if not given.
            The tile order changes no pixel's operations: the maps are
            bit-equal to the plain version's under any order.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch).
    """
    check_inputs(records, ids, counts, charts, cam_info, grid, order)
    dev = records.device
    if dev.type == "cpu":
        return rasterize_dense_eval_reference(records, ids, counts, charts,
                                              cam_info, grid)
    out = torch.empty((8, grid.height, grid.width), dtype=torch.float32,
                      device=dev)
    if order is None:
        order = tile_order(counts, ids.shape[1])
    _launch("rasterize_dense_eval", 7,
            (records, ids, counts, charts, cam_info, out, order),
            _geometry(grid, charts, ids), dev)
    rasterize_dense_eval.launches += 1
    return out


def rasterize_dense_fwd(records, ids, counts, charts, cam_info,
                        grid: TileGrid, lean: bool = False, order=None):
    """Training forward; returns ``(maps (14, H, W), ncontrib (H, W)
    int32)``. ``lean=True`` skips the normal and reg chains; their planes
    stay zero. Arguments, ``order`` among them, as
    ``rasterize_dense_eval``: the maps and ncontrib are bit-equal to the
    plain version's under any tile order."""
    check_inputs(records, ids, counts, charts, cam_info, grid, order)
    dev = records.device
    if dev.type == "cpu":
        return plain.forward_scan(records, ids, counts, charts, cam_info,
                                  grid, lean=lean)
    out = torch.empty((NCH, grid.height, grid.width), dtype=torch.float32,
                      device=dev)
    ncon = torch.empty((grid.height, grid.width), dtype=torch.int32,
                       device=dev)
    if order is None:
        order = tile_order(counts, ids.shape[1])
    _launch("rasterize_dense_fwd", 8,
            (records, ids, counts, charts, cam_info, out, ncon, order),
            (*_geometry(grid, charts, ids), int(lean)), dev)
    rasterize_dense_fwd.launches += 1
    return out, ncon


def rasterize_dense_bwd(records, ids, counts, charts, cam_info, maps,
                        ncontrib, gmaps, grid: TileGrid, lean: bool = False,
                        order=None):
    """Gradients of the training forward's first 12 maps: returns
    ``(d_records (N, 32), d_charts (N, Ch, Cw, 3))``.

    ``maps`` (14, H, W) and ``ncontrib`` (H, W) are ``rasterize_dense_fwd``'s
    outputs for the same inputs, ``gmaps`` (12, H, W) the cotangents of its
    first 12 channels; ``order`` is ``tile_order(counts, s_max)``, computed
    here if not given. ``records`` must be 16-byte aligned. CPU tensors run
    the plain version (``rasterize.backward_walk``); CUDA tensors launch
    the kernel (and raise if it cannot launch).
    """
    check_inputs(records, ids, counts, charts, cam_info, grid, order)
    dev = records.device
    check_residuals(maps, ncontrib, gmaps, dev, grid)
    if dev.type == "cpu":
        return plain.backward_walk(records, ids, counts, charts, cam_info,
                                   maps, ncontrib, gmaps, grid, lean=lean)
    d_rec = torch.zeros_like(records)
    d_ch = torch.zeros_like(charts)
    if order is None:
        order = tile_order(counts, ids.shape[1])
    _launch("rasterize_dense_bwd", 11,
            (records, ids, counts, charts, cam_info, maps, ncontrib, gmaps,
             d_rec, d_ch, order),
            (*_geometry(grid, charts, ids), int(lean)), dev)
    rasterize_dense_bwd.launches += 1
    return d_rec, d_ch


# kernel launches since the last reset (CPU calls do not count;
# ``launch_counts``)
counted(rasterize_dense_eval)
counted(rasterize_dense_fwd)
counted(rasterize_dense_bwd)


def bwd_launch_smem(tile_h: int, tile_w: int) -> int:
    """Bytes of shared memory a launch of the dense backward takes at
    ``tile_h x tile_w`` tiles: its static arrays and the tile's 14
    per-pixel planes. The chart pad does not enter it."""
    from . import _build

    fn = _build.load("rasterize_dense_bwd").gstex_rasterize_dense_bwd_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(tile_h, tile_w)
