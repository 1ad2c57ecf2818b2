"""Fused SSIM loss and gradient: the CUDA kernel ``csrc/ssim_fused.cu``,
its wrapper and its plain PyTorch version (counterpart of
``gstex_tpu/ops/ssim_fused.py``).

``fused_ssim(pred, gt)`` is the mean SSIM of ``ops/ssim.py`` (11x11
window, sigma 1.5, VALID, K1/K2 = 0.01/0.03). Its forward computes the
value and the gradient with respect to ``pred`` in one call and keeps
the gradient for the backward; ``gt`` gets none. The plain version is
``ops/ssim.py`` with ``torch.autograd.grad``. Kernel and plain version
compute in float32, as the TPU kernel does; their roundoff differs, so
each is checked against ``fused_ssim_reference`` on float64 copies of
the inputs (see the precision note in the kernel's source).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .launch_counts import counted
from .ssim import gaussian_window, ssim

WIN = 11
R = WIN - 1   # valid-window margin
HALO = 16     # the TPU kernel's row halo; it sets which shapes it takes
# The CUDA kernel's blocks each walk a strip of TILE_W output columns (its
# compile-time width, ``gstex_ssim_fused_tile_w``) and tile_h rows of one
# channel, in bands; the strips' height is chosen so that the grid fills
# the card's SMs once (``slots``: blocks an SM holds x SMs; 1 x 132 on the
# H100), and is at least MIN_TILE_H rows.
TILE_W = 118
MIN_TILE_H = 16
H100_SLOTS = 132


@dataclass(frozen=True)
class SSIMLaunch:
    """The kernel's launch over an (H, W, C) image: ``grid`` (x, y, z) of
    blocks, each walking ``tile_h`` x ``tile_w`` output pixels of one
    channel, and one double of ``partial`` per block."""
    height: int
    width: int
    channels: int
    tile_h: int
    tile_w: int

    @property
    def grid(self) -> tuple:
        return (-(-self.width // self.tile_w), -(-self.height // self.tile_h),
                self.channels)

    @property
    def n_partial(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    def own_windows(self, bx: int, by: int):
        """The window positions (rows, columns) whose SSIM block (bx, by,
        channel) adds to its partial sum."""
        r0, c0 = by * self.tile_h, bx * self.tile_w
        return (range(r0, min(r0 + self.tile_h, self.height - R)),
                range(c0, min(c0 + self.tile_w, self.width - R)))


def launch_geometry(h: int, w: int, c: int, slots: int = H100_SLOTS,
                    tile_w: int = TILE_W,
                    tile_h: int | None = None) -> SSIMLaunch:
    """The kernel's launch for an (h, w, c) image: strips of ``tile_w``
    columns and, unless given, as many rows as one wave of ``slots``
    blocks takes (the strips of one column and channel share the image's
    rows evenly)."""
    if tile_h is None:
        strips = max(1, slots // (-(-w // tile_w) * c))
        tile_h = max(MIN_TILE_H, -(-h // strips))
    if tile_h < 1 or tile_w < 2 or c < 1:
        raise ValueError(f"no SSIM launch with {tile_h}x{tile_w} strips "
                         f"for C={c}")
    return SSIMLaunch(h, w, c, tile_h, tile_w)


def _pick_band(h: int):
    """The TPU kernel's band height for ``h`` rows, or None."""
    for bh in (80, 64, 96, 48, 112, 40, 56, 72, 88, 104, 32, 24, 16, 8):
        if h % bh == 0 and h >= bh + 2 * HALO:
            return bh
    return None


def fused_ssim_supported(shape) -> bool:
    """The JAX package's rule for the fused path, so that ``loss_fn``
    takes the same branch in both packages."""
    h, w, c = shape
    return (_pick_band(h) is not None and w - R > 0
            and c * (w - R) >= 2 and h > R)


def fused_ssim_reference(pred, gt, data_range: float = 1.0):
    """Plain version: ``(mean SSIM, its gradient with respect to pred)``,
    in the inputs' dtype."""
    with torch.enable_grad():
        x = pred.detach().requires_grad_(True)
        value = ssim(x, gt.detach(), data_range)
        (grad,) = torch.autograd.grad(value, x)
    return value.detach(), grad


def fused_ssim_value_and_grad(pred, gt, data_range: float = 1.0):
    """``(mean SSIM (), d SSIM / d pred (H, W, C))``. CPU tensors run the
    plain version; CUDA tensors launch the kernel (and raise if it cannot
    launch)."""
    if pred.shape != gt.shape or pred.dim() != 3:
        raise ValueError(f"pred and gt must be one (H, W, C) shape, got "
                         f"{tuple(pred.shape)} and {tuple(gt.shape)}")
    for name, x in (("pred", pred), ("gt", gt)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
        if x.device != pred.device:
            raise ValueError(f"{name} is on {x.device}, pred on "
                             f"{pred.device}")
    h, w, c = pred.shape
    if h <= R or w <= R:
        raise ValueError(f"an {h}x{w} image has no {WIN}x{WIN} window")
    dev = pred.device
    if dev.type == "cpu":
        return fused_ssim_reference(pred, gt, data_range)
    if dev.type != "cuda":
        raise ValueError(f"fused_ssim runs on cpu or cuda, not {dev}")
    fn, slots, tile_w = _kernel(dev)
    geo = launch_geometry(h, w, c, slots=slots, tile_w=tile_w)
    partial = torch.empty(geo.n_partial, dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    grad = torch.empty_like(pred)
    c1 = float((0.01 * data_range) ** 2)
    c2 = float((0.03 * data_range) ** 2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(pred.data_ptr(), gt.data_ptr(), ctypes.addressof(_TAPS),
                partial.data_ptr(), loss.data_ptr(), grad.data_ptr(), h, w,
                c, geo.tile_h, c1, c2, stream)
    if rc != 0:
        raise RuntimeError(f"ssim_fused kernel launch failed: cudaError {rc}")
    fused_ssim_value_and_grad.launches += 1
    return loss, grad


# kernel launches since the last reset (CPU calls do not count;
# ``launch_counts``)
counted(fused_ssim_value_and_grad)


# the window's weights, as the kernel takes them (host memory)
_TAPS = (ctypes.c_float * WIN)(*gaussian_window(WIN, 1.5).tolist())
# per CUDA device index: the kernel's C entry, the blocks the card holds
# at once (one wave) and the kernel's strip width; filled at first use
_kernels: dict = {}


def _kernel(dev):
    k = _kernels.get(dev.index)
    if k is None:
        from . import _build

        lib = _build.load("ssim_fused")
        fn = lib.gstex_ssim_fused
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            per_sm = lib.gstex_ssim_fused_blocks_per_sm()
        if per_sm < 1:
            raise RuntimeError("ssim_fused: the kernel fits no SM")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        k = _kernels[dev.index] = (fn, per_sm * sms,
                                   lib.gstex_ssim_fused_tile_w())
    return k


def launch_smem() -> int:
    """Bytes of shared memory a launch takes: the kernel's static arrays,
    two bands of staged input rows and the passes' rows. Neither the
    image nor the strip's height enters it."""
    from . import _build

    return _build.load("ssim_fused").gstex_ssim_fused_smem()


class _FusedSSIM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, gt, data_range):
        value, grad = fused_ssim_value_and_grad(pred.contiguous(),
                                                gt.contiguous(), data_range)
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None, None


def fused_ssim(pred, gt, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) pair; gradient with respect to
    ``pred`` only (the training loss differentiates the render, never the
    ground truth)."""
    return _FusedSSIM.apply(pred, gt, data_range)
