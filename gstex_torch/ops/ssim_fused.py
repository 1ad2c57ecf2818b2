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

import torch

from .ssim import gaussian_window, ssim

WIN = 11
R = WIN - 1   # valid-window margin
HALO = 16     # the TPU kernel's row halo; it sets which shapes it takes
TILE = 32     # the CUDA kernel's output tile (TILE x TILE pixels)


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
    from . import _build

    lib = _build.load("ssim_fused")
    fn = lib.gstex_ssim_fused
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    taps = torch.as_tensor(gaussian_window(WIN, 1.5), device=dev)
    n_blocks = -(-h // TILE) * -(-w // TILE) * c
    partial = torch.empty(n_blocks, dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    grad = torch.empty_like(pred)
    c1 = float((0.01 * data_range) ** 2)
    c2 = float((0.03 * data_range) ** 2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(pred.data_ptr(), gt.data_ptr(), taps.data_ptr(),
                partial.data_ptr(), loss.data_ptr(), grad.data_ptr(), h, w,
                c, c1, c2, stream)
    if rc != 0:
        raise RuntimeError(f"ssim_fused kernel launch failed: cudaError {rc}")
    fused_ssim_value_and_grad.launches += 1
    return loss, grad


# kernel launches since the last reset (CPU calls do not count)
fused_ssim_value_and_grad.launches = 0


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
