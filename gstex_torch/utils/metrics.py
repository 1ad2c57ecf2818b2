"""Eval image metrics with uint8 quantization (counterpart of
``gstex_tpu/utils/metrics.py``).

As the reference's ``get_image_metrics_and_images``, the prediction is
quantized to uint8 before PSNR, SSIM and LPIPS are taken. LPIPS is the
AlexNet LPIPS v0.1 of ``utils/lpips.py``; it needs a weight file
(``GSTEX_LPIPS_NPZ``, else ``weights/lpips_alex.npz``), which the port
does not carry. Where there is none, ``lpips`` is reported as ``None``:
the JAX package reports the same, and a stand-in number would not compare
to the reference's metric.
"""

from __future__ import annotations

import torch

from ..ops.ssim import psnr, ssim
from . import lpips as lpips_mod

# the loaded metric, by weight file: loaded once, looked for each call
_lpips_models: dict = {}


def quantize_uint8(img: torch.Tensor) -> torch.Tensor:
    """``img`` clipped to [0, 1], cast to uint8 levels and back to
    float32 in [0, 1]."""
    q = (255.0 * torch.clamp(img, 0.0, 1.0)).to(torch.uint8)
    return q.to(torch.float32) / 255.0


def lpips(pred: torch.Tensor, gt: torch.Tensor):
    """LPIPS of ``pred`` against ``gt`` (H, W, 3) where a weight file
    exists (``lpips.weight_path``), else None."""
    path = lpips_mod.weight_path()
    if path is None:
        return None
    if path not in _lpips_models:
        _lpips_models[path] = lpips_mod.load(path)
    return _lpips_models[path](pred, gt)


def image_metrics(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """PSNR, SSIM and LPIPS (None without a weight file) of the
    uint8-quantized prediction ``pred`` (H, W, 3) against ``gt``."""
    pred_q = quantize_uint8(pred)
    return {"psnr": float(psnr(gt, pred_q)),
            "ssim": float(ssim(gt, pred_q)),
            "lpips": lpips(pred_q, gt)}
