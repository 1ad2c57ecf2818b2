"""Eval image metrics with uint8 quantization (counterpart of
``gstex_tpu/utils/metrics.py``).

As the reference's ``get_image_metrics_and_images``, the prediction is
quantized to uint8 before PSNR and SSIM are taken. LPIPS needs the
AlexNet weights, which the port does not carry, so ``lpips`` is reported
as ``None``: the JAX package reports the same when it finds no weight
file, and a stand-in number would not compare to the reference's metric.
"""

from __future__ import annotations

import torch

from ..ops.ssim import psnr, ssim


def quantize_uint8(img: torch.Tensor) -> torch.Tensor:
    """``img`` clipped to [0, 1], cast to uint8 levels and back to
    float32 in [0, 1]."""
    q = (255.0 * torch.clamp(img, 0.0, 1.0)).to(torch.uint8)
    return q.to(torch.float32) / 255.0


def image_metrics(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """PSNR and SSIM of the uint8-quantized prediction ``pred`` (H, W, 3)
    against ``gt``; ``lpips`` is ``None``."""
    pred_q = quantize_uint8(pred)
    return {"psnr": float(psnr(gt, pred_q)),
            "ssim": float(ssim(gt, pred_q)),
            "lpips": None}
