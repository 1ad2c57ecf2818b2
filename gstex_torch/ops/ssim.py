"""SSIM as separable depthwise convolutions (counterpart of
``gstex_tpu/ops/ssim.py``).

Matches ``pytorch_msssim.SSIM(data_range=1.0, size_average=True,
channel=3)``: 11x11 Gaussian window (sigma 1.5), VALID padding,
K1 = 0.01, K2 = 0.03. The convolutions run in float32 (the package turns
cuDNN's TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalized 1-D window, float32."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable VALID Gaussian blur of an (H, W, C) image: rows, then
    columns."""
    c = x.shape[-1]
    k = win.shape[0]
    y = x.permute(2, 0, 1)[None]                        # (1, C, H, W)
    y = F.conv2d(y, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    y = F.conv2d(y, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return y[0].permute(1, 2, 0)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
             win_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Per-window SSIM values, (H - w + 1, W - w + 1, C)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = torch.as_tensor(gaussian_window(win_size, sigma), device=img1.device,
                          dtype=img1.dtype)
    mu1 = _blur(img1, win)
    mu2 = _blur(img2, win)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, win) - mu1_sq
    sigma2_sq = _blur(img2 * img2, win) - mu2_sq
    sigma12 = _blur(img1 * img2, win) - mu12
    cs = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return ((2.0 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair. Differentiable."""
    return ssim_map(img1, img2, data_range, win_size, sigma).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = ((img1 - img2) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
