"""LPIPS (Learned Perceptual Image Patch Similarity), AlexNet variant
(counterpart of ``gstex_tpu/utils/lpips.py``).

LPIPS v0.1 (Zhang et al., CVPR 2018), the eval metric the reference
reports through ``torchmetrics``:

1. inputs scaled to [-1, 1], then normalized by the fixed LPIPS
   shift/scale constants;
2. the AlexNet feature stack (5 conv stages, a tap after each ReLU);
3. each tap unit-normalized over its channels;
4. squared differences weighted by the learned non-negative 1x1 "lin"
   weights, averaged over space and summed over the taps.

The weights come from the JAX package's 15-array ``.npz`` (``conv{i}_w``
(O, I, kh, kw), ``conv{i}_b`` (O,), ``lin{i}_w`` (C,) for i in 0..4), so
one file serves both packages: ``GSTEX_LPIPS_NPZ``, else
``weights/lpips_alex.npz`` at the repository's root. None is fetched or
committed; without a file ``find`` returns None and the eval metrics
report ``lpips: None``. The convolutions are ``torch.nn.functional``'s,
on the images' device.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# fixed input normalization (lpips.ScalingLayer constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet feature config: (out_ch, kernel, stride, pad, maxpool_before)
_ALEX_CFG = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
CHANNELS = [c for c, *_ in _ALEX_CFG]
KEYS = ([f"conv{i}_{s}" for i in range(5) for s in ("w", "b")]
        + [f"lin{i}_w" for i in range(5)])

DEFAULT_PATH = Path(__file__).resolve().parents[2] / "weights" / \
    "lpips_alex.npz"


def _features(w: dict, x: torch.Tensor) -> list:
    """The 5 unit-normalized feature taps of x (1, 3, H, W) in [-1, 1]."""
    shift = torch.tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    taps = []
    for i, (_, _, stride, pad, pool_before) in enumerate(_ALEX_CFG):
        if pool_before:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = F.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"],
                            stride=stride, padding=pad))
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        taps.append(x / (norm + 1e-10))
    return taps


class LPIPS:
    """Callable LPIPS metric over the weights of the module's note."""

    def __init__(self, weights: dict):
        missing = set(KEYS) - set(weights)
        if missing:
            raise ValueError(f"LPIPS weights missing keys: {sorted(missing)}")
        self.weights = {k: torch.as_tensor(np.asarray(weights[k],
                                                      np.float32))
                        for k in KEYS}

    def _on(self, device) -> dict:
        if self.weights["conv0_w"].device != torch.device(device):
            self.weights = {k: v.to(device) for k, v in self.weights.items()}
        return self.weights

    @torch.no_grad()
    def __call__(self, img0, img1) -> float:
        """LPIPS distance between two (H, W, 3) images in [0, 1], on the
        first image's device."""
        img0 = torch.as_tensor(img0, dtype=torch.float32)
        img1 = torch.as_tensor(img1, dtype=torch.float32,
                               device=img0.device)
        w = self._on(img0.device)
        a = img0.permute(2, 0, 1)[None] * 2 - 1
        b = img1.permute(2, 0, 1)[None] * 2 - 1
        total = torch.zeros((), device=img0.device)
        for i, (xa, xb) in enumerate(zip(_features(w, a), _features(w, b))):
            val = torch.sum((xa - xb) ** 2 * w[f"lin{i}_w"][None, :, None,
                                                             None], dim=1)
            total = total + torch.mean(val)
        return float(total)


def load(path) -> LPIPS:
    with np.load(path) as data:
        return LPIPS({k: data[k] for k in data.files})


def weight_path() -> Optional[Path]:
    """The weight file to use: ``GSTEX_LPIPS_NPZ``, else
    ``weights/lpips_alex.npz`` at the repository's root, where it exists;
    else None."""
    env = os.environ.get("GSTEX_LPIPS_NPZ")
    for p in ([Path(env)] if env else []) + [DEFAULT_PATH]:
        if p.is_file():
            return p
    return None


def find() -> Optional[LPIPS]:
    """The LPIPS metric of ``weight_path()``'s file, or None when there is
    none."""
    path = weight_path()
    return load(path) if path is not None else None
