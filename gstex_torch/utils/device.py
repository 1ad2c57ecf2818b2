"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: a missing
GPU is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None means ``"cuda"``) as a ``torch.device``; raises if
    it names CUDA and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gstex_torch runs on a CUDA device unless told otherwise, and "
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
