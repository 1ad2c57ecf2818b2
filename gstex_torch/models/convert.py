"""Bridge from the JAX package's parameter containers to the port's.

``params_from_jax`` takes the numpy leaves of a ``gstex_tpu``
``GStexParams`` / ``GStexBuffers`` (for example after
``jax.tree.map(np.asarray, params)``) and needs nothing of JAX itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .gstex import GStexBuffers, GStexParams


def params_from_jax(params_np, buffers_np, device=None):
    """Port tensors from objects with the JAX containers' field names
    (NamedTuples or anything with those attributes) whose leaves are
    array-likes. Dtypes are kept (float32 leaves, int32 ``texture_hw``)."""
    dev = resolve_device(device)
    conv = lambda src, cls: cls(*(
        torch.as_tensor(np.array(getattr(src, f)), device=dev)
        for f in cls._fields))
    return conv(params_np, GStexParams), conv(buffers_np, GStexBuffers)
