"""Quaternion utilities (counterpart of ``gstex_tpu/ops/quat.py``).

Quaternions are (w, x, y, z), the 2DGS/gsplat ply order.
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions along the last axis."""
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix.

    Normalizes first. Columns are the surfel axes: R[..., :, 0] = ax1 (u),
    R[..., :, 1] = ax2 (v), R[..., :, 2] = normal.
    """
    q = normalize_quat(q)
    w, x, y, z = q.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)
