"""Quaternion utilities (counterpart of ``gstex_tpu/ops/quat.py``).

Quaternions are (w, x, y, z), the 2DGS/gsplat ply order.
"""

from __future__ import annotations

import math

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


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion, normalized.

    Branch-free (a select over the four standard cases), as the JAX
    package's, which mirrors ``rotations.matrix_to_quaternion`` used by
    fix_init (reference ``gstex.py:661``).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    # case w: trace dominant
    sw = safe_sqrt(1.0 + tr) * 0.5
    qw = (sw, (m21 - m12) / (4.0 * sw), (m02 - m20) / (4.0 * sw),
          (m10 - m01) / (4.0 * sw))
    # case x dominant
    sx = safe_sqrt(1.0 + m00 - m11 - m22) * 0.5
    qx = ((m21 - m12) / (4.0 * sx), sx, (m01 + m10) / (4.0 * sx),
          (m02 + m20) / (4.0 * sx))
    # case y dominant
    sy = safe_sqrt(1.0 - m00 + m11 - m22) * 0.5
    qy = ((m02 - m20) / (4.0 * sy), (m01 + m10) / (4.0 * sy), sy,
          (m12 + m21) / (4.0 * sy))
    # case z dominant
    sz = safe_sqrt(1.0 - m00 - m11 + m22) * 0.5
    qz = ((m10 - m01) / (4.0 * sz), (m02 + m20) / (4.0 * sz),
          (m12 + m21) / (4.0 * sz), sz)

    use_w = tr > 0.0
    use_x = ~use_w & (m00 >= m11) & (m00 >= m22)
    use_y = ~use_w & ~use_x & (m11 >= m22)
    q = torch.stack([
        torch.where(use_w, a, torch.where(use_x, b, torch.where(use_y, c, d)))
        for a, b, c, d in zip(qw, qx, qy, qz)], dim=-1)
    return normalize_quat(q)


def random_quats(n: int, generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """(n, 4) uniform random unit quaternions (reference ``gstex.py:68-83``),
    from ``(u, v, w)`` uniform in [0, 1) drawn with ``generator``."""
    u, v, w = torch.rand((3, n), generator=generator, device=device)
    return quats_from_uniform(u, v, w)


def quats_from_uniform(u: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """The unit quaternions of ``random_quats`` for given uniforms."""
    two_pi = 2.0 * math.pi
    return torch.stack([
        torch.sqrt(1.0 - u) * torch.sin(two_pi * v),
        torch.sqrt(1.0 - u) * torch.cos(two_pi * v),
        torch.sqrt(u) * torch.sin(two_pi * w),
        torch.sqrt(u) * torch.cos(two_pi * w),
    ], dim=-1)


def fix_init_rotation(quats: torch.Tensor) -> torch.Tensor:
    """COLMAP coordinate fix: rows (x, y, z) -> (x, z, −y) of the rotation
    matrix (reference ``gstex.py:656-661``), returned as quaternions."""
    rm = quat_to_rotmat(quats)
    fixed = torch.stack([rm[..., 0, :], rm[..., 2, :], -rm[..., 1, :]],
                        dim=-2)
    return rotmat_to_quat(fixed)


def fix_init_points(xyz: torch.Tensor) -> torch.Tensor:
    """COLMAP coordinate fix for points: (x, y, z) -> (x, z, −y)
    (reference ``gstex.py:651-654``)."""
    return torch.stack([xyz[..., 0], xyz[..., 2], -xyz[..., 1]], dim=-1)
