"""Real spherical harmonics for view-dependent color (counterpart of
``gstex_tpu/ops/sh.py``).

The SH dc coefficient is zeroed in the view-dependent term (the albedo,
with its +0.5 offset, lives in the per-texel texture), so no offset or
clamp is applied here.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

MAX_SH_DEGREE = 3


def num_sh_bases(degree: int) -> int:
    """(degree+1)^2."""
    return (degree + 1) ** 2


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> dc coefficient."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    """dc coefficient -> RGB."""
    return sh * C0 + 0.5


def eval_sh_bases(dirs: torch.Tensor) -> torch.Tensor:
    """All 16 real SH basis functions (degrees 0..3, 3DGS signs) at unit
    directions ``(..., 3)`` -> ``(..., 16)``."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    b = [
        torch.full_like(x, C0),
        -C1 * y,
        C1 * z,
        -C1 * x,
        C2[0] * xy,
        C2[1] * yz,
        C2[2] * (2.0 * zz - xx - yy),
        C2[3] * xz,
        C2[4] * (xx - yy),
        C3[0] * y * (3.0 * xx - yy),
        C3[1] * xy * z,
        C3[2] * y * (4.0 * zz - xx - yy),
        C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        C3[4] * x * (4.0 * zz - xx - yy),
        C3[5] * z * (xx - yy),
        C3[6] * x * (xx - 3.0 * yy),
    ]
    return torch.stack(b, dim=-1)


def spherical_harmonics(active_degree: int, dirs: torch.Tensor,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """View-dependent color ``(..., 3)`` from SH coefficients
    ``(..., K, 3)`` at unit view directions ``(..., 3)``; bases above
    ``active_degree`` are masked out."""
    k = coeffs.shape[-2]
    bases = eval_sh_bases(dirs)[..., :k]
    basis_degree = torch.tensor(
        [d for d in range(MAX_SH_DEGREE + 1) for _ in range(2 * d + 1)],
        device=dirs.device)[:k]
    bases = bases * (basis_degree <= int(active_degree)).to(bases.dtype)
    return torch.einsum("...k,...kc->...c", bases, coeffs)
