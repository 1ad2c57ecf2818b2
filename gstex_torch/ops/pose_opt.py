"""Camera pose optimization: the SO(3)xR3 and SE(3) exp maps and the
correction they make (counterpart of ``gstex_tpu/ops/pose_opt.py``).

A learnable (num_cameras, 6) tangent array [t | ω] whose exp map
right-multiplies each training camera-to-world, trained with the model
under the ``camera_opt`` group (Adam 1e-3 → 5e-5, 100-step gradient
accumulation; ``train/optim.py:make_pose_optimizer``). Everything is
batched over (..., 6) tangents; the exp map runs inside the
differentiated render, so the pose gradient rides the model's backward.
"""

from __future__ import annotations

import torch

# the regularizer's weights
TRANS_L2_PENALTY = 1e-2
ROT_L2_PENALTY = 1e-3

MODES = ("off", "SO3xR3", "SE3")


def _skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues, the squared norm clamped at 1e-4:
    R = I + sin(θ)/θ K + (1 − cos θ)/θ² K²."""
    nrm2 = torch.clamp((w * w).sum(-1), min=1e-4)
    theta = torch.sqrt(nrm2)
    fac1 = (torch.sin(theta) / theta)[..., None, None]
    fac2 = ((1.0 - torch.cos(theta)) / nrm2)[..., None, None]
    k = _skew(w)
    return _eye_like(k) + fac1 * k + fac2 * (k @ k)


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """(..., 6) [t | ω] -> (..., 3, 4) [R | t]: the rotation from ω, the
    translation taken as it is (the direct-product group)."""
    r = _so3_exp(tangent[..., 3:])
    return torch.cat([r, tangent[..., :3, None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor) -> torch.Tensor:
    """(..., 6) [ρ | ω] in se(3) -> (..., 3, 4): the translation through
    V = I + (1 − cos θ)/θ² K + (θ − sin θ)/θ³ K², Taylor series below
    θ = 1e-2."""
    rho, w = tangent[..., :3], tangent[..., 3:]
    theta2 = (w * w).sum(-1)
    near = theta2 < 1e-4
    one = torch.ones_like(theta2)
    # sqrt's derivative is infinite at 0, where every delta starts, and
    # the where below would turn 0 · inf into NaN in the backward; theta
    # is read only by the branches away from 0, so guarding its argument
    # changes no value
    theta = torch.sqrt(torch.where(near, one, theta2))
    t_nz = torch.where(near, one, theta)
    t2_nz = torch.where(near, one, theta2)
    t3_nz = torch.where(near, one, theta2 * theta)

    sine = torch.sin(theta)
    cosine = torch.where(near, 8.0 / (4.0 + theta2) - 1.0, torch.cos(theta))
    sin_t = torch.where(near, 0.5 * cosine + 0.5, sine / t_nz)
    omc_t2 = torch.where(near, 0.5 * sin_t, (1.0 - cosine) / t2_nz)

    k = _skew(w)
    r = (cosine[..., None, None] * _eye_like(k)
         + sin_t[..., None, None] * k
         + omc_t2[..., None, None] * (w[..., :, None] * w[..., None, :]))

    sin_t_v = torch.where(near, 1.0 - theta2 / 6.0, sin_t)
    omc_t2_v = torch.where(near, 0.5 - theta2 / 24.0, omc_t2)
    tms_t3 = torch.where(near, 1.0 / 6.0 - theta2 / 120.0,
                         (theta - sine) / t3_nz)
    t = (sin_t_v[..., None] * rho
         + omc_t2_v[..., None] * torch.linalg.cross(w, rho, dim=-1)
         + tms_t3[..., None] * w * (w * rho).sum(-1, keepdim=True))
    return torch.cat([r, t[..., :, None]], dim=-1)


def exp_map(mode: str, tangent: torch.Tensor) -> torch.Tensor:
    if mode == "SO3xR3":
        return exp_map_SO3xR3(tangent)
    if mode == "SE3":
        return exp_map_SE3(tangent)
    raise ValueError(f"camera_opt mode {mode!r} (expected SO3xR3 | SE3)")


def apply_correction(c2w: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """c2w' = c2w @ [adj; 0 0 0 1]: the correction right-multiplies the
    (3, 4) camera-to-world (fp32: the package keeps TF32 off)."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=adj.dtype,
                          device=adj.device)
    return c2w @ torch.cat([adj, bottom], dim=0)


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """Norm over the last axis with a zero gradient at the origin, where
    the deltas start (the plain norm's gradient there is NaN)."""
    return torch.sqrt((x * x).sum(-1) + 1e-24)


def regularizer(delta: torch.Tensor) -> torch.Tensor:
    """1e-2 · mean ‖t‖ + 1e-3 · mean ‖ω‖ over the cameras."""
    return (TRANS_L2_PENALTY * _safe_norm(delta[:, :3]).mean()
            + ROT_L2_PENALTY * _safe_norm(delta[:, 3:]).mean())


def metrics(delta: torch.Tensor) -> dict:
    """``camera_opt_translation`` and ``camera_opt_rotation``: the
    Frobenius norms of every camera's t and ω together."""
    with torch.no_grad():
        return {"camera_opt_translation": torch.linalg.norm(delta[:, :3]),
                "camera_opt_rotation": torch.linalg.norm(delta[:, 3:])}
