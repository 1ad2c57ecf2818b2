"""Per-frame splat preparation: activations, SH color, projection, screen
AABBs (counterpart of ``gstex_tpu/ops/prepare.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sh as sh_ops
from .camera import Camera, project_points, surfel_aabb_2d, viewmat_from_c2w
from .quat import normalize_quat, quat_to_rotmat
from .surfel import SplatGeom


class PreparedSplats(NamedTuple):
    geom: SplatGeom
    depths: torch.Tensor    # (N,) view z of centers
    centers: torch.Tensor   # (N,2) screen AABB centers
    extents: torch.Tensor   # (N,2) screen AABB half extents
    valid: torch.Tensor     # (N,) bool


def activate_scales(log_scales: torch.Tensor):
    """l = clamp(exp(s), 1e-9) for the two surfel axes."""
    l = torch.clamp(torch.exp(log_scales), min=1e-9)
    return l[..., 0], l[..., 1]


def prepare_splats(means, log_scales, quats, opacity_logits, features_dc,
                   features_rest, mappings, cam: Camera, active_sh_degree,
                   sh_degree: int = 3, fix_init: bool = False,
                   extent_sigma: float = 3.0) -> PreparedSplats:
    """Activate raw parameters for one camera. Shapes: means (N,3),
    log_scales (N,2), quats (N,4) wxyz, opacity_logits (N,1) or (N,),
    features_dc (N,3), features_rest (N,K-1,3), mappings (N,2)."""
    viewmat = viewmat_from_c2w(cam.c2w)
    R = quat_to_rotmat(normalize_quat(quats))
    ax1, ax2, normal = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    l0, l1 = activate_scales(log_scales)
    opacity = torch.sigmoid(opacity_logits.reshape(-1))

    if sh_degree > 0:
        # the dc coefficient is zeroed in the view-dependent color; view
        # directions use the (detached) means
        coeffs = torch.cat(
            [torch.zeros_like(features_dc[:, None, :]), features_rest], dim=1)
        viewdirs = means.detach() - cam.c2w[:3, 3]
        viewdirs = viewdirs / (torch.linalg.norm(viewdirs, dim=-1,
                                                 keepdim=True) + 1e-12)
        if fix_init:
            # (x, y, z) -> (x, -z, y)
            viewdirs = torch.stack(
                [viewdirs[..., 0], -viewdirs[..., 2], viewdirs[..., 1]],
                dim=-1)
        rgb = sh_ops.spherical_harmonics(active_sh_degree, viewdirs, coeffs)
    else:
        rgb = torch.sigmoid(features_dc)

    xys, depths = project_points(means, viewmat, cam.intrins)
    centers, extents, valid = surfel_aabb_2d(
        means, l0, l1, R, viewmat, cam.intrins, extent_sigma=extent_sigma)
    valid = valid & (depths > 1e-6)

    geom = SplatGeom(mean=means, ax1=ax1, ax2=ax2, normal=normal, l0=l0,
                     l1=l1, opacity=opacity, rgb=rgb, xy=xys,
                     uv_scale=mappings)
    return PreparedSplats(geom=geom, depths=depths, centers=centers,
                          extents=extents, valid=valid)
