"""Pinhole camera model and 2D-surfel projection (counterpart of
``gstex_tpu/ops/camera.py``).

Conventions (the same as the JAX package):
- ``c2w`` is the nerfstudio camera-to-world (3,4): +x right, +y up, the
  camera looks along −z (OpenGL).
- ``viewmat`` is world-to-camera in the gsplat convention (+z forward,
  y down), obtained by flipping the y/z columns, ``R ← R·diag(1,−1,−1)``.
- Continuous pixel coordinate ``px`` equals the column/row index at pixel
  centers; projection is ``px = fx·X/Z + cx − 0.5``.

The diag(1,−1,−1) flip is applied as an exact column negation, never as a
matrix product, so no reduced-precision product can round the rotation.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """One pinhole camera; intrinsics are 0-d float32 tensors."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    height: int
    width: int
    c2w: torch.Tensor  # (3,4) nerfstudio/OpenGL convention

    @property
    def intrins(self):
        return (self.fx, self.fy, self.cx, self.cy)


def make_camera(fx, fy, cx, cy, height, width, c2w, device=None) -> Camera:
    """Camera with float32 intrinsics and c2w on ``device`` (default
    cuda)."""
    dev = resolve_device(device)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    c2w = f32(c2w)[:3, :4].contiguous()
    return Camera(f32(fx), f32(fy), f32(cx), f32(cy), int(height),
                  int(width), c2w)


def stack_cameras(cams) -> Camera:
    """Same-size cameras as one ``Camera`` whose intrinsics are (n,)
    tensors and ``c2w`` (n, 3, 4): a scan's input
    (``train/step.py:make_train_scan``)."""
    h, w = cams[0].height, cams[0].width
    if any(c.height != h or c.width != w for c in cams):
        raise ValueError("stack_cameras requires equal resolutions")
    stack = lambda f: torch.stack([getattr(c, f) for c in cams])
    return Camera(stack("fx"), stack("fy"), stack("cx"), stack("cy"), h, w,
                  stack("c2w"))


def _flip_yz(R: torch.Tensor) -> torch.Tensor:
    """R · diag(1, −1, −1), exactly."""
    return torch.cat([R[..., :, :1], -R[..., :, 1:3]], dim=-1)


def viewmat_from_c2w(c2w: torch.Tensor) -> torch.Tensor:
    """(3,4) nerfstudio c2w -> (4,4) gsplat world-to-camera."""
    R_inv = _flip_yz(c2w[:3, :3]).T
    T_inv = -(R_inv @ c2w[:3, 3:4])
    view = torch.eye(4, dtype=c2w.dtype, device=c2w.device)
    view[:3, :3] = R_inv
    view[:3, 3:4] = T_inv
    return view


def camera_origin(c2w: torch.Tensor) -> torch.Tensor:
    """World-space camera center."""
    return c2w[:3, 3]


def camera_rotation_gsplat(c2w: torch.Tensor) -> torch.Tensor:
    """(3,3) camera-to-world rotation in the gsplat (z-forward)
    convention."""
    return _flip_yz(c2w[:3, :3])


def project_points(means: torch.Tensor, viewmat: torch.Tensor, intrins):
    """Project world points through the viewmat and pinhole intrinsics.

    Returns ``xys`` (N,2) continuous pixel coords (x=column, y=row) and
    ``depths`` (N,) view-space z.
    """
    fx, fy, cx, cy = intrins
    p = means @ viewmat[:3, :3].T + viewmat[:3, 3]
    z = p[..., 2]
    safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    x = fx * p[..., 0] / safe_z + cx - 0.5
    y = fy * p[..., 1] / safe_z + cy - 0.5
    return torch.stack([x, y], dim=-1), z


def pixel_ray_dirs(px_x: torch.Tensor, px_y: torch.Tensor,
                   cam: Camera) -> torch.Tensor:
    """World-space ray directions with unit view-space z for continuous
    pixel coords, so the ray parameter ``t`` is the view depth."""
    dx = (px_x + 0.5 - cam.cx) / cam.fx
    dy = (px_y + 0.5 - cam.cy) / cam.fy
    d_cam = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
    return d_cam @ camera_rotation_gsplat(cam.c2w).T


def ray_dirs_typed(px_x: torch.Tensor, px_y: torch.Tensor, cam: Camera,
                   camera_type: str = "perspective") -> torch.Tensor:
    """World-space ray directions of continuous pixel coords for the
    perspective, fisheye (equidistant) and equirectangular camera types
    (``gstex_tpu/ops/camera.py:ray_dirs_typed``, the reference's
    ``Cameras.generate_rays`` direction math in this module's OpenCV camera
    frame). Perspective rays keep unit view z; fisheye and equirectangular
    rays are unit length."""
    if camera_type == "perspective":
        return pixel_ray_dirs(px_x, px_y, cam)
    x = (px_x + 0.5 - cam.cx) / cam.fx
    y = (px_y + 0.5 - cam.cy) / cam.fy
    if camera_type == "fisheye":
        # equidistant: the angle from the axis is the normalized radius
        theta = torch.clamp(torch.sqrt(x * x + y * y), max=torch.pi)
        sinc = torch.where(theta < 1e-9, torch.ones_like(theta),
                           torch.sin(theta) / torch.clamp(theta, min=1e-9))
        d_cam = torch.stack([x * sinc, y * sinc, torch.cos(theta)], dim=-1)
    elif camera_type == "equirectangular":
        # fx = fy = height = width / 2: x in [-1, 1], y in [-1/2, 1/2]
        theta = -torch.pi * x
        phi = torch.pi * (0.5 + y)
        d_cam = torch.stack([-torch.sin(theta) * torch.sin(phi),
                             -torch.cos(phi),
                             torch.cos(theta) * torch.sin(phi)], dim=-1)
    else:
        raise ValueError(f"unsupported camera_type {camera_type}")
    return d_cam @ camera_rotation_gsplat(cam.c2w).T


def surfel_aabb_2d(means, l0, l1, rotmats, viewmat, intrins,
                   extent_sigma: float = 3.0, aa_margin: float = 3.0,
                   near: float = 0.01):
    """Screen-space AABB of each 2D surfel: the projected AABB of its
    ±extent_sigma·σ parallelogram corners, padded by ``aa_margin`` pixels
    for the screen-space low-pass filter.

    Returns centers (N,2), extents (N,2) half-sizes in pixels and valid
    (N,) bool (False: behind the near plane).
    """
    fx, fy, cx, cy = intrins
    ax1 = rotmats[..., :, 0]
    ax2 = rotmats[..., :, 1]
    e1 = extent_sigma * l0[..., None] * ax1
    e2 = extent_sigma * l1[..., None] * ax2
    corners = torch.stack(
        [means + e1 + e2, means + e1 - e2, means - e1 + e2, means - e1 - e2],
        dim=-2)                                               # (N,4,3)
    pv = corners @ viewmat[:3, :3].T + viewmat[:3, 3]
    z = pv[..., 2]
    valid = z.max(dim=-1).values > near
    zc = torch.clamp(z, min=near)
    x = fx * pv[..., 0] / zc + cx - 0.5
    y = fy * pv[..., 1] / zc + cy - 0.5
    x_min, x_max = x.min(dim=-1).values, x.max(dim=-1).values
    y_min, y_max = y.min(dim=-1).values, y.max(dim=-1).values
    centers = torch.stack([(x_min + x_max) * 0.5, (y_min + y_max) * 0.5],
                          dim=-1)
    extents = torch.stack([(x_max - x_min) * 0.5 + aa_margin,
                           (y_max - y_min) * 0.5 + aa_margin], dim=-1)
    return centers, extents, valid
