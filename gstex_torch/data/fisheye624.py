"""Fisheye624 (FisheyeRadTanThinPrism) camera model, host-side numpy
(counterpart of ``gstex_tpu/data/fisheye624.py``, whose numpy this module
copies; the remap is ``data/undistort.py:remap_linear``, cv2's
``remap(INTER_LINEAR)`` without cv2).

The reference supports this 16-parameter model (fx fy cx cy, k0..k5 radial,
p0 p1 tangential, s0..s3 thin-prism) for cache-time undistortion of aria-style
captures (``nerfstudio/cameras/camera_utils.py:634`` ``fisheye624_project``,
``nerfstudio/data/datamanagers/full_images_datamanager.py:421-517``
FISHEYE624 branch). Undistortion follows the reference's recipe: estimate the
FOV of the crop circle by unprojecting four boundary points, build a
``2r x 2r`` pinhole target whose focal matches that FOV, forward-project the
target rays through the distortion model, and remap; pixels whose source
falls outside the crop circle are masked.
"""

from __future__ import annotations

import numpy as np

from .undistort import remap_linear

_EPS = 1e-9


def fisheye624_project(xyz: np.ndarray, params: np.ndarray) -> np.ndarray:
    """Project (N,3) camera-space points with the 16-param Fisheye624 model.

    params: [fx fy cx cy k0..k5 p0 p1 s0..s3]. Returns (N,2) pixel uv.
    (reference math: ``camera_utils.py:634-716``)"""
    fx, fy, cx, cy = params[:4]
    k = params[4:10]
    p0, p1 = params[10:12]
    s0, s1, s2, s3 = params[12:16]
    z = xyz[:, 2]
    z = np.where(np.abs(z) < _EPS, np.where(z < 0, -_EPS, _EPS), z)
    a = xyz[:, 0] / z
    b = xyz[:, 1] / z
    r = np.hypot(a, b)
    th = np.arctan(r)
    th_k = th.copy()
    for i in range(6):
        th_k = th_k + k[i] * th ** (3 + 2 * i)
    inv_r = np.where(r < _EPS, 1.0, 1.0 / np.maximum(r, _EPS))
    xr = np.where(r < _EPS, a, th_k * a * inv_r)
    yr = np.where(r < _EPS, b, th_k * b * inv_r)
    rd2 = xr * xr + yr * yr
    rd4 = rd2 * rd2
    u = xr + (2 * xr * xr + rd2) * p0 + 2 * xr * yr * p1 + s0 * rd2 + s1 * rd4
    v = yr + (2 * yr * yr + rd2) * p1 + 2 * xr * yr * p0 + s2 * rd2 + s3 * rd4
    return np.stack([fx * u + cx, fy * v + cy], axis=-1)


def fisheye624_unproject(uv: np.ndarray, params: np.ndarray,
                         iters: int = 20) -> np.ndarray:
    """Invert the projection: (N,2) pixels -> (N,3) unit camera rays.

    Fixed-point removal of tangential/thin-prism terms, then Newton on the
    odd radial polynomial (the reference's unproject helper strategy)."""
    fx, fy, cx, cy = params[:4]
    k = params[4:10]
    p0, p1 = params[10:12]
    s0, s1, s2, s3 = params[12:16]
    un = (uv[:, 0] - cx) / fx
    vn = (uv[:, 1] - cy) / fy
    xr, yr = un.copy(), vn.copy()
    for _ in range(iters):
        rd2 = xr * xr + yr * yr
        rd4 = rd2 * rd2
        du = (2 * xr * xr + rd2) * p0 + 2 * xr * yr * p1 + s0 * rd2 + s1 * rd4
        dv = (2 * yr * yr + rd2) * p1 + 2 * xr * yr * p0 + s2 * rd2 + s3 * rd4
        xr = un - du
        yr = vn - dv
    th_d = np.hypot(xr, yr)
    th = th_d.copy()
    for _ in range(iters):
        f = th.copy()
        fp = np.ones_like(th)
        for i in range(6):
            f = f + k[i] * th ** (3 + 2 * i)
            fp = fp + (3 + 2 * i) * k[i] * th ** (2 + 2 * i)
        th = th - (f - th_d) / np.maximum(fp, _EPS)
    r = np.tan(th)
    scale = np.where(th_d < _EPS, 1.0, r / np.maximum(th_d, _EPS))
    d = np.stack([xr * scale, yr * scale, np.ones_like(th)], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def undistort_fisheye624(img: np.ndarray, params: np.ndarray,
                         crop_radius: float):
    """Rectify a Fisheye624 image to pinhole.

    Returns (undistorted image, mask uint8, new fx, fy, cx, cy) following
    ``full_images_datamanager.py:421-517``: a ``2r x 2r`` output whose focal
    matches the FOV of the crop circle."""
    fx, fy, cx, cy = params[:4]
    bounds = np.array([
        [cx, cy - crop_radius],
        [cx, cy + crop_radius],
        [cx - crop_radius, cy],
        [cx + crop_radius, cy],
    ], np.float64)
    d = fisheye624_unproject(bounds, params)
    fov = max(
        float(np.arccos(np.clip(np.dot(d[0], d[1]), -1, 1))),
        float(np.arccos(np.clip(np.dot(d[2], d[3]), -1, 1))),
    )
    uh = uw = int(crop_radius * 2)
    f_new = uh / (2 * np.tan(fov / 2.0))
    cx_new = (uw - 1) / 2.0
    cy_new = (uh - 1) / 2.0

    us, vs = np.meshgrid(np.arange(uw, dtype=np.float64),
                         np.arange(uh, dtype=np.float64))
    rays = np.stack([(us.ravel() - cx_new) / f_new,
                     (vs.ravel() - cy_new) / f_new,
                     np.ones(us.size)], axis=-1)
    src = fisheye624_project(rays, params)
    map_x = src[:, 0].reshape(uh, uw).astype(np.float32)
    map_y = src[:, 1].reshape(uh, uw).astype(np.float32)
    out = remap_linear(img, map_x, map_y)
    inside = ((map_x - cx) ** 2 + (map_y - cy) ** 2
              <= crop_radius * crop_radius)
    mask = inside.astype(np.uint8)
    return out, mask, float(f_new), float(f_new), float(cx_new), float(cy_new)
