"""Lens undistortion with numpy, to the numbers and bytes of OpenCV
(counterpart of the cv2 calls in ``gstex_tpu/data/manager.py:63-85``).

- Perspective (OPENCV ``k1, k2, p1, p2, k3``):
  ``optimal_new_camera_matrix`` is ``cv2.getOptimalNewCameraMatrix(K, d,
  (w, h), alpha=0)``: the inner rectangle of a 9x9 border grid undistorted
  by the iterative ``undistortPoints`` (5 fixed-point steps);
  ``undistort`` is ``cv2.undistort(img, K, d, newCameraMatrix=newK)``:
  the undistortion map of ``initUndistortRectifyMap`` computed in the
  stripes of rows ``cv2.undistort`` computes it in, quantized to 1/32
  pixel, then ``remap_fixed``.
- Fisheye (``k1..k4``, equidistant): ``fisheye_new_camera_matrix`` is
  ``cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(balance=0)``,
  ``fisheye_undistort_map`` ``cv2.fisheye.initUndistortRectifyMap``
  (CV_32FC1), and the image goes through ``remap_linear``.
- ``remap_linear`` is ``cv2.remap(img, map_x, map_y, INTER_LINEAR,
  BORDER_CONSTANT)`` on uint8 images with float32 maps, which OpenCV 5
  interpolates in float32; ``remap_fixed`` is its path for maps in 1/32
  pixel (CV_16SC2, what ``cv2.undistort`` builds): the four taps weighted
  in 15-bit fixed point. Taps outside the image read as 0.

OpenCV's Python package ships no source; these follow its documented
algorithms and are held against cv2 in the tests.
"""

from __future__ import annotations

import numpy as np

INTER_BITS = 5
INTER_TAB = 1 << INTER_BITS
COEF_BITS = 15


# ---------------------------------------------------------------------------
# remap
# ---------------------------------------------------------------------------

def remap_fixed(img: np.ndarray, ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """Bilinear resampling of a uint8 (H, W[, C]) image at positions given
    in 1/32 pixel (int arrays of the output's shape), as cv2's fixed-point
    ``remapBilinear`` with a constant 0 border."""
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    h, w, c = src.shape
    flat = src.reshape(-1, c).astype(np.int32)
    ix = np.clip(ix, -(1 << 22), 1 << 22).astype(np.int32)
    iy = np.clip(iy, -(1 << 22), 1 << 22).astype(np.int32)
    sx, sy = ix >> INTER_BITS, iy >> INTER_BITS
    fx, fy = ix & (INTER_TAB - 1), iy & (INTER_TAB - 1)
    unit = 1 << (COEF_BITS - 2 * INTER_BITS)
    weights = ((INTER_TAB - fy) * (INTER_TAB - fx) * unit,
               (INTER_TAB - fy) * fx * unit,
               fy * (INTER_TAB - fx) * unit,
               fy * fx * unit)
    acc = np.full(ix.shape + (c,), 1 << (COEF_BITS - 1), np.int32)
    for (dy, dx), wgt in zip(((0, 0), (0, 1), (1, 0), (1, 1)), weights):
        x, y = sx + dx, sy + dy
        inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        tap = flat[np.clip(y, 0, h - 1) * w + np.clip(x, 0, w - 1)]
        acc += tap * (wgt * inside)[..., None]
    out = (acc >> COEF_BITS).astype(np.uint8)
    # a position whose four taps all lie outside is the border value
    outside = (sx >= w) | (sx + 1 < 0) | (sy >= h) | (sy + 1 < 0)
    out[outside] = 0
    return out[..., 0] if squeeze else out


def remap_linear(img: np.ndarray, map_x: np.ndarray,
                 map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR)`` (BORDER_CONSTANT
    0) for a uint8 (H, W[, C]) image and float32 (h, w) maps, as OpenCV 5
    computes it for float maps: in float32, x0 = floor(x), a = x − x0,
    each row pair interpolated as a·(p01 − p00) + p00, then the two rows
    as b·(t1 − t0) + t0, each a fused multiply-add, rounded to nearest
    (ties to even); taps outside the image read as 0."""
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    h, w, _ = src.shape
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    bad = ~(np.isfinite(mx) & np.isfinite(my))
    mx = np.clip(np.where(bad, -4, mx), -4, w + 4).astype(np.float32)
    my = np.clip(np.where(bad, -4, my), -4, h + 4).astype(np.float32)
    x0, y0 = np.floor(mx), np.floor(my)
    a = (mx - x0)[..., None]
    b = (my - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    pad = np.pad(src.astype(np.float32), ((2, 2), (2, 2), (0, 0)))

    def tap(dy, dx):
        return pad[np.clip(y0 + dy + 2, 0, h + 3),
                   np.clip(x0 + dx + 2, 0, w + 3)]

    def fma(x, y, z):
        # x·y + z rounded once to float32, as the fused multiply-add of
        # OpenCV's SIMD path: x·y is exact in float64 here, and so is
        # the sum in the first stage
        return (x.astype(np.float64) * y + z).astype(np.float32)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    t0 = fma(a, p01 - p00, p00)
    t1 = fma(a, p11 - p10, p10)
    out = np.clip(np.rint(fma(b, t1 - t0, t0)), 0, 255).astype(np.uint8)
    out[bad] = 0
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# perspective: OPENCV k1 k2 p1 p2 k3
# ---------------------------------------------------------------------------

def _inv3(a: np.ndarray) -> np.ndarray:
    """The 3x3 inverse by cofactors over the determinant, as OpenCV's
    ``Matx<double,3,3>::inv(DECOMP_LU)``; ``a`` may be (..., 3, 3)."""
    a = np.asarray(a, np.float64)
    m = lambda i, j: a[..., i, j]
    d = (m(0, 0) * (m(1, 1) * m(2, 2) - m(2, 1) * m(1, 2))
         - m(0, 1) * (m(1, 0) * m(2, 2) - m(2, 0) * m(1, 2))
         + m(0, 2) * (m(1, 0) * m(2, 1) - m(2, 0) * m(1, 1)))
    d = 1.0 / d
    return np.stack([
        (m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1)) * d,
        (m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2)) * d,
        (m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1)) * d,
        (m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2)) * d,
        (m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0)) * d,
        (m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2)) * d,
        (m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)) * d,
        (m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1)) * d,
        (m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0)) * d], axis=-1).reshape(
            a.shape)


def _coeffs(d) -> np.ndarray:
    """OpenCV's 14 distortion coefficients (k1 k2 p1 p2 k3 k4 k5 k6 s1..s4
    tx ty) from the leading ones given."""
    k = np.zeros(14)
    d = np.asarray(d, np.float64).ravel()
    k[:len(d)] = d
    return k


def undistort_points(pts: np.ndarray, K: np.ndarray, d,
                     iters: int = 5) -> np.ndarray:
    """(N, 2) distorted pixels -> (N, 2) normalized undistorted
    coordinates: ``cv2.undistortPoints(pts, K, d)`` with its default
    criteria (``iters`` fixed-point steps)."""
    k = _coeffs(d)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ifx, ify = 1.0 / fx, 1.0 / fy
    u, v = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    x0 = x = (u - cx) * ifx
    y0 = y = (v - cy) * ify
    done = np.zeros(len(u), bool)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                  / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
        # a negative icdist stops the iteration at the undistorted start
        stop = ~done & (icdist < 0)
        x = np.where(stop, x0, x)
        y = np.where(stop, y0, y)
        done |= stop
        dx = (2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2
              + k[9] * r2 * r2)
        dy = (k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2
              + k[11] * r2 * r2)
        x = np.where(done, x, (x0 - dx) * icdist)
        y = np.where(done, y, (y0 - dy) * icdist)
    return np.stack([x, y], axis=-1)


def optimal_new_camera_matrix(K, d, size) -> np.ndarray:
    """``cv2.getOptimalNewCameraMatrix(K, d, (w, h), alpha=0)[0]``: the
    camera that maps the inner rectangle of the undistorted 9x9 grid over
    the image's pixel centres, (w−1)/8 and (h−1)/8 apart, onto the whole
    (w, h) image."""
    w, h = size
    K = np.asarray(K, np.float64)
    n = 9
    ys, xs = np.mgrid[:n, :n].astype(np.float64)
    grid = np.stack([xs * (w - 1) / (n - 1), ys * (h - 1) / (n - 1)],
                    axis=-1).reshape(-1, 2)
    p = undistort_points(grid, K, d).reshape(n, n, 2)
    ix0, ix1 = p[:, 0, 0].max(), p[:, n - 1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[n - 1, :, 1].min()
    fx = (w - 1) / (ix1 - ix0)
    fy = (h - 1) / (iy1 - iy0)
    return np.array([[fx, 0, -fx * ix0], [0, fy, -fy * iy0], [0, 0, 1.0]])


def undistort_map_fixed(K, d, new_k, size, stripe: int | None = None):
    """``cv2.initUndistortRectifyMap(K, d, I, new_k, (w, h), CV_16SC2)`` as
    1/32-pixel positions (ix, iy), (h, w) each. With ``stripe`` rows, as
    ``cv2.undistort`` builds it: each stripe's map from its own first row,
    the camera's cy shifted up by that row. Along a row the column step
    is added once per column, as OpenCV accumulates it."""
    w, h = size
    k = _coeffs(d)
    K = np.asarray(K, np.float64)
    rows = np.arange(h)
    stripe = stripe or h
    row0 = rows // stripe * stripe
    ar = np.broadcast_to(np.asarray(new_k, np.float64), (h, 3, 3)).copy()
    ar[:, 1, 2] -= row0
    ir = _inv3(ar).reshape(h, 9)                     # one per row
    i = (rows - row0).astype(np.float64)

    def along(step, c1, c2):
        run = np.repeat(step[:, None], w, axis=1)
        run[:, 0] = i * c1 + c2
        return np.add.accumulate(run, axis=1)

    _x = along(ir[:, 0], ir[:, 1], ir[:, 2])
    _y = along(ir[:, 3], ir[:, 4], ir[:, 5])
    _w = along(ir[:, 6], ir[:, 7], ir[:, 8])
    ww = 1.0 / _w
    x, y = _x * ww, _y * ww
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = ((1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
          / (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2))
    xd = x * kr + k[2] * _2xy + k[3] * (r2 + 2 * x2) + k[8] * r2 \
        + k[9] * r2 * r2
    yd = y * kr + k[2] * (r2 + 2 * y2) + k[3] * _2xy + k[10] * r2 \
        + k[11] * r2 * r2
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return (np.rint(u * INTER_TAB).astype(np.int64),
            np.rint(v * INTER_TAB).astype(np.int64))


def undistort(img: np.ndarray, K, d, new_k) -> np.ndarray:
    """``cv2.undistort(img, K, d, newCameraMatrix=new_k)`` for a uint8
    image: the map in ``cv2.undistort``'s stripes of ``max(1, 4096 // w)``
    rows, remapped with a constant 0 border."""
    h, w = img.shape[:2]
    stripe = min(max(1, (1 << 12) // max(w, 1)), h)
    ix, iy = undistort_map_fixed(K, d, new_k, (w, h), stripe)
    return remap_fixed(img, ix, iy)


# ---------------------------------------------------------------------------
# fisheye (equidistant) k1..k4
# ---------------------------------------------------------------------------

def fisheye_undistort_points(pts: np.ndarray, K, d, iters: int = 10,
                             eps: float = 1e-8) -> np.ndarray:
    """(N, 2) distorted pixels -> (N, 2) normalized undistorted
    coordinates: ``cv2.fisheye.undistortPoints(pts, K, d)`` (Newton on
    θ, its default criteria)."""
    k = np.asarray(d, np.float64).ravel()[:4]
    f = (K[0][0], K[1][1])
    c = (K[0][2], K[1][2])
    out = []
    for px, py in np.asarray(pts, np.float64):
        wx, wy = (px - c[0]) / f[0], (py - c[1]) / f[1]
        theta_d = np.sqrt(wx * wx + wy * wy)
        theta_d = min(max(-np.pi / 2, theta_d), np.pi / 2)
        theta = theta_d
        converged = False
        scale = 0.0
        if abs(theta_d) > eps:
            for _ in range(iters):
                t2 = theta * theta
                t4 = t2 * t2
                t6 = t4 * t2
                t8 = t6 * t2
                k0t2, k1t4, k2t6, k3t8 = k[0] * t2, k[1] * t4, k[2] * t6, \
                    k[3] * t8
                fix = ((theta * (1 + k0t2 + k1t4 + k2t6 + k3t8) - theta_d)
                       / (1 + 3 * k0t2 + 5 * k1t4 + 7 * k2t6 + 9 * k3t8))
                theta = theta - fix
                if abs(fix) < eps:
                    converged = True
                    break
            scale = np.tan(theta) / theta_d
        else:
            converged = True
        flipped = (theta_d < 0 < theta) or (theta_d > 0 > theta)
        if converged and not flipped:
            out.append((wx * scale, wy * scale))
        else:
            out.append((-1e6, -1e6))
    return np.array(out, np.float64)


def fisheye_new_camera_matrix(K, d, size) -> np.ndarray:
    """``cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(K, d,
    (w, h), np.eye(3), balance=0)``."""
    w, h = size
    K = np.asarray(K, np.float64)
    pts = np.array([[w // 2, 0], [w, h // 2], [w // 2, h], [0, h // 2]],
                   np.float64)
    p = fisheye_undistort_points(pts, K, d)
    cn = p.mean(axis=0)
    aspect = K[0, 0] / K[1, 1]
    # to an aspect ratio of one: the y coordinates (OpenCV 5 scales the
    # centre's y with the points', where OpenCV 4 scaled its x)
    cn[1] *= aspect
    p[:, 1] *= aspect
    minx, maxx = p[:, 0].min(), p[:, 0].max()
    miny, maxy = p[:, 1].min(), p[:, 1].max()
    f1 = w * 0.5 / (cn[0] - minx)
    f2 = w * 0.5 / (maxx - cn[0])
    f3 = h * 0.5 * aspect / (cn[1] - miny)
    f4 = h * 0.5 * aspect / (maxy - cn[1])
    f = max(f1, f2, f3, f4)        # balance 0 takes the largest
    new_f = np.array([f, f])
    new_c = -cn * f + np.array([w, h * aspect]) * 0.5
    new_f[1] /= aspect
    new_c[1] /= aspect
    return np.array([[new_f[0], 0, new_c[0]], [0, new_f[1], new_c[1]],
                     [0, 0, 1.0]])


def fisheye_undistort_map(K, d, new_k, size):
    """``cv2.fisheye.initUndistortRectifyMap(K, d, I, new_k, (w, h),
    CV_32FC1)``: float32 (h, w) maps."""
    w, h = size
    K = np.asarray(K, np.float64)
    k = np.asarray(d, np.float64).ravel()[:4]
    ir = np.linalg.inv(np.asarray(new_k, np.float64))
    i = np.arange(h, dtype=np.float64)[:, None]
    first = np.zeros((1, w), bool)
    first[0, 0] = True

    def run(c0, c1, c2):
        return np.add.accumulate(np.where(first, i * c1 + c2, c0), axis=1)

    _x = run(ir[0, 0], ir[0, 1], ir[0, 2])
    _y = run(ir[1, 0], ir[1, 1], ir[1, 2])
    _w = run(ir[2, 0], ir[2, 1], ir[2, 2])
    x, y = _x / _w, _y / _w
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    t4 = t2 * t2
    t6 = t4 * t2
    t8 = t4 * t4
    theta_d = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8)
    scale = np.where(r == 0, 1.0, theta_d / np.where(r == 0, 1.0, r))
    u = K[0, 0] * x * scale + K[0, 2]
    v = K[1, 1] * y * scale + K[1, 2]
    behind = _w <= 0
    u = np.where(behind, np.where(_x > 0, -np.inf, np.inf), u)
    v = np.where(behind, np.where(_y > 0, -np.inf, np.inf), v)
    return u.astype(np.float32), v.astype(np.float32)
