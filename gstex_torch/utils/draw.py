"""Thick polylines on a uint8 image, in numpy (the canvases of texture
painting, ``models/editing.py:EditSession.add_polyline``).

The JAX package draws them with ``cv2.polylines(img, [pts], False, color,
thickness)``: OpenCV's 8-connected rasteriser in 16.16 fixed point. Each
segment of a line thicker than one pixel is clipped to the image grown by
the thickness, then widened by half the thickness on each side into a
convex quadrilateral, filled by OpenCV's convex-polygon scan with its
outline drawn in; each vertex gets a filled disc of radius ``(thickness +
1) // 2`` by the midpoint circle. A line of thickness 1 is Bresenham's. The integer arithmetic below follows that
rasteriser step by step, so the pixels are OpenCV's; the machine that
runs the port has no cv2.
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _put(img, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _hline(img, y: int, x0: int, x1: int, color) -> None:
    """Pixels x0..x1 (inclusive) of row y, clipped to the image."""
    if 0 <= y < img.shape[0]:
        x0, x1 = max(x0, 0), min(x1, img.shape[1] - 1)
        if x0 <= x1:
            img[y, x0:x1 + 1] = color


def _trunc_div(a: float) -> int:
    """C's cast of a double to an integer: toward zero."""
    return int(math.trunc(a))


def _clip_line(width: int, height: int, p1: list, p2: list) -> bool:
    """OpenCV's ``clipLine`` on an image of ``width`` x ``height`` (in
    whatever fixed point the points are); clips ``p1`` and ``p2`` in
    place and says whether any of the segment is left."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False

    def code(p, full=True):
        c = (p[0] < 0) + (p[0] > right) * 2
        if full:
            c += (p[1] < 0) * 4 + (p[1] > bottom) * 8
        return c

    c1, c2 = code(p1), code(p2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            p1[0] += _trunc_div((a - p1[1]) * (p2[0] - p1[0])
                                / (p2[1] - p1[1]))
            p1[1] = a
            c1 = code(p1, full=False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            p2[0] += _trunc_div((a - p2[1]) * (p2[0] - p1[0])
                                / (p2[1] - p1[1]))
            p2[1] = a
            c2 = code(p2, full=False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                p1[1] += _trunc_div((a - p1[0]) * (p2[1] - p1[1])
                                    / (p2[0] - p1[0]))
                p1[0] = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                p2[1] += _trunc_div((a - p2[0]) * (p2[1] - p1[1])
                                    / (p2[0] - p1[0]))
                p2[0] = a
                c2 = 0
    return (c1 | c2) == 0


def _line_fixed(img, p1, p2, color) -> None:
    """OpenCV's ``Line2``, the outline of a filled polygon: an
    8-connected line between two 16.16 fixed-point points, clipped in
    fixed point."""
    h, w = img.shape[:2]
    p1, p2 = list(p1), list(p2)
    if not _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            p1, p2 = p2, p1
            dy = -dy
        y_step = _trunc_div_int(dy * XY_ONE, ax | 1)
        ecount = (p2[0] - p1[0]) >> XY_SHIFT
    else:
        if dy < 0:
            p1, p2 = p2, p1
            dx = -dx
        x_step = _trunc_div_int(dx * XY_ONE, ay | 1)
        ecount = (p2[1] - p1[1]) >> XY_SHIFT
    x1 = p1[0] + (XY_ONE >> 1)
    y1 = p1[1] + (XY_ONE >> 1)
    _put(img, (p2[0] + (XY_ONE >> 1)) >> XY_SHIFT,
         (p2[1] + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _trunc_div_int(a: int, b: int) -> int:
    """C's integer division: the quotient rounded toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line(img, p0, p1, color) -> None:
    """OpenCV's 8-connected ``LineIterator`` walk between integer points,
    left to right, both ends drawn, clipped to the image first."""
    h, w = img.shape[:2]
    p0, p1 = list(p0), list(p1)
    if not _clip_line(w, h, p0, p1):
        return
    (x, y), (x1, y1) = p0, p1
    if x1 < x:
        x, y, x1, y1 = x1, y1, x, y
    dx, dy = x1 - x, y1 - y
    ystep = 1 if dy >= 0 else -1
    dy = abs(dy)
    xmajor = dy <= dx
    if not xmajor:
        dx, dy = dy, dx
    err = dx - 2 * dy
    for _ in range(dx + 1):
        _put(img, x, y, color)
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if xmajor:
            x += 1
            y += ystep if minor else 0
        else:
            y += ystep
            x += 1 if minor else 0


def _fill_convex(img, pts, color) -> None:
    """OpenCV's ``FillConvexPoly`` at shift 16 for 8-connected lines: the
    outline, then a scan of each row between its two edges."""
    h, w = img.shape[:2]
    npts = len(pts)
    delta = XY_ONE >> 1
    p0 = pts[-1]
    imin = 0
    xmin = xmax = pts[0][0]
    ymin = ymax = pts[0][1]
    for i, p in enumerate(pts):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line_fixed(img, p0, p, color)
        p0 = p
    xmin = (xmin + delta) >> XY_SHIFT
    xmax = (xmax + delta) >> XY_SHIFT
    ymin = (ymin + delta) >> XY_SHIFT
    ymax = (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while edges > 0:
                    edges -= 1
                    ty = (pts[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = pts[idx0][0], pts[idx][0]
                        e["ye"] = ty
                        e["dx"] = _trunc_div_int((xe - xs) * 2 + (ty - y),
                                                 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = ((1, 0) if edge[0]["x"] > edge[1]["x"]
                           else (0, 1))
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, xx1, xx2, color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _disc(img, cx: int, cy: int, radius: int, color) -> None:
    """OpenCV's filled ``Circle``: the midpoint circle's spans."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img, p0, p1, color, thickness: int, caps: int) -> None:
    """OpenCV's ``ThickLine`` at shift 0, 8-connected; bit 1 of ``caps``
    draws the disc at p0, bit 2 the one at p1. The segment is first
    clipped to the image grown by ``thickness`` on every side."""
    if thickness <= 1:
        _line(img, p0, p1, color)
        return
    h, w = img.shape[:2]
    m = thickness
    p0, p1 = [p0[0] + m, p0[1] + m], [p1[0] + m, p1[1] + m]
    if not _clip_line(w + 2 * m, h + 2 * m, p0, p1):
        return
    p0, p1 = (p0[0] - m, p0[1] - m), (p1[0] - m, p1[1] - m)
    q0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    q1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (q0[0] - q1[0]) / XY_ONE
    dy = (q1[1] - q0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        # cvRound: to nearest, ties to even
        ddx, ddy = round(dy * r), round(dx * r)
        _fill_convex(img, [(q0[0] + ddx, q0[1] + ddy),
                           (q0[0] - ddx, q0[1] - ddy),
                           (q1[0] - ddx, q1[1] - ddy),
                           (q1[0] + ddx, q1[1] + ddy)], color)
    radius = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for i, q in enumerate((q0, q1)):
        if caps & (i + 1):
            _disc(img, (q[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                  (q[1] + (XY_ONE >> 1)) >> XY_SHIFT, radius, color)


def polyline(img: np.ndarray, points, color, thickness: int = 1) -> None:
    """Draw the open polyline through ``points`` ((x, y) pixel pairs) on
    ``img`` (H, W[, C]) uint8 in place, as ``cv2.polylines(img, [points],
    False, color, thickness)`` draws it."""
    if thickness < 0:
        raise ValueError("thickness must be >= 0")
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    color = np.asarray(color, img.dtype)
    if not pts:
        return
    caps = 3
    p0 = pts[0]
    for p in pts[1:]:
        _thick_line(img, p0, p, color, thickness, caps)
        p0 = p
        caps = 2
