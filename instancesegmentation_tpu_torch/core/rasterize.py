"""Mask rasterisation without cv2: the start of the port's copy of
``instancesegmentation_tpu/core/rasterize.py``.

``fill_ellipse`` is ``cv2.ellipse(mask, center, axes, angle, 0, 360, color,
-1)`` (a filled ellipse, line type 8) by cv2's own algorithm, so that the
port's synthetic datasets hold the JAX package's masks:

- the polygon: ``ellipse2Poly`` with the angular step that ``cv::ellipse``
  picks from the larger axis, on cv2's 7-digit sine table, the vertices
  rounded to 16-bit fixed point (``XY_SHIFT``);
- ``fill_convex_poly``: ``FillConvexPoly`` in that fixed point: every edge
  drawn as an 8-connected line (``Line2``), then the scanline fill between
  the left and right edges.

All arithmetic is on Python integers where cv2's is on int64, with C's
truncating division where cv2 divides.
"""
from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

#: sin of 0..450 degrees to 7 decimals, as float32: cv2's ``SinTable``
_SIN_TABLE = np.array([round(math.sin(math.radians(d)), 7) for d in range(451)],
                      np.float32).astype(np.float64)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _cround(v: float) -> int:
    """``cvRound``: round half to even."""
    return int(np.rint(v))


def ellipse_poly(center, axes, angle: int, delta: int) -> list:
    """``cv::ellipse2Poly`` (double form) of a whole ellipse (arc 0-360):
    the polygon's vertices as floats in the units of ``center`` and
    ``axes``, one every ``delta`` degrees."""
    angle = int(angle) % 360
    alpha = _SIN_TABLE[450 - angle]   # cos, float32 in cv2
    beta = _SIN_TABLE[angle]          # sin
    pts = []
    for a in range(0, 360 + delta, delta):
        a = min(a, 360)
        x = axes[0] * _SIN_TABLE[450 - a]
        y = axes[1] * _SIN_TABLE[a]
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    return pts


def _clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """``cv::clipLine`` on the fixed-point image ``w x h`` (already scaled):
    clips ``p1``, ``p2`` in place; False when the line misses the image."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _line2(img: np.ndarray, p1, p2, color: int) -> None:
    """``Line2``: an 8-connected line between two fixed-point points."""
    h, w = img.shape
    pt1, pt2 = list(p1), list(p2)
    if not _clip_line(w << XY_SHIFT, h << XY_SHIFT, pt1, pt2):
        return
    dx, dy = pt2[0] - pt1[0], pt2[1] - pt1[1]
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        if j:  # walk left to right
            pt1, pt2 = pt2, pt1
        x_step, y_step = XY_ONE, _cdiv(((dy ^ j) - j) << XY_SHIFT, ax | 1)
        ecount = (pt2[0] - pt1[0]) >> XY_SHIFT
    else:
        if i:  # walk top to bottom
            pt1, pt2 = pt2, pt1
        x_step, y_step = _cdiv(((dx ^ i) - i) << XY_SHIFT, ay | 1), XY_ONE
        ecount = (pt2[1] - pt1[1]) >> XY_SHIFT
    x, y = pt1[0] + (XY_ONE >> 1), pt1[1] + (XY_ONE >> 1)

    def put(px: int, py: int) -> None:
        if 0 <= px < w and 0 <= py < h:
            img[py, px] = color

    put((pt2[0] + (XY_ONE >> 1)) >> XY_SHIFT, (pt2[1] + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x >>= XY_SHIFT
        while ecount >= 0:
            put(x, y >> XY_SHIFT)
            x += 1
            y += y_step
            ecount -= 1
    else:
        y >>= XY_SHIFT
        while ecount >= 0:
            put(x >> XY_SHIFT, y)
            x += x_step
            y += 1
            ecount -= 1


def fill_convex_poly(img: np.ndarray, pts: list, color: int) -> None:
    """``FillConvexPoly`` (line type 8) of fixed-point vertices ``pts``
    (``XY_SHIFT`` fractional bits) into the uint8 ``img [H, W]``, in place."""
    h, w = img.shape
    npts = len(pts)
    delta = XY_ONE >> 1
    delta1 = delta2 = XY_ONE >> 1
    xs_all = [p[0] for p in pts]
    ys_all = [p[1] for p in pts]
    ymin = min(ys_all)
    imin = ys_all.index(ymin)
    p0 = pts[-1]
    for p in pts:
        _line2(img, p0, p, color)
        p0 = p
    xmin = (min(xs_all) + delta) >> XY_SHIFT
    xmax = (max(xs_all) + delta) >> XY_SHIFT
    ymin = (ymin + delta) >> XY_SHIFT
    ymax = (max(ys_all) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = idx0 + e["di"]
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (pts[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = pts[idx0][0], pts[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += e["di"]
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            x1 = (edge[left]["x"] + delta1) >> XY_SHIFT
            x2 = (edge[right]["x"] + delta2) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def fill_ellipse(mask: np.ndarray, center, axes, angle: float, color: int = 255) -> np.ndarray:
    """``cv2.ellipse(mask, center, axes, angle, 0, 360, color, -1)`` on a
    uint8 ``mask [H, W]``, in place (and returned): integer ``center`` and
    ``axes``, ``angle`` in degrees (rounded to an integer, as cv2 does)."""
    cx, cy = (int(v) << XY_SHIFT for v in center)
    aw, ah = (abs(int(v)) << XY_SHIFT for v in axes)
    big = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    pts = []
    for fx, fy in ellipse_poly((float(cx), float(cy)), (float(aw), float(ah)),
                               _cround(angle), delta):
        px = _cround(fx / XY_ONE) << XY_SHIFT
        py = _cround(fy / XY_ONE) << XY_SHIFT
        pt = (px + _cround(fx - px), py + _cround(fy - py))
        if not pts or pt != pts[-1]:
            pts.append(pt)
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    fill_convex_poly(mask, pts, color)
    return mask
