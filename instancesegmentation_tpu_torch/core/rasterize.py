"""Mask rasterisation and the COCO mask codecs without cv2: the port's copy
of ``instancesegmentation_tpu/core/rasterize.py``.

``fill_ellipse`` is ``cv2.ellipse(mask, center, axes, angle, 0, 360, color,
-1)`` (a filled ellipse, line type 8) by cv2's own algorithm, so that the
port's synthetic datasets hold the JAX package's masks:

- the polygon: ``ellipse2Poly`` with the angular step that ``cv::ellipse``
  picks from the larger axis, on cv2's 7-digit sine table, the vertices
  rounded to 16-bit fixed point (``XY_SHIFT``);
- ``fill_convex_poly``: ``FillConvexPoly`` in that fixed point: every edge
  drawn as an 8-connected line (``Line2``), then the scanline fill between
  the left and right edges.

``polygons_to_mask`` is ``cv2.fillPoly`` (line type 8, no fractional bits)
by cv2's algorithm, ``fill_poly``: every edge drawn as an 8-connected line
(``LineIterator``), then the spans between the sorted crossings of each row
filled even-odd (``CollectPolyEdges`` + ``FillEdgeCollection``), so a
self-intersecting polygon, and the overlap of two polygons, fill as cv2's do.

The RLE codecs (uncompressed COCO RLE, column-major runs that start with the
count of zeros, and COCO's compressed string format) are numpy and plain
Python; ``ops/native`` holds the C++ run-merge IoU that mask AP uses.

All arithmetic is on Python integers where cv2's is on int64, with C's
truncating division where cv2 divides.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

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


# ---------------------------------------------------------------------------
# polygons
# ---------------------------------------------------------------------------

def _line8(img: np.ndarray, p0, p1, color: int) -> None:
    """``Line``: cv2's 8-connected ``LineIterator`` (left to right) between
    two integer points, clipped to ``img``."""
    h, w = img.shape
    (x0, y0), (x1, y1) = p0, p1
    if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
        a, b = [x0, y0], [x1, y1]
        if not _clip_line(w, h, a, b):
            return
        (x0, y0), (x1, y1) = a, b
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = -1 if y1 < y0 else 1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += 2 * dx - 2 * dy if minor else -2 * dy
        if steep:
            y += sy
            x += minor
        else:
            x += 1
            y += sy if minor else 0


def _poly_edges(img: np.ndarray, pts: np.ndarray, color: int, edges: list) -> None:
    """``CollectPolyEdges`` (line type 8, shift 0) of one closed polygon:
    draws each edge with ``_line8`` and appends the non-horizontal ones to
    ``edges`` as ``(y_top, y_bottom, x at y_top, dx per row)``, x in
    ``XY_SHIFT`` fixed point.  An edge that leaves the image takes its x
    (and, unless the clipped line is horizontal, its rows) from the clipped
    line, as cv2 does."""
    h, w = img.shape
    p0 = pts[-1]
    for p1 in pts:
        (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
        p0 = p1
        t0, t1 = [x0, y0], [x1, y1]
        _line8(img, t0, t1, color)
        c0x, c0y, c1x, c1y = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            _clip_line(w, h, t0, t1)
            if t0[1] != t1[1]:
                c0y, c1y = t0[1], t1[1]
            c0x, c1x = t0[0] << XY_SHIFT, t1[0] << XY_SHIFT
        if y0 == y1:
            continue
        dx = _cdiv(c1x - c0x, c1y - c0y)
        if y0 < y1:
            edges.append((y0, y1, c0x + (y0 - c0y) * dx, dx))
        else:
            edges.append((y1, y0, c1x + (y1 - c1y) * dx, dx))


def fill_poly(img: np.ndarray, polygons: Sequence[np.ndarray], color: int = 255) -> np.ndarray:
    """``cv2.fillPoly(img, polygons, color)`` (line type 8, shift 0) on a
    uint8 ``img [H, W]``, in place (and returned): ``polygons`` is a list of
    integer ``[N, 2]`` (x, y) vertex arrays.  Each row is filled even-odd
    between the sorted crossings of all polygons' edges (a crossing at x
    fills from ``ceil(x)`` on the left of a span to ``floor(x)`` on its
    right); the edges themselves are drawn as lines."""
    h, w = img.shape
    edges: list = []
    for pts in polygons:
        _poly_edges(img, np.asarray(pts).reshape(-1, 2), color, edges)
    if len(edges) < 2:
        return img
    e = np.asarray(edges, np.int64)
    y0, y1, x, dx = e.T
    x_end = x + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x.max(), x_end.max()) < 0
            or min(x.min(), x_end.min()) >= w << XY_SHIFT):
        return img
    rows = np.arange(max(int(y0.min()), 0), min(int(y1.max()), h))
    if rows.size == 0:
        return img
    active = (rows[:, None] >= y0) & (rows[:, None] < y1)
    # rows' crossings, sorted; inactive edges sort last (a sentinel that
    # the ceil below cannot overflow)
    xs = np.where(active, x + (rows[:, None] - y0) * dx, np.iinfo(np.int64).max >> 1)
    xs.sort(axis=1)
    m = len(edges) // 2
    pair = np.arange(m) < (active.sum(1) // 2)[:, None]
    x1 = np.where(pair, (xs[:, 0:2 * m:2] + XY_ONE - 1) >> XY_SHIFT, w)
    x2 = np.where(pair, xs[:, 1:2 * m:2] >> XY_SHIFT, -1)
    for r, k in zip(*np.nonzero((x1 < w) & (x2 >= 0))):
        img[rows[r], max(x1[r, k], 0):min(x2[r, k], w - 1) + 1] = color
    return img


def polygons_to_mask(polygons: Sequence[Sequence[float]], height: int, width: int) -> np.ndarray:
    """Rasterize COCO-style polygons ([[x0,y0,x1,y1,...], ...]) to uint8 0/255:
    the vertices rounded half to even (``np.round``), polygons of fewer than
    3 points dropped, then ``fill_poly`` (``cv2.fillPoly``)."""
    mask = np.zeros((height, width), dtype=np.uint8)
    pts = [
        np.asarray(p, dtype=np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        fill_poly(mask, pts, 255)
    return mask


# ---------------------------------------------------------------------------
# uncompressed RLE
# ---------------------------------------------------------------------------

def rle_encode(mask: np.ndarray) -> dict:
    """Encode a binary mask as uncompressed COCO RLE.

    Runs are column-major (Fortran order) and start with the count of
    zeros, matching the COCO convention.
    """
    mask = np.asarray(mask)
    h, w = mask.shape
    flat = (mask.flatten(order="F") > 0).astype(np.int8)
    if flat.size == 0:
        return {"size": [h, w], "counts": []}
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate(([0], change, [flat.size]))
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_decode(rle: dict) -> np.ndarray:
    """Decode uncompressed COCO RLE to a uint8 0/255 mask."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], dtype=np.int64)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = np.concatenate(([0], np.cumsum(counts)))
    for i in range(1, len(counts), 2):  # odd runs are ones
        flat[pos[i]:pos[i + 1]] = 255
    return flat.reshape((h, w), order="F")


def rle_area(rle: dict) -> int:
    """Foreground pixel count of an RLE (sum of odd-indexed runs)."""
    return int(sum(rle["counts"][1::2]))


# ---------------------------------------------------------------------------
# compressed RLE (COCO string format)
# ---------------------------------------------------------------------------

def rle_to_string(rle: dict) -> str:
    """Compress RLE counts to the COCO ascii string format: 5-bit groups
    with a continuation flag, each count from the 4th on delta-coded against
    the count two before it."""
    counts = [int(c) for c in rle["counts"]]
    chars = []
    for i, cnt in enumerate(counts):
        x = cnt
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            chars.append(chr(c + 48))
    return "".join(chars)


def rle_from_string(s: str, height: int, width: int) -> dict:
    """Decompress a COCO ascii RLE string to uncompressed counts."""
    counts: list[int] = []
    i, n = 0, len(s)
    while i < n:
        x = k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return {"size": [height, width], "counts": counts}


# ---------------------------------------------------------------------------
# COCO segmentation field -> mask
# ---------------------------------------------------------------------------

def segmentation_to_mask(segm: Any, height: int, width: int) -> np.ndarray:
    """Rasterize a COCO ``segmentation`` field of any flavour to uint8 0/255:
    polygon lists, uncompressed RLE dicts (counts as a list) and compressed
    RLE dicts (counts as str or bytes)."""
    if isinstance(segm, dict):
        counts = segm["counts"]
        h, w = segm["size"]
        if isinstance(counts, (bytes, bytearray)):
            counts = counts.decode("ascii")
        if isinstance(counts, str):
            return rle_decode(rle_from_string(counts, h, w))
        return rle_decode(segm)
    return polygons_to_mask(segm, height, width)


def rle_iou(a: dict, b: dict) -> float:
    """IoU of two RLE masks, decoded (two empty masks: 1.0)."""
    ma = rle_decode(a) > 0
    mb = rle_decode(b) > 0
    union = np.logical_or(ma, mb).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(ma, mb).sum()) / float(union)
