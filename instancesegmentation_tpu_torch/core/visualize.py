"""Drawing helpers for the training's image grids and the dataset
converters' ``mix`` previews: the port's copy of
``instancesegmentation_tpu/core/visualize.py``.  All functions draw in place
on RGB uint8 ``[H, W, 3]`` images.

``draw_box`` is ``cv2.rectangle`` (line type 8, thickness 2 by default) and
``draw_keypoint`` a filled ``cv2.circle`` (line type 8) by cv2's own
algorithms, clipped at the image's edges as cv2 clips them:

- a rectangle is cv2's ``PolyLine`` of its four corners: each side a
  ``ThickLine``, i.e. a quadrilateral half the thickness to either side in
  16-bit fixed point (``core/rasterize.py:fill_convex_poly``) and a filled
  circle of half the thickness at its end (thickness 1: an 8-connected
  line);
- a filled circle is cv2's integer ``Circle``: horizontal spans from the
  midpoint walk of its octant.

``draw_label`` is ``cv2.putText`` with ``FONT_HERSHEY_SIMPLEX``, which cv2
5.0 draws in its embedded TrueType font (``core/text.py:put_text``):
``draw_keypoint(labeled=True)`` names each point with it.
"""
from __future__ import annotations

import math

import numpy as np

from instancesegmentation_tpu_torch.core.keys import key_combine, key_decompose
from instancesegmentation_tpu_torch.core.rasterize import (
    XY_ONE,
    XY_SHIFT,
    _line8,
    fill_convex_poly,
)
from instancesegmentation_tpu_torch.core.text import put_text

DEFAULT_COLORS = (
    (255, 0, 0), (255, 255, 0), (0, 255, 0),
    (0, 255, 255), (0, 0, 255), (255, 0, 255),
)


def draw_mask(image: np.ndarray, mask: np.ndarray, color=(0, 255, 0), alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend ``color`` over pixels where ``mask > 127``."""
    sel = mask > 127
    overlay = np.asarray(color, dtype=np.float32)
    image[sel] = (image[sel].astype(np.float32) * (1 - alpha) + overlay * alpha).astype(np.uint8)
    return image


def _circle(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """cv2's ``Circle(..., fill=1)``: a filled circle of ``color`` into
    ``img`` ([H, W] or [H, W, C]), clipped."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, x0, x1 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and x1 >= 0 and x0 < w:
                img[y, max(x0, 0):min(x1, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = int(err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(shape: np.ndarray, p0, p1, thickness: int) -> None:
    """cv2's ``ThickLine`` (line type 8) of integer points into the uint8
    ``shape [H, W]``: above thickness 1 with the round cap at ``p1`` only
    (``PolyLine``'s flags 2)."""
    if thickness <= 1:
        _line8(shape, p0, p1, 1)
        return
    x0, y0 = p0[0] << XY_SHIFT, p0[1] << XY_SHIFT
    x1, y1 = p1[0] << XY_SHIFT, p1[1] << XY_SHIFT
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        ex, ey = int(np.rint(dy * r)), int(np.rint(dx * r))
        fill_convex_poly(shape, [(x0 + ex, y0 + ey), (x0 - ex, y0 - ey),
                                 (x1 - ex, y1 - ey), (x1 + ex, y1 + ey)], 1)
    _circle(shape, (x1 + (XY_ONE >> 1)) >> XY_SHIFT, (y1 + (XY_ONE >> 1)) >> XY_SHIFT,
            (half + (XY_ONE >> 1)) >> XY_SHIFT, 1)


def draw_box(image: np.ndarray, box, color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    """Draw an xyxy box outline: ``cv2.rectangle(image, (x0, y0),
    (x1 - 1, y1 - 1), color, thickness)`` of the rounded corners."""
    if box is None:
        return image
    x0, y0, x1, y1 = [int(round(v)) for v in box]
    corners = [(x0, y0), (x1 - 1, y0), (x1 - 1, y1 - 1), (x0, y1 - 1)]
    shape = np.zeros(image.shape[:2], np.uint8)
    p0 = corners[-1]
    for p in corners:
        _thick_line(shape, p0, p, thickness)
        p0 = p
    image[shape > 0] = np.asarray(color, np.uint8)[:image.shape[2]]
    return image


def draw_label(image: np.ndarray, text: str, origin, color=(255, 255, 255), thickness: int = 1, scale: float = 0.6) -> np.ndarray:
    """Draw a text label with its top-left corner at ``origin``:
    ``cv2.putText(image, str(text), (x, y + 14), cv2.FONT_HERSHEY_SIMPLEX,
    scale, color, thickness, cv2.LINE_AA)`` of the truncated origin."""
    x, y = int(origin[0]), int(origin[1])
    put_text(image, str(text), (x, y + 14), scale, color, thickness)
    return image


def draw_keypoint(image: np.ndarray, body_keypoint: dict, labeled: bool = False, radius: int = 3) -> np.ndarray:
    """Draw a common-format ``body_keypoint`` sub_dict: visible points in
    green, occluded (not_vis) in orange, missing points skipped; with
    ``labeled`` each point's name at ``(x + radius, y - radius)``, scale
    0.35, in its colour."""
    status_key = key_combine("status", "keypoint_status")
    point_key = key_combine("point", "point_xy")
    for key, kp in body_keypoint.items():
        name, key_type = key_decompose(key)
        if key_type != "sub_dict" or not isinstance(kp, dict):
            continue
        status = kp.get(status_key, "missing")
        if status == "missing":
            continue
        x, y = kp[point_key]
        color = (0, 255, 0) if status == "vis" else (255, 165, 0)
        _circle(image, int(x), int(y), radius, np.asarray(color, np.uint8)[:image.shape[2]])
        if labeled:
            draw_label(image, name, (x + radius, y - radius), color=color, scale=0.35)
    return image


def image_grid(rows) -> np.ndarray:
    """Stack a list of rows (each a list of same-height HWC images) into one image."""
    return np.concatenate([np.concatenate(list(r), axis=1) for r in rows], axis=0)
