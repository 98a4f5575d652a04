"""Box utilities (xyxy convention, x1/y1 exclusive).

Copy of ``instancesegmentation_tpu/core/boxes.py`` (numpy only).

Replaces ``ymlib.dataset_visual.mask2box`` (reference usage at
train_instance.py:161-164: a mask spanning the whole image must yield
``[0, 0, w, h]`` so that the crop-pad arithmetic at :166-171 produces a
symmetric 16px pad) and provides the box algebra needed by proposal
matching (ops/matching.py).
"""
from __future__ import annotations

import numpy as np


def mask2box(mask: np.ndarray) -> list[int] | None:
    """Tight xyxy box (exclusive upper bounds) around nonzero mask pixels.

    Returns None for an all-zero mask (reference train_instance.py:163
    falls back to the whole image in that case).
    """
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return None
    return [int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1]


def box_area(boxes: np.ndarray) -> np.ndarray:
    """Areas of [N,4] xyxy boxes."""
    boxes = np.asarray(boxes, dtype=np.float64)
    w = np.clip(boxes[..., 2] - boxes[..., 0], 0, None)
    h = np.clip(boxes[..., 3] - boxes[..., 1], 0, None)
    return w * h


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU matrix of [N,4] x [M,4] xyxy boxes -> [N,M]."""
    a = np.asarray(a, dtype=np.float64).reshape(-1, 4)
    b = np.asarray(b, dtype=np.float64).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def box_center(box) -> tuple[float, float]:
    """(cx, cy) of one xyxy box."""
    x0, y0, x1, y1 = box
    return (x0 + x1) / 2.0, (y0 + y1) / 2.0
