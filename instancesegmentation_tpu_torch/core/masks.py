"""Binary-mask metrics and helpers.

Copy of ``instancesegmentation_tpu/core/masks.py`` (numpy only).

Replaces ``ymlib.eval_function.mask_iou`` (reference usage at
train_instance.py:398-403: inputs are uint8 arrays scaled 0..255, the
metric feeding the best-checkpoint gate).
"""
from __future__ import annotations

import numpy as np


def mask_iou(a: np.ndarray, b: np.ndarray, threshold: int = 127) -> float:
    """IoU of two uint8 masks, binarized at ``> threshold``.

    Two empty masks are defined as IoU 1.0 (identical).
    """
    a_bin = np.asarray(a) > threshold
    b_bin = np.asarray(b) > threshold
    union = np.logical_or(a_bin, b_bin).sum()
    if union == 0:
        return 1.0
    inter = np.logical_and(a_bin, b_bin).sum()
    return float(inter) / float(union)


def union_masks(masks) -> np.ndarray:
    """Bitwise-or of uint8 masks (the converters' segment_mask,
    reference transfer_coco.py:185)."""
    out = None
    for m in masks:
        out = m.copy() if out is None else (out | m)
    return out
