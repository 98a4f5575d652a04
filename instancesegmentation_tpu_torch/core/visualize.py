"""Drawing helpers for the training's image grids.

Copy of ``draw_mask`` and ``image_grid`` of
``instancesegmentation_tpu/core/visualize.py`` (numpy only); its box,
label and keypoint drawing needs cv2 and is not ported yet.
"""
from __future__ import annotations

import numpy as np


def draw_mask(image: np.ndarray, mask: np.ndarray, color=(0, 255, 0), alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend ``color`` over pixels where ``mask > 127``."""
    sel = mask > 127
    overlay = np.asarray(color, dtype=np.float32)
    image[sel] = (image[sel].astype(np.float32) * (1 - alpha) + overlay * alpha).astype(np.uint8)
    return image


def image_grid(rows) -> np.ndarray:
    """Stack a list of rows (each a list of same-height HWC images) into one image."""
    return np.concatenate([np.concatenate(list(r), axis=1) for r in rows], axis=0)
