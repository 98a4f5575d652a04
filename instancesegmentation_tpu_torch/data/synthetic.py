"""Synthetic host batch for benchmarks, smoke runs and tests.

Port of ``instancesegmentation_tpu/data/synthetic.py:synthetic_host_batch``
(numpy only): the same contract, so the JAX package and the port are fed
identical batches from one seed.
"""
from __future__ import annotations

import numpy as np


def synthetic_host_batch(b: int, canvas: int = 640, seed: int = 1) -> dict:
    """Random host batch in the ``predict_instances`` layout: uint8 canvases
    and masks, float32 image sizes, boxes and (x, y, vis) keypoints, with all
    geometry proportional to the canvas."""
    rng = np.random.default_rng(seed)
    lo, hi = int(canvas * 0.094), int(canvas * 0.844)
    m1, m2, m3 = (int(canvas * f) for f in (0.03125, 0.0625, 0.09375))
    return {
        "image": rng.integers(0, 255, size=(b, canvas, canvas, 3), dtype=np.uint8),
        "mask": (rng.random((b, canvas, canvas)) > 0.7).astype(np.uint8) * 255,
        "image_hw": np.full((b, 2), canvas, np.float32),
        "obj_box": np.tile(
            np.asarray([lo - m1, lo - m1, hi + m1, hi + m3], np.float32), (b, 1)
        ),
        "mask_box": np.tile(np.asarray([lo, lo, hi, hi + m2], np.float32), (b, 1)),
        "mask_valid": np.ones((b,), bool),
        "keypoints": np.concatenate(
            [
                rng.uniform(lo, hi, size=(b, 17, 2)).astype(np.float32),
                np.ones((b, 17, 1), np.float32),
            ],
            axis=-1,
        ),
    }
