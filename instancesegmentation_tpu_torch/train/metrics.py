"""Scalar logging and periodic image-grid dumps.

Port of ``instancesegmentation_tpu/train/metrics.py``: JSONL scalar logs
and ``image | target | overlay | prediction`` grids written as PNG by the
port's own encoder (``core/png.py``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.core.png import write_png
from instancesegmentation_tpu_torch.core.visualize import draw_mask, image_grid


class MetricLogger:
    """Appends one JSON record per ``log`` call to ``out_dir/<name>.jsonl``:
    the step, the seconds since the logger was made, and the scalars.

    ``enabled=False`` makes every method a no-op that touches no file: the
    ranks other than 0 of a data-parallel run pass it, so a shared
    ``out_dir`` has one writer."""

    def __init__(self, out_dir: str, name: str = "metrics", enabled: bool = True):
        self.enabled = enabled
        self.t0 = time.time()
        self.path = None
        self._f = None
        if not enabled:
            return
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, **scalars) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": round(time.time() - self.t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self.enabled:
            self._f.close()


def dump_image_grid(
    out_dir: str,
    tag: str,
    images: np.ndarray,    # [B, H, W, 3] in [-1, 1]
    targets: np.ndarray,   # [B, H, W, 1] in [0, 1]
    probs: np.ndarray,     # [B, H, W, 1] in [0, 1]
    max_rows: int = 4,
) -> Optional[str]:
    """Write an ``image | target | overlay | prediction`` grid PNG and
    return its path."""
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i in range(min(max_rows, images.shape[0])):
        img = ((np.asarray(images[i]) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        tgt = (np.asarray(targets[i, ..., 0]) * 255).astype(np.uint8)
        prd = (np.asarray(probs[i, ..., 0]) * 255).astype(np.uint8)
        mix = img.copy()
        draw_mask(mix, prd)
        tgt3 = np.repeat(tgt[..., None], 3, axis=-1)
        prd3 = np.repeat(prd[..., None], 3, axis=-1)
        rows.append([img, tgt3, mix, prd3])
    path = os.path.join(out_dir, f"{tag}.png")
    write_png(path, image_grid(rows))
    return path
