"""Keypoint-list -> common-format body_keypoint conversion, shared by the
COCO and OCHuman converters (copy of the JAX package's
``data/converters/keypoints.py``):

- 17 triplets  -> COCO part order, visibility {0: missing, 1: not_vis,
  2: vis},
- 19 triplets  -> OCHuman part order, visibility {0: missing, 1: vis,
  2/3 (self/others-occluded): not_vis}.

Coordinates are truncated to int.
"""
from __future__ import annotations

import numpy as np

from instancesegmentation_tpu_torch.core.keys import (
    COCO_PART_NAMES,
    COCO_VISIBILITY_MAP,
    OCHUMAN_PART_NAMES,
    OCHUMAN_VISIBILITY_MAP,
    key_combine,
)


def get_body_keypoint(kpt) -> dict:
    """Convert a flat [x, y, v] * N keypoint list (N in {17, 19})."""
    kpt = np.asarray(kpt, dtype=np.int32).reshape(-1, 3)
    npart = kpt.shape[0]
    if npart == 17:
        part_names, key_map = COCO_PART_NAMES, COCO_VISIBILITY_MAP
    elif npart == 19:
        part_names, key_map = OCHUMAN_PART_NAMES, OCHUMAN_VISIBILITY_MAP
    else:
        raise ValueError(f"unsupported keypoint count {npart} (need 17 or 19)")

    body_keypoint = {}
    for (x, y, v), name in zip(kpt, part_names):
        body_keypoint[key_combine(name, "sub_dict")] = {
            key_combine("status", "keypoint_status"): key_map[int(v)],
            key_combine("point", "point_xy"): [int(x), int(y)],
        }
    return body_keypoint
