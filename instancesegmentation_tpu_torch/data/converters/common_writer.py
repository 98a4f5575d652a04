"""Shared writer for the common-format directory layout (the port's copy of
the JAX package's ``data/converters/common_writer.py``, writing through
``core/imwrite.py``).

Layout per image ``<name>``:
  image/<file>                    copied/encoded source image
  instance_mask/<name>/<i>.png    per-instance 0/255 masks
  segment_mask/<name>.png         union of instance masks
  class_mask/<name>/person.png    copy of the union (per-class)
  mix/<file>                      debug overlay render, encoded by the
                                  file's extension (a ``.jpg`` as cv2
                                  encodes it, byte for byte)
  data/<name>.json                the typed-key annotation record
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.core.imwrite import imwrite
from instancesegmentation_tpu_torch.core.keys import key_combine
from instancesegmentation_tpu_torch.core.visualize import (
    DEFAULT_COLORS,
    draw_box,
    draw_keypoint,
    draw_mask,
)


class CommonFormatWriter:
    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        for d in ("image", "instance_mask", "segment_mask", "class_mask", "mix", "data"):
            os.makedirs(os.path.join(save_dir, d), exist_ok=True)

    def write_image(self, name: str, filename: str, image_rgb: np.ndarray) -> str:
        rel = os.path.join("image", filename)
        imwrite(os.path.join(self.save_dir, rel), image_rgb)
        return rel

    def write_instance_mask(self, name: str, idx: int, mask: np.ndarray) -> str:
        d = os.path.join(self.save_dir, "instance_mask", name)
        os.makedirs(d, exist_ok=True)
        rel = os.path.join("instance_mask", name, f"{idx}.png")
        imwrite(os.path.join(self.save_dir, rel), mask)
        return rel

    def finish_image(
        self,
        name: str,
        filename: str,
        image_rgb: np.ndarray,
        objs: list[dict],
        instance_masks: list[Optional[np.ndarray]],
        meta: dict,
        class_name: str = "person",
    ) -> dict:
        """Write segment/class masks, the mix render, and data JSON."""
        h, w = image_rgb.shape[:2]
        segment_mask = np.zeros((h, w), dtype=np.uint8)
        mix = image_rgb.copy()
        for i, (obj, mask) in enumerate(zip(objs, instance_masks)):
            color = DEFAULT_COLORS[i % len(DEFAULT_COLORS)]
            if mask is not None:
                segment_mask |= mask
                draw_mask(mix, mask, color=color)
            box = obj.get(key_combine("box", "box_xyxy"))
            if box is not None:
                draw_box(mix, box, color=color)
            body = obj.get(key_combine("body_keypoint", "sub_dict"))
            if body:
                draw_keypoint(mix, body)

        mix_rel = os.path.join("mix", filename)
        imwrite(os.path.join(self.save_dir, mix_rel), mix)
        seg_rel = os.path.join("segment_mask", name + ".png")
        imwrite(os.path.join(self.save_dir, seg_rel), segment_mask)
        os.makedirs(os.path.join(self.save_dir, "class_mask", name), exist_ok=True)
        class_rel = os.path.join("class_mask", name, class_name + ".png")
        imwrite(os.path.join(self.save_dir, class_rel), segment_mask)

        record = {
            key_combine("image", "image_path"): os.path.join("image", filename),
            key_combine("mix", "image_path"): mix_rel,
            key_combine("segment_mask", "mask_path"): seg_rel,
            key_combine("class", "class"): class_name,
            key_combine("meta", "other"): meta,
            key_combine("class_mask", "sub_list"): [
                {
                    key_combine("class", "class"): class_name,
                    key_combine("segment_mask", "mask_path"): class_rel,
                }
            ],
            key_combine("object", "sub_list"): objs,
        }
        with open(os.path.join(self.save_dir, "data", name + ".json"), "w") as f:
            json.dump(record, f)
        return record
