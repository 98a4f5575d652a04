"""Host-side instance dataset over the common format.

Port of ``instancesegmentation_tpu/data/dataset.py``: the host builds the
per-object sample index once at startup (the reference's eligibility
filter, reference train_instance.py:102-117) and per sample only decodes
images and masks and pads them onto a fixed canvas; all geometry,
normalisation and heatmap rendering run on the device in the train step
(``data/pipeline.py:preprocess_batch``).  Images larger than the canvas are
prescaled on the host.  The index and the samples equal the JAX package's
bit for bit: files are decoded by ``core/imread.py`` (PNG and JPEG, as
``cv2.imread``) and the prescale is ``infer/pipeline.py:resize``, cv2's
INTER_LINEAR arithmetic on uint8.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np
import torch

from instancesegmentation_tpu_torch.core.boxes import mask2box
from instancesegmentation_tpu_torch.core.keys import ORDER_PART_NAMES, key_combine
from instancesegmentation_tpu_torch.core.records import (
    ROOT_KEY,
    _load_image,
    _load_mask,
    common_ann_loader,
    common_choice,
    common_filter,
)
from instancesegmentation_tpu_torch.infer.pipeline import resize


def body_keypoint_array(body: dict | None) -> np.ndarray:
    """Common-format ``body_keypoint`` sub-dict -> [17, 3] (x, y, vis).

    vis is 1.0 only for status=='vis' (only those render heatmaps,
    reference train_instance.py:45-47); absent parts are (0, 0, 0).
    Shared by the training dataset and the full-image eval/proposal
    path, so GT keypoints condition inference exactly as in training.
    """
    out = np.zeros((len(ORDER_PART_NAMES), 3), dtype=np.float32)
    if not isinstance(body, dict):
        return out
    status_key = key_combine("status", "keypoint_status")
    point_key = key_combine("point", "point_xy")
    for i, part in enumerate(ORDER_PART_NAMES):
        kp = body.get(key_combine(part, "sub_dict"))
        if not isinstance(kp, dict):
            continue
        x, y = kp.get(point_key, (0, 0))
        vis = 1.0 if kp.get(status_key) == "vis" else 0.0
        out[i] = (float(x), float(y), vis)
    return out


def _resize_u8(a: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.resize(a, INTER_LINEAR)`` of a uint8 image, on the host."""
    return resize(torch.from_numpy(a), out_hw).to(torch.uint8).numpy()


@dataclasses.dataclass
class Sample:
    """One host-prepared training sample (fixed shapes)."""

    image: np.ndarray      # [S, S, 3] uint8, top-left anchored
    mask: np.ndarray       # [S, S] uint8
    image_hw: np.ndarray   # [2] f32 effective (h, w) on the canvas
    obj_box: np.ndarray    # [4] f32 xyxy annotation box
    mask_box: np.ndarray   # [4] f32 xyxy tight mask box
    mask_valid: bool
    keypoints: np.ndarray  # [17, 3] f32 (x, y, vis) canonical order
    index: int


class InstanceCommonDataset:
    """Per-object sample index over a common-format directory.

    Eligibility filter identical to reference train_instance.py:102-117:
    has instance_mask, has body_keypoint, >9 non-missing keypoints,
    class=='person' (when present), box wider and taller than 50 px.
    """

    def __init__(self, dataset_dir: str, canvas: int = 640):
        self.dataset_dir = dataset_dir
        self.canvas = canvas
        self.records: list[dict] = []

        for ann in common_ann_loader(dataset_dir):
            common_choice(ann, {"image", "object"})
            image_path = ann.get(key_combine("image", "image_path"))
            objs = ann.get(key_combine("object", "sub_list"), [])
            for obj in objs:

                def eligible(result):
                    yield "instance_mask" in result
                    yield "body_keypoint" in result
                    yield sum(
                        kp["status"] != "missing"
                        for kp in result["body_keypoint"].values()
                    ) > 9
                    if "class" in result:
                        yield result["class"] in ["person"]
                    yield "box" in result
                    x0, y0, x1, y1 = result["box"]
                    yield (x1 - x0) > 50 and (y1 - y0) > 50

                if not common_filter(obj, eligible):
                    continue
                rec = dict(obj)
                rec[key_combine("image", "image_path")] = image_path
                common_choice(rec, {"instance_mask", "image", "box", "body_keypoint"})
                rec[ROOT_KEY] = dataset_dir
                self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def keypoints_array(self, rec: dict) -> np.ndarray:
        """[17, 3] (x, y, vis) in the reference's canonical part order
        (see module-level ``body_keypoint_array``)."""
        return body_keypoint_array(
            rec.get(key_combine("body_keypoint", "sub_dict"), {})
        )

    def fetch(self, index: int) -> Sample:
        """Decode one sample and place it on the fixed canvas."""
        rec = self.records[index]
        root = rec[ROOT_KEY]
        image = _load_image(os.path.join(root, rec[key_combine("image", "image_path")]))
        mask = _load_mask(
            os.path.join(root, rec[key_combine("instance_mask", "mask_path")])
        )
        box = np.asarray(rec[key_combine("box", "box_xyxy")], dtype=np.float32)
        kps = self.keypoints_array(rec)

        h, w = image.shape[:2]
        scale = 1.0
        if max(h, w) > self.canvas:
            scale = self.canvas / max(h, w)
            out_hw = (int(h * scale), int(w * scale))
            image = _resize_u8(image, out_hw)
            mask = _resize_u8(mask, out_hw)
            box = box * scale
            kps = kps * np.array([scale, scale, 1.0], dtype=np.float32)
            h, w = image.shape[:2]

        canvas_img = np.zeros((self.canvas, self.canvas, 3), dtype=np.uint8)
        canvas_img[:h, :w] = image
        canvas_mask = np.zeros((self.canvas, self.canvas), dtype=np.uint8)
        canvas_mask[:h, :w] = mask

        mb = mask2box(mask)
        mask_valid = mb is not None
        mask_box = np.asarray(mb if mask_valid else [0, 0, 0, 0], dtype=np.float32)

        return Sample(
            image=canvas_img,
            mask=canvas_mask,
            image_hw=np.asarray([h, w], dtype=np.float32),
            obj_box=box,
            mask_box=mask_box,
            mask_valid=mask_valid,
            keypoints=kps,
            index=index,
        )

    def iter_samples(self, order=None) -> Iterator[Sample]:
        for i in order if order is not None else range(len(self)):
            yield self.fetch(int(i))
