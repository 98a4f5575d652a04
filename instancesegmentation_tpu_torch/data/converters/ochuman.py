"""OCHuman -> common format (the port's copy of the JAX package's
``data/converters/ochuman.py``).

The ochuman.json schema: top-level ``images`` list, each with
``file_name``, ``width``, ``height`` and ``annotations``; every annotation
holds ``bbox`` (already xyxy, stored verbatim), ``keypoints`` (19 x 3 flat
list; may be null) and ``segms`` (may be null): a dict of
``outer``/``inner`` polygon lists, the mask being fill(outer) minus
fill(inner).  Visibility mapping (2/3 -> not_vis) lives in
``converters/keypoints.py``.  Unreadable images are skipped as in
``coco.py``.

    python -m instancesegmentation_tpu_torch.data.converters.ochuman ANN.json IMG_DIR OUT
"""
from __future__ import annotations

import json
import os
from shutil import copyfile

import numpy as np

from instancesegmentation_tpu_torch.core.imread import imread
from instancesegmentation_tpu_torch.core.keys import key_combine
from instancesegmentation_tpu_torch.core.rasterize import polygons_to_mask
from instancesegmentation_tpu_torch.data.converters.coco import path_decompose
from instancesegmentation_tpu_torch.data.converters.common_writer import CommonFormatWriter
from instancesegmentation_tpu_torch.data.converters.keypoints import get_body_keypoint


def poly2mask(segms: dict, height: int, width: int) -> np.ndarray:
    """outer polys filled minus inner polys (hole support)."""
    outer = segms.get("outer") or []
    inner = segms.get("inner") or []
    mask = polygons_to_mask(outer, height, width)
    if inner:
        holes = polygons_to_mask(inner, height, width)
        mask[holes > 0] = 0
    return mask


def transfer_ochuman(ann_path: str, img_dir: str, save_dir: str, progress: bool = True) -> int:
    with open(ann_path) as f:
        data = json.load(f)

    images = data.get("images", [])
    print(f"Total images: {len(images)}")
    writer = CommonFormatWriter(save_dir)
    n = 0
    for imgd in images:
        filename = imgd["file_name"]
        _, name, _ = path_decompose(filename)

        load_path = os.path.join(img_dir, filename)
        try:
            img = imread(load_path, "color")
        except FileNotFoundError:
            continue
        h, w = imgd.get("height", img.shape[0]), imgd.get("width", img.shape[1])
        copyfile(load_path, os.path.join(save_dir, "image", filename))

        objs = []
        masks = []
        for i, ann in enumerate(imgd.get("annotations", [])):
            obj = {}
            bbox = ann.get("bbox")
            if bbox is not None:
                obj[key_combine("box", "box_xyxy")] = [int(v) for v in bbox]
            obj[key_combine("class", "class")] = "person"

            mask = None
            segms = ann.get("segms")
            if segms is not None:
                mask = poly2mask(segms, h, w)
                rel = writer.write_instance_mask(name, i, mask)
                obj[key_combine("instance_mask", "mask_path")] = rel

            kpt = ann.get("keypoints")
            if kpt is not None:
                obj[key_combine("body_keypoint", "sub_dict")] = get_body_keypoint(kpt)

            objs.append(obj)
            masks.append(mask)

        meta = {"origin_image_path": load_path, "width": w, "height": h}
        writer.finish_image(name, filename, img, objs, masks, meta)
        n += 1
        if progress and n % 200 == 0:
            print(f"transfer_ochuman: {n}/{len(images)}")
    return n


if __name__ == "__main__":
    import sys

    transfer_ochuman(sys.argv[1], sys.argv[2], sys.argv[3])
