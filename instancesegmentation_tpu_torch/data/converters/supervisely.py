"""Supervisely person datasets -> common format (the port's copy of the JAX
package's ``data/converters/supervisely.py``).

The project is read directly (``meta.json`` + ``<dataset>/ann/*.json``),
geometries rasterized here.  Kept from the reference:
- keypoints are stored as separate point-geometry objects and merged into
  their parent instance via the ``instance`` id field; point objects' class
  name IS the body-part name, status always 'vis';
- class whitelist assert: only person_poly / person_bmp / persona /
  neutral / body-part names are accepted; 'neutral' objects are skipped;
- output items are renamed to zero-padded sequence numbers and images
  re-encoded as PNG;
- boxes are the geometry bbox with INCLUSIVE right/bottom like
  supervisely's ``to_bbox``.

Supported geometries: ``bitmap`` (base64 + zlib-compressed PNG placed at
``origin``, read as ``cv2.imdecode(..., IMREAD_GRAYSCALE)`` reads it: the
1-bit palette PNGs that Supervisely writes included), ``polygon`` (exterior
+ interior holes), ``point``.  Unreadable images are skipped as in
``coco.py``.

    python -m instancesegmentation_tpu_torch.data.converters.supervisely PROJECT_DIR OUT
"""
from __future__ import annotations

import base64
import glob
import json
import os
import zlib

import numpy as np

from instancesegmentation_tpu_torch.core.boxes import mask2box
from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.keys import (
    BODY_PART_CHOICES,
    CLASS_CHOICES,
    key_combine,
)
from instancesegmentation_tpu_torch.core.rasterize import polygons_to_mask
from instancesegmentation_tpu_torch.data.converters.common_writer import CommonFormatWriter

_PERSON_ALIASES = ("person_poly", "person_bmp", "persona")
_ALLOWED = set(_PERSON_ALIASES) | {"neutral"} | set(BODY_PART_CHOICES)


def class2common(class_str: str):
    if class_str in _PERSON_ALIASES:
        return "person"
    if class_str in CLASS_CHOICES or class_str in BODY_PART_CHOICES:
        return class_str
    return None


def _bitmap_to_mask(bitmap: dict, height: int, width: int) -> np.ndarray:
    """Decode a supervisely bitmap geometry (zlib+base64 PNG at origin)."""
    raw = base64.b64decode(bitmap["data"])
    try:
        raw = zlib.decompress(raw)
    except zlib.error:
        pass  # some exports store plain PNG
    patch = imdecode(raw, "gray")
    mask = np.zeros((height, width), dtype=np.uint8)
    ox, oy = bitmap.get("origin", [0, 0])
    ph, pw = patch.shape[:2]
    mask[oy : oy + ph, ox : ox + pw] = np.where(patch > 0, 255, 0).astype(np.uint8)
    return mask


def _polygon_to_mask(points: dict, height: int, width: int) -> np.ndarray:
    exterior = [np.asarray(points["exterior"]).reshape(-1).tolist()]
    mask = polygons_to_mask(exterior, height, width)
    interior = points.get("interior") or []
    if interior:
        holes = polygons_to_mask(
            [np.asarray(p).reshape(-1).tolist() for p in interior], height, width
        )
        mask[holes > 0] = 0
    return mask


def transfer_supervisely_to_common(data_dir: str, save_dir: str, progress: bool = True) -> int:
    writer = CommonFormatWriter(save_dir)
    ann_paths = sorted(glob.glob(os.path.join(data_dir, "*", "ann", "*.json")))
    i0 = 0
    for ann_path in ann_paths:
        with open(ann_path) as f:
            sann = json.load(f)

        for label in sann.get("objects", []):
            assert label.get("classTitle") in _ALLOWED, (
                f"not support some obj class name: {label.get('classTitle')}"
            )

        item = os.path.splitext(os.path.basename(ann_path))[0]
        ds_dir = os.path.dirname(os.path.dirname(ann_path))
        img_path = None
        for cand_dir in ("img", "image"):
            for cand in glob.glob(os.path.join(ds_dir, cand_dir, item + "*")):
                img_path = cand
                break
            if img_path:
                break
        if img_path is None:
            continue
        try:
            img = imread(img_path, "color")
        except FileNotFoundError:
            continue
        h, w = img.shape[:2]

        name = str(i0).zfill(5)
        filename = name + ".png"
        writer.write_image(name, filename, img)

        # group labels by instance id; point objects become keypoints
        objs: dict = {}
        obj_masks: dict = {}
        j0 = 0
        for idx, label in enumerate(sann.get("objects", [])):
            instance_id = label.get("instance", idx)
            c = class2common(label.get("classTitle", ""))
            if c is None:
                continue
            entry = objs.setdefault(
                instance_id, {key_combine("body_keypoint", "sub_dict"): {}}
            )

            gtype = label.get("geometryType")
            if c in BODY_PART_CHOICES and gtype == "point":
                xy = label["points"]["exterior"][0]
                entry[key_combine("body_keypoint", "sub_dict")][
                    key_combine(c, "sub_dict")
                ] = {
                    key_combine("status", "keypoint_status"): "vis",
                    key_combine("point", "point_xy"): [int(xy[0]), int(xy[1])],
                }
                continue

            if c in CLASS_CHOICES:
                if gtype == "bitmap":
                    mask = _bitmap_to_mask(label["bitmap"], h, w)
                elif gtype == "polygon":
                    mask = _polygon_to_mask(label["points"], h, w)
                else:
                    continue
                rel = writer.write_instance_mask(name, j0, mask)
                j0 += 1
                box = mask2box(mask) or [0, 0, 1, 1]
                entry[key_combine("instance_mask", "mask_path")] = rel
                # inclusive right/bottom like supervisely to_bbox
                entry[key_combine("box", "box_xyxy")] = [
                    box[0], box[1], box[2] - 1, box[3] - 1
                ]
                entry[key_combine("class", "class")] = c
                obj_masks[instance_id] = mask

        obj_list = list(objs.values())
        mask_list = [obj_masks.get(k) for k in objs.keys()]
        meta = {"origin_image_path": img_path, "width": w, "height": h}
        writer.finish_image(name, filename, img, obj_list, mask_list, meta)
        i0 += 1
        if progress and i0 % 200 == 0:
            print(f"transfer_supervisely: {i0}/{len(ann_paths)}")
    return i0


if __name__ == "__main__":
    import sys

    transfer_supervisely_to_common(sys.argv[1], sys.argv[2])
