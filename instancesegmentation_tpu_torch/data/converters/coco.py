"""COCO person-keypoints -> common format (the port's copy of the JAX
package's ``data/converters/coco.py``).

The annotation JSON is parsed directly and masks are rasterized by
``core/rasterize.py`` (polygons, compressed and uncompressed RLE).  Kept
from the reference:
- bbox xywh -> xyxy with the +1 quirk: ``[x, y, x+1+w, y+1+h]``,
- only the 'person' category is exported,
- per-image JSON carries class='person' at top level.

An image that cv2 would not read (``imread`` raises ``FileNotFoundError``)
is skipped, as the JAX package skips it; one of a form the port does not
decode raises ``UnsupportedImage`` and stops the conversion.

    python -m instancesegmentation_tpu_torch.data.converters.coco IMG_DIR ANN.json OUT
"""
from __future__ import annotations

import json
import os
from shutil import copyfile

from instancesegmentation_tpu_torch.core.imread import imread
from instancesegmentation_tpu_torch.core.keys import key_combine
from instancesegmentation_tpu_torch.core.rasterize import segmentation_to_mask
from instancesegmentation_tpu_torch.data.converters.common_writer import CommonFormatWriter
from instancesegmentation_tpu_torch.data.converters.keypoints import get_body_keypoint


def path_decompose(path: str) -> tuple[str, str, str]:
    """(dirname, stem, ext-without-dot)."""
    dirname = os.path.dirname(path)
    base = os.path.basename(path)
    stem, ext = os.path.splitext(base)
    return dirname, stem, ext[1:]


def transfer_coco(img_dir: str, ann_path: str, save_dir: str, progress: bool = True) -> int:
    """Convert COCO person images; returns the number converted."""
    with open(ann_path) as f:
        coco = json.load(f)

    person_ids = {
        c["id"] for c in coco.get("categories", []) if c.get("name") == "person"
    }
    anns_by_image: dict[int, list] = {}
    for ann in coco.get("annotations", []):
        if person_ids and ann.get("category_id") not in person_ids:
            continue
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    images = [img for img in coco.get("images", []) if img["id"] in anns_by_image]
    writer = CommonFormatWriter(save_dir)
    n = 0
    for imgd in images:
        filename = imgd["file_name"]
        _, name, _ = path_decompose(filename)
        h, w = imgd["height"], imgd["width"]

        load_path = os.path.join(img_dir, filename)
        try:
            img = imread(load_path, "color")
        except FileNotFoundError:
            continue
        copyfile(load_path, os.path.join(save_dir, "image", filename))

        objs = []
        masks = []
        for i, ann in enumerate(anns_by_image[imgd["id"]]):
            obj = {}
            x, y, bw, bh = ann["bbox"]
            # the reference's +1 xyxy quirk
            obj[key_combine("box", "box_xyxy")] = [
                int(x), int(y), int(x + 1 + bw), int(y + 1 + bh)
            ]
            obj[key_combine("class", "class")] = "person"

            mask = None
            if ann.get("segmentation") is not None:
                mask = segmentation_to_mask(ann["segmentation"], h, w)
                rel = writer.write_instance_mask(name, i, mask)
                obj[key_combine("instance_mask", "mask_path")] = rel

            if ann.get("keypoints") is not None:
                obj[key_combine("body_keypoint", "sub_dict")] = get_body_keypoint(
                    ann["keypoints"]
                )
            objs.append(obj)
            masks.append(mask)

        meta = {"origin_image_path": load_path, "width": w, "height": h}
        writer.finish_image(name, filename, img, objs, masks, meta)
        n += 1
        if progress and n % 200 == 0:
            print(f"transfer_coco: {n}/{len(images)}")
    return n


if __name__ == "__main__":
    import sys

    transfer_coco(sys.argv[1], sys.argv[2], sys.argv[3])
