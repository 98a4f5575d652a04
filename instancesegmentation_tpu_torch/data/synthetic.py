"""Synthetic data: common-format datasets on disk and host batches in memory.

Port of ``instancesegmentation_tpu/data/synthetic.py``
(``make_synthetic_dataset`` with its ``crossed_pairs`` mode,
``make_hard_dataset`` and ``synthetic_host_batch``), numpy only: the same
draws from
``np.random.default_rng(seed)`` in the same order, so that both packages
write identical JSON records and pixels from one seed.  The ellipses are
``core/rasterize.py:fill_ellipse`` (cv2's algorithm) and the files
``core/png.py:write_png``.

Each image contains one or more elliptical "persons" with plausible
keypoint layouts; masks are exact ellipse rasterizations.
"""
from __future__ import annotations

import json
import os

import numpy as np

from instancesegmentation_tpu_torch.core.keys import ORDER_PART_NAMES, key_combine
from instancesegmentation_tpu_torch.core.masks import union_masks
from instancesegmentation_tpu_torch.core.png import write_png
from instancesegmentation_tpu_torch.core.rasterize import fill_ellipse

#: canonical part offsets within a unit body box (x, y in [0,1])
_PART_OFFSETS = {
    "nose": (0.5, 0.12), "right_eye": (0.44, 0.09), "left_eye": (0.56, 0.09),
    "right_ear": (0.40, 0.12), "left_ear": (0.60, 0.12),
    "right_shoulder": (0.35, 0.25), "left_shoulder": (0.65, 0.25),
    "right_elbow": (0.28, 0.40), "left_elbow": (0.72, 0.40),
    "right_wrist": (0.25, 0.55), "left_wrist": (0.75, 0.55),
    "right_hip": (0.40, 0.55), "left_hip": (0.60, 0.55),
    "right_knee": (0.40, 0.75), "left_knee": (0.60, 0.75),
    "right_ankle": (0.40, 0.93), "left_ankle": (0.60, 0.93),
}


def _crossed_pair_specs(rng, h: int, w: int):
    """Two same-color ellipses rotated +/-theta sharing one bounding box.

    A mirrored-rotation ellipse pair has the identical axis-aligned
    bbox (bbox half-extents are sqrt(a^2 cos^2 t + b^2 sin^2 t) — even
    in t), so box/crop geometry carries zero information about which
    instance is the target; the 17 keypoints are laid out in each
    ellipse's own rotated frame and are the only disambiguator.
    Returns [(box, mask, kp_xy[17,2], color), ...] for both instances.
    """
    a_min = rng.uniform(22, 32)               # semi-minor (body half-width)
    a_maj = rng.uniform(62, 85)               # semi-major (body half-length)
    theta = rng.uniform(20.0, 38.0)           # degrees off vertical
    t = np.deg2rad(theta)
    # shared axis-aligned half-extents of BOTH rotated ellipses
    half_w = np.sqrt((a_min * np.cos(t)) ** 2 + (a_maj * np.sin(t)) ** 2)
    half_h = np.sqrt((a_min * np.sin(t)) ** 2 + (a_maj * np.cos(t)) ** 2)
    cx = rng.uniform(half_w + 6, w - half_w - 6)
    cy = rng.uniform(half_h + 6, h - half_h - 6)
    box = [int(cx - half_w), int(cy - half_h), int(cx + half_w), int(cy + half_h)]
    color = tuple(int(c) for c in rng.integers(120, 255, size=3))

    out = []
    for sign in (+1.0, -1.0):
        ang = sign * theta
        mask = np.zeros((h, w), dtype=np.uint8)
        # fill_ellipse (cv2.ellipse): axes=(along-x, along-y) before rotation by `ang`
        # degrees; body frame = minor along x, major along y
        fill_ellipse(mask, (int(cx), int(cy)), (int(a_min), int(a_maj)), float(ang))
        # keypoints in the same rotated body frame (cv2's screen-coords
        # rotation: +angle rotates x-axis toward +y since y points down)
        ca, sa = np.cos(np.deg2rad(ang)), np.sin(np.deg2rad(ang))
        kp = np.zeros((len(ORDER_PART_NAMES), 2), np.float32)
        for p_i, part in enumerate(ORDER_PART_NAMES):
            ox, oy = _PART_OFFSETS[part]
            lx = (ox - 0.5) * 2 * a_min * 0.9   # body frame, within ellipse
            ly = (oy - 0.5) * 2 * a_maj * 0.9
            kp[p_i] = (cx + lx * ca - ly * sa, cy + lx * sa + ly * ca)
        out.append((box, mask, kp, color))
    return out


def make_synthetic_dataset(
    out_dir: str,
    num_images: int = 8,
    image_hw: tuple[int, int] = (240, 320),
    objects_per_image: int = 1,
    seed: int = 0,
    crossed_pairs: bool = False,
) -> str:
    """Write a synthetic common-format dataset and return ``out_dir``.

    ``crossed_pairs`` generates the keypoint-conditioning stress case
    (the occluded-person regime OCHuman exists for): each image holds
    one pair of SAME-color ellipses rotated +/-theta around a SHARED
    bounding box, so the image + crop window alone cannot identify the
    target instance — only its keypoints (laid out along each ellipse's
    major axis) can.  An unconditioned model caps out near the
    pair-overlap IoU on such data; a conditioned one can separate them.
    ``objects_per_image`` is ignored in this mode (always 2).
    """
    rng = np.random.default_rng(seed)
    h, w = image_hw
    for d in ("image", "instance_mask", "segment_mask", "class_mask", "mix", "data"):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)

    for i in range(num_images):
        name = f"{i:05d}"
        img = rng.integers(0, 80, size=(h, w, 3), dtype=np.uint8)
        objs = []
        masks = []
        os.makedirs(os.path.join(out_dir, "instance_mask", name), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "class_mask", name), exist_ok=True)

        if crossed_pairs:
            specs = _crossed_pair_specs(rng, h, w)
        else:
            specs = None

        n_objs = 2 if crossed_pairs else objects_per_image
        for j in range(n_objs):
            if crossed_pairs:
                box, mask, kp_xy, color = specs[j]
                img[mask > 0] = color
                masks.append(mask)
                x0, y0 = box[0], box[1]
                bw, bh = box[2] - box[0], box[3] - box[1]
                body = {}
                for p_i, part in enumerate(ORDER_PART_NAMES):
                    body[key_combine(part, "sub_dict")] = {
                        key_combine("status", "keypoint_status"): "vis",
                        key_combine("point", "point_xy"): [
                            int(kp_xy[p_i, 0]),
                            int(kp_xy[p_i, 1]),
                        ],
                    }

                mask_rel = os.path.join("instance_mask", name, f"{j}.png")
                write_png(os.path.join(out_dir, mask_rel), mask)
                objs.append(
                    {
                        key_combine("box", "box_xyxy"): box,
                        key_combine("class", "class"): "person",
                        key_combine("instance_mask", "mask_path"): mask_rel,
                        key_combine("body_keypoint", "sub_dict"): body,
                    }
                )
                continue

            bw = int(rng.uniform(70, min(140, w - 20)))
            bh = int(rng.uniform(80, min(180, h - 20)))
            x0 = int(rng.uniform(0, w - bw))
            y0 = int(rng.uniform(0, h - bh))
            box = [x0, y0, x0 + bw, y0 + bh]

            mask = np.zeros((h, w), dtype=np.uint8)
            center = (x0 + bw // 2, y0 + bh // 2)
            axes = (bw // 2 - 2, bh // 2 - 2)
            fill_ellipse(mask, center, axes, 0)
            color = tuple(int(c) for c in rng.integers(120, 255, size=3))
            img[mask > 0] = color
            masks.append(mask)

            body = {}
            for part in ORDER_PART_NAMES:
                ox, oy = _PART_OFFSETS[part]
                body[key_combine(part, "sub_dict")] = {
                    key_combine("status", "keypoint_status"): "vis",
                    key_combine("point", "point_xy"): [
                        int(x0 + ox * bw),
                        int(y0 + oy * bh),
                    ],
                }

            mask_rel = os.path.join("instance_mask", name, f"{j}.png")
            write_png(os.path.join(out_dir, mask_rel), mask)
            objs.append(
                {
                    key_combine("box", "box_xyxy"): box,
                    key_combine("class", "class"): "person",
                    key_combine("instance_mask", "mask_path"): mask_rel,
                    key_combine("body_keypoint", "sub_dict"): body,
                }
            )

        image_rel = os.path.join("image", name + ".png")
        write_png(os.path.join(out_dir, image_rel), img)
        seg = union_masks(masks)
        seg_rel = os.path.join("segment_mask", name + ".png")
        write_png(os.path.join(out_dir, seg_rel), seg)
        class_rel = os.path.join("class_mask", name, "person.png")
        write_png(os.path.join(out_dir, class_rel), seg)

        ann = {
            key_combine("image", "image_path"): image_rel,
            key_combine("segment_mask", "mask_path"): seg_rel,
            key_combine("class", "class"): "person",
            key_combine("meta", "other"): {"width": w, "height": h},
            key_combine("class_mask", "sub_list"): [
                {
                    key_combine("class", "class"): "person",
                    key_combine("segment_mask", "mask_path"): class_rel,
                }
            ],
            key_combine("object", "sub_list"): objs,
        }
        with open(os.path.join(out_dir, "data", name + ".json"), "w") as f:
            json.dump(ann, f)
    return out_dir


def _rot_offsets(a_min: float, a_maj: float, ang_deg: float, cx: float, cy: float):
    """[17, 2] keypoint positions: the canonical body layout scaled into
    an ellipse of half-axes (a_min, a_maj), rotated by ``ang_deg`` about
    (cx, cy) (cv2 screen-coords rotation, y down)."""
    ca, sa = np.cos(np.deg2rad(ang_deg)), np.sin(np.deg2rad(ang_deg))
    kp = np.zeros((len(ORDER_PART_NAMES), 2), np.float32)
    for p_i, part in enumerate(ORDER_PART_NAMES):
        ox, oy = _PART_OFFSETS[part]
        lx = (ox - 0.5) * 2 * a_min * 0.9
        ly = (oy - 0.5) * 2 * a_maj * 0.9
        kp[p_i] = (cx + lx * ca - ly * sa, cy + lx * sa + ly * ca)
    return kp


def make_hard_dataset(
    out_dir: str,
    num_images: int = 100,
    image_hw: tuple[int, int] = (480, 640),
    seed: int = 0,
    min_objects: int = 3,
    max_objects: int = 6,
    missing_prob: float = 0.15,
) -> str:
    """Write the crowded, occluded synthetic set (the OCHuman analogue of the
    full-image eval) and return ``out_dir``.

    Per image: 3-6 elliptical "persons" in 1-2 spatial clusters so
    instances overlap heavily; body size log-uniform over a >=4x range;
    arbitrary orientation; instances drawn back-to-front with VISIBLE
    (modal) masks: front bodies erase occluded parts of back bodies, as
    COCO and OCHuman annotate crowd masks.  Keypoints: 'vis' where the part
    lands on the instance's own visible mask, 'not_vis' where occluded by
    a nearer body, and 'missing' for off-canvas parts or with
    ``missing_prob`` (dropped annotations).  Colours come from a small
    shaded palette, so appearance is ambiguous between neighbours: box
    geometry and keypoints are the usable signals.

    Boxes are the visible-mask bboxes.  Instances whose visible box is under
    the 50x50 eligibility floor stay in the JSON: full-image eval counts
    them as GT, while the training filter drops them.
    """
    rng = np.random.default_rng(seed)
    h, w = image_hw
    for d in ("image", "instance_mask", "segment_mask", "class_mask", "mix", "data"):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)

    palette = [(200, 160, 140), (180, 150, 130), (160, 140, 150),
               (190, 170, 120), (170, 155, 145)]

    for i in range(num_images):
        name = f"{i:05d}"
        # low-contrast textured background
        img = rng.integers(40, 90, size=(h, w, 3), dtype=np.uint8)
        yy = np.linspace(0, 30, h, dtype=np.float32)[:, None, None]
        img = np.clip(img.astype(np.float32) + yy, 0, 255).astype(np.uint8)

        n_objs = int(rng.integers(min_objects, max_objects + 1))
        n_clusters = 1 if n_objs <= 3 else int(rng.integers(1, 3))
        anchors = np.stack(
            [rng.uniform(w * 0.25, w * 0.75, n_clusters),
             rng.uniform(h * 0.30, h * 0.70, n_clusters)], axis=-1
        )

        # geometry back-to-front: index j is drawn j-th, so larger j is
        # nearer the camera and occludes everything before it
        specs = []
        for j in range(n_objs):
            # log-uniform semi-major over [0.06, 0.30]*h -> 5x scale range
            a_maj = float(np.exp(rng.uniform(np.log(0.06 * h), np.log(0.30 * h))))
            a_min = a_maj * rng.uniform(0.30, 0.45)
            ang = float(rng.uniform(0.0, 180.0))
            anchor = anchors[int(rng.integers(0, n_clusters))]
            cx = float(np.clip(anchor[0] + rng.normal(0, a_maj * 0.5), a_min, w - a_min))
            cy = float(np.clip(anchor[1] + rng.normal(0, a_maj * 0.5), a_min, h - a_min))
            full = np.zeros((h, w), np.uint8)
            fill_ellipse(full, (int(cx), int(cy)), (int(a_min), int(a_maj)), ang)
            specs.append((cx, cy, a_min, a_maj, ang, full))

        objs = []
        masks = []
        os.makedirs(os.path.join(out_dir, "instance_mask", name), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "class_mask", name), exist_ok=True)
        kept = 0
        for j, (cx, cy, a_min, a_maj, ang, full) in enumerate(specs):
            visible = full.copy()
            for k in range(j + 1, n_objs):
                visible[specs[k][5] > 0] = 0
            ys, xs = np.nonzero(visible)
            if ys.size < 40:
                continue  # fully (or near-fully) occluded: no annotation
            box = [int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1]

            # shaded near-ambiguous colour fill + speckle
            base = np.asarray(palette[int(rng.integers(0, len(palette)))], np.float32)
            shade = ((np.arange(h, dtype=np.float32)[:, None] - cy) / max(a_maj, 1)) * 25
            fill = np.clip(base[None, None] + shade[..., None]
                           + rng.normal(0, 6, (h, w, 3)), 0, 255)
            sel = visible > 0
            img[sel] = fill[sel].astype(np.uint8)

            kp = _rot_offsets(a_min, a_maj, ang, cx, cy)
            body = {}
            for p_i, part in enumerate(ORDER_PART_NAMES):
                x, y = float(kp[p_i, 0]), float(kp[p_i, 1])
                # floor, not int(): int(-0.5) == 0 would count y in
                # (-1, 0) as on-canvas row 0
                iy, ix = int(np.floor(y)), int(np.floor(x))
                inside = 0 <= iy < h and 0 <= ix < w
                if rng.random() < missing_prob or not inside:
                    status = "missing"
                elif visible[iy, ix] > 0:
                    status = "vis"
                else:
                    status = "not_vis"  # occluded by a nearer body
                entry = {key_combine("status", "keypoint_status"): status}
                if status != "missing":
                    entry[key_combine("point", "point_xy")] = [int(x), int(y)]
                body[key_combine(part, "sub_dict")] = entry

            mask_rel = os.path.join("instance_mask", name, f"{kept}.png")
            write_png(os.path.join(out_dir, mask_rel), visible)
            masks.append(visible)
            objs.append(
                {
                    key_combine("box", "box_xyxy"): box,
                    key_combine("class", "class"): "person",
                    key_combine("instance_mask", "mask_path"): mask_rel,
                    key_combine("body_keypoint", "sub_dict"): body,
                }
            )
            kept += 1

        image_rel = os.path.join("image", name + ".png")
        write_png(os.path.join(out_dir, image_rel), img)
        seg = union_masks(masks) if masks else np.zeros((h, w), np.uint8)
        seg_rel = os.path.join("segment_mask", name + ".png")
        write_png(os.path.join(out_dir, seg_rel), seg)
        class_rel = os.path.join("class_mask", name, "person.png")
        write_png(os.path.join(out_dir, class_rel), seg)
        ann = {
            key_combine("image", "image_path"): image_rel,
            key_combine("segment_mask", "mask_path"): seg_rel,
            key_combine("class", "class"): "person",
            key_combine("meta", "other"): {"width": w, "height": h},
            key_combine("class_mask", "sub_list"): [
                {
                    key_combine("class", "class"): "person",
                    key_combine("segment_mask", "mask_path"): class_rel,
                }
            ],
            key_combine("object", "sub_list"): objs,
        }
        with open(os.path.join(out_dir, "data", name + ".json"), "w") as f:
            json.dump(ann, f)
    return out_dir


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
