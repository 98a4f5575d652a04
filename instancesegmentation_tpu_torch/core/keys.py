"""Typed-key schema for the "common format".

Copy of ``instancesegmentation_tpu/core/keys.py``.

The common format stores each image's annotation as one JSON dict whose
keys carry a type suffix: ``"<name>##<type>"``.  The type suffix drives
generic machinery (path materialization, geometric augmentation), see
``records.py``.

Schema reconstructed from the reference's call sites (it never vendors
the library that defines it): reference ``train_instance.py:25-30``
(canonical 17-part order), ``dataset/transfer_coco.py:17-36,82-91``
(COCO part names + visibility maps), ``dataset/transfer_ochuman.py:46-57``
(OCHuman 19-part names), ``dataset/change_common_data_json.py:24-37``
(the ``##`` separator), ``dataset/transfer_supervisely.py:6,30-46``
(BODY_PART_CHOICES / CLASS constants).
"""
from __future__ import annotations

KEY_SEP = "##"

#: Known type suffixes. "``*_path``" types are materialized to arrays by
#: ``common_transfer`` (image_path -> image, mask_path -> mask).
KEY_TYPES = frozenset(
    {
        "image_path",
        "mask_path",
        "image",
        "mask",
        "class",
        "sub_list",
        "sub_dict",
        "other",
        "box_xyxy",
        "keypoint_status",
        "point_xy",
    }
)

#: status values for one body keypoint.
KEYPOINT_STATUSES = ("vis", "not_vis", "missing")

#: Canonical 17-part training order (reference train_instance.py:25-30).
ORDER_PART_NAMES = (
    "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist",
    "right_hip", "right_knee", "right_ankle",
    "left_hip", "left_knee", "left_ankle",
    "right_ear", "left_ear",
    "nose", "right_eye", "left_eye",
)

#: COCO keypoint order (reference transfer_coco.py:18-22).
COCO_PART_NAMES = (
    "nose",
    "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)

#: OCHuman 19-part order (reference transfer_ochuman.py:47-52).
OCHUMAN_PART_NAMES = (
    "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist",
    "right_hip", "right_knee", "right_ankle",
    "left_hip", "left_knee", "left_ankle",
    "head", "neck",
    "right_ear", "left_ear", "nose", "right_eye", "left_eye",
)

#: COCO `v` flag -> status (reference transfer_coco.py:82-88).
COCO_VISIBILITY_MAP = {0: "missing", 1: "not_vis", 2: "vis"}

#: OCHuman `v` flag -> status; both occlusion kinds collapse to not_vis
#: (reference transfer_ochuman.py:83-89).
OCHUMAN_VISIBILITY_MAP = {0: "missing", 1: "vis", 2: "not_vis", 3: "not_vis"}

#: Body-part class names accepted by the Supervisely converter
#: (reference transfer_supervisely.py:6,33 imports BODY_PART_CHOICES).
BODY_PART_CHOICES = frozenset(OCHUMAN_PART_NAMES)

#: Object class names in the common format.
CLASS_CHOICES = frozenset({"person"})

#: COCO skeleton (1-indexed pairs, reference transfer_coco.py:31-36),
#: used only for visualization.
COCO_SKELETON = (
    (16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12),
    (7, 13), (6, 7), (6, 8), (7, 9), (8, 10), (9, 11),
    (2, 3), (1, 2), (1, 3), (2, 4), (3, 5), (4, 6), (5, 7),
)


def key_combine(name: str, key_type: str) -> str:
    """Build a typed JSON key, e.g. ``key_combine('box', 'box_xyxy')``."""
    if key_type not in KEY_TYPES:
        raise ValueError(f"unknown key type {key_type!r}")
    return f"{name}{KEY_SEP}{key_type}"


def key_decompose(key: str) -> tuple[str, str]:
    """Split a typed key into ``(name, type)``."""
    name, sep, key_type = key.rpartition(KEY_SEP)
    if not sep:
        return key, ""
    return name, key_type
