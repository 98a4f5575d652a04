"""Record operators over common-format annotation dicts.

Reimplements (from call-site behavior, SURVEY.md §2.8) the generic
record machinery the reference imports from ``ymlib.common_dataset_api``
(used at reference ``train_instance.py:93-132`` and
``tool/show_aug.py:19-50``):

- ``common_ann_loader(dir)``    iterate ``data/*.json`` as dicts,
- ``common_choice(d, keys)``    keep only chosen key *names*,
- ``common_filter(d, genfn)``   all() over a generator that reads the
                                record through *untyped* keys,
- ``common_transfer(d)``        materialize ``*_path`` entries into
                                numpy arrays (recursing into sub_list /
                                sub_dict values).

Host-side, perf-noncritical code: the training hot path never touches
these per step (the loader builds its index once at startup).

Copy of ``instancesegmentation_tpu/core/records.py``; images and masks are
decoded by the port's own ``core/imread.py:imread`` instead of ``cv2``.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Callable, Iterable, Iterator

import numpy as np

from instancesegmentation_tpu_torch.core.keys import key_combine, key_decompose
from instancesegmentation_tpu_torch.core.imread import imread

#: Private key (carries no ## suffix so record ops ignore it) under which
#: the loader stashes the dataset root dir for path materialization.
ROOT_KEY = "__dataset_root__"


def common_ann_loader(dataset_dir: str, sort: bool = True) -> Iterator[dict]:
    """Yield each ``data/*.json`` annotation dict of a common-format dir.

    The dataset root is attached under ``ROOT_KEY`` so that
    ``common_transfer`` can resolve the relative image/mask paths.
    """
    paths = glob.glob(os.path.join(dataset_dir, "data", "*.json"))
    if sort:
        paths.sort()
    for path in paths:
        with open(path, "r") as f:
            ann = json.load(f)
        ann[ROOT_KEY] = dataset_dir
        yield ann


def common_choice(record: dict, key_choices: Iterable[str]) -> None:
    """Drop every typed key whose *name* part is not in ``key_choices``.

    In-place, like the reference's usage (train_instance.py:95,122).
    Untyped/private keys (no ``##``) are always kept.
    """
    choices = set(key_choices)
    for key in list(record.keys()):
        name, key_type = key_decompose(key)
        if key_type and name not in choices:
            del record[key]


def untyped_view(value: Any) -> Any:
    """Recursively strip type suffixes: ``{'box##box_xyxy': v}`` -> ``{'box': v}``.

    ``common_filter`` generators read records through plain names
    (reference train_instance.py:102-115 reads ``result['box']``,
    ``result['body_keypoint'].values()`` etc.).
    """
    if isinstance(value, dict):
        return {
            key_decompose(k)[0]: untyped_view(v)
            for k, v in value.items()
            if k != ROOT_KEY
        }
    if isinstance(value, list):
        return [untyped_view(v) for v in value]
    return value


def common_filter(record: dict, gen_fn: Callable[[dict], Iterator[bool]]) -> bool:
    """True iff every condition yielded by ``gen_fn(untyped record)`` holds.

    Short-circuits on the first False, so later yields may safely assume
    earlier ones (the reference's filter unpacks ``result['box']`` only
    after yielding ``'box' in result``).
    """
    view = untyped_view(record)
    for ok in gen_fn(view):
        if not ok:
            return False
    return True


def _load_image(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 HWC (``FileNotFoundError`` where
    ``cv2.imread`` gives None)."""
    return imread(path, "color")


def _load_mask(path: str) -> np.ndarray:
    """Decode a mask file to uint8 HW (0/255)."""
    return imread(path, "gray")


def common_transfer(record: dict, root: str | None = None) -> None:
    """Materialize path-typed entries into arrays, in place.

    ``<name>##image_path`` gains ``<name>##image`` (RGB uint8 HWC) and
    ``<name>##mask_path`` gains ``<name>##mask`` (uint8 HW).  Recurses
    into ``sub_list`` / ``sub_dict`` values.  The original ``*_path``
    entries are kept (they are cheap and keep records re-transferable).
    """
    root = record.get(ROOT_KEY, root)
    if root is None:
        raise ValueError("dataset root unknown; record not from common_ann_loader")

    for key in list(record.keys()):
        name, key_type = key_decompose(key)
        value = record[key]
        if key_type == "image_path":
            record[key_combine(name, "image")] = _load_image(
                os.path.join(root, value)
            )
        elif key_type == "mask_path":
            record[key_combine(name, "mask")] = _load_mask(
                os.path.join(root, value)
            )
        elif key_type == "sub_list":
            for sub in value:
                if isinstance(sub, dict):
                    sub.setdefault(ROOT_KEY, root)
                    common_transfer(sub, root)
        elif key_type == "sub_dict":
            if isinstance(value, dict):
                value.setdefault(ROOT_KEY, root)
                common_transfer(value, root)


def attach_root(record: dict, root: str) -> dict:
    """Attach a dataset root to a record (for records built in memory)."""
    record[ROOT_KEY] = root
    return record
