"""Schema migration: rename ``<name>##other`` class keys to ``##class``
(copy of the JAX package's ``data/converters/migrate.py``).  Migrates the
top-level record, every object and every class_mask entry, in place.
"""
from __future__ import annotations

import glob
import json
import os

from instancesegmentation_tpu_torch.core.keys import key_combine

_OLD = key_combine("class", "other")
_NEW = key_combine("class", "class")


def _migrate_record(d: dict) -> bool:
    if _OLD in d:
        d[_NEW] = d.pop(_OLD)
        return True
    return False


def migrate_class_keys(dataset_dir: str) -> int:
    """Returns the number of JSON files modified."""
    changed_files = 0
    for ann_path in glob.glob(os.path.join(dataset_dir, "data", "*.json")):
        with open(ann_path) as f:
            ann = json.load(f)
        changed = _migrate_record(ann)
        for obj in ann.get(key_combine("object", "sub_list"), []):
            changed |= _migrate_record(obj)
        for cm in ann.get(key_combine("class_mask", "sub_list"), []):
            changed |= _migrate_record(cm)
        if changed:
            with open(ann_path, "w") as f:
                json.dump(ann, f)
            changed_files += 1
    return changed_files
