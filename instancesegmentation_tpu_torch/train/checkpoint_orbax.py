"""Branch-best checkpoints as a directory: the port of the JAX package's
orbax backend (``instancesegmentation_tpu/train/checkpoint_orbax.py``).

Orbax imports JAX, so the port keeps the backend's contract, not orbax's
files:

- ``<branch>_best.orbax`` is a directory, written whole to ``.new`` (a
  leftover one is removed first) and then moved into place with
  ``os.replace``;
- inside it, ``state.iseg`` holds the payload of ``train/checkpoint.py``
  (``save_checkpoint``: ISEG magic, meta header, msgpack state tree);
- the sidecar ``<branch>_best.orbax.meta.json`` ``{branch_name, best,
  epoch}`` is written through ``mkstemp`` and ``os.replace`` AFTER the
  directory is in place, so a concurrent reader (syn_train) never adopts a
  half-written checkpoint;
- ``exists()`` needs the directory and the sidecar; ``best()`` reads the
  sidecar (None when it is missing or bad).

``load()`` returns ``(tree, meta)`` as ``BranchBestCheckpoint.load`` does, so
the trainer's resume, regression reload and syn_train adoption run
unchanged.  A directory that JAX's orbax wrote holds no ``state.iseg``:
``load`` raises ``ValueError`` saying so (ROADMAP C).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

from instancesegmentation_tpu_torch.train.checkpoint import (
    get_git_branch_name,
    load_checkpoint,
    save_checkpoint,
)

#: the payload's file inside the checkpoint directory
PAYLOAD = "state.iseg"


class OrbaxBranchBestCheckpoint:
    def __init__(self, checkpoint_dir: str, branch_name: Optional[str] = None):
        self.branch_name = branch_name or get_git_branch_name()
        self.path = os.path.join(checkpoint_dir, f"{self.branch_name}_best.orbax")
        self._meta_path = self.path + ".meta.json"

    def exists(self) -> bool:
        return os.path.exists(self._meta_path) and os.path.exists(self.path)

    def best(self) -> Optional[float]:
        try:
            with open(self._meta_path) as f:
                return json.load(f).get("best")
        except (OSError, ValueError, AttributeError):
            return None

    def save(self, tree: Any, best: float, epoch: int) -> None:
        meta = {"branch_name": self.branch_name, "best": float(best), "epoch": int(epoch)}
        directory = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(directory, exist_ok=True)
        tmp = self.path + ".new"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        save_checkpoint(os.path.join(tmp, PAYLOAD), tree, meta)
        if os.path.exists(self.path):
            shutil.rmtree(self.path)
        os.replace(tmp, self.path)

        fd, tmp_meta = tempfile.mkstemp(dir=directory)
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f)
        os.replace(tmp_meta, self._meta_path)

    def load(self) -> tuple[dict, dict]:
        payload = os.path.join(self.path, PAYLOAD)
        if not os.path.isfile(payload):
            raise ValueError(f"{self.path}: no {PAYLOAD} inside (a directory written by the "
                             "JAX package's orbax backend does not load in the port)")
        tree, _ = load_checkpoint(payload)
        with open(self._meta_path) as f:
            meta = json.load(f)
        return tree, meta
