"""Atomic single-file checkpoints with the reference's branch-best contract.

Port of ``instancesegmentation_tpu/train/checkpoint.py``; the files are the
JAX package's, byte for byte in layout, so each package reads the other's:
``ISEG`` magic, a little-endian u32 header length, the JSON meta header
``{branch_name, best, epoch}``, then the flax msgpack payload of the state
tree (``train/state.py:to_state_tree``), packed by the port's own codec
(``utils/msgpack.py``).  A file is written to a temp file in the same
directory and moved into place with ``os.replace``, so a reader never sees
half a checkpoint.
"""
from __future__ import annotations

import json
import os
import struct
import subprocess
import tempfile
from typing import Any, Optional

from instancesegmentation_tpu_torch.utils.msgpack import packb, unpackb

MAGIC = b"ISEG"


def get_git_branch_name(cwd: str = ".") -> str:
    """Current git branch (the reference keys checkpoints by it)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--abbrev-ref", "HEAD"],
            capture_output=True, text=True, cwd=cwd, timeout=10,
        )
        name = out.stdout.strip()
        return name if out.returncode == 0 and name else "main"
    except (OSError, subprocess.SubprocessError):
        return "main"


def save_checkpoint(path: str, tree: Any, meta: dict) -> None:
    """Atomically write ``tree`` (nested dicts of arrays) + JSON-able ``meta``."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    header = json.dumps(meta).encode("utf-8")
    payload = packb(tree)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_meta(path: str) -> Optional[dict]:
    """Read only the JSON meta header (cheap syn_train poll); None when the
    file is missing or not a checkpoint."""
    try:
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                return None
            (n,) = struct.unpack("<I", f.read(4))
            return json.loads(f.read(n).decode("utf-8"))
    except (OSError, ValueError, struct.error):
        return None


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """``(tree, meta)`` of a checkpoint: the payload as nested dicts of
    numpy arrays (bfloat16 leaves as torch tensors)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != MAGIC:
        raise ValueError(f"{path}: not an ISEG checkpoint")
    (n,) = struct.unpack("<I", blob[4:8])
    meta = json.loads(blob[8:8 + n].decode("utf-8"))
    return unpackb(blob[8 + n:]), meta


class BranchBestCheckpoint:
    """The reference's branch-best checkpoint file + contract."""

    def __init__(self, checkpoint_dir: str, branch_name: Optional[str] = None,
                 explicit_path: Optional[str] = None):
        self.branch_name = branch_name or get_git_branch_name()
        self.path = explicit_path or os.path.join(
            checkpoint_dir, f"{self.branch_name}_best.ckpt"
        )

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def best(self) -> Optional[float]:
        meta = read_meta(self.path)
        return None if meta is None else meta.get("best")

    def save(self, tree: Any, best: float, epoch: int) -> None:
        save_checkpoint(
            self.path,
            tree,
            {"branch_name": self.branch_name, "best": float(best), "epoch": int(epoch)},
        )

    def load(self) -> tuple[dict, dict]:
        return load_checkpoint(self.path)
