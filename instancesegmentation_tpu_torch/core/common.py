"""Small host utilities: dict2class, path_decompose, mean, host
identification.

Copy of ``instancesegmentation_tpu/core/common.py`` without ``pick_device``
(the port's is ``core/device.py``)."""
from __future__ import annotations

import os
import socket
from types import SimpleNamespace
from typing import Iterable


def dict2class(d: dict) -> SimpleNamespace:
    """Attribute-style view of a config dict (ymlib.common.dict2class)."""
    return SimpleNamespace(**d)


def path_decompose(path: str) -> tuple[str, str, str]:
    """(dirname, stem, ext-without-dot) — ymlib.common.path_decompose
    (call-site semantics at reference infer.py:24-29)."""
    dirname = os.path.dirname(path)
    base = os.path.basename(path)
    stem, ext = os.path.splitext(base)
    return dirname, stem, ext[1:]


def mean(values: Iterable[float]) -> float:
    """Mean of an iterable/generator (ymlib.common.mean, used at
    reference train_instance.py:403,417)."""
    values = list(values)
    return sum(values) / len(values) if values else 0.0


def get_user_hostname() -> str:
    """user@hostname string (the reference keyed configs on it; this
    build keeps it only for informational logging)."""
    user = os.environ.get("USER", os.environ.get("USERNAME", "user"))
    return f"{user}@{socket.gethostname()}"
