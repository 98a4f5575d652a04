"""Device selection for the port's entry points.

Counterpart of ``instancesegmentation_tpu/core/common.py:pick_device``: the
entry points run on the card unless the caller asks for the CPU, and never
fall back to the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def pick_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Resolve ``device``: ``None`` means ``cuda:0``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and CUDA is not available; pass ``device="cpu"`` to run on the
    host.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
