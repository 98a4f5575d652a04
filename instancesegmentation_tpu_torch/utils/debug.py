"""Debug helpers: model summaries and array statistics.

Port of ``instancesegmentation_tpu/utils/debug.py`` (the reference's
``modshow`` / ``check``) for tensors and modules.
"""
from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch
from torch import nn

#: state-dict entries that are buffers, not parameters
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def check(x: Any, name: str = "array") -> str:
    """One-line statistics of an array or tensor (the reference's
    ``check``), printed and returned.  A tensor is read on the host (a
    bfloat16 one in float32) and named by its own dtype."""
    if isinstance(x, torch.Tensor):
        dtype = str(x.dtype).removeprefix("torch.")
        t = x.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    else:
        arr = np.asarray(x)
        dtype = arr.dtype
    finite = np.isfinite(arr)
    line = (
        f"{name}: shape={tuple(arr.shape)} dtype={dtype} "
        f"min={arr.min():+.5g} max={arr.max():+.5g} "
        f"mean={arr.mean():+.5g} std={arr.std():.5g} "
        f"nonfinite={int((~finite).sum())}"
    )
    print(line)
    return line


def model_summary(model: Union[nn.Module, Mapping[str, Any]], max_depth: int = 1) -> str:
    """Per-module parameter table (the reference's ``modshow``), printed and
    returned: parameters grouped by the first ``max_depth`` components of
    their dotted names.  ``model`` is a module (its parameters) or a state
    dict (its entries but the BN running statistics)."""
    if isinstance(model, nn.Module):
        leaves = [(n, p.numel()) for n, p in model.named_parameters()]
    else:
        leaves = [(n, int(np.prod(np.shape(v)))) for n, v in model.items()
                  if not n.endswith(_BUFFERS)]
    groups: dict[str, int] = {}
    for name, size in leaves:
        group = ".".join(name.split(".")[:max_depth])
        groups[group] = groups.get(group, 0) + size
    total = sum(groups.values())
    width = max(len(g) for g in groups) if groups else 10
    lines = [f"{'module':<{width}}  params"]
    for g in sorted(groups):
        lines.append(f"{g:<{width}}  {groups[g]:,}")
    lines.append(f"{'TOTAL':<{width}}  {total:,}")
    table = "\n".join(lines)
    print(table)
    return table
