"""Fused inference bottleneck block: one ``Bottleneck3x3`` in one launch.

Port of ``instancesegmentation_tpu/ops/fused_block.py:bottleneck3x3_fused``
(a Pallas TPU kernel): 1x1 reduce, PReLU, depthwise 3x3, PReLU, 1x1 expand,
residual add, PReLU, with BN pre-folded into the weights.  It runs as a
one-block ``ChainSpec`` on the chain kernel (``csrc/fused_chain.cu``), in
the form ``chain_form`` picks for float32 (the banded float32 cluster
kernel at the serving shapes), with the same signature and a float32
output.  The spec, and with it the packed weights on the card, is built
once per set of weight tensors.  Standalone: the serving path runs whole
chains instead.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from instancesegmentation_tpu_torch.ops.fused_chain import (
    ChainSpec,
    DepthwiseOp,
    MatmulOp,
    ResidualAdd,
    SaveResidual,
    _check,
    _launch,
    _launch_banded,
    chain_form,
    fused_chain_reference,
)


def bottleneck3x3_reference(x, w1, b1, a1, dw, b_dw, a2, w2, b2, a_out):
    """Unfused plain version (NHWC, BN already folded into the weights).

    x [N,H,W,C]; w1 [C,P]; dw [3,3,P]; w2 [P,C]; a* are PReLU alphas.
    """
    x = x.float()
    y = x @ w1 + b1
    y = torch.where(y >= 0, y, a1 * y)
    h, w = x.shape[1], x.shape[2]
    yp = F.pad(y, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(y)
    for dy in range(3):
        for dx in range(3):
            acc = acc + yp[:, dy:dy + h, dx:dx + w, :] * dw[dy, dx]
    acc = acc + b_dw
    acc = torch.where(acc >= 0, acc, a2 * acc)
    out = acc @ w2 + b2 + x
    return torch.where(out >= 0, out, a_out * out)


def _np(t) -> np.ndarray:
    return torch.as_tensor(t).detach().cpu().numpy().astype(np.float32)


def _spec(x, w1, b1, a1, dw, b_dw, a2, w2, b2, a_out) -> ChainSpec:
    n, h, w, c = x.shape
    taps = [(dy - 1, dx - 1) for dy in range(3) for dx in range(3)]
    ops = [
        SaveResidual(),
        MatmulOp(_np(w1), _np(b1), alpha=_np(a1)),
        DepthwiseOp(taps, _np(dw).reshape(9, -1), _np(b_dw), alpha=_np(a2)),
        MatmulOp(_np(w2), _np(b2)),
        ResidualAdd(alpha=_np(a_out)),
    ]
    return ChainSpec(h=h, w=w, c_in=c, c_out=c, ops=ops)


#: specs by (shape, weight tensors' identities and versions); each entry
#: holds its tensors, so an identity stays theirs while it is cached
_SPECS: dict = {}
_MAX_SPECS = 8


def _cached_spec(x, weights) -> ChainSpec:
    key = (tuple(x.shape[1:]),) + tuple(
        (id(t), getattr(t, "_version", None)) for t in weights)
    hit = _SPECS.get(key)
    if hit is None:
        if len(_SPECS) >= _MAX_SPECS:
            _SPECS.pop(next(iter(_SPECS)))
        hit = _SPECS[key] = (weights, _spec(x, *weights))
    return hit[1]


def bottleneck3x3_fused(x, w1, b1, a1, dw, b_dw, a2, w2, b2, a_out):
    """Fused version of ``bottleneck3x3_reference``: float32 out.

    A CPU tensor runs the chain's plain version; a CUDA tensor launches the
    chain kernel in the form ``chain_form`` picks (counted in
    ``bottleneck3x3_fused.launches`` and ``.launches_by_form``) or raises.
    """
    x = x.float().contiguous()
    spec = _cached_spec(x, (w1, b1, a1, dw, b_dw, a2, w2, b2, a_out))
    _check(x, spec)
    if x.device.type == "cpu":
        return fused_chain_reference(x, spec)
    if x.device.type != "cuda":
        raise RuntimeError(f"bottleneck3x3_fused has no kernel for device {x.device}")
    form = chain_form(spec, torch.float32)
    out = _launch(x, spec) if form == "simt" else _launch_banded(x, spec)
    bottleneck3x3_fused.launches += 1
    bottleneck3x3_fused.launches_by_form[form] += 1
    return out


def reset_launches() -> None:
    """Set ``bottleneck3x3_fused``'s launch counts to 0."""
    bottleneck3x3_fused.launches = 0
    bottleneck3x3_fused.launches_by_form = {"banded_f32": 0, "simt": 0}


reset_launches()
