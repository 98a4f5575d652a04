"""Inference-export transform: BatchNorm folding on the port's state dict.

Port of ``instancesegmentation_tpu/models/export.py``.  Every conv followed
by a BN gets ``w' = w * g / sqrt(v + eps)`` and
``b' = beta + (b - m) * g / sqrt(v + eps)``; the BN is then reset to
identity (scale 1, bias 0, mean 0, var 1 - eps), so the module graph is
unchanged.  Besides the ``ConvBN`` pairs (``<p>.conv`` / ``<p>.bn``), the
raw BN ``convs.2`` of a ``BottleneckUpRes`` folds into its transposed conv
``convs.1``, whose torch weight ``[in, out, kh, kw]`` keeps the output
channel on dim 1.
"""
from __future__ import annotations

from typing import Mapping

import torch

EPS = 1e-5

_MEAN = ".running_mean"


def _conv_of(bn_prefix: str) -> tuple[str, int]:
    """(conv prefix, output-channel dim of its weight) folded by a BN."""
    if bn_prefix.endswith(".bn"):
        return bn_prefix[: -len(".bn")] + ".conv", 0
    parent, _, name = bn_prefix.rpartition(".convs.")
    if name == "2" and parent.endswith("up"):
        return parent + ".convs.1", 1
    raise KeyError(f"no conv to fold BatchNorm {bn_prefix} into")


def fold_batchnorm(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Return a new state dict with every BN folded into its conv.

    A model loaded with the result computes the same eval forward as one
    loaded with ``state_dict`` (up to float rounding).
    """
    sd = {k: v.clone() for k, v in state_dict.items()}
    for key in state_dict:
        if not key.endswith(_MEAN):
            continue
        bn = key[: -len(_MEAN)]
        conv, out_dim = _conv_of(bn)
        scale = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + EPS)
        shape = [1] * sd[f"{conv}.weight"].dim()
        shape[out_dim] = -1
        sd[f"{conv}.weight"] = sd[f"{conv}.weight"] * scale.view(shape)
        sd[f"{conv}.bias"] = (
            sd[f"{bn}.bias"] + (sd[f"{conv}.bias"] - sd[f"{bn}.running_mean"]) * scale
        )
        sd[f"{bn}.weight"] = torch.ones_like(scale)
        sd[f"{bn}.bias"] = torch.zeros_like(scale)
        sd[f"{bn}.running_mean"] = torch.zeros_like(scale)
        sd[f"{bn}.running_var"] = torch.ones_like(scale) - EPS
    return sd
