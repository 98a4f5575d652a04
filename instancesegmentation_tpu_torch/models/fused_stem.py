"""Space-to-depth re-lowering of the stride-4 stem (``InitHeadS4``).

Port of ``instancesegmentation_tpu/models/fused_stem.py``.  Each k5 s2 p2
conv of the stem is computed exactly as a 3x3 s1 p1 conv over the 2x2
space-to-depth transform of its input: with ``X[b, r] = x[2b + r]``,

    out(i, j) = sum_{ky,kx<3} K'[ky, kx] . X[i+ky-1, j+kx-1]
    K'[o, (ry*2+rx)*C + c, ky, kx] = K[o, c, 2ky+ry, 2kx+rx]

(the tap ``dy = 5``, i.e. ``ky = 2, ry = 1``, is zero).  The sums are the
same, so only float rounding differs from ``InitHeadS4``.

Inference only: each conv's BatchNorm running statistics are folded into
its kernel and bias (``scale = gamma * rsqrt(var + eps)``), and the PReLU
is applied as it is.  The folds read the port's state dict
(``<name>.layer{1,2}.conv.weight``, ``.conv.bias``, ``.bn.*``,
``.act.weight``).  Images and outputs are NHWC; the kernels are torch
``[out, in, kh, kw]`` tensors, float32.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # models/layers.BN_EPS


class FoldedStem(NamedTuple):
    k1: torch.Tensor  # [16, 4*C_in, 3, 3] s2d conv1 kernel, BN-folded
    b1: torch.Tensor  # [16]
    a1: torch.Tensor  # [16] PReLU weight
    k2: torch.Tensor  # [16, 64, 3, 3]
    b2: torch.Tensor  # [16]
    a2: torch.Tensor  # [16]
    in_channels: int


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/2, W/2, 4C]; channel = (ry*2+rx)*C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def _scatter_s2d_kernel(k5: torch.Tensor) -> torch.Tensor:
    """[O, C, 5, 5] k5 s2 p2 kernel -> the equivalent [O, 4C, 3, 3] k3 s1 p1."""
    o, c, kh, kw = k5.shape
    if (kh, kw) != (5, 5):
        raise ValueError(f"expected a 5x5 kernel, got {kh}x{kw}")
    out = k5.new_zeros((o, 4 * c, 3, 3))
    for dy in range(5):
        ky, ry = dy // 2, dy % 2
        for dx in range(5):
            kx, rx = dx // 2, dx % 2
            blk = (ry * 2 + rx) * c
            out[:, blk:blk + c, ky, kx] = k5[:, :, dy, dx]
    return out


def _fold_layer(sd: Mapping[str, torch.Tensor], prefix: str):
    """Fold a ``ConvBN``'s running-statistics BN into its conv: returns
    (kernel [O, C, kh, kw], bias [O]), float32."""
    def f(key):
        return sd[f"{prefix}.{key}"].detach().float().cpu()

    scale = f("bn.weight") * torch.rsqrt(f("bn.running_var") + BN_EPS)
    k = f("conv.weight") * scale.view(-1, 1, 1, 1)
    return k, (f("conv.bias") - f("bn.running_mean")) * scale + f("bn.bias")


def fold_stem(state_dict: Mapping[str, torch.Tensor], name: str = "init_conv") -> FoldedStem:
    """The s2d stem of a Segment state dict, BN running statistics folded in
    (float32, on the CPU)."""
    k1, b1 = _fold_layer(state_dict, f"{name}.layer1")
    k2, b2 = _fold_layer(state_dict, f"{name}.layer2")
    return FoldedStem(
        k1=_scatter_s2d_kernel(k1), b1=b1,
        a1=state_dict[f"{name}.layer1.act.weight"].detach().float().cpu(),
        k2=_scatter_s2d_kernel(k2), b2=b2,
        a2=state_dict[f"{name}.layer2.act.weight"].detach().float().cpu(),
        in_channels=int(k1.shape[1]),
    )


def nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as NCHW in channels_last memory (no copy when dense)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def prelu_nhwc(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha.to(x) * x)


def stem_apply(x: torch.Tensor, stem: FoldedStem, dtype=torch.float32) -> torch.Tensor:
    """Folded stem forward: ``x [N, H, W, C] -> [N, H/4, W/4, C+16]`` in
    ``dtype`` on ``x``'s device, the maxpool4 shortcut before the two-conv
    path, as ``InitHeadS4``."""
    xd = x.to(dtype)
    short = F.max_pool2d(nchw(xd), 4, 4).permute(0, 2, 3, 1)

    def conv(y, k, b, a):
        y = F.conv2d(nchw(space_to_depth(y)), k.to(y), padding=1).permute(0, 2, 3, 1)
        return prelu_nhwc(y + b.to(y), a)

    y = conv(xd, stem.k1, stem.b1, stem.a1)
    y = conv(y, stem.k2, stem.b2, stem.a2)
    return torch.cat([short, y], dim=-1)
