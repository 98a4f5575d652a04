"""The Segment network: ENet-style encoder-decoder for one-instance masks.

Port of ``instancesegmentation_tpu/models/segment.py``.  Public layout is
the JAX package's NHWC: ``images [N,H,W,3]`` and ``heatmaps
[N,H,W,in_channels-3]`` in, ``[N,H,W,1]`` float32 logits out (or the
``[N,H/4,W/4,16]`` features with ``truncate_head``).  Inside, the
activations are NCHW tensors in ``channels_last`` memory.  ``train=True``
runs every BN on its batch statistics and updates the running statistics
(``models/layers.py``); ``dtype`` is the compute dtype (default: the
parameters'), so float32 parameters can train in bfloat16.

When ``prepare_serving`` has been given the two chain specs built from
BN-folded weights, sections 1 and 2+3 run through
``ops.fused_chain.fused_chain`` (the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor); otherwise they run the layer modules, so
the unfolded eval forward stays available.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from instancesegmentation_tpu_torch.models.layers import (
    Bottleneck3x3,
    Bottleneck5x5,
    BottleneckDim,
    BottleneckDimRes,
    BottleneckDown2,
    BottleneckUpRes,
    ConvBN,
    InitHeadS4,
    conv,
    conv_transpose,
)
from instancesegmentation_tpu_torch.ops.fused_chain import ChainSpec, fused_chain

#: dilations of the four Bottleneck3x3(48) blocks of sections 2 and 3,
#: each section then ending in one Bottleneck5x5(48)
_S23_DILATIONS = (1, 2, 1, 4)


def _section(inplanes: int) -> nn.ModuleList:
    blocks = [Bottleneck3x3(inplanes, 48, d) for d in _S23_DILATIONS]
    return nn.ModuleList(blocks + [Bottleneck5x5(inplanes, 48)])


def _run(blocks, y, train: bool):
    for block in blocks:
        y = block(y, train)
    return y


def _chain(y, spec: ChainSpec):
    """Run a chain on an NCHW channels_last tensor through its NHWC view."""
    out = fused_chain(y.permute(0, 2, 3, 1).contiguous(), spec)
    return out.permute(0, 3, 1, 2)


class Segment(nn.Module):
    """Predict a full-resolution single-instance mask logit map.

    ``in_channels``: 3 (RGB only) or 20 (RGB + 17 keypoint heatmaps).
    Channel plan: stem C -> C+16 at /4; s1 48 at /8; s2 128 at /16;
    s3 cat 256 -> 128 at /16; s4 48 at /8; s5 16 at /4; s6 1 at /1.
    """

    def __init__(self, in_channels: int = 20):
        super().__init__()
        self.in_channels = in_channels
        init_dim = 16 + in_channels
        self.init_conv = InitHeadS4(in_channels, 16)
        self.bottle1_1 = BottleneckDown2(init_dim, 16, 48)
        self.bottle1_x = nn.ModuleList([Bottleneck3x3(48, 16) for _ in range(4)])
        self.bottle2_1 = BottleneckDown2(48, 16, 128)
        self.bottle2_x = _section(128)
        self.bottle3_1 = BottleneckDimRes(256, 48, 128, use_prelu=True)
        self.bottle3_x = _section(128)
        self.bottle4_1up = BottleneckUpRes(128, 16, 48, skip_channels=48)
        self.bottle4_2 = BottleneckDimRes(96, 16, 48, use_prelu=False)
        self.bottle4_3 = BottleneckDim(48, 16, 48, use_prelu=False)
        self.bottle5_1up = BottleneckUpRes(48, 4, 16, skip_channels=init_dim)
        self.bottle5_2 = BottleneckDim(16, 4, 16, use_prelu=False)
        self.bottle6_1 = nn.ConvTranspose2d(16, 4, 8, stride=4, padding=2)
        self.bottle6_2 = nn.Conv2d(4, 1, 3, padding=1)
        self.chains: Optional[tuple[ChainSpec, ChainSpec]] = None

    def prepare_serving(self, s1: ChainSpec, s23: ChainSpec) -> None:
        """Serve from BN-folded weights: skip the identity BNs and route
        sections 1 and 2+3 through the two chains (built from the same
        folded state dict)."""
        for m in self.modules():
            if isinstance(m, (ConvBN, BottleneckUpRes)):
                m.bn_folded = True
        self.chains = (s1, s23)

    def forward(self, images, heatmaps=None, truncate_head: bool = False,
                train: bool = False, dtype: Optional[torch.dtype] = None):
        if train and self.chains is not None:
            raise ValueError("a model prepared for serving (folded BN, chains) cannot train")
        dtype = self.bottle6_1.weight.dtype if dtype is None else dtype
        x = images.to(dtype)
        if heatmaps is not None:
            x = torch.cat([x, heatmaps.to(dtype)], dim=-1)
        if x.shape[-1] != self.in_channels:
            raise ValueError(
                f"input has {x.shape[-1]} channels, model expects {self.in_channels}"
            )
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

        init_down = self.init_conv(x, train)

        # section 1: /8, 48ch
        b1_down, b1_pool = self.bottle1_1(init_down, train)
        if self.chains is not None:
            b1_5 = _chain(b1_down, self.chains[0])
        else:
            b1_5 = _run(self.bottle1_x, b1_down, train)

        # section 2 + concat_2 + section 3: /16, 128ch
        b2_down, b2_pool = self.bottle2_1(b1_5, train)
        if self.chains is not None:
            b3_8 = _chain(b2_down, self.chains[1])
        else:
            b2_8 = _run(self.bottle2_x, b2_down, train)
            cat2 = torch.cat([b2_8, b2_down], dim=1)
            b3_8 = _run(self.bottle3_x, self.bottle3_1(cat2, train), train)

        # section 4: up to /8, 48ch
        b4_1 = self.bottle4_1up(b3_8, b2_pool, train)
        y = self.bottle4_2(torch.cat([b1_down, b4_1], dim=1), train)
        b4_3 = self.bottle4_3(y, train)

        # section 5: up to /4, 16ch
        b5_2 = self.bottle5_2(self.bottle5_1up(b4_3, b1_pool, train), train)
        if truncate_head:
            return b5_2.permute(0, 2, 3, 1)

        # section 6: /1, 1ch logits (no BN)
        logits = conv(self.bottle6_2, conv_transpose(self.bottle6_1, b5_2))
        return logits.float().permute(0, 2, 3, 1)


def count_params(model: nn.Module) -> int:
    """Trainable parameter count (BN running statistics excluded)."""
    return sum(p.numel() for p in model.parameters())
