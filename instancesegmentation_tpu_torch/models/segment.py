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

``forward(..., skip_stem=True)`` takes the stem's output computed elsewhere
(``models/fused_stem.py:stem_apply``, ``models/fused_stem_hm.py:
stem_hm_apply``) in place of the images, and runs everything after
``init_conv``.

``set_quant`` switches the 76 convs that JAX builds with a ``quant_mode``
(every conv but the head's ``bottle6_2``) to post-training int8: "calibrate"
records each conv's input abs-max, "int8" quantises all 76, "int8_mxu" the 6
spatial non-grouped ones.  A section whose convs are quantised runs its
layer modules instead of its chain: under "int8_mxu" no chain conv is
quantised and both chains run; under "int8" neither does.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from instancesegmentation_tpu_torch.models.layers import (
    Bottleneck3x3,
    Bottleneck5x5,
    BottleneckDim,
    BottleneckDimRes,
    BottleneckDown2,
    BottleneckUpRes,
    Calibration,
    ConvBN,
    InitHeadS4,
    Int8,
    QUANT_MODES,
    conv,
    conv_transpose,
    int8_selected,
)
from instancesegmentation_tpu_torch.ops.fused_chain import ChainSpec, fused_chain
from instancesegmentation_tpu_torch.ops.int8_conv import Int8Conv

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
        self.quant_mode = "off"
        self._chains_bypassed = False  # a chain section holds a quantised conv

    def chain_sections(self) -> tuple[tuple[nn.Module, ...], tuple[nn.Module, ...]]:
        """The layer modules each chain computes in their place (``forward``
        runs them when the chains do not): section 1 after ``bottle1_1``,
        and sections 2 and 3 after ``bottle2_1``."""
        return (self.bottle1_x,), (self.bottle2_x, self.bottle3_1, self.bottle3_x)

    def quant_convs(self) -> dict[str, nn.Conv2d]:
        """The convs a quantisation mode can cover, by module path: every
        ``Conv2d`` but the head's ``bottle6_2`` (JAX's ``ConvBN`` and
        ``RawConv`` built with a ``quant_mode``; 76)."""
        return {path: m for path, m in self.named_modules()
                if isinstance(m, nn.Conv2d) and path != "bottle6_2"}

    def set_quant(self, mode: str, scales: Optional[Mapping] = None,
                  state_dict: Optional[Mapping] = None) -> None:
        """Switch the convs to a quantisation mode (JAX's ``quant_mode``):

        - "off": the float convs;
        - "calibrate": float math, every conv recording the running abs-max
          of its input (``calibration_scales``);
        - "int8", "int8_mxu": each conv ``int8_selected`` covers runs
          ``ops/int8_conv.py`` with the input abs-max ``scales[path]``
          (``calibration_scales``'s keys; entries of convs the mode does not
          cover are ignored), its weights quantised once, in float32, from
          ``state_dict[path + ".weight"]`` and its bias from
          ``state_dict[path + ".bias"]`` (default: the module's own).

        Training always runs the float convs.
        """
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant_mode {mode!r}; one of {QUANT_MODES}")
        convs = self.quant_convs()
        covered = [path for path, m in convs.items()
                   if mode != "off" and int8_selected(mode, m.kernel_size, m.groups)]
        if mode in ("int8", "int8_mxu"):
            missing = [path for path in covered if path not in (scales or {})]
            if missing:
                raise KeyError(f"{mode}: no calibrated scale for {len(missing)} convs, "
                               f"e.g. {missing[:3]}")
        device = self.bottle6_1.weight.device
        sd = state_dict or {}
        for path, m in convs.items():
            if path not in covered:
                m.quant = None
            elif mode == "calibrate":
                m.quant = Calibration()
            else:
                m.quant = Int8(Int8Conv(sd.get(f"{path}.weight", m.weight),
                                        sd.get(f"{path}.bias", m.bias), scales[path], m.stride,
                                        m.padding, m.dilation, m.groups, device))
        self.quant_mode = mode
        chained = {id(m) for section in self.chain_sections() for top in section
                   for m in top.modules()}
        self._chains_bypassed = any(id(convs[path]) in chained for path in covered)

    def calibration_scales(self) -> dict[str, float]:
        """The input abs-max each conv recorded under "calibrate", by module
        path (the convs that ran at least once)."""
        recorders = {path: getattr(m, "quant", None) for path, m in self.quant_convs().items()}
        return {path: float(q.amax) for path, q in recorders.items()
                if isinstance(q, Calibration) and q.amax is not None}

    def prepare_serving(self, s1: ChainSpec, s23: ChainSpec) -> None:
        """Serve from BN-folded weights: skip the identity BNs and route
        sections 1 and 2+3 through the two chains (built from the same
        folded state dict)."""
        for m in self.modules():
            if isinstance(m, (ConvBN, BottleneckUpRes)):
                m.bn_folded = True
        self.chains = (s1, s23)

    def forward(self, images, heatmaps=None, truncate_head: bool = False,
                train: bool = False, dtype: Optional[torch.dtype] = None,
                skip_stem: bool = False):
        """``skip_stem``: ``images`` is the stem's output ``[N, H/4, W/4,
        in_channels + 16]`` computed elsewhere (``models/fused_stem.py``,
        ``models/fused_stem_hm.py``); ``init_conv`` does not run."""
        if train and self.chains is not None:
            raise ValueError("a model prepared for serving (folded BN, chains) cannot train")
        dtype = self.bottle6_1.weight.dtype if dtype is None else dtype
        x = images.to(dtype)
        if skip_stem:
            if heatmaps is not None:
                raise ValueError("skip_stem takes the stem's features, with the heatmaps "
                                 "already in them")
            if x.shape[-1] != 16 + self.in_channels:
                raise ValueError(f"stem features have {x.shape[-1]} channels, expected "
                                 f"{16 + self.in_channels}")
        else:
            if heatmaps is not None:
                x = torch.cat([x, heatmaps.to(dtype)], dim=-1)
            if x.shape[-1] != self.in_channels:
                raise ValueError(
                    f"input has {x.shape[-1]} channels, model expects {self.in_channels}"
                )
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

        init_down = x if skip_stem else self.init_conv(x, train)

        chains = None if self._chains_bypassed else self.chains

        (bottle1_x,), (bottle2_x, bottle3_1, bottle3_x) = self.chain_sections()

        # section 1: /8, 48ch
        b1_down, b1_pool = self.bottle1_1(init_down, train)
        if chains is not None:
            b1_5 = _chain(b1_down, chains[0])
        else:
            b1_5 = _run(bottle1_x, b1_down, train)

        # section 2 + concat_2 + section 3: /16, 128ch
        b2_down, b2_pool = self.bottle2_1(b1_5, train)
        if chains is not None:
            b3_8 = _chain(b2_down, chains[1])
        else:
            b2_8 = _run(bottle2_x, b2_down, train)
            cat2 = torch.cat([b2_8, b2_down], dim=1)
            b3_8 = _run(bottle3_x, bottle3_1(cat2, train), train)

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
