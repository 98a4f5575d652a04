"""Building blocks of the Segment encoder-decoder.

Port of ``instancesegmentation_tpu/models/layers.py``.  Activations are
logical NCHW tensors kept in ``torch.channels_last`` memory format, so the
NHWC ``[N*H*W, C]`` view the chain kernel reads costs no copy.  Attribute
names follow the state-dict keys of the PyTorch reference Segment (for
example ``convs.1.conv.weight``, ``convm.0.bn.running_var``,
``uppool.1.weight``), so ``utils/weights.py`` carries flax variables over
with a key mapping and layout transforms only.

Quirks kept from the reference:
- explicit symmetric torch paddings (k5 s2 p2 pads (2, 2), not 'SAME');
- ``Bottleneck5x5``: the (5,1) depthwise conv is raw — bias, no BN, no
  activation — while the (1,5) leg has BN + PReLU;
- ``BottleneckDim(use_prelu=False)``: the middle 3x3 conv is dense, with
  ReLU activations;
- ``BottleneckDim`` / ``BottleneckDimRes`` with ``use_prelu=False`` keep a
  dead PReLU so the state dict stays a bijection with the reference;
- ``BottleneckDown2`` returns the max-pooled *input* as the skip tensor;
- ``BottleneckUpRes`` runs its 1x1 merge conv before the nearest 2x
  upsample (a pointwise conv commutes exactly with replication);
- VALID max pools, BatchNorm eps 1e-5, PReLU as ``where(x >= 0, x, a*x)``.

Every forward takes ``train``.  In eval mode BN uses its running
statistics; once ``fold_batchnorm`` has folded every BN into its conv,
``bn_folded`` (set by ``Segment.prepare_serving``) skips the identity BNs.  In
train mode BN normalises with the batch statistics in float32 and updates the
running statistics as flax does (``_bn_train``); inside
``sync_batchnorm(model, group)`` the batch statistics are those of the whole
data-parallel batch over the ranks of ``group``.  Convs run in the dtype of
their input: float32 parameters are cast to it at each call, so a float32
model computes in bfloat16 when fed bfloat16 activations, as the JAX
package's ``dtype=bfloat16`` modules do.

Every conv that JAX builds as a ``ConvBN`` or ``RawConv`` can be switched to
post-training int8 (``quant_mode``: "calibrate", "int8" or "int8_mxu";
``Segment.set_quant``): the switch is the conv's ``quant`` attribute, which
``conv`` calls outside training, and is not part of the state dict, so a
float checkpoint loads unchanged (JAX's separate ``quant`` collection).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from instancesegmentation_tpu_torch.ops.int8_conv import Int8Conv, int8_conv

BN_EPS = 1e-5
#: flax's BatchNorm momentum: running = MOMENTUM * running + (1 - MOMENTUM) *
#: batch (torch's ``momentum=0.1`` is the same decay)
BN_MOMENTUM = 0.9


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def autopad(k) -> Tuple[int, int]:
    """torch-style 'same' padding: k//2 per spatial dim."""
    kh, kw = _pair(k)
    return kh // 2, kw // 2


class PReLU(nn.Module):
    """Per-channel PReLU on NCHW (init 0.25): ``where(x >= 0, x, a*x)``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        a = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return torch.where(x >= 0, x, a * x)


class ConvBN(nn.Module):
    """Conv2d(bias) + BatchNorm + activation ('prelu', 'relu' or None)."""

    def __init__(self, cin: int, cout: int, kernel=1, stride=1,
                 padding=None, groups: int = 1, dilation=1,
                 act: Optional[str] = None):
        super().__init__()
        pad = autopad(kernel) if padding is None else _pair(padding)
        self.conv = nn.Conv2d(cin, cout, _pair(kernel), _pair(stride), pad,
                              _pair(dilation), groups, bias=True)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        if act not in (None, "prelu", "relu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = PReLU(cout) if act == "prelu" else None
        self.relu = act == "relu"
        self.bn_folded = False
        self.bn_group = None  # set by sync_batchnorm

    def forward(self, x, train: bool = False):
        x = conv(self.conv, x, train)
        if train:
            x = _bn_train(self.bn, x, self.bn_group)
        elif not self.bn_folded:
            x = _bn_eval(self.bn, x)
        if self.act is not None:
            return self.act(x)
        return F.relu(x) if self.relu else x


def conv(m: nn.Conv2d, x, train: bool = False):
    """``m`` applied to ``x`` in ``x``'s dtype (parameters cast to it), or,
    outside training, through its quantisation mode when one is set
    (``m.quant``: ``Calibration`` or ``Int8``)."""
    quant = getattr(m, "quant", None)
    if quant is not None and not train:
        return quant(m, x)
    return _float_conv(m, x)


def _float_conv(m: nn.Conv2d, x):
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return m._conv_forward(x, m.weight.to(x.dtype), bias)


#: a conv's quantisation modes (JAX ``ConvBN.quant_mode``)
QUANT_MODES = ("off", "calibrate", "int8", "int8_mxu")


def int8_selected(mode: str, kernel_size, groups: int) -> bool:
    """Which convs a mode covers (JAX ``layers.py:_int8_selected``): every
    conv under "calibrate" and "int8" (one calibration serves both int8
    modes); under "int8_mxu" only the spatial (k >= 2) non-grouped ones."""
    if mode == "int8_mxu":
        return groups == 1 and max(_pair(kernel_size)) >= 2
    return True


class Calibration:
    """A conv's "calibrate" mode: the float conv, unchanged, while ``amax``
    (a float32 scalar tensor on the input's device) keeps the running
    maximum of ``|x|`` over the calls."""

    def __init__(self):
        self.amax = None

    def __call__(self, m: nn.Conv2d, x):
        a = x.detach().abs().amax().float()
        self.amax = a if self.amax is None else torch.maximum(self.amax, a)
        return _float_conv(m, x)


class Int8:
    """A conv's int8 mode: ``ops/int8_conv.py:int8_conv`` of the NHWC view of
    ``x`` (channels_last memory), in ``x``'s dtype."""

    def __init__(self, qconv: Int8Conv):
        self.qconv = qconv

    def __call__(self, m: nn.Conv2d, x):
        return int8_conv(x.permute(0, 2, 3, 1), self.qconv).permute(0, 3, 1, 2)


def conv_transpose(m: nn.ConvTranspose2d, x):
    """``m`` applied to ``x`` in ``x``'s dtype (parameters cast to it)."""
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv_transpose2d(x, m.weight.to(x.dtype), bias, m.stride, m.padding,
                              m.output_padding, m.groups, m.dilation)


def _stat_dtype(x) -> torch.dtype:
    """BN statistics run in at least float32 (flax's promotion)."""
    return torch.promote_types(x.dtype, torch.float32)


def _bn_eval(bn: nn.BatchNorm2d, x):
    """Running-statistics BN, computed in at least float32, returned in
    ``x``'s dtype."""
    dt = _stat_dtype(x)
    return F.batch_norm(x.to(dt), bn.running_mean.to(dt), bn.running_var.to(dt),
                        bn.weight.to(dt), bn.bias.to(dt), training=False,
                        eps=bn.eps).to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce(SUM)`` over ``group`` whose backward is the same sum:
    JAX's psum, whose transpose is a psum.  Each rank's gradient then holds
    every rank's terms through the shared statistics, and the ranks' mean
    gradient is the full batch's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


#: set in the thread that recomputes a checkpointed forward (``recomputing``)
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """Within the block, train-mode BN leaves its running statistics alone:
    the recompute of a checkpointed forward (``TrainConfig.remat``) gives the
    batch statistics the gradient needs, and the forward already updated the
    running ones."""
    outer = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = outer


def _bn_train(bn: nn.BatchNorm2d, x, group=None):
    """Batch-statistics BN as flax computes it, returned in ``x``'s dtype.

    In at least float32: ``mean = E[x]``, ``var = max(0, E[x^2] - mean^2)`` (the
    BIASED variance), ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``.
    The running statistics become ``0.9 * running + 0.1 * batch`` with that
    same biased variance (``F.batch_norm(training=True)`` would store the
    unbiased one).

    With a process ``group``, ``E[x]`` and ``E[x^2]`` are the means of the
    ranks' local ones (every rank holds as many rows), in one differentiable
    all-reduce: flax's ``pmean`` of the two under ``axis_name``.  Inside
    ``recomputing()`` the statistics (and their all-reduce) are computed
    again, and the running statistics are not updated.
    """
    x32 = x.to(_stat_dtype(x))
    dims = (0, 2, 3)
    mean = x32.mean(dims)
    meansq = (x32 * x32).mean(dims)
    if group is not None:
        stats = _AllReduceSum.apply(torch.stack([mean, meansq]), group)
        mean, meansq = stats / dist.get_world_size(group)
    var = torch.clamp_min(meansq - mean * mean, 0.0)
    if not getattr(_RECOMPUTE, "active", False):
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x32 - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)
    return y.to(x.dtype)


@contextlib.contextmanager
def sync_batchnorm(model: nn.Module, group):
    """Within the block, every train-mode BN of ``model`` takes its batch
    statistics over the ranks of the process ``group`` (``_bn_train``)."""
    mods = [m for m in model.modules() if hasattr(m, "bn_group")]
    for m in mods:
        m.bn_group = group
    try:
        yield
    finally:
        for m in mods:
            m.bn_group = None


def _apply(m: nn.Module, y, train: bool):
    """One entry of a block's ``convs``: a ConvBN, or a raw Conv2d."""
    return m(y, train) if isinstance(m, ConvBN) else conv(m, y, train)


class InitHeadS4(nn.Module):
    """Stride-4 stem: maxpool4 shortcut || two k5 s2 PReLU convs,
    channel-concat (shortcut first) -> ``in+16`` channels at 1/4 res."""

    def __init__(self, cin: int, planes: int = 16):
        super().__init__()
        self.layer1 = ConvBN(cin, planes, 5, 2, 2, act="prelu")
        self.layer2 = ConvBN(planes, planes, 5, 2, 2, act="prelu")

    def forward(self, x, train: bool = False):
        short = F.max_pool2d(x, 4, 4)
        y = self.layer2(self.layer1(x, train), train)
        return torch.cat([short.to(y.dtype), y], dim=1)


class Bottleneck3x3(nn.Module):
    """1x1-reduce -> depthwise 3x3 (opt. dilated) -> 1x1-expand, PReLU
    residual add."""

    def __init__(self, inplanes: int, planes: int, dilation: int = 1):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(inplanes, planes, 1, act="prelu"),
            ConvBN(planes, planes, 3, padding=dilation, groups=planes,
                   dilation=dilation, act="prelu"),
            ConvBN(planes, inplanes, 1),
        ])
        self.prelu = PReLU(inplanes)

    def forward(self, x, train: bool = False):
        y = x
        for m in self.convs:
            y = _apply(m, y, train)
        return self.prelu(y + x)


class Bottleneck5x5(nn.Module):
    """Factorised 5x1 + 1x5 depthwise bottleneck; the (5,1) leg is a raw
    biased conv with no BN and no activation."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(inplanes, planes, 1, act="prelu"),
            nn.Conv2d(planes, planes, (5, 1), padding=(2, 0), groups=planes),
            ConvBN(planes, planes, (1, 5), padding=(0, 2), groups=planes,
                   act="prelu"),
            ConvBN(planes, inplanes, 1),
        ])
        self.prelu = PReLU(inplanes)

    def forward(self, x, train: bool = False):
        y = x
        for m in self.convs:
            y = _apply(m, y, train)
        return self.prelu(y + x)


class BottleneckDown2(nn.Module):
    """Stride-2 downsample block.  Returns ``(out, pooled_input)``: the
    second value is the max-pooled input, a later decoder skip."""

    def __init__(self, inplanes: int, planes: int, outplanes: int):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBN(inplanes, planes, 2, 2, padding=0, act="prelu"),
            ConvBN(planes, planes, 3, padding=1, groups=planes, act="prelu"),
            ConvBN(planes, outplanes, 1),
        ])
        self.convm = nn.ModuleList([ConvBN(inplanes, outplanes, 1)])
        self.prelu = PReLU(outplanes)

    def forward(self, x, train: bool = False):
        y = x
        for m in self.convs:
            y = m(y, train)
        pooled = F.max_pool2d(x, 2, 2)
        return self.prelu(y + self.convm[0](pooled, train)), pooled


class BottleneckDimRes(nn.Module):
    """Channel-changing residual block with a 1x1 shortcut projection.
    Both branches use PReLU inside; ``use_prelu`` picks only the final
    activation (PReLU, or ReLU with a dead PReLU kept)."""

    def __init__(self, inplanes: int, planes: int, outplanes: int,
                 use_prelu: bool):
        super().__init__()
        self.use_prelu = use_prelu
        self.convs = nn.ModuleList([
            ConvBN(inplanes, planes, 1, act="prelu"),
            ConvBN(planes, planes, 3, padding=1, groups=planes, act="prelu"),
            ConvBN(planes, outplanes, 1),
        ])
        self.resconv = nn.ModuleList([ConvBN(inplanes, outplanes, 1)])
        self.prelu = PReLU(outplanes)

    def forward(self, x, train: bool = False):
        y = x
        for m in self.convs:
            y = m(y, train)
        y = y + self.resconv[0](x, train)
        return self.prelu(y) if self.use_prelu else F.relu(y)


class BottleneckDim(nn.Module):
    """Identity-shortcut block.  With ``use_prelu=False`` the middle 3x3
    conv is dense (no groups) and the activations are ReLU, with a dead
    PReLU kept."""

    def __init__(self, inplanes: int, planes: int, outplanes: int,
                 use_prelu: bool):
        super().__init__()
        self.use_prelu = use_prelu
        act = "prelu" if use_prelu else "relu"
        groups = planes if use_prelu else 1
        self.convs = nn.ModuleList([
            ConvBN(inplanes, planes, 1, act=act),
            ConvBN(planes, planes, 3, padding=1, groups=groups, act=act),
            ConvBN(planes, outplanes, 1),
        ])
        self.prelu = PReLU(outplanes)

    def forward(self, x, train: bool = False):
        y = x
        for m in self.convs:
            y = m(y, train)
        y = y + x
        return self.prelu(y) if self.use_prelu else F.relu(y)


class BottleneckUpRes(nn.Module):
    """2x upsampling decoder block with a skip-feature merge.

    Main path: 1x1 (ReLU) -> ConvTranspose k4 s2 p1 + BN + ReLU -> 1x1.
    Skip path: 1x1-project x, concat the encoder skip at low resolution,
    raw 1x1 merge conv, nearest 2x upsample.  ``convs`` and ``uppool`` keep
    the reference's Sequential indices (``convs.3`` is the ReLU,
    ``uppool.0`` the upsample).
    """

    def __init__(self, inplanes: int, planes: int, outplanes: int,
                 skip_channels: int):
        super().__init__()
        self.convs = nn.Sequential(
            ConvBN(inplanes, planes, 1, act="relu"),
            nn.ConvTranspose2d(planes, planes, 4, stride=2, padding=1),
            nn.BatchNorm2d(planes, eps=BN_EPS),
            nn.ReLU(),
            ConvBN(planes, outplanes, 1),
        )
        self.conv2 = nn.ModuleList([ConvBN(inplanes, outplanes, 1)])
        self.uppool = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            nn.Conv2d(outplanes + skip_channels, outplanes, 1),
        )
        self.bn_folded = False
        self.bn_group = None  # set by sync_batchnorm

    def forward(self, x, skip, train: bool = False):
        y = conv_transpose(self.convs[1], self.convs[0](x, train))
        if train:
            y = _bn_train(self.convs[2], y, self.bn_group)
        elif not self.bn_folded:
            y = _bn_eval(self.convs[2], y)
        y = self.convs[4](F.relu(y), train)
        merged = torch.cat([self.conv2[0](x, train), skip.to(y.dtype)], dim=1)
        shortcut = self.uppool[0](conv(self.uppool[1], merged, train))
        return F.relu(y + shortcut)


def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation matching the JAX package's: Kaiming fan-in
    normal convs with zero bias; transposed convs (weight and bias)
    uniform in +-1/sqrt(out*kh*kw), torch's default for them; BN scale 1,
    bias 0, mean 0, var 1; PReLU 0.25.  Draws from ``generator`` in module
    order."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, PReLU):
                m.weight.fill_(0.25)
