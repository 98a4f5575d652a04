"""int8 post-training-quantised convolution (NHWC): s8 x s8 -> s32 and the
dequantising epilogue.

Port of the JAX package's ``models/layers.py:_Int8Conv`` int8 path (its XLA
conv and the quantise / dequantise around it):

- the input is quantised with one symmetric scale per tensor,
  ``s_in = max(amax, 1e-6) / 127``, ``q = clip(round(x / s_in), -127, 127)``
  (a true division, rounded half to even);
- the weights are quantised per output channel,
  ``s_w = max(max|w|, 1e-12) / 127``, ``wq = clip(round(w / s_w), -127, 127)``;
- the conv accumulates in int32 and the epilogue is
  ``(float)acc * (s_in * s_w) + bias`` in float32, cast to the output dtype.

The scales are computed as XLA compiles JAX's expressions, so that they
equal the JAX program's bit for bit: both divisions by 127 are
multiplications by ``float32(1 / 127)`` (a constant divisor becomes its
reciprocal), and the epilogue's ``s_in * s_w`` is reassociated into
``max(max|w|, 1e-12) * (max(amax, 1e-6) * float32(1 / 127)^2)``.  The
division ``x / s_in`` has no constant divisor and stays a division.  XLA on
the CPU then contracts the epilogue's multiply-add into an FMA; the port
rounds the product and the sum apart (``__fmul_rn``, ``__fadd_rn``), so its
outputs may differ from the JAX program's by one rounding of the product.

``Int8Conv`` holds one conv's quantised weights, built once on the host in
float32 from the (BN-folded) float weights.  ``int8_conv`` on a CPU tensor
runs the plain version ``int8_conv_reference`` (the integer conv as a
float64 ``F.conv2d`` of the integer values, exact since
``|acc| <= K * 127^2 < 2^53``); on a CUDA tensor it launches the two
kernels of ``csrc/int8_conv.cu`` (quantise, then the direct conv with its
epilogue), counted in ``int8_conv.launches`` and
``int8_conv.launches_by_kernel``, or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

#: XLA's reciprocal of the constant divisor 127.0, and its square (the two
#: scales' constants folded into one)
RECIP_127 = np.float32(1.0) / np.float32(127.0)
RECIP_127_SQ = np.float32(RECIP_127 * RECIP_127)
KERNELS = ("quantize", "conv")
#: dynamic shared memory of the dense kernel's weight tile, bytes (no opt-in)
MAX_TILE_BYTES = 48 * 1024
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _clamped_amax(amax) -> np.float32:
    return np.maximum(np.float32(amax), np.float32(1e-6))


def input_scale(amax) -> np.float32:
    """``s_in = max(amax, 1e-6) / 127`` in float32, as the JAX program
    computes it."""
    return np.float32(_clamped_amax(amax) * RECIP_127)


def _weight_absmax(w: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 weights of ``w [out, in/groups, kh, kw]``
    (float32): ``(wq int8, s_w float32 [out])``."""
    w = w.detach().to("cpu", torch.float32)
    s_w = _weight_absmax(w) * torch.tensor(RECIP_127)
    wq = torch.clamp(torch.round(w / s_w.view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    return wq, s_w


def epilogue_scale(w: torch.Tensor, amax) -> torch.Tensor:
    """The epilogue's per-channel ``s_in * s_w`` (float32 [out]) as XLA
    compiles it: ``max(max|w|, 1e-12) * (max(amax, 1e-6) * (1/127)^2)``."""
    w = w.detach().to("cpu", torch.float32)
    return _weight_absmax(w) * torch.tensor(np.float32(_clamped_amax(amax) * RECIP_127_SQ))


class Int8Conv:
    """One conv's int8 form, from its float ``weight [out, in/groups, kh, kw]``,
    ``bias [out]``, the calibrated input abs-max ``amax`` and its geometry.

    The quantisation runs once, on the host in float32; the tensors the
    kernels read (the epilogue's ``scale`` (``epilogue_scale``) and bias, the
    weights in the kernel's layout) are put on ``device``.
    """

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, amax, stride: Sequence[int],
                 padding: Sequence[int], dilation: Sequence[int], groups: int, device="cpu"):
        self.wq, self.s_w = quantize_weight(weight)
        self.s_in = input_scale(amax)
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.dilation, self.groups = tuple(dilation), int(groups)
        self.out_channels, self.in_per_group, self.kh, self.kw = self.wq.shape
        self.in_channels = self.in_per_group * self.groups
        device = torch.device(device)
        self.scale = epilogue_scale(weight, amax).to(device)
        self.bias = bias.detach().to("cpu", torch.float32).to(device)
        self.w_kernel = None
        if device.type == "cuda":
            w = self.wq
            if self.groups == 1:
                # [out, kh, kw, Cp]: input channels last, zero-padded to a
                # multiple of 4 as the quantised input is
                w = F.pad(w.permute(0, 2, 3, 1), (0, _padded(self.in_channels) - self.in_channels))
            self.w_kernel = w.contiguous().to(device)

    def out_hw(self, h: int, w: int) -> tuple[int, int]:
        (sh, sw), (ph, pw), (dh, dw) = self.stride, self.padding, self.dilation
        return ((h + 2 * ph - dh * (self.kh - 1) - 1) // sh + 1,
                (w + 2 * pw - dw * (self.kw - 1) - 1) // sw + 1)


def _padded(c: int) -> int:
    return -(-c // 4) * 4


def _tile_channels(cout: int) -> int:
    """Output channels per block of the dense kernel (its ``COT``)."""
    return next(t for t in (16, 4, 1) if cout % t == 0)


def quantize_input_reference(x: torch.Tensor, s_in) -> torch.Tensor:
    """``clip(round(x / s_in), -127, 127)`` as int8, on ``x``'s device.  The
    divisor is a tensor on that device: a Python scalar would let CUDA
    multiply by its reciprocal instead."""
    s = torch.tensor(np.float32(s_in), device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def int8_conv_reference(x: torch.Tensor, conv: Int8Conv,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version on ``x [N, H, W, C]``'s device: ``[N, Ho, Wo, out]``
    in ``out_dtype`` (default ``x``'s), or the int32 accumulators for
    ``out_dtype=torch.int32``."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xq = quantize_input_reference(x, conv.s_in)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), conv.wq.to(x.device).double(), None,
                   conv.stride, conv.padding, conv.dilation, conv.groups)
    acc = acc.round().to(torch.int32).permute(0, 2, 3, 1)
    if out_dtype == torch.int32:
        return acc.contiguous()
    y = acc.float() * conv.scale.to(x.device) + conv.bias.to(x.device)
    return y.to(out_dtype).contiguous()


def _library():
    from instancesegmentation_tpu_torch.ops import _build

    lib = _build.library("int8_conv.cu")
    quant, conv = lib.int8_quantize_launch, lib.int8_conv_launch
    if quant.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        quant.argtypes = [p, i, p, ll, i, i, f, p]
        quant.restype = ctypes.c_int
        conv.argtypes = [p, p, p, p, p] + [i] * 18 + [p]
        conv.restype = ctypes.c_int
    return quant, conv


def _launch(x: torch.Tensor, conv: Int8Conv, out_dtype: torch.dtype) -> torch.Tensor:
    """The two kernels on a CUDA ``x [N, H, W, C]`` (float32 or bfloat16)."""
    if conv.w_kernel is None or conv.w_kernel.device != x.device:
        raise ValueError(f"the int8 conv's weights are not on {x.device}")
    n, h, w, c = x.shape
    cp = _padded(c)
    ho, wo = conv.out_hw(h, w)
    tile = _tile_channels(conv.out_channels) * conv.kh * conv.kw * cp
    if conv.groups == 1 and tile > MAX_TILE_BYTES:
        raise ValueError(f"int8 conv weights [{conv.out_channels}, {conv.kh}, {conv.kw}, {cp}] "
                         "exceed the dense kernel's shared-memory tile")
    out = torch.empty((n, ho, wo, conv.out_channels), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    quant, conv_fn = _library()
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = quant(x.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(), n * h * w, c,
                   cp // 4, float(conv.s_in), stream)
        if rc != 0:
            raise RuntimeError(f"int8 quantise kernel launch failed: CUDA error {rc}")
        int8_conv.launches += 1
        int8_conv.launches_by_kernel["quantize"] += 1
        (sh, sw), (ph, pw), (dh, dw) = conv.stride, conv.padding, conv.dilation
        rc = conv_fn(xq.data_ptr(), conv.w_kernel.data_ptr(), conv.scale.data_ptr(),
                     conv.bias.data_ptr(), out.data_ptr(), _OUT_KIND[out_dtype], n, h, w, cp,
                     ho, wo, conv.out_channels, conv.in_per_group, conv.groups, conv.kh,
                     conv.kw, sh, sw, ph, pw, dh, dw, stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {rc}")
    int8_conv.launches += 1
    int8_conv.launches_by_kernel["conv"] += 1
    return out


def int8_conv(x: torch.Tensor, conv: Int8Conv,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 conv of ``x [N, H, W, C]`` (float32 or bfloat16) ->
    ``[N, Ho, Wo, out]`` in ``out_dtype`` (default ``x``'s; ``torch.int32``:
    the accumulators, without the epilogue).

    A CPU tensor runs ``int8_conv_reference``; a CUDA tensor launches the
    quantise and conv kernels (2 launches, counted) or raises.
    """
    if x.dim() != 4 or x.shape[-1] != conv.in_channels:
        raise ValueError(f"int8_conv expects [N, H, W, {conv.in_channels}], got "
                         f"{tuple(x.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.dtype not in (torch.float32, torch.bfloat16) or out_dtype not in _OUT_KIND:
        raise TypeError(f"int8_conv takes float32 or bfloat16 in and float32, bfloat16 or "
                        f"int32 out, got {x.dtype} -> {out_dtype}")
    if x.device.type == "cpu":
        return int8_conv_reference(x, conv, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_conv has no kernel for device {x.device}")
    return _launch(x.contiguous(), conv, out_dtype)


def reset_launches() -> None:
    """Zero ``int8_conv.launches`` and ``int8_conv.launches_by_kernel``."""
    int8_conv.launches = 0
    int8_conv.launches_by_kernel = dict.fromkeys(KERNELS, 0)


reset_launches()
