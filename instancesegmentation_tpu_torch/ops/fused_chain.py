"""Fused bottleneck-chain kernel (inference): a chain of BN-folded residual
bottleneck blocks in one launch.

Port of ``instancesegmentation_tpu/ops/fused_chain.py:fused_chain`` (a
Pallas TPU kernel) to a hand-written CUDA C++ kernel for Hopper
(``csrc/fused_chain.cu``).  It computes what the TPU kernel computes:

  * activations are flat ``[H*W, C]`` rows of one image (NHWC);
  * a 1x1 conv is ``[R,Ci] @ [Ci,Co]`` + bias + PReLU / ReLU;
  * a depthwise tap at ``(dy, dx)`` (3x3 at dilation 1/2/4, (5,1), (1,5))
    reads ``in[y+dy, x+dx]`` when that coordinate is inside the image and
    zero otherwise;
  * a residual add closes each block, with an optional 1x1 projection of
    the saved tensor (``BottleneckDimRes``'s resconv);
  * ``ConcatChainInput`` appends the chain input to the current tensor
    (``cat2 = [b2_8, b2_down]``).

The spec (``ChainSpec`` and its op descriptors) and the extractors come
over from the JAX module; the extractors read the port's state dict
(torch layouts) instead of flax params.

The CUDA source has three forms of the kernel:

  * **banded** (bfloat16 I/O): one thread-block cluster per image, each CTA
    owning a band of whole image rows; every activation of the chain lives
    in shared memory as bf16, the 1x1 convs run on the tensor cores
    (``mma.sync`` m16n8k16, float32 accumulation) and the depthwise taps
    read the neighbours' rows through distributed shared memory.
    ``plan_banded`` lays it out once per spec: cluster size, bands, buffers,
    weight slots, barrier phases, and the weights packed in fragment order.
  * **banded_f32** (float32 I/O): the same cluster schedule from the same
    planner over float32 rows, the 1x1 convs as register-tiled float32 FMAs
    on the CUDA cores (both operands from shared memory), their weights
    streamed in K-chunks through the two parameter slots.  The exact
    float32 program the TPU kernel runs; ``bottleneck3x3_fused`` runs on it.
  * **simt** (any spec no cluster of <= 16 CTAs can hold): one CTA per image
    walking an instruction table from ``compile_chain`` over a float32
    global scratch, products as float32 FMAs.

``fused_chain(x, spec)`` runs the plain PyTorch version
(``fused_chain_reference``) on a CPU tensor and launches one form on a CUDA
tensor (``chain_form`` decides by dtype and shape), raising on a build or
launch failure.  ``fused_chain.launches`` counts every launch and
``fused_chain.launches_by_form`` each form's.  ``fused_chain_reference(...,
act_dtype=torch.bfloat16)`` is the banded form's plain version: it rounds
where that kernel rounds; the float32 default is the other two forms'.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field, fields, replace
from typing import List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "MatmulOp",
    "DepthwiseOp",
    "ResidualAdd",
    "SaveResidual",
    "ConcatChainInput",
    "ChainSpec",
    "ChainProgram",
    "compile_chain",
    "BandPlan",
    "plan_banded",
    "chain_form",
    "fused_chain",
    "fused_chain_reference",
    "extract_bottleneck3x3",
    "extract_bottleneck5x5",
    "extract_bottleneck_dim",
    "extract_s23_chain",
    "extract_s1_chain",
]


# ---------------------------------------------------------------------------
# chain op descriptors (weights are float32 arrays captured at build time)
# ---------------------------------------------------------------------------


@dataclass
class MatmulOp:
    """1x1 conv: ``y = act(x @ w + b)``; w [Ci, Co], b [Co]."""

    w: np.ndarray
    b: np.ndarray
    alpha: Optional[np.ndarray] = None  # PReLU slope [Co]; None = linear
    relu: bool = False


@dataclass
class DepthwiseOp:
    """Depthwise conv as masked taps: taps [(dy, dx)] (dilation applied),
    w [n_taps, C], b [C]; ``alpha`` / ``relu`` as in MatmulOp."""

    taps: List[Tuple[int, int]]
    w: np.ndarray
    b: np.ndarray
    alpha: Optional[np.ndarray] = None
    relu: bool = False


@dataclass
class ResidualAdd:
    """``x = act(y + saved)`` closing a block; ``proj`` optionally projects
    the saved tensor first."""

    alpha: Optional[np.ndarray] = None
    relu: bool = False
    proj: Optional[MatmulOp] = None


@dataclass
class SaveResidual:
    """Mark the current tensor as the pending residual input."""


@dataclass
class ConcatChainInput:
    """``x = concat([x, chain_input], axis=-1)``."""


@dataclass
class ChainSpec:
    h: int
    w: int
    c_in: int
    c_out: int
    ops: list = field(default_factory=list)
    # the banded plan and the per-device packed buffers of the kernels,
    # filled on first use
    _packed: dict = field(default_factory=dict, repr=False, compare=False)

    def to(self, device) -> "ChainSpec":
        """A copy whose weights are torch tensors on ``device``, for the
        plain version (the kernel packs the numpy spec itself)."""

        def conv(op):
            kw = {}
            for f in fields(op):
                v = getattr(op, f.name)
                if isinstance(v, np.ndarray):
                    kw[f.name] = torch.as_tensor(v, device=device)
                elif isinstance(v, MatmulOp):
                    kw[f.name] = conv(v)
            return replace(op, **kw)

        return ChainSpec(self.h, self.w, self.c_in, self.c_out,
                         [conv(op) for op in self.ops])


# ---------------------------------------------------------------------------
# spec extraction from a BN-folded port state dict (torch layouts)
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _conv1x1(sd, p):
    """``<p>.conv`` 1x1 weight [Co,Ci,1,1] -> (w [Ci,Co], b [Co])."""
    k = _np(sd[f"{p}.conv.weight"])
    return np.ascontiguousarray(k[:, :, 0, 0].T), _np(sd[f"{p}.conv.bias"])


def _dw_taps(sd, p, dilation: int, shape: Tuple[int, int]):
    """Depthwise conv ``<p>.weight`` [C,1,kh,kw] -> (taps, w [n,C], b [C])."""
    k = _np(sd[f"{p}.weight"])
    kh, kw = shape
    assert k.shape[2:] == (kh, kw), k.shape
    taps, ws = [], []
    for dy in range(kh):
        for dx in range(kw):
            taps.append(((dy - kh // 2) * dilation, (dx - kw // 2) * dilation))
            ws.append(k[:, 0, dy, dx])
    return taps, np.stack(ws), _np(sd[f"{p}.bias"])


def _alpha(sd, p):
    return _np(sd[f"{p}.weight"])


def extract_bottleneck3x3(sd, prefix: str, dilation: int = 1) -> list:
    """Bottleneck3x3 at ``prefix`` (e.g. ``bottle2_x.1``)."""
    w1, b1 = _conv1x1(sd, f"{prefix}.convs.0")
    taps, dw, bdw = _dw_taps(sd, f"{prefix}.convs.1.conv", dilation, (3, 3))
    w2, b2 = _conv1x1(sd, f"{prefix}.convs.2")
    return [
        SaveResidual(),
        MatmulOp(w1, b1, alpha=_alpha(sd, f"{prefix}.convs.0.act")),
        DepthwiseOp(taps, dw, bdw, alpha=_alpha(sd, f"{prefix}.convs.1.act")),
        MatmulOp(w2, b2),
        ResidualAdd(alpha=_alpha(sd, f"{prefix}.prelu")),
    ]


def extract_bottleneck5x5(sd, prefix: str) -> list:
    """Bottleneck5x5: the (5,1) leg is raw — bias, no BN, no activation."""
    w1, b1 = _conv1x1(sd, f"{prefix}.convs.0")
    taps_v, dwv, bv = _dw_taps(sd, f"{prefix}.convs.1", 1, (5, 1))
    taps_h, dwh, bh = _dw_taps(sd, f"{prefix}.convs.2.conv", 1, (1, 5))
    w2, b2 = _conv1x1(sd, f"{prefix}.convs.3")
    return [
        SaveResidual(),
        MatmulOp(w1, b1, alpha=_alpha(sd, f"{prefix}.convs.0.act")),
        DepthwiseOp(taps_v, dwv, bv),  # raw: no activation
        DepthwiseOp(taps_h, dwh, bh, alpha=_alpha(sd, f"{prefix}.convs.2.act")),
        MatmulOp(w2, b2),
        ResidualAdd(alpha=_alpha(sd, f"{prefix}.prelu")),
    ]


def extract_bottleneck_dim(sd, prefix: str, use_prelu: bool, residual: str) -> list:
    """BottleneckDim / BottleneckDimRes with a depthwise middle conv.

    residual: 'proj' (DimRes: 1x1 resconv shortcut) or 'identity'.  The
    dense middle 3x3 of ``BottleneckDim(use_prelu=False)`` is not a chain
    op (it is only used in the decoder, outside the chains).
    """
    w1, b1 = _conv1x1(sd, f"{prefix}.convs.0")
    taps, dw, bdw = _dw_taps(sd, f"{prefix}.convs.1.conv", 1, (3, 3))
    w2, b2 = _conv1x1(sd, f"{prefix}.convs.2")
    if use_prelu:
        inner = dict(alpha=_alpha(sd, f"{prefix}.convs.0.act"))
        inner_dw = dict(alpha=_alpha(sd, f"{prefix}.convs.1.act"))
        final = dict(alpha=_alpha(sd, f"{prefix}.prelu"))
    else:
        inner = inner_dw = final = dict(relu=True)
    proj = None
    if residual == "proj":
        proj = MatmulOp(*_conv1x1(sd, f"{prefix}.resconv.0"))
    return [
        SaveResidual(),
        MatmulOp(w1, b1, **inner),
        DepthwiseOp(taps, dw, bdw, **inner_dw),
        MatmulOp(w2, b2),
        ResidualAdd(proj=proj, **final),
    ]


_S23_BLOCKS = [(0, 1), (1, 2), (2, 1), (3, 4)]


def extract_s23_chain(sd: Mapping, h: int, w: int) -> ChainSpec:
    """Sections 2+3 of Segment after ``bottle2_1``:

        x0 -> B3x3 B3x3(d2) B3x3 B3x3(d4) B5x5 -> y
        cat2 = concat(y, x0)
        -> DimRes(48,128,prelu) -> B3x3 B3x3(d2) B3x3 B3x3(d4) B5x5

    Input [N,h,w,128], output [N,h,w,128], from a BN-folded state dict.
    """
    ops: list = []
    for i, d in _S23_BLOCKS:
        ops += extract_bottleneck3x3(sd, f"bottle2_x.{i}", d)
    ops += extract_bottleneck5x5(sd, "bottle2_x.4")
    ops.append(ConcatChainInput())
    ops += extract_bottleneck_dim(sd, "bottle3_1", use_prelu=True, residual="proj")
    for i, d in _S23_BLOCKS:
        ops += extract_bottleneck3x3(sd, f"bottle3_x.{i}", d)
    ops += extract_bottleneck5x5(sd, "bottle3_x.4")
    return ChainSpec(h=h, w=w, c_in=128, c_out=128, ops=ops)


def extract_s1_chain(sd: Mapping, h: int, w: int) -> ChainSpec:
    """Section 1 body after ``bottle1_1``: four Bottleneck3x3(16) blocks on
    [N,h,w,48]."""
    ops: list = []
    for i in range(4):
        ops += extract_bottleneck3x3(sd, f"bottle1_x.{i}", 1)
    return ChainSpec(h=h, w=w, c_in=48, c_out=48, ops=ops)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _act(v, alpha, relu: bool):
    if alpha is not None:
        return torch.where(v >= 0, v, torch.as_tensor(alpha, device=v.device) * v)
    if relu:
        return torch.clamp_min(v, 0.0)
    return v


def _t(a, device):
    return torch.as_tensor(a, device=device)


def _depthwise(cur, op: DepthwiseOp, h: int, w: int, dtype):
    """``b + sum_t tap_t * w_t`` in tap order, a tap outside the image
    reading zero (a zero-padded copy)."""
    pad = max(max(abs(dy), abs(dx)) for dy, dx in op.taps)
    cp = F.pad(cur, (0, 0, pad, pad, pad, pad))
    wt = _t(op.w, cur.device).to(dtype)
    acc = torch.zeros_like(cur) + _t(op.b, cur.device).to(dtype)
    for t, (dy, dx) in enumerate(op.taps):
        acc = acc + cp[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w] * wt[t]
    return _act(acc, op.alpha, op.relu)


def fused_chain_reference(x: torch.Tensor, spec: ChainSpec,
                          act_dtype: torch.dtype = torch.float32,
                          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch walk of ``spec.ops`` on ``x [N,H,W,C_in]``, output in
    ``x.dtype``.  Depthwise taps read a zero-padded copy, so a tap outside
    the image reads zero.

    With the default ``act_dtype`` (float32) it is the float32 program the
    TPU kernel runs.  With ``act_dtype=torch.bfloat16`` it is the banded
    kernel's plain version, rounding where that kernel rounds: the chain
    input and every op's output are rounded to bf16, the 1x1 weights too
    (bias, PReLU slopes and depthwise taps stay float32), and a linear 1x1
    conv followed by a projected residual is one product over the
    concatenated K (``[y | saved] @ [W2; Wproj]``, biases summed).  Inside
    an op it computes in ``compute_dtype``; in float32 a 1x1 product is the
    correctly rounded float32 value of the exact sum (its bf16 products are
    exact; summed in float64), so it does not depend on the order of the
    sums.
    """
    if act_dtype == torch.float32:
        return _reference_f32(x, spec)
    return _reference_rounded(x, spec, act_dtype, compute_dtype)


def _reference_rounded(x, spec: ChainSpec, act_dtype, compute) -> torch.Tensor:
    dev = x.device

    def rnd(v):
        return v.to(act_dtype).to(compute)

    def weight(a):
        return rnd(_t(a, dev))

    def mm(v, wt):
        if compute == torch.float32:
            return (v.double() @ wt.double()).float()
        return v @ wt

    xin = rnd(x)
    cur, saved = xin, None
    ops = list(spec.ops)
    i = 0
    while i < len(ops):
        op = ops[i]
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        if isinstance(op, SaveResidual):
            saved = cur
        elif isinstance(op, MatmulOp):
            b = _t(op.b, dev).to(compute)
            if op.alpha is None and not op.relu and isinstance(nxt, ResidualAdd):
                if nxt.proj is None:
                    v = mm(cur, weight(op.w)) + b + saved
                else:  # the merged bottle3_1 product
                    wk = torch.cat([weight(op.w), weight(nxt.proj.w)], 0)
                    # summed in float32, as the plan stores it
                    bias = (_t(op.b, dev).float() + _t(nxt.proj.b, dev).float()).to(compute)
                    v = mm(torch.cat([cur, saved], -1), wk) + bias
                cur, saved = rnd(_act(v, nxt.alpha, nxt.relu)), None
                i += 1  # the ResidualAdd is folded in
            else:
                cur = rnd(_act(mm(cur, weight(op.w)) + b, op.alpha, op.relu))
        elif isinstance(op, DepthwiseOp):
            cur = rnd(_depthwise(cur, op, spec.h, spec.w, compute))
        elif isinstance(op, ResidualAdd):
            raise NotImplementedError(
                "a ResidualAdd must follow a linear MatmulOp in the banded form")
        elif isinstance(op, ConcatChainInput):
            cur = torch.cat([cur, xin], dim=-1)
        else:
            raise TypeError(f"unknown chain op {op!r}")
        i += 1
    return cur.to(x.dtype)


def _reference_f32(x: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    dev = x.device
    h, w = spec.h, spec.w
    xin = x.float()
    cur, saved = xin, None
    for op in spec.ops:
        if isinstance(op, SaveResidual):
            saved = cur
        elif isinstance(op, MatmulOp):
            cur = _act(cur @ _t(op.w, dev) + _t(op.b, dev), op.alpha, op.relu)
        elif isinstance(op, DepthwiseOp):
            cur = _depthwise(cur, op, h, w, torch.float32)
        elif isinstance(op, ResidualAdd):
            assert saved is not None, "ResidualAdd without SaveResidual"
            s = saved
            if op.proj is not None:
                s = s @ _t(op.proj.w, dev) + _t(op.proj.b, dev)
            cur = _act(cur + s, op.alpha, op.relu)
            saved = None
        elif isinstance(op, ConcatChainInput):
            cur = torch.cat([cur, xin], dim=-1)
        else:
            raise TypeError(f"unknown chain op {op!r}")
    return cur.to(x.dtype)


# ---------------------------------------------------------------------------
# the program the CUDA kernel walks
# ---------------------------------------------------------------------------

# instruction opcodes, activation kinds and row layout: keep in step with
# csrc/fused_chain.cu
OP_LOAD, OP_STORE, OP_MATMUL, OP_DW, OP_CONCAT = range(5)
ACT_NONE, ACT_PRELU, ACT_RELU = range(3)
ROW = 12  # op, src, dst, cin, cout, w_off, b_off, act, alpha_off, add, ntaps, taps_off


class ChainProgram(NamedTuple):
    """A compiled chain: ``weights`` float32, ``table`` int32 holding
    ``n_instr`` rows of ``ROW`` ints, then the slot bases (in floats per
    pixel) at ``slots_off``, then the (dy, dx) tap pairs.  Each image's
    scratch holds ``per_pixel`` floats per pixel; ``smem_floats`` is the
    largest 1x1 weight matrix, staged in shared memory."""

    weights: np.ndarray
    table: np.ndarray
    n_instr: int
    slots_off: int
    per_pixel: int
    smem_floats: int


def compile_chain(spec: ChainSpec) -> ChainProgram:
    """Lower ``spec`` to the kernel's instruction table.

    Values live in scratch slots; a slot is reused once no register
    (``cur``, ``saved``, the chain input) refers to it, and an output never
    shares a slot with its inputs.  A linear 1x1 conv followed by a plain
    ``ResidualAdd`` becomes one MATMUL with an add operand (every block the
    extractors build ends so); a projected ``ResidualAdd`` becomes a MATMUL
    of the saved tensor with the current one as its add operand.  Channel
    counts must be multiples of 4 (the kernel moves float4s).
    """
    chunks: List[np.ndarray] = []
    n_w = 0

    def add_w(a) -> int:
        nonlocal n_w
        a = np.asarray(a, np.float32).ravel()
        off = n_w
        pad = (-a.size) % 4  # keep every array float4-aligned
        chunks.append(np.concatenate([a, np.zeros(pad, np.float32)]))
        n_w += a.size + pad
        return off

    def act_fields(alpha, relu):
        if alpha is not None:
            return ACT_PRELU, add_w(alpha)
        return (ACT_RELU if relu else ACT_NONE), -1

    rows: List[list] = []
    taps: List[int] = []
    widths: List[int] = []
    reg: dict = {}  # register name -> slot

    def alloc(width: int) -> int:
        if width % 4:
            raise ValueError(f"chain channel count {width} is not a multiple of 4")
        used = set(reg.values())
        for s in range(len(widths)):
            if s not in used:
                widths[s] = max(widths[s], width)
                return s
        widths.append(width)
        return len(widths) - 1

    def row(op, src=-1, dst=-1, cin=0, cout=0, w_off=-1, b_off=-1,
            act=ACT_NONE, alpha_off=-1, add=-1, ntaps=0, taps_off=-1):
        rows.append([op, src, dst, cin, cout, w_off, b_off, act, alpha_off,
                     add, ntaps, taps_off])

    smem = 0

    def matmul(src_reg, mm: MatmulOp, act, alpha_off, add_reg=None):
        nonlocal smem
        ci, co = mm.w.shape
        if ci % 4:
            raise ValueError(f"chain channel count {ci} is not a multiple of 4")
        smem = max(smem, ci * co)
        w_off, b_off = add_w(mm.w), add_w(mm.b)
        dst = alloc(co)
        row(OP_MATMUL, reg[src_reg], dst, ci, co, w_off, b_off, act, alpha_off,
            -1 if add_reg is None else reg[add_reg])
        return dst, co

    ops = list(spec.ops)
    last_cat = max((i for i, op in enumerate(ops)
                    if isinstance(op, ConcatChainInput)), default=-1)
    reg["xin"] = alloc(spec.c_in)
    row(OP_LOAD, dst=reg["xin"], cout=spec.c_in)
    reg["cur"], c = reg["xin"], spec.c_in
    if last_cat < 0:
        del reg["xin"]

    i = 0
    while i < len(ops):
        op = ops[i]
        if isinstance(op, SaveResidual):
            reg["saved"] = reg["cur"]
        elif isinstance(op, MatmulOp):
            nxt = ops[i + 1] if i + 1 < len(ops) else None
            if (op.alpha is None and not op.relu
                    and isinstance(nxt, ResidualAdd) and nxt.proj is None):
                act, a_off = act_fields(nxt.alpha, nxt.relu)
                reg["cur"], c = matmul("cur", op, act, a_off, add_reg="saved")
                del reg["saved"]
                i += 1  # the ResidualAdd is folded in
            else:
                act, a_off = act_fields(op.alpha, op.relu)
                reg["cur"], c = matmul("cur", op, act, a_off)
        elif isinstance(op, DepthwiseOp):
            act, a_off = act_fields(op.alpha, op.relu)
            w_off, b_off = add_w(op.w), add_w(op.b)
            t_off = len(taps)
            for dy, dx in op.taps:
                taps += [int(dy), int(dx)]
            dst = alloc(c)
            row(OP_DW, reg["cur"], dst, c, c, w_off, b_off, act, a_off,
                ntaps=len(op.taps), taps_off=t_off)
            reg["cur"] = dst
        elif isinstance(op, ResidualAdd):
            if op.proj is None:
                raise NotImplementedError(
                    "a ResidualAdd without projection must follow a linear MatmulOp")
            act, a_off = act_fields(op.alpha, op.relu)
            reg["cur"], c = matmul("saved", op.proj, act, a_off, add_reg="cur")
            del reg["saved"]
        elif isinstance(op, ConcatChainInput):
            dst = alloc(c + spec.c_in)
            row(OP_CONCAT, reg["cur"], dst, c, c + spec.c_in, add=reg["xin"])
            reg["cur"], c = dst, c + spec.c_in
            if i == last_cat:
                del reg["xin"]
        else:
            raise TypeError(f"unknown chain op {op!r}")
        i += 1
    if c != spec.c_out:
        raise ValueError(f"chain ends with {c} channels, spec says {spec.c_out}")
    row(OP_STORE, src=reg["cur"], cin=c)

    n_instr = len(rows)
    bases = np.cumsum([0] + widths[:-1]).tolist()
    slots_off = n_instr * ROW
    taps_base = slots_off + len(bases)
    for r in rows:
        if r[0] == OP_DW:
            r[11] += taps_base
    table = np.asarray(sum(rows, []) + bases + taps, np.int32)
    weights = np.concatenate(chunks) if chunks else np.zeros(4, np.float32)
    return ChainProgram(weights, table, n_instr, slots_off, int(sum(widths)), smem)


# ---------------------------------------------------------------------------
# the banded forms (bf16 and float32): their plan and packed weights
# ---------------------------------------------------------------------------

#: dynamic shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: cluster sizes tried in order; above 8 needs the non-portable attribute
CLUSTER_SIZES = (2, 4, 8, 16)
PORTABLE_CLUSTER = 8
#: n8 output tiles a warp takes at once (the bf16 kernel's template instances)
MMA_N_TILES = (2, 4)
#: (rows, columns) a thread takes in a float32 product, in warp tiles of
#: 16 x rows by 2 x columns (the f32 kernel's template instances)
F32_TILES = ((4, 8), (4, 4), (2, 8), (2, 4), (1, 8), (1, 4))
#: the largest float32 K-chunk of a product's weights staged at once
CHUNK_BYTES = 32_768
MAX_SEGS = 3  # K-segments of one product
DW_TAPS = (5, 9)  # the depthwise tap counts the kernel unrolls
# keep in step with csrc/fused_chain.cu
BANDED_THREADS = 384
B_MM, B_DW = 0, 1
MM_FIRST, MM_LAST = 1, 2  # an f32 K-chunk: starts from zero; ends the product
BROW = 22
# every op: [11] params offset, [12] params length (16-byte units, into
# ``params``), [13] its slot (op index % 2); byte offsets below are into
# the slot.
# MM row: op, nseg, buf0, ch0, buf1, ch1, buf2, ch2, n, dst, add, p_off, p_len,
#         slot, bias_off, act, alpha_off, k_off, phase, unit, flags, cols
#         (slot: the weights at 0, bf16 fragments or an f32 [ch0, n]
#         K-chunk; unit: n8 tiles a warp takes (bf16) or rows a thread takes
#         (f32); k_off: the chunk's first column of buf0 (f32, one segment);
#         flags: MM_FIRST | MM_LAST, both on an unchunked product, which
#         alone applies bias, residual and activation; cols: columns a
#         thread takes (f32))
# DW row: op, src, dst, c, ntaps, taps_off, w_off, bias_off, act, alpha_off,
#         phase, p_off, p_len, slot, 0...
HDR = 16
# header: n_ops, h, w, cluster, in_buf, out_buf, c_in, c_out, n_bufs,
#         table_words, rows_off, ops_off, row_addr_off, slot0_off, slot1_off,
#         n_phases
MAX_BUFS = 8  # then MAX_BUFS pairs (smem offset, stride), row_lo, row_rank, ops

#: the k index (within a 16-deep tile) of each of the 4 bf16 a lane holds
#: in an m16n8k16 B fragment, by lane % 4 and element
_FRAG_K = np.array([[2 * q + (e & 1) + 8 * (e >> 1) for e in range(4)] for q in range(4)])


def bf16_bits(a) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), round to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def pack_fragments(w: np.ndarray) -> np.ndarray:
    """``w [K, N]`` -> bf16 bits in the order the kernel reads B fragments of
    ``mma.m16n8k16``: tiles (k16, n8), k-major; in a tile, lane ``4g + q``
    holds ``w[2q, g], w[2q+1, g], w[2q+8, g], w[2q+9, g]`` (8 bytes)."""
    k, n = w.shape
    t = bf16_bits(w).reshape(k // 16, 16, n // 8, 8).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(t[..., _FRAG_K]).ravel()


def unpack_fragments(bits: np.ndarray, k: int, n: int) -> np.ndarray:
    """Inverse of ``pack_fragments``, as float32."""
    t = np.zeros((k // 16, n // 8, 8, 16), np.uint16)
    t[..., _FRAG_K] = bits.reshape(k // 16, n // 8, 8, 4, 4)
    w = t.transpose(0, 3, 1, 2).reshape(k, n)
    return (w.astype(np.uint32) << 16).view(np.float32)


def _stride(c: int, elt: int = 2) -> int:
    """Row stride (elements) of a buffer of ``c`` channels of ``elt`` bytes:
    an odd number of 16-byte units, so 8 rows read at one column (an
    ``ldmatrix``, or the float4 loads of the f32 products) fall in 8
    different bank groups."""
    per = 16 // elt
    units = -(-c // per)
    return per * (units + 1 - units % 2)


def _f32_chunks(segs, n: int, chunk_bytes: int) -> list:
    """The K-chunks of a float32 product over ``segs`` [(buffer, channels)]
    with ``n`` outputs: ``(buffer, first column, depth)``, one segment each,
    each at most ``chunk_bytes`` of weights (a multiple of 4 rows)."""
    depth = max(4, chunk_bytes // (4 * n) // 4 * 4)
    return [(b, k0, min(depth, c - k0)) for b, c in segs for k0 in range(0, c, depth)]


#: cycles a warp waits for a k-step's shared-memory loads before its FMAs
#: can issue (the latency the tile choice must hide)
F32_LOAD_LATENCY = 200


def _f32_tile(px: int, n: int) -> Tuple[int, int]:
    """(rows, columns) a thread takes in a float32 product of ``n`` columns
    over a band of ``px`` rows.  The kernel runs warp tiles of 16 x rows by
    2 x columns, the block's warps taking them in rounds, a scheduler per 4
    warps.  A k-step of a round takes the longer of the FMAs its busiest
    scheduler issues (4 x rows x columns a warp) and one warp's load latency
    followed by its FMAs.  The cheapest sum over the rounds wins: large
    tiles where the band is wide, more warps where it is narrow (fitted to
    the kernel's times on an H100 at the serving shapes)."""
    warps = BANDED_THREADS // 32

    def cost(tile):
        tm, tn = tile
        fmas = 4 * tm * tn
        tiles, total = -(-px // (16 * tm)) * (n // (2 * tn)), 0
        while tiles > 0:
            active = min(tiles, warps)
            total += max(-(-active // 4) * fmas, F32_LOAD_LATENCY + fmas)
            tiles -= active
        return total
    return min(F32_TILES, key=cost)


class _Lowered(NamedTuple):
    rows: list
    params: np.ndarray
    widths: list
    slot_bytes: list
    out_buf: int
    n_phases: int


def _lower_banded(spec: ChainSpec, elt: int = 2,
                  chunk_bytes: int = CHUNK_BYTES) -> Optional[_Lowered]:
    """Lower ``spec`` to the banded kernel's ops over shared-memory buffers
    of ``elt``-byte elements (2: bf16, 4: float32), or None where its
    channel counts do not suit the kernel's tiles.

    Buffer 0 holds the chain input.  A buffer is chosen for an op's output
    among those holding no live value (``cur``, ``saved``, the chain input
    until the last concat), never one of the op's inputs, and never the
    buffer that the current phase's depthwise op reads from other CTAs:
    phases are the stretches between cluster barriers, one barrier before
    each depthwise op.  So no CTA overwrites rows that another may still be
    reading, without a second barrier.  A folded residual add writes in
    place over the saved tensor; a concat is a second K-segment; a linear
    1x1 conv followed by a projected residual is one product over
    ``[y | saved]`` (biases summed).  No product writes over one of its
    K-segments, so a warp may take any slice of the output's columns.

    Each op's parameters are one block of ``params``, which the kernel
    stages into a shared-memory slot while the op before it runs: a 1x1
    conv's bf16 fragments, float32 bias and PReLU slopes; a depthwise op's
    float32 taps ``[ntaps, C]``, bias, slopes and int32 ``(dy, dx)`` pairs.
    In float32 a 1x1 conv is one row per K-chunk (``_f32_chunks``), each
    with its float32 weights ``[depth, n]``, the last also with bias and
    slopes; the partial sums of a chunked product live in its output
    buffer, so it is never written in place over the residual.
    """
    blocks: List[np.ndarray] = []
    n_params = 0  # 16-byte units

    def add_params(*parts):
        """Append one op's block; returns (offset, length) in 16-byte units
        and each part's byte offset in it (-1 for a None part)."""
        nonlocal n_params
        offs, chunks, at = [], [], 0
        for part in parts:
            if part is None:
                offs.append(-1)
                continue
            raw = np.ascontiguousarray(part).view(np.uint8).ravel()
            raw = np.concatenate([raw, np.zeros((-raw.size) % 16, np.uint8)])
            offs.append(at)
            chunks.append(raw)
            at += raw.size
        blocks.append(np.concatenate(chunks))
        off, n_params = n_params, n_params + at // 16
        return off, at // 16, offs

    def act_kind(alpha, relu):
        return ACT_PRELU if alpha is not None else ACT_RELU if relu else ACT_NONE

    def f32(a):
        return None if a is None else np.asarray(a, np.float32)

    ops = list(spec.ops)
    last_cat = max((i for i, op in enumerate(ops)
                    if isinstance(op, ConcatChainInput)), default=-1)
    widths = [spec.c_in]
    cur: list = [(0, spec.c_in)]
    saved: Optional[list] = None
    xin_live = last_cat >= 0
    phase, phase_src = 0, -1
    rows: List[list] = []
    slot_bytes = [0, 0]

    def live() -> set:
        s = {b for b, _ in cur} | {b for b, _ in (saved or [])}
        return s | {0} if xin_live else s

    def pick(width: int, avoid) -> int:
        busy = live() | set(avoid) | {phase_src}
        free = [b for b in range(len(widths)) if b not in busy]
        if not free:
            widths.append(width)
            return len(widths) - 1
        b = min(free, key=lambda b: (max(width - widths[b], 0), widths[b]))
        widths[b] = max(widths[b], width)
        return b

    def add_row(row, p_off, p_len):
        slot = len(rows) % 2
        slot_bytes[slot] = max(slot_bytes[slot], 16 * p_len)
        row[11:14] = [p_off, p_len, slot]
        rows.append(row)

    def mm_row(segs, w, b, alpha, relu, dst, add) -> bool:
        n = w.shape[1]
        if elt == 4:
            if any(c % 4 for _, c in segs) or n % 16:
                return False
            chunks = _f32_chunks(segs, n, chunk_bytes)
            k = 0
            for i, (sb, k0, kc) in enumerate(chunks):
                last = i == len(chunks) - 1
                flags = (MM_FIRST if i == 0 else 0) | (MM_LAST if last else 0)
                p_off, p_len, (_, b_at, a_at) = add_params(
                    f32(w[k:k + kc]), f32(b) if last else None,
                    f32(alpha) if last else None)
                add_row([B_MM, 1, sb, kc, -1, 0, -1, 0, n, dst, add if last else -1, 0, 0, 0,
                         b_at, act_kind(alpha, relu) if last else ACT_NONE, a_at, k0, phase,
                         0, flags, 0], p_off, p_len)
                k += kc
            return True
        if len(segs) > MAX_SEGS or any(c % 16 for _, c in segs) or n % 16:
            return False
        p_off, p_len, (_, b_at, a_at) = add_params(pack_fragments(w), f32(b), f32(alpha))
        seg_fields = sum(([sb, c] for sb, c in segs), []) + [-1, 0] * (MAX_SEGS - len(segs))
        tiles = n // 8
        unit = 4 if tiles % 4 == 0 and tiles > 6 else 2
        add_row([B_MM, len(segs), *seg_fields, n, dst, add, 0, 0, 0, b_at,
                 act_kind(alpha, relu), a_at, 0, phase, unit, MM_FIRST | MM_LAST, 0],
                p_off, p_len)
        return True

    i = 0
    while i < len(ops):
        op = ops[i]
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        if isinstance(op, SaveResidual):
            saved = list(cur)
        elif isinstance(op, MatmulOp):
            n = op.w.shape[1]
            seg_bufs = {b for b, _ in cur}
            if op.alpha is None and not op.relu and isinstance(nxt, ResidualAdd):
                if saved is None:
                    raise ValueError("ResidualAdd without SaveResidual")
                head = saved[0][0]
                if nxt.proj is None:
                    if len(saved) != 1 or saved[0][1] != n:
                        raise ValueError("residual width differs from the 1x1 conv's")
                    segs, w, b, add = list(cur), op.w, op.b, head
                else:
                    segs = list(cur) + list(saved)
                    w = np.concatenate([op.w, nxt.proj.w])
                    b = np.asarray(op.b, np.float32) + np.asarray(nxt.proj.b, np.float32)
                    add = -1
                # in place over the saved tensor where it is the residual
                # operand alone, not a K-segment, no later op reads it (the
                # chain input until its last concat) and the product is not
                # accumulated over several chunks
                chunked = elt == 4 and len(_f32_chunks(segs, n, chunk_bytes)) > 1
                in_place = (add == head and not (xin_live and head == 0)
                            and head not in seg_bufs and not chunked)
                dst = head if in_place else pick(n, {sb for sb, _ in segs})
                if not mm_row(segs, w, b, nxt.alpha, nxt.relu, dst, add):
                    return None
                i += 1  # the ResidualAdd is folded in
                saved = None
            else:
                dst = pick(n, seg_bufs)
                if not mm_row(list(cur), op.w, op.b, op.alpha, op.relu, dst, -1):
                    return None
            cur = [(dst, n)]
        elif isinstance(op, DepthwiseOp):
            if (len(cur) != 1 or cur[0][1] % (16 // elt) or BANDED_THREADS % (cur[0][1] // 4)
                    or len(op.taps) not in DW_TAPS):
                return None
            phase, phase_src = phase + 1, -1
            src, c = cur[0]
            dst = pick(c, {src})
            p_off, p_len, (w_at, b_at, a_at, t_at) = add_params(
                f32(op.w), f32(op.b), f32(op.alpha), np.asarray(op.taps, np.int32).ravel())
            add_row([B_DW, src, dst, c, len(op.taps), t_at, w_at, b_at,
                     act_kind(op.alpha, op.relu), a_at, phase] + [0] * (BROW - 11),
                    p_off, p_len)
            phase_src = src
            cur = [(dst, c)]
        elif isinstance(op, ResidualAdd):
            raise NotImplementedError(
                "a ResidualAdd must follow a linear MatmulOp")
        elif isinstance(op, ConcatChainInput):
            cur = cur + [(0, spec.c_in)]
            if i == last_cat:
                xin_live = False
        else:
            raise TypeError(f"unknown chain op {op!r}")
        i += 1
    if sum(c for _, c in cur) != spec.c_out:
        raise ValueError(f"chain ends with {sum(c for _, c in cur)} channels, "
                         f"spec says {spec.c_out}")
    if len(cur) != 1 or not rows or len(widths) > MAX_BUFS or spec.c_in % (16 // elt):
        return None
    return _Lowered(rows, np.concatenate(blocks), widths, slot_bytes, cur[0][0], phase)


@dataclass(frozen=True)
class BandPlan:
    """The banded kernel's layout for one spec: a cluster of ``cluster``
    CTAs per image, rank ``r`` owning image rows ``row_lo[r]:row_lo[r+1]``
    (``row_rank[y]`` is the owner of row ``y``); per CTA, in
    ``smem_bytes`` of dynamic shared memory: a copy of ``table``, a row
    address table, buffers of ``band_px`` rows of ``elt``-byte elements
    (2: bf16, 4: float32) at ``buf_offsets`` with ``strides``, and two
    parameter slots.  ``table`` (int32: header, buffers, rows, op rows) and
    ``params`` (bytes: each op's parameter block) are what the kernel
    reads."""

    elt: int
    h: int
    w: int
    c_in: int
    c_out: int
    cluster: int
    row_lo: Tuple[int, ...]
    row_rank: Tuple[int, ...]
    band_px: int
    widths: Tuple[int, ...]
    strides: Tuple[int, ...]
    buf_offsets: Tuple[int, ...]
    slot_offsets: Tuple[int, ...]
    slot_bytes: Tuple[int, ...]
    smem_bytes: int
    out_buf: int
    n_phases: int
    table: np.ndarray = field(repr=False)
    params: np.ndarray = field(repr=False)

    @property
    def nonportable(self) -> bool:
        return self.cluster > PORTABLE_CLUSTER

    def ops(self) -> np.ndarray:
        """The op rows, ``[n_ops, BROW]``."""
        n_ops, off = int(self.table[0]), int(self.table[11])
        return self.table[off:off + n_ops * BROW].reshape(n_ops, BROW)

    def op_params(self, row) -> np.ndarray:
        """The parameter block (bytes) of op ``row``."""
        return self.params[16 * int(row[11]):16 * int(row[11] + row[12])]


def _align(n: int, a: int = 128) -> int:
    return -(-n // a) * a


def plan_banded(spec: ChainSpec, clusters: Tuple[int, ...] = CLUSTER_SIZES,
                dtype: torch.dtype = torch.bfloat16,
                chunk_bytes: int = CHUNK_BYTES) -> Optional[BandPlan]:
    """The banded kernel's plan for ``spec`` on ``dtype`` I/O (bfloat16 or
    float32): the smallest cluster of 2, 4 or 8 CTAs (else 16,
    non-portable) whose per-CTA table, buffers and parameter slots fit in
    ``SMEM_LIMIT`` bytes; None where none does or the spec's channel counts
    do not suit the kernel (the SIMT form runs it).  ``clusters`` narrows
    the sizes tried and ``chunk_bytes`` caps the float32 weight chunks (the
    tests force many bands and many chunks)."""
    elt = 2 if dtype == torch.bfloat16 else 4
    low = _lower_banded(spec, elt, chunk_bytes)
    if low is None:
        return None
    h, w = spec.h, spec.w
    strides = [_stride(c, elt) for c in low.widths]
    rows_off = HDR + 2 * MAX_BUFS
    for cl in clusters:
        if cl > h:
            break
        base, rem = divmod(h, cl)
        row_lo = [r * base + min(r, rem) for r in range(cl + 1)]
        band_px = (base + (rem > 0)) * w
        if elt == 4:  # rows x columns a thread takes in each product, for this band
            for row in low.rows:
                if row[0] == B_MM:
                    row[19], row[21] = _f32_tile(band_px, row[8])
        ops_off = rows_off + cl + 1 + h
        words = _align(ops_off + BROW * len(low.rows), 4)  # copied in 16-byte units
        row_addr_off = _align(4 * words)
        offs, at = [], _align(row_addr_off + 4 * h)
        for s in strides:
            offs.append(at)
            at = _align(at + band_px * s * elt)
        slot_offs = []
        for nb in low.slot_bytes:
            slot_offs.append(at)
            at = _align(at + nb)
        if at > SMEM_LIMIT:
            continue
        row_rank = [r for r in range(cl) for _ in range(row_lo[r], row_lo[r + 1])]
        bufs = sum(([o, s] for o, s in zip(offs, strides)), [])
        bufs += [0, 0] * (MAX_BUFS - len(strides))
        header = [len(low.rows), h, w, cl, 0, low.out_buf, spec.c_in, spec.c_out,
                  len(strides), words, rows_off, ops_off, row_addr_off,
                  slot_offs[0], slot_offs[1], low.n_phases]
        body = header + bufs + row_lo + row_rank + sum(low.rows, [])
        table = np.asarray(body + [0] * (words - len(body)), np.int32)
        return BandPlan(elt, h, w, spec.c_in, spec.c_out, cl, tuple(row_lo), tuple(row_rank),
                        band_px, tuple(low.widths), tuple(strides), tuple(offs),
                        tuple(slot_offs), tuple(low.slot_bytes), at, low.out_buf,
                        low.n_phases, table, low.params)
    return None


def chain_form(spec: ChainSpec, dtype: torch.dtype) -> str:
    """Which kernel form runs ``spec`` on ``dtype`` I/O where a band plan
    exists: "banded" for bfloat16, "banded_f32" for float32; else "simt".
    Decided by shape alone."""
    if _band_plan(spec, dtype) is None:
        return "simt"
    return "banded" if dtype == torch.bfloat16 else "banded_f32"


def _band_plan(spec: ChainSpec, dtype: torch.dtype) -> Optional[BandPlan]:
    key = ("band_plan", dtype)
    if key not in spec._packed:
        spec._packed[key] = plan_banded(spec, dtype=dtype)
    return spec._packed[key]


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes


class _Packed(NamedTuple):
    weights: torch.Tensor
    table: torch.Tensor
    program: ChainProgram


def _packed(spec: ChainSpec, device: torch.device) -> _Packed:
    key = str(device)
    if key not in spec._packed:
        prog = compile_chain(spec)
        spec._packed[key] = _Packed(
            torch.from_numpy(prog.weights).to(device),
            torch.from_numpy(prog.table).to(device),
            prog,
        )
    return spec._packed[key]


def _check(x: torch.Tensor, spec: ChainSpec) -> None:
    if x.dim() != 4 or tuple(x.shape[1:]) != (spec.h, spec.w, spec.c_in):
        raise ValueError(
            f"chain expects [N,{spec.h},{spec.w},{spec.c_in}], got {tuple(x.shape)}"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"chain takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("chain input must be a contiguous NHWC tensor")


def _library():
    from instancesegmentation_tpu_torch.ops import _build

    lib = _build.library("fused_chain.cu")
    fn = lib.fused_chain_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    """Launch the CUDA kernel on ``x`` (checked by the caller); raises on a
    build or launch failure."""
    fn = _library()
    dev = x.device
    packed = _packed(spec, dev)
    prog = packed.program
    n, h, w = x.shape[0], spec.h, spec.w
    out = torch.empty((n, h, w, spec.c_out), dtype=x.dtype, device=dev)
    if n == 0:
        return out
    per_image = prog.per_pixel * h * w
    scratch = torch.empty(n * per_image, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                packed.weights.data_ptr(), packed.table.data_ptr(),
                prog.n_instr, prog.slots_off, n, h, w, per_image,
                _DTYPES[x.dtype], 4 * prog.smem_floats, stream)
    if rc != 0:
        raise RuntimeError(f"fused_chain kernel launch failed: CUDA error {rc}")
    return out


def _banded_library():
    from instancesegmentation_tpu_torch.ops import _build

    lib = _build.library("fused_chain.cu")
    fn = lib.fused_chain_banded_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        occ = lib.fused_chain_banded_occupancy
        occ.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
    return lib


class _BandedPacked(NamedTuple):
    plan: BandPlan
    table: torch.Tensor
    params: torch.Tensor


def _banded_packed(spec: ChainSpec, device: torch.device, dtype) -> _BandedPacked:
    key = ("banded", dtype, str(device))
    if key not in spec._packed:
        plan = _band_plan(spec, dtype)
        spec._packed[key] = _BandedPacked(
            plan,
            torch.from_numpy(plan.table).to(device),
            torch.from_numpy(plan.params).to(device),
        )
    return spec._packed[key]


def _launch_banded(x: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    """Launch the banded kernel of ``x.dtype`` (bf16 or float32; checked by
    the caller, with a plan); raises on a build or launch failure."""
    fn = _banded_library().fused_chain_banded_launch
    dev = x.device
    packed = _banded_packed(spec, dev, x.dtype)
    n = x.shape[0]
    out = torch.empty((n, spec.h, spec.w, spec.c_out), dtype=x.dtype, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), packed.table.data_ptr(),
                packed.params.data_ptr(), n, packed.plan.cluster, packed.plan.smem_bytes,
                _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused_chain banded kernel launch failed: CUDA error {rc}")
    return out


def banded_occupancy(spec: ChainSpec, dtype: torch.dtype = torch.bfloat16) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the banded kernel of ``dtype``
    at ``spec``'s cluster size and shared memory (needs a card)."""
    plan = _band_plan(spec, dtype)
    if plan is None:
        raise ValueError("no banded plan for this spec")
    n = ctypes.c_int(0)
    rc = _banded_library().fused_chain_banded_occupancy(plan.cluster, plan.smem_bytes,
                                                        _DTYPES[dtype], ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {rc}")
    return n.value


FORMS = ("banded", "banded_f32", "simt")


def fused_chain(x: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    """Run the chain on ``x [N, H, W, C_in]`` -> ``[N, H, W, C_out]`` in
    ``x.dtype``.

    A CPU tensor runs ``fused_chain_reference``; a CUDA tensor launches the
    form ``chain_form`` names (counted in ``fused_chain.launches`` and
    ``fused_chain.launches_by_form``) or raises.
    """
    _check(x, spec)
    if x.device.type == "cpu":
        return fused_chain_reference(x, spec)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_chain has no kernel for device {x.device}")
    form = chain_form(spec, x.dtype)
    out = _launch(x, spec) if form == "simt" else _launch_banded(x, spec)
    fused_chain.launches += 1
    fused_chain.launches_by_form[form] += 1
    return out


def reset_launches() -> None:
    """Set ``fused_chain``'s launch counts to 0."""
    fused_chain.launches = 0
    fused_chain.launches_by_form = dict.fromkeys(FORMS, 0)


reset_launches()
