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

Compute is float32 inside; I/O is the caller's dtype (float32 or bfloat16).

The spec (``ChainSpec`` and its op descriptors) and the extractors come
over from the JAX module; the extractors read the port's state dict
(torch layouts) instead of flax params.  ``compile_chain`` turns a spec
into what the CUDA kernel walks: one float32 weight buffer and a small
int32 instruction table whose operands are scratch slots (a liveness pass
assigns them), with each residual add folded into the 1x1 conv before it.

``fused_chain(x, spec)`` runs the plain PyTorch version
(``fused_chain_reference``) on a CPU tensor and launches the CUDA kernel on
a CUDA tensor, raising on a build or launch failure; ``fused_chain.launches``
counts the kernel launches.
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
    # per-device packed buffers of the kernel, filled on first launch
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


def fused_chain_reference(x: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    """Plain PyTorch walk of ``spec.ops`` on ``x [N,H,W,C_in]``: float32
    inside, output in ``x.dtype``.  Depthwise taps read a zero-padded copy,
    so a tap outside the image reads zero."""
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
            pad = max(max(abs(dy), abs(dx)) for dy, dx in op.taps)
            cp = F.pad(cur, (0, 0, pad, pad, pad, pad))
            wt = _t(op.w, dev)
            acc = torch.zeros_like(cur) + _t(op.b, dev)
            for t, (dy, dx) in enumerate(op.taps):
                acc = acc + cp[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w] * wt[t]
            cur = _act(acc, op.alpha, op.relu)
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


def fused_chain(x: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    """Run the chain on ``x [N, H, W, C_in]`` -> ``[N, H, W, C_out]`` in
    ``x.dtype``.

    A CPU tensor runs ``fused_chain_reference``; a CUDA tensor launches the
    kernel (counted in ``fused_chain.launches``) or raises.
    """
    _check(x, spec)
    if x.device.type == "cpu":
        return fused_chain_reference(x, spec)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_chain has no kernel for device {x.device}")
    out = _launch(x, spec)
    fused_chain.launches += 1
    return out


fused_chain.launches = 0
