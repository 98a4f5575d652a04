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
``|acc| <= K * 127^2 < 2^53``); on a CUDA tensor it launches one kernel of
``csrc/int8_conv.cu`` per conv, which quantises the float input as it loads
it and convolves it (the dense form on the int8 tensor cores, the grouped
form on int32 multiply-adds), counted in ``int8_conv.launches`` and, by
form, ``int8_conv.launches_by_kernel``, or raises.  ``plan`` gives the
launch's tile and shared memory on the host; ``pack_weights`` the weights
in the order the kernel reads them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

#: XLA's reciprocal of the constant divisor 127.0, and its square (the two
#: scales' constants folded into one)
RECIP_127 = np.float32(1.0) / np.float32(127.0)
RECIP_127_SQ = np.float32(RECIP_127 * RECIP_127)
#: the kernel's forms, counted in ``int8_conv.launches_by_kernel``
KERNELS = ("dense", "grouped")
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
#: a block's shared memory on sm_90 with the opt-in, and an SM's (each
#: resident block also holds 1 KB for the system)
SMEM_MAX = 232448
SMEM_PER_SM = 233472
#: threads (and warps) per block; output pixels per grouped thread; blocks
#: an SM holds by their registers (the kernels' launch bounds; every
#: instantiation takes 86-128 registers, so no third block fits), for which
#: the plan leaves room in shared memory
THREADS, WARPS, RUN, BLOCKS_PER_SM = 256, 8, 4, 2
#: the SMs of an H100 SXM: ``plan``'s default where it is not given the
#: card's own count (the CPU tests)
H100_SMS = 132
#: the dense kernel's output-channel tiles of 8 (``NT``) it is built for,
#: and the m-tiles of 16 pixels a warp takes at once with each (``MT``); a
#: conv wider than ``DENSE_SLICE`` outputs runs in slices of that many
#: channels (NT 16), one more index of the grid's tiles
DENSE_NT = (1, 2, 6, 16)
DENSE_MT = {1: 4, 2: 2, 6: 2, 16: 1}
DENSE_SLICE = 128
#: the largest tile (pixels) and tile width of each form
DENSE_TILE_PX, DENSE_TW_MAX = 512, 128
GROUPED_TILE_PX, GROUPED_TW_MAX = 1024, 64
#: the plan prefers tiles that make at least this many per SM
MIN_TILES_PER_SM = 4
#: the plan's estimates of a block's issue slots, used only to rank tiles:
#: per word loaded and quantised (``fetch`` and ``quantize_batch``: the
#: address walk, the load, four values' multiply, clip, round and check, the
#: pack and the shared-memory store) and per tile (its barriers, the wait
#: for its first loads, the epilogue). Estimates set by hand, not fitted by
#: a script of the repository: ``chip_smoke.py``'s per-conv times are what
#: judge the tiles they pick.
LOAD_COST, TILE_COST = 58, 16384
#: ``int8_conv_launch``'s return value for a plan its layout disagrees with,
#: and the ints of its geometry (``geometry``)
PLAN_MISMATCH, GEOM_INTS = 1000, 32
#: plans and launch geometries an ``Int8Conv`` keeps (per input shape)
LAUNCH_CACHE = 32


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
    weights in the kernel's layout) are put on ``device``.  Every form takes
    any number of output channels (a dense conv wider than ``DENSE_SLICE``
    in slices, ``dense_tiles``); every conv of ``Segment`` has 4-128.
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
        self._launches = {}  # (shape, dtypes, tile, aligned) -> plan, geometry, out shape
        if device.type == "cuda":
            self.w_kernel = pack_weights(self.wq, self.groups).to(device)

    def out_hw(self, h: int, w: int) -> tuple[int, int]:
        (sh, sw), (ph, pw), (dh, dw) = self.stride, self.padding, self.dilation
        return ((h + 2 * ph - dh * (self.kh - 1) - 1) // sh + 1,
                (w + 2 * pw - dw * (self.kw - 1) - 1) // sw + 1)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def dense_tiles(cout: int) -> int:
    """The dense kernel's output-channel tiles of 8 for ``cout`` output
    channels, over all its slices: up to ``DENSE_SLICE`` channels the
    smallest of ``DENSE_NT`` that holds them (its ``NT``: 17-47 channels
    compute 48, 49-128 compute 128), above it 16 per slice of
    ``DENSE_SLICE`` (129-256 compute 256); the padding's weights are zero
    and its outputs not written."""
    need = -(-cout // 8)
    if 8 * need > DENSE_SLICE:
        return DENSE_NT[-1] * -(-cout // DENSE_SLICE)
    return next(nt for nt in DENSE_NT if nt >= need)


def dense_slices(cout: int) -> int:
    """The dense kernel's slices of output channels (1 up to
    ``DENSE_SLICE`` outputs)."""
    return -(-8 * dense_tiles(cout) // DENSE_SLICE)


def padded_k(in_channels: int, kh: int, kw: int) -> int:
    """The dense kernel's K: ``kh * kw * Cp`` ordered (ky, kx, c), with Cp
    the input channels rounded up to 4 (a word), the whole zero-padded to a
    multiple of 32 (one ``m16n8k32`` step): the stem's 5 * 5 * 20 = 500 ->
    512, a 3-channel stem's 5 * 5 * 4 = 100 -> 128."""
    return _round_up(kh * kw * _round_up(in_channels, 4), 32)


def pack_weights(wq: torch.Tensor, groups: int) -> torch.Tensor:
    """The int8 weights ``wq [out, in/groups, kh, kw]`` as int32 words in the
    order the kernel reads them (on ``wq``'s device):

    - groups == 1: the B fragments of ``m16n8k32``, ``[K/32][NT][32 lanes][2]``:
      lane ``4 g + t`` of step ``s`` and tile ``j`` holds output channel
      ``8 j + g``'s k = 32 s + 4 t .. + 3 and 32 s + 16 + 4 t .. + 3, K in
      ``padded_k``'s order, channels past ``out`` zero; above
      ``DENSE_SLICE`` outputs the slices of that many channels one after
      another, ``[slices * K/32][16][32][2]``;
    - groups > 1: ``[kh * kw][in/groups][ceil(out / 4)]``, each word 4
      consecutive output channels' weights of one tap and group input.
    """
    out, cin_g, kh, kw = wq.shape
    if groups == 1:
        nt = dense_tiles(out)
        cp = _round_up(cin_g, 4)
        kp = padded_k(cin_g, kh, kw)
        w = F.pad(wq.permute(0, 2, 3, 1), (0, cp - cin_g)).reshape(out, kh * kw * cp)
        w = F.pad(w, (0, kp - w.shape[1], 0, 8 * nt - out)).contiguous()
        slices = dense_slices(out)
        nts = nt // slices
        words = w.view(torch.int32).reshape(slices, nts, 8, kp // 32, 2, 4)
        return words.permute(0, 3, 1, 2, 5, 4).contiguous().reshape(slices * kp // 32, nts, 32, 2)
    w = F.pad(wq.permute(2, 3, 1, 0), (0, _round_up(out, 4) - out)).contiguous()
    return w.view(torch.int32).reshape(kh * kw, cin_g, -1).contiguous()


class Plan(NamedTuple):
    """One launch's tile and shared memory (``csrc/int8_conv.cu``'s I8Geom):
    a block computes ``th x tw`` output pixels of one image from an input
    tile of ``ir x ic`` pixels (the halo included) of ``pp`` words each; the
    dense form's K and N padded to ``kp`` and ``np`` (N over all its slices,
    ``dense_slices``) and its staged pixel of ``pitch`` bytes; for the
    grouped form ``kp`` is the taps and ``np`` the output channel words.
    ``blocks``: the persistent grid, as many blocks as the card holds at
    once at this shared memory, at most one per tile (and slice)."""
    form: str
    th: int
    tw: int
    ir: int
    ic: int
    pp: int
    kp: int
    np: int
    tiles_y: int
    tiles_x: int
    pitch: int
    smem: int
    blocks: int


def _words_per_pixel(c4: int, sw: int) -> int:
    """The dense tile's words per pixel: ``c4`` rounded up until ``pp * sw
    = 4 (mod 8)``, so that the 8 pixels of a fragment's rows (``sw * pp``
    words apart) and their 4 words fall in 32 distinct banks."""
    if sw % 4 == 0:
        return c4
    pp = c4
    while (pp * sw) % 8 != 4:
        pp += 1
    return pp


def _dense_smem(kp: int, np_: int, pitch: int, ir: int, ic: int, pp: int) -> int:
    return kp * np_ + kp + 8 * np_ + WARPS * 16 * pitch + ir * ic * pp * 4


def _grouped_smem(taps: int, cin_g: int, co4: int, ir: int, ic: int, pp: int) -> int:
    return taps * cin_g * co4 * 4 + 32 * co4 + ir * ic * pp * 4


def _grid(n: int, tiles_y: int, tiles_x: int, smem: int, sms: int) -> int:
    """The persistent grid: ``sms`` times the blocks an SM holds (its
    registers allow ``BLOCKS_PER_SM``; each block also takes 1 KB of shared
    memory for the system), at most one block per tile."""
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024))
    return min(n * tiles_y * tiles_x, sms * per_sm)


def plan(conv: Int8Conv, x_shape: Sequence[int], dtype: torch.dtype = torch.float32,
         out_dtype: Optional[torch.dtype] = None,
         tile: Optional[tuple[int, int]] = None, sms: int = H100_SMS) -> Plan:
    """The kernel's tile for ``conv`` on an input of ``x_shape [N, H, W,
    C]`` in ``dtype`` and an output in ``out_dtype`` (default ``dtype``; the
    dense form stages output pixels in it): ``th`` output rows by ``tw``
    columns (a multiple of 16 for the dense form, at most ``DENSE_TW_MAX``
    / ``GROUPED_TW_MAX``, at most ``DENSE_TILE_PX`` / ``GROUPED_TILE_PX``
    pixels), the one of least estimated work (the halo's words loaded again,
    the ragged edges' pixels computed in vain) whose shared memory leaves
    room for ``BLOCKS_PER_SM`` blocks on an SM, preferring at least
    ``MIN_TILES_PER_SM`` tiles per SM of the card's ``sms``; one row of the
    widest that ``SMEM_MAX`` holds if none does.  ``tile = (th, tw)``
    imposes a tile instead (tests of the ragged edges).  Raises
    ``ValueError`` where no tile fits."""
    out_dtype = dtype if out_dtype is None else out_dtype
    if dtype not in (torch.float32, torch.bfloat16) or out_dtype not in _OUT_KIND:
        raise TypeError(f"the int8 kernel reads float32 or bfloat16 and writes float32, "
                        f"bfloat16 or int32, not {dtype} -> {out_dtype}")
    n, h, w, c = x_shape
    if c != conv.in_channels:
        raise ValueError(f"conv takes {conv.in_channels} channels, not {c}")
    ho, wo = conv.out_hw(h, w)
    if min(n, ho, wo) < 1:
        raise ValueError(f"int8 conv of {tuple(x_shape)} has an empty output")
    if h * w * c >= 2 ** 31:
        raise ValueError(f"int8 conv of {tuple(x_shape)}: an image of 2^31 elements or more")
    (sh, sw), (dh, dw) = conv.stride, conv.dilation
    c4 = -(-c // 4)
    slices = 1
    if conv.groups == 1:
        form, mult, px_max, tw_max = "dense", 16, DENSE_TILE_PX, DENSE_TW_MAX
        pp, kp = _words_per_pixel(c4, sw), padded_k(c, conv.kh, conv.kw)
        np_ = 8 * dense_tiles(conv.out_channels)
        slices = dense_slices(conv.out_channels)
        ns = np_ // slices  # a slice's channels: shared memory holds one slice
        osz = torch.empty((), dtype=out_dtype).element_size()
        pitch = _round_up(osz * min(conv.out_channels, ns), 16) + 16
    else:
        form, mult, px_max, tw_max = "grouped", 1, GROUPED_TILE_PX, GROUPED_TW_MAX
        pp, kp, np_, pitch = c4, conv.kh * conv.kw, -(-conv.out_channels // 4), 0

    def smem(th: int, tw: int) -> tuple[int, int, int]:
        ir = (th - 1) * sh + (conv.kh - 1) * dh + 1
        ic = (tw - 1) * sw + (conv.kw - 1) * dw + 1
        if form == "dense":
            return _dense_smem(kp, ns, pitch, ir, ic, pp), ir, ic
        return _grouped_smem(kp, conv.in_per_group, np_, ir, ic, pp), ir, ic

    def fits(size: int, ir: int, ic: int) -> bool:
        # the kernel's loader numbers a tile's words in 16 bits
        return size <= SMEM_MAX and ir * ic * pp < 0xffff

    if tile is not None:
        th, tw = tile
        if th < 1 or tw < 1 or tw % mult:
            raise ValueError(f"a {form} tile is th >= 1 by tw a multiple of {mult}, not {tile}")
        if not fits(*smem(th, tw)):
            raise ValueError(f"tile {tile} needs {smem(th, tw)[0]} bytes of shared memory")
    else:
        # the tile of least estimated work per image (issue slots: a loaded word
        # LOAD_COST, a computed pixel its MMA or taps, a tile TILE_COST) among
        # those within an SM's share of shared memory, preferring grids of at
        # least MIN_TILES_PER_SM tiles per SM
        target = SMEM_PER_SM // BLOCKS_PER_SM - 1024
        if form == "dense":
            # a tile's m-tiles go to the warps MT at a time: pixels short of a
            # whole round leave warps idle
            px_cost, px_round = kp * (8 + ns // 8) // 8, 16 * WARPS * DENSE_MT[ns // 8]
        else:
            px_cost, px_round = np_ * kp * conv.in_per_group * 9, 1
        best = None
        for tw in range(mult, min(tw_max, _round_up(wo, mult)) + 1, mult):
            for th in range(1, min(ho, max(1, px_max // tw)) + 1):
                size, ir, ic = smem(th, tw)
                if size > target or not fits(size, ir, ic):
                    break
                tiles = -(-ho // th) * -(-wo // tw) * slices
                cost = tiles * (LOAD_COST * ir * ic * c4 + px_cost * _round_up(th * tw, px_round)
                                + TILE_COST)
                key = (n * tiles < MIN_TILES_PER_SM * sms, cost, -th * tw)
                if best is None or key < best[0]:
                    best = (key, th, tw)
        if best is None:  # one row of the widest tile a block can hold at all
            widths = [tw for tw in range(mult, min(tw_max, _round_up(wo, mult)) + 1, mult)
                      if fits(*smem(1, tw))]
            if not widths:
                raise ValueError(f"int8 conv {tuple(x_shape)} k{conv.kh}x{conv.kw}: no tile fits "
                                 f"{SMEM_MAX} bytes of shared memory")
            best = (None, 1, widths[-1])
        _, th, tw = best
    size, ir, ic = smem(th, tw)
    ty, tx = -(-ho // th), -(-wo // tw)
    return Plan(form, th, tw, ir, ic, pp, kp, np_, ty, tx, pitch, size,
                _grid(n * slices, ty, tx, size, sms))


def geometry(conv: Int8Conv, x_shape: Sequence[int], p: Plan, vec: bool) -> list[int]:
    """The launch's ints in ``csrc/int8_conv.cu``'s I8Geom order."""
    n, h, w, c = x_shape
    ho, wo = conv.out_hw(h, w)
    (sh, sw), (ph, pw), (dh, dw) = conv.stride, conv.padding, conv.dilation
    return [int(p.form == "grouped"), n, h, w, c, -(-c // 4), ho, wo, conv.out_channels,
            conv.kh, conv.kw, sh, sw, ph, pw, dh, dw, conv.in_per_group,
            conv.out_channels // conv.groups, p.th, p.tw, p.ir, p.ic, p.pp, p.kp, p.np,
            p.tiles_y, p.tiles_x, p.pitch, p.smem, p.blocks, int(vec)]


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
    fn = lib.int8_conv_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, ctypes.c_int, p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, conv: Int8Conv, out_dtype: torch.dtype,
            tile: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """One kernel launch on a CUDA ``x [N, H, W, C]`` (float32 or bfloat16,
    contiguous), on ``plan``'s tile or ``tile`` for the card's SMs;
    allocates only the output.  The plan and the launch's geometry are kept
    per input shape (the last ``LAUNCH_CACHE`` shapes)."""
    if conv.w_kernel is None or conv.w_kernel.device != x.device:
        raise ValueError(f"the int8 conv's weights are not on {x.device}")
    aligned = x.data_ptr() % 16 == 0
    key = (tuple(x.shape), x.dtype, out_dtype, tile, aligned)
    entry = conv._launches.get(key)
    if entry is None:
        n, h, w, c = x.shape
        ho, wo = conv.out_hw(h, w)
        if min(n, ho, wo) < 1:
            return torch.empty((n, max(ho, 0), max(wo, 0), conv.out_channels), dtype=out_dtype,
                               device=x.device)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        p = plan(conv, x.shape, x.dtype, out_dtype, tile, sms)
        geom = (ctypes.c_int * GEOM_INTS)(*geometry(conv, x.shape, p, c % 4 == 0 and aligned))
        if len(conv._launches) >= LAUNCH_CACHE:
            conv._launches.clear()
        entry = conv._launches[key] = (p, geom, (n, ho, wo, conv.out_channels))
    p, geom, out_shape = entry
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    fn = _library()
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), conv.w_kernel.data_ptr(),
            conv.scale.data_ptr(), conv.bias.data_ptr(), out.data_ptr(), _OUT_KIND[out_dtype],
            ctypes.cast(geom, ctypes.c_void_p), float(conv.s_in))
    if torch.cuda.current_device() == x.device.index:
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc == PLAN_MISMATCH:
        raise RuntimeError(f"int8 conv plan {p} disagrees with the kernel's shared-memory layout")
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {rc}")
    int8_conv.launches += 1
    int8_conv.launches_by_kernel[p.form] += 1
    return out


def int8_conv(x: torch.Tensor, conv: Int8Conv,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 conv of ``x [N, H, W, C]`` (float32 or bfloat16) ->
    ``[N, Ho, Wo, out]`` in ``out_dtype`` (default ``x``'s; ``torch.int32``:
    the accumulators, without the epilogue).

    A CPU tensor runs ``int8_conv_reference``; a CUDA tensor launches one
    kernel (counted; a non-contiguous input is copied first, counted in
    ``int8_conv.copies``) or raises.
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
    if not x.is_contiguous():
        int8_conv.copies += 1
        x = x.contiguous()
    return _launch(x, conv, out_dtype)


def reset_launches() -> None:
    """Zero ``int8_conv.launches``, ``int8_conv.launches_by_kernel`` and
    ``int8_conv.copies``."""
    int8_conv.launches = 0
    int8_conv.copies = 0
    int8_conv.launches_by_kernel = dict.fromkeys(KERNELS, 0)


reset_launches()
