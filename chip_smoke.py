"""Smoke run of the PyTorch/CUDA port (``instancesegmentation_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero; nothing is caught and continued):

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``instancesegmentation_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   serving shapes, with TF32 off: the chain's SIMT form (through ``_launch``)
   on the section-1 and section-2+3 specs of the 480 px program in float32
   (atol 1e-3 plus rtol 1e-4 of the reference's magnitude: the sums run in
   another order) and bfloat16 I/O (atol 0.1, rtol 0.1); the chain's banded
   cluster form on both specs of the 480 and 512 px programs at batch 8 and
   128, against its rounding plain version within twice the spread between
   that plain version with its sums in float32 and in float64 (at least one
   bf16 ulp of the output's largest magnitude), and against the float32
   plain version within atol 0.1 + rtol 0.1 of the output's largest
   magnitude; the banded float32 form on the same specs and batches against
   the float32 plain version (atol 1e-3, rtol 1e-4); each banded plan (cluster,
   bands, shared memory, phases, resident clusters) and both banded kernels'
   ptxas lines; ``bottleneck3x3_fused`` in float32 through the banded
   float32 form (atol 1e-3, rtol 1e-4); then the detection kernels: NMS
   bit-equal, one launch per call (N = 48 to 4096, where the kernel sorts,
   and one N above its sort limit; thresholds 0.5 and 0.7, ties, duplicates,
   zero-area boxes, -0.0 beside +0.0 and NaN scores, K below and above N, a
   score threshold; N = 1024 with the walk forced into column windows of 1,
   3 and 8 words; one image of N = 60,000 against the row-blocked plain
   version; ``nms_batch`` on [8, 1000] in one launch), ``roi_align`` with
   and without its locality order (through ``_launch``) within atol 1e-4 +
   rtol 1e-4 at torchvision's Mask R-CNN pooler shapes on a stride-4 FPN
   level of an 800x1344 input (features [2, 200, 336, 256], scale 1/4, 1000
   ROIs at 7x7 and 100 at 14x14, both ``aligned`` values, bfloat16
   features, boxes with NaN and infinite coordinates giving zeros, indices
   -1, N and -N-1); matching bit-equal
   against the plain version, with the rescue in the cluster form (also
   against the two-pass form), without it in the two-pass form's row pass
   ([2000, 64] with ties and an all-zero column, [256, 8], [60000, 64]
   whose rows do not fit in shared memory, NaN in rows, in columns and a
   whole NaN row), one launch per call; and
   both two-level rotated
   warp kernels (``warp_2level``, one tiled launch, and ``warp_2level_fused``)
   at the training shape (batch 32, 640 -> 480, draws with rotate 25 incl.
   samples at 0, flips, jitter 0.1, boxes moved so the centring translation
   cuts content off) within 1e-2 on the 0-255 scale of the plain version,
   and bit-equal to each other, also with tile plans too small for the
   samples (sub-tiles, and rows read straight from pass 1);
4. serve at full width from seeded random weights with random running
   statistics: the 20-channel instance program at 480 px over a batch of 128
   in bfloat16 (with the launch counts read around that one dispatch: 2
   banded chain launches), the same engine in float32 on the card (2 banded
   float32 launches, no SIMT one), a float32 CPU engine on two rows
   of the batch, a few requests through ``ServingFrontend``, the uint8
   resize on the card against the host (bit-equal), and the 3-channel
   whole-image program at 512 px over 128 images (2 banded launches, one
   integer uint8 resize per image); then the proposal path (2 banded
   launches per dispatch): 64 images of 360-800 px with 48 proposals each
   through ``iter_segment_proposals`` (NMS at 0.7, 16 instances, dispatches
   of 128), with one NMS launch per image, one integer uint8 resize per
   image larger than the canvas, the keeps of the plain NMS on the CPU and
   the packing rule's dispatch count, and its first two images through the
   float32 card and CPU engines; and ``roi_align`` and ``match_proposals``
   through their own entry points (3 roi_align launches: 2 gathers and the
   locality order of the 1000 ROIs; one cluster matcher launch); then
   train at full width (the training
   slice's main path): ``TrainConfig`` defaults with ``Segment(20)``, 640 ->
   480, bf16, folded head, rotate 25 through the 2level sampler, flips,
   jitter, photometric draws, 10 ``make_train_step`` steps at batch 32 on
   one fixed batch (1 ``warp_2level`` launch per step, finite falling
   losses), one ``make_eval_step``, ``warp_2level_fused`` through its own
   entry point, and one float32 step (batch 2, 192 -> 64) on the card
   against the same step on the CPU; then the trainer from disk: the port
   writes a synthetic train set of 128 COCO-sized images (480 x 640, one
   object each) and a val set of 32, ``python -m
   instancesegmentation_tpu_torch.train``'s ``main`` trains on them
   (``TrainConfig`` defaults, batch 32, 2 epochs, the train480
   augmentations, save gate 0, a loss row per step, image grids), with
   ``warp_2level`` launched on every step that rotates a sample; a fresh
   ``Trainer`` resumes from the checkpoint (epoch and best from its meta,
   its state tree bit-equal to the file's); ``load_any_checkpoint`` feeds
   an ``InferenceEngine(in_channels=20, size=480)`` that serves the 32 val
   instances in one dispatch (2 banded ``fused_chain`` launches, non-empty
   masks); and the train img/s over steps 2-8 (host clock, loader
   included), the loader alone (``batch_iterator``, 8 threads), ``read_png``
   per 480 x 640 file and the checkpoint's save and load times and size;
5. time each kernel and its plain version with CUDA events at batch 128 (the
   detection kernels at the shapes above, NMS, the warp, roi_align and
   matching also by their kernels' device time in a ``torch.profiler``
   trace; roi_align without and with its locality order in turns
   (without, with, with, without) at both poolers and in bfloat16, and the
   gather traffic beside the bound (taps issued, distinct pixels per output
   row and per ROI, the union per image); matching's two forms in turns
   two-pass, cluster, cluster, two-pass; the banded chain beside
   its bound per launch, its rounding and float32 plain versions and, as a
   yardstick the port never calls, the same sections through the layer
   modules on cuDNN in bf16 channels_last; the banded float32 form beside its
   bound, the float32 plain version, the SIMT form in turns with it (SIMT,
   banded, banded, SIMT) and the same sections on cuDNN in float32 with TF32
   off; ``bottleneck3x3_fused`` on both forms in turns), the instance
   program in bf16 and float32 by CUDA events (float32 also with its chain
   on the SIMT form, in turns), the two programs and the
   proposal path end to end, and the train step (of which preprocessing and
   the warp kernels) with ``F.grid_sample`` at the warp's shape as a
   yardstick;
6. print the per-kernel JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 128
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def random_state_dict(in_channels: int, seed: int) -> dict:
    """Seeded random Segment weights with random BN running statistics and
    PReLU slopes (so that folding and per-channel indexing matter)."""
    from instancesegmentation_tpu_torch.models.layers import PReLU, init_weights_
    from instancesegmentation_tpu_torch.models.segment import Segment

    g = torch.Generator().manual_seed(seed)
    model = Segment(in_channels)
    init_weights_(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
            elif isinstance(m, PReLU):
                m.weight.uniform_(0.05, 0.45, generator=g)
    return model.state_dict()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def chain_cost(spec, n: int, elt: int) -> tuple[float, float, float]:
    """(1x1-product operations, other operations, bytes) the chain needs on
    ``n`` images: the 1x1 products; the depthwise taps and residual adds;
    input read once, output written once, weights read once."""
    from instancesegmentation_tpu_torch.ops import fused_chain as fc

    p = n * spec.h * spec.w
    mm, other, weights, c = 0.0, 0.0, 0, spec.c_in
    for op in spec.ops:
        if isinstance(op, (fc.MatmulOp, fc.DepthwiseOp)):
            if isinstance(op, fc.MatmulOp):
                mm += 2.0 * p * op.w.size
            else:
                other += 2.0 * p * op.w.size
            weights += op.w.size + op.b.size
            c = op.w.shape[1]
        elif isinstance(op, fc.ResidualAdd):
            if op.proj is not None:
                mm += 2.0 * p * op.proj.w.size
                weights += op.proj.w.size + op.proj.b.size
                c = op.proj.w.shape[1]
            other += p * c
        elif isinstance(op, fc.ConcatChainInput):
            c += spec.c_in
    io = p * (spec.c_in + spec.c_out) * elt + 4 * weights
    return mm, other, io


def chain_bound(spec, n: int, dtype) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, operations, bytes) of one chain launch on
    ``n`` images.  bf16 I/O: the 1x1 products at the bf16 tensor-core rate,
    the depthwise taps and residual adds (float32 on the CUDA cores) at the
    float32 rate, the larger of the two (the pipes can overlap); float32 I/O:
    every operation at the float32 rate."""
    mm, other, io = chain_cost(spec, n, 2 if dtype == torch.bfloat16 else 4)
    if dtype == torch.bfloat16:
        t_ops = max(mm / PEAK_BF16_FLOPS, other / PEAK_F32_FLOPS)
    else:
        t_ops = (mm + other) / PEAK_F32_FLOPS
    t_bytes = io / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            mm + other, io)


def bf16_ulp(v: float) -> float:
    """The spacing of bfloat16 values at magnitude ``v``."""
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def banded_check(got, r32, r64, f32, what: str) -> dict:
    """The banded kernel against its rounding plain version ``r32`` within
    twice the spread between ``r32`` and the same program with its sums in
    float64 (``r64``), and at least one bf16 ulp of the output's largest
    magnitude: a sum that rounds differently flips a bf16 rounding, which the
    later ops carry on, so two right float32 programs differ by that much.
    Against the float32 plain version ``f32`` within atol 0.1 + rtol 0.1 of
    the output's largest magnitude (per element, values near zero move by
    more than 10 % of themselves: their share is printed)."""
    got, r32, r64, f32 = got.float(), r32.float(), r64.float(), f32.float()
    spread = (r32 - r64).abs().max().item()
    top = r64.abs().max().item()
    limit = 2.0 * max(spread, bf16_ulp(top))
    err = (got - r32).abs().max().item()
    d32 = (got - f32).abs()
    top32 = f32.abs().max().item()
    out = {"max_abs_err": err, "limit": limit, "spread_f32_f64": spread, "max_abs_ref": top,
           "mean_abs_err": (got - r32).abs().mean().item(),
           "max_abs_err_f32": d32.max().item(), "limit_f32": 0.1 + 0.1 * top32,
           "rms_rel_err_f32": (d32.pow(2).mean().sqrt() / f32.pow(2).mean().sqrt()).item(),
           "share_outside_elementwise_f32": (d32 > 0.1 + 0.1 * f32.abs()).float().mean().item()}
    print(f"check {what}: {json.dumps(out)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(err <= limit, f"{what}: outside twice the float32/float64 spread")
    check(out["max_abs_err_f32"] <= out["limit_f32"], f"{what}: too far from the float32 program")
    return out


def section_yardstick(model, name: str):
    """The chain's sections through the layer modules of a model prepared for
    serving (BN folded, its dtype, channels_last; cuDNN convolutions) on an
    NHWC input: a yardstick only, the port never runs it."""
    def run(x):
        y = x.permute(0, 3, 1, 2)
        if name == "s1":
            for block in model.bottle1_x:
                y = block(y, False)
        else:
            y0 = y
            for block in model.bottle2_x:
                y = block(y, False)
            y = model.bottle3_1(torch.cat([y, y0], dim=1), False)
            for block in model.bottle3_x:
                y = block(y, False)
        return y.permute(0, 2, 3, 1)
    return run


LAUNCH_RECORDS = ("cudaLaunchKernel", "cuLaunchKernel")  # the launch calls CUPTI records
TRACE_WARMUP = 3  # calls at the start of a trace that it does not measure
TRACE_ATTEMPTS = 5  # traces taken before the time falls back to CUDA events
trace_stats = {"traces": 0, "warmup_launches_without_span": 0, "measured_calls_dropped": 0,
               "event_fallbacks": []}


def _kernel_time(fn, iters: int, kernel: str = "") -> tuple[float, float]:
    """Device ms per call of ``fn`` in the CUDA kernels whose name holds
    ``kernel``, and their launches per call, from a ``torch.profiler`` trace
    of ``TRACE_WARMUP + iters`` calls, of which the last ``iters`` are
    measured.  On the card kernel launches at times had no device span while
    their launch records were there: most often the first two of a trace,
    at times a long run of them, in up to three traces in a row (PERF.md).
    The warm-up calls take the first loss; of the measured calls
    only those whose every launch has its span (matched by CUPTI correlation
    id) are averaged, and a trace counts if at least half of them are
    whole.  A trace that does not is printed, with the positions of the
    launches that lack a span, and taken again, up to five times in all.
    After five such traces the time is that of the calls by CUDA events
    (``cuda_ms``: launches and any other kernels included, so an upper
    bound of the kernels' time), its launches per call those of the launch
    records, and the kernel is listed in ``trace_stats["event_fallbacks"]``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls = TRACE_WARMUP + iters
    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = prof.profiler.kineto_results.events()
        spans = {}
        for e in evs:
            if e.device_type().name == "CUDA":
                spans.update({c: e for c in (e.correlation_id(), e.linked_correlation_id()) if c})
        records = [c for _, c in sorted((e.start_ns(), e.correlation_id()) for e in evs
                                        if any(k in e.name() for k in LAUNCH_RECORDS))]
        per_call = len(records) // calls
        trace_stats["traces"] += 1
        trace_stats["warmup_launches_without_span"] += sum(
            c not in spans for c in records[:TRACE_WARMUP * per_call])
        if per_call and len(records) == calls * per_call:
            whole = [[spans[c] for c in records[i * per_call:(i + 1) * per_call]]
                     for i in range(TRACE_WARMUP, calls)
                     if all(c in spans for c in records[i * per_call:(i + 1) * per_call])]
            mine = [[e for e in call if kernel in e.name()] for call in whole]
            if 2 * len(whole) >= iters and all(mine):
                trace_stats["measured_calls_dropped"] += iters - len(whole)
                return (sum(e.duration_ns() for call in mine for e in call) / 1e6 / len(mine),
                        sum(map(len, mine)) / len(mine))
        print(f"profiler: incomplete trace {attempt + 1} of {kernel or 'every kernel'}: "
              f"{len(records)} launches in {calls} calls, those without a span (in launch "
              f"order): {[i for i, c in enumerate(records) if c not in spans]}")
    check(per_call > 0 and len(records) == calls * per_call,
          f"profiler: {len(records)} launch records in {calls} calls of {kernel or 'a function'}")
    trace_stats["event_fallbacks"].append(kernel or "every kernel")
    print(f"profiler: no whole trace of {kernel or 'every kernel'} in {TRACE_ATTEMPTS}; its "
          f"time from CUDA events around the calls instead")
    return cuda_ms(fn, iters), float(per_call)


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Device time per call of ``fn`` in the CUDA kernels whose name holds
    ``kernel`` (``_kernel_time``)."""
    return _kernel_time(fn, iters, kernel)[0]


def device_calls(fn, iters: int = 20) -> tuple[float, float]:
    """Device time per call of ``fn`` summed over every kernel it launches,
    and the kernels it launches per call (``_kernel_time``)."""
    return _kernel_time(fn, iters)


def ptxas_report(log: str, kernel: str) -> str:
    """nvcc -Xptxas -v's lines for one kernel (registers, spills, shared
    memory), joined."""
    entry = log.split(kernel, 1)[1].split("Compiling entry", 1)[0]
    return " | ".join(ln.strip() for ln in entry.splitlines()[1:] if ln.strip())


def max_err(got, want, atol, rtol, what) -> float:
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    print(f"check {what}: max_abs_err={err.max().item():.3e} "
          f"max|ref|={want.float().abs().max().item():.3e} (atol {atol}, rtol {rtol})")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(bool((err <= limit).all()), f"{what}: outside tolerance")
    return err.max().item()


def exact(got, want, what: str) -> None:
    """Bit equality of two tuples of tensors (indices, flags, labels)."""
    for a, b in zip(got, want):
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
              f"{what}: kernel and plain version differ")
    print(f"check {what}: equal")


# -- detection ops: inputs and costs ------------------------------------------

# float32 operations greedy NMS needs: per IoU pair 4 min/max, 2 subtractions,
# 2 clamps, the intersection product, the union's add and subtract, its
# test, clamp and the division, and the threshold test; per box its area
# (2 subtractions, 2 clamps, 1 product)
IOU_PAIR_OPS, IOU_BOX_OPS = 15, 5


def nms_inputs(g, n: int, dev, batch=()):
    """Boxes in a 640 px field with exact score ties (20 levels), duplicated
    boxes (IoU 1), zero-area boxes, -0.0 beside +0.0 scores and a few NaN
    scores (which never survive)."""
    shape = tuple(batch) + (n,)
    xy = torch.rand(shape + (2,), generator=g, device=dev) * 600
    wh = torch.rand(shape + (2,), generator=g, device=dev) * 120 + 8
    boxes = torch.cat([xy, xy + wh], -1)
    scores = (torch.rand(shape, generator=g, device=dev) * 20).floor() / 20
    scores[..., 0::17] = 0.0
    scores[..., 8::17] = -0.0
    scores[..., 5::29] = float("nan")
    dup = boxes[..., 3::9, :].shape[-2]
    boxes[..., 3::9, :] = boxes[..., 2::9, :][..., :dup, :]
    boxes[..., 5::11, 2] = boxes[..., 5::11, 0]
    boxes[..., 7::13, 3] = boxes[..., 7::13, 1]
    return boxes.contiguous(), scores.contiguous()


def nms_work(boxes, scores, thr: float) -> int:
    """IoU evaluations greedy NMS needs on these boxes: for each surviving
    box, the later boxes still alive at its step."""
    from instancesegmentation_tpu_torch.ops.nms import box_iou

    order = torch.argsort(-scores.float(), stable=True)
    sup = (box_iou(boxes[order], boxes[order]) > thr).cpu().numpy()
    alive = (scores.float()[order] > float("-inf")).cpu().numpy()  # NaN never lives
    pairs = 0
    for i in range(len(order)):
        if alive[i]:
            pairs += int(alive[i + 1:].sum())
            alive[i + 1:] &= ~sup[i, i + 1:]
    return pairs


def nms_bound(n: int, k: int, pairs: int, images: int = 1) -> tuple[float, str]:
    """boxes and scores read once, indices and flags written once; the IoU
    work at the float32 rate outside the tensor cores."""
    return bound_f32(IOU_PAIR_OPS * pairs + IOU_BOX_OPS * images * n,
                     images * (20 * n + 9 * k))


def bound_f32(ops: float, io: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, io / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def roi_inputs(g, r: int, dev, image_hw=(800, 1344), n_images: int = 2):
    """``r`` proposals of 16-600 px (log-uniform) centred anywhere in the
    image, so some reach past its edges, on random images of the batch."""
    lo, hi = np.log(16.0), np.log(600.0)
    wh = torch.exp(torch.rand((r, 2), generator=g, device=dev) * (hi - lo) + lo)
    ctr = torch.rand((r, 2), generator=g, device=dev) * torch.tensor(
        [image_hw[1], image_hw[0]], dtype=torch.float32, device=dev)
    idx = torch.randint(0, n_images, (r,), generator=g, device=dev, dtype=torch.int32)
    return torch.cat([ctr - wh / 2, ctr + wh / 2], 1), idx


def roi_repair_inputs(boxes, idx, n: int):
    """The first boxes with NaN and infinite coordinates (whose samples count
    for nothing), and indices -1, N and -N-1 on the next ones."""
    b, i = boxes.clone(), idx.clone()
    inf, nan = float("inf"), float("nan")
    b[0] = torch.tensor([nan, 10.0, 50.0, 50.0])
    b[1] = torch.tensor([-inf, 10.0, inf, 50.0])
    b[2] = torch.tensor([10.0, nan, 50.0, nan])
    b[3] = torch.tensor([20.0, -inf, 60.0, 40.0])
    i[4:7] = torch.tensor([-1, n, -n - 1], dtype=i.dtype)
    return b, i


def nan_matrices(iou) -> dict:
    """IoU matrices with NaN in a few rows, in a few columns, and one whole
    NaN row."""
    rows, cols, whole = iou.clone(), iou.clone(), iou.clone()
    rows[[0, 40, 1999], 5] = float("nan")
    rows[40, 60] = float("nan")
    cols[[3, 900], 20] = float("nan")
    cols[:, 33] = float("nan")
    whole[17] = float("nan")
    return {"[2000, 64] NaN rows": rows, "[2000, 64] NaN columns": cols,
            "[2000, 64] a NaN row": whole}


def _axis_taps(start, bin_size, size: int, out_dim: int, ratio: int):
    """Per ROI, output index and sample: the two taps and whether the
    sample counts (the rule of ops/roi_align.py:_interp_weights)."""
    dev = start.device
    o = torch.arange(out_dim, dtype=torch.float32, device=dev)[:, None]
    s = (torch.arange(ratio, dtype=torch.float32, device=dev) + 0.5) / torch.full(
        (), float(ratio), device=dev)
    ctr = start[:, None, None] + (o + s) * bin_size[:, None, None]
    ok = (ctr >= -1) & (ctr <= size)
    i0 = ctr.clamp(0, size - 1).floor().long()
    i1 = (i0 + 1).clamp(max=size - 1)
    return torch.where(ok, i0, -1), torch.where(ok, i1, -1), ok  # [R, out, ratio]


def roi_traffic(features, boxes, idx, out_hw, scale, ratio, aligned) -> dict:
    """Feature bytes of the gathers: the taps the kernel issues (four per
    counted sample), the distinct pixels of each output row and of each
    ROI, and the union over the ROIs of each image (what the bound
    counts)."""
    from instancesegmentation_tpu_torch.ops.roi_align import _roi_geometry, gather_index

    n, h, w, c = features.shape
    oh, ow = out_hw
    px = c * features.element_size()
    x0, y0, bw, bh = _roi_geometry(boxes, out_hw, scale, aligned)
    xi0, xi1, xok = _axis_taps(x0, bw, w, ow, ratio)
    yi0, yi1, yok = _axis_taps(y0, bh, h, oh, ratio)
    issued = 4 * yok.sum((1, 2)) * xok.sum((1, 2))

    def marks(i0, i1, size):  # [R, k] taps -> [R, size] pixels touched
        m = torch.zeros((i0.shape[0], size + 1), dtype=torch.bool, device=i0.device)
        m.scatter_(1, torch.where(i0 < 0, size, i0), True)
        m.scatter_(1, torch.where(i1 < 0, size, i1), True)
        return m[:, :size]

    cols = marks(xi0.flatten(1), xi1.flatten(1), w)
    ncols = cols.sum(1)
    rows_roi = marks(yi0.flatten(1), yi1.flatten(1), h)
    per_row = sum(marks(yi0[:, j], yi1[:, j], h).sum(1) for j in range(oh)) * ncols
    img = gather_index(idx, n)
    union = 0
    for i in range(n):
        sel = img == i
        union += int((rows_roi[sel][:, :, None] & cols[sel][:, None, :]).any(0).sum())
    return {"issued_taps": int(issued.sum()) * px, "per_row_distinct": int(per_row.sum()) * px,
            "per_roi_distinct": int((rows_roi.sum(1) * ncols).sum()) * px, "union": union * px}


def proposal_requests(rng, n_images: int) -> list:
    """Images of 360-800 px, each with 48 proposals: 8 jittered copies of
    the box of each of 6 persons, random scores, 17 keypoints per box."""
    reqs = []
    for _ in range(n_images):
        h, w = (int(v) for v in rng.integers(360, 801, 2))
        boxes, kps = [], []
        for _ in range(6):
            bw, bh = rng.uniform(0.15, 0.45) * w, rng.uniform(0.3, 0.8) * h
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            for _ in range(8):
                b = np.array([x0, y0, x0 + bw, y0 + bh]) + rng.normal(0, 0.03 * min(bw, bh), 4)
                boxes.append(b)
                kps.append(np.concatenate([rng.uniform(b[:2], b[2:], (17, 2)),
                                           np.ones((17, 1))], 1))
        reqs.append({"image": rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                     "boxes": np.asarray(boxes, np.float32),
                     "scores": rng.uniform(0.05, 1.0, 48).astype(np.float32),
                     "keypoints": np.asarray(kps, np.float32)})
    return reqs


def packed_dispatches(kept_counts, cap: int) -> int:
    """``predict_instances`` calls of iter_segment_proposals' packing rule:
    one each time the pending crops reach ``cap``, one for the rest."""
    calls, pending = 0, 0
    for k in kept_counts:
        pending += k
        if pending >= cap:
            calls, pending = calls + 1, 0
    return calls + (pending > 0)


# -- training: inputs and costs -----------------------------------------------

TRAIN_BATCH = 32
TRAIN_STEPS = 10
#: float32 operations per output value of each warp pass: two hat taps, each a
#: 2-tap residual lerp (2 products, 1 add) accumulated (1 product, 1 add)
WARP_OPS_PER_VALUE = 10


def training_batch(b: int, canvas: int, seed: int) -> dict:
    """``synthetic_host_batch`` with each sample's boxes moved by up to a
    third of the canvas, so that the centring translation cuts content off
    (the case where the probe kernels and the path's sampler part ways)."""
    from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch

    batch = synthetic_host_batch(b, canvas, seed=seed)
    shift = np.random.default_rng(seed).uniform(-canvas / 3, canvas / 3, (b, 2))
    batch["obj_box"] = batch["obj_box"] + np.tile(shift, 2).astype(np.float32)
    batch["mask_box"] = batch["mask_box"] + np.tile(shift, 2).astype(np.float32)
    return batch


def warp_cost(coefs, image_shape, out_hw) -> tuple[float, float]:
    """(operations, bytes) of the two-level warp on these inputs: uint8 canvas
    and mask read once, coefficients read once, the float32 [B,oh,ow,4] output
    written once; operations for the pass-1 rows inside the translation cut
    and the pass-2 pixels inside the rotation cut, 4 channels each."""
    b, h, w, _ = image_shape
    oh, ow = out_hw
    c = coefs.double().cpu()
    y = torch.arange(h, dtype=torch.float64)
    rows = ((y >= c[:, 8:9]) & (y < torch.clamp_max(c[:, 9:10], h))).sum().item()
    pyu = c[:, 10:11] * torch.arange(oh, dtype=torch.float64) + c[:, 11:12]
    pxv = c[:, 12:13] * torch.arange(ow, dtype=torch.float64) + c[:, 13:14]
    row_ok = ((pyu >= 0) & (pyu < c[:, 14:15])).sum(1)
    col_ok = ((pxv >= 0) & (pxv < c[:, 15:16])).sum(1)
    pixels = rows * ow + (row_ok * col_ok).sum().item()
    ops = WARP_OPS_PER_VALUE * 4 * pixels
    io = b * h * w * 4 + coefs.numel() * 4 + b * oh * ow * 4 * 4
    return float(ops), float(io)


# -- the trainer from disk -----------------------------------------------------

DISK_TRAIN, DISK_VAL, DISK_HW = 128, 32, (480, 640)
DISK_BATCH, DISK_EPOCHS = 32, 2


def step_ms_from_log(rows: list) -> tuple[float, int]:
    """Host time of the train steps after the first, from ``metrics.jsonl``
    rows in file order (``show_iter`` 1: one loss row per step, stamped after
    the step's loss was read back): each step from the row before it, so a
    validation (its own row) is left out and the loader's waits are kept.
    Returns (seconds, steps)."""
    seconds, steps, prev = 0.0, 0, None
    for r in rows:
        if "loss" in r and r["step"] > 1 and prev is not None:
            seconds += r["time"] - prev
            steps += 1
        prev = r["time"]
    return seconds, steps


def trainer_from_disk(dev, card: str, w2, fc) -> dict:
    """The trainer's path from a dataset directory to a served checkpoint, at
    full width: write a COCO-sized synthetic train and val set with the port,
    ``python -m instancesegmentation_tpu_torch.train``'s ``main`` on it
    (``TrainConfig`` defaults: ``Segment(20)``, 640 -> 480, bf16, folded head,
    Adam 1e-3; batch 32, 2 epochs, the train480 augmentations), resume it in a
    fresh ``Trainer`` (bit for bit), serve the checkpoint through
    ``load_any_checkpoint`` and ``InferenceEngine``, and time the loader,
    ``read_png`` and the checkpoint codec."""
    import glob
    import os
    import tempfile

    from instancesegmentation_tpu_torch.core.png import read_png
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.data.pipeline import batch_iterator, draw_augment, host_batch
    from instancesegmentation_tpu_torch.data.synthetic import make_synthetic_dataset
    from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine, load_any_checkpoint
    from instancesegmentation_tpu_torch.train import loop
    from instancesegmentation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from instancesegmentation_tpu_torch.train.config import parse_args
    from instancesegmentation_tpu_torch.train.state import from_state_tree, to_state_tree
    from instancesegmentation_tpu_torch.train.steps import augment_config

    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        train_dir, val_dir = os.path.join(tmp, "train"), os.path.join(tmp, "val")
        t0 = time.perf_counter()
        make_synthetic_dataset(train_dir, DISK_TRAIN, DISK_HW, 1, seed=SEED)
        make_synthetic_dataset(val_dir, DISK_VAL, DISK_HW, 1, seed=SEED + 1)
        out["write_dataset_s"] = time.perf_counter() - t0
        argv = ["--train-dataset-dir", train_dir, "--val-dataset-dir", val_dir,
                "--checkpoint-dir", os.path.join(tmp, "ckpt"),
                "--out-dir", os.path.join(tmp, "runs"),
                "--batch-size", str(DISK_BATCH), "--epochs", str(DISK_EPOCHS),
                "--rotate", "25", "--flip-prob", "0.5", "--jitter", "0.1",
                "--brightness", "0.2", "--contrast", "0.2", "--noise-std", "5",
                "--save-iou-gate", "0", "--show-iter", "1", "--log-images", "true"]
        cfg = parse_args(argv)
        check((cfg.in_channels, cfg.canvas, cfg.out_size, cfg.bfloat16, cfg.fused_head,
               cfg.learning_rate) == (20, 640, 480, True, True, 1e-3),
              "trainer from disk: TrainConfig defaults")

        # -- train through the entry point; counts read around this run only
        w2.warp_2level.launches = 0
        fc.reset_launches()
        t0 = time.perf_counter()
        loop.main(argv)
        torch.cuda.synchronize()
        out["train_wall_s"] = time.perf_counter() - t0
        launches = {"warp_2level": w2.warp_2level.launches,
                    "fused_chain": fc.fused_chain.launches}
        out["launches"] = launches
        n_steps = DISK_EPOCHS * (DISK_TRAIN // DISK_BATCH)
        aug = augment_config(cfg, train=True)
        rotated = sum(bool((draw_augment(DISK_BATCH, aug, torch.Generator(device=dev).manual_seed(
            loop.step_seed(cfg.seed, s)))["theta"] != 0).any()) for s in range(n_steps))
        with open(os.path.join(cfg.out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["loss"] for r in rows if "loss" in r]
        vals = [r["val_iou"] for r in rows if "val_iou" in r]
        print(f"trainer from disk (Segment(20) 640 -> 480, bf16, batch {DISK_BATCH}, "
              f"{DISK_EPOCHS} epochs of {DISK_TRAIN} images {DISK_HW}, val {DISK_VAL}): "
              f"losses {[round(v, 4) for v in losses]}, val IoU {[round(v, 4) for v in vals]}, "
              f"launches {launches}, {rotated} of {n_steps} steps with a rotated sample")
        check(len(losses) == n_steps and all(np.isfinite(losses)),
              "trainer from disk: one finite loss row per step in metrics.jsonl")
        check(len(vals) == DISK_EPOCHS and all(0.0 <= v <= 1.0 for v in vals),
              "trainer from disk: one validation per epoch")
        check(launches["warp_2level"] >= rotated > 0,
              "trainer from disk: warp_2level launched on every step with a rotated sample")
        found = glob.glob(os.path.join(cfg.checkpoint_dir, "*_best.ckpt"))
        check(len(found) == 1, "trainer from disk: the branch-best checkpoint exists")
        ckpt_path = found[0]
        grids = sorted(glob.glob(os.path.join(cfg.out_dir, "viz", "*.png")))
        check(len(grids) == DISK_EPOCHS and all(
            read_png(g).shape == (4 * 480, 4 * 480, 3) for g in grids),
            "trainer from disk: the viz grids decode")
        secs, steps = step_ms_from_log(rows)
        out.update({"steps": n_steps, "rotated_steps": rotated, "losses": losses,
                    "val_iou": vals, "train_img_per_s_steps_2_to_n": steps * DISK_BATCH / secs,
                    "train_ms_per_step_steps_2_to_n": secs / steps * 1e3})

        # -- resume: a fresh Trainer holds the saved state bit for bit
        saved, meta = load_checkpoint(ckpt_path)
        resumed = loop.Trainer(cfg)
        resumed.logger.close()
        check(resumed.start_epoch == meta["epoch"] and resumed.iou_max == meta["best"],
              "resume: the saved epoch and best")
        tree = to_state_tree(resumed.state)

        def leaves(t, prefix=()):
            for k, v in t.items():
                if isinstance(v, dict):
                    yield from leaves(v, prefix + (k,))
                else:
                    yield prefix + (k,), np.asarray(v)

        got = dict(leaves(tree))
        want = dict(leaves(saved))
        check(got.keys() == want.keys() and all(
            got[k].dtype == v.dtype and np.array_equal(got[k], v) for k, v in want.items()),
            "resume: to_state_tree equals the file's tree bit for bit")
        print(f"resume: epoch {resumed.start_epoch}, best {resumed.iou_max:.4f}, step "
              f"{resumed.state.step}; {len(want)} leaves bit-equal")

        # -- checkpoint codec times and size
        t0 = time.perf_counter()
        tree = to_state_tree(resumed.state)
        save_checkpoint(os.path.join(tmp, "timed.ckpt"), tree, meta)
        out["checkpoint_save_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        from_state_tree(load_checkpoint(os.path.join(tmp, "timed.ckpt"))[0], resumed.state)
        torch.cuda.synchronize()
        out["checkpoint_load_ms"] = (time.perf_counter() - t0) * 1e3
        out["checkpoint_bytes"] = os.path.getsize(ckpt_path)

        # -- serve the checkpoint: instance program over the val samples
        valset = InstanceCommonDataset(val_dir, cfg.canvas)
        batch = host_batch([valset.fetch(i) for i in range(len(valset))])
        eng = InferenceEngine(load_any_checkpoint(ckpt_path), in_channels=20, size=480)
        fc.reset_launches()
        probs, masks = eng.predict_instances(batch)
        torch.cuda.synchronize()
        serve_launches = dict(fc.fused_chain.launches_by_form)
        serve_launches["total"] = fc.fused_chain.launches
        out["serve_launches"] = serve_launches
        nonempty = int((masks.reshape(len(masks), -1) > 0).any(1).sum())
        print(f"served the checkpoint: {len(masks)} val instances in 1 dispatch, fused_chain "
              f"launches {serve_launches}, {nonempty} non-empty masks")
        check(serve_launches["total"] == 2 and serve_launches.get("banded") == 2,
              "serve: 2 fused_chain launches per dispatch")
        check(probs.shape == (DISK_VAL, 480, 480, 1) and np.isfinite(probs).all(),
              "serve: finite crop probabilities")
        check(nonempty > 0, "serve: non-empty masks")
        out["nonempty_masks"] = nonempty

        # -- the loader alone and the decoder
        trainset = InstanceCommonDataset(train_dir, cfg.canvas)
        t0 = time.perf_counter()
        n = sum(b["image"].shape[0] for b in batch_iterator(
            trainset, DISK_BATCH, shuffle=True, seed=0, epochs=2, num_threads=8))
        out["loader_samples_per_s"] = n / (time.perf_counter() - t0)
        files = sorted(glob.glob(os.path.join(train_dir, "image", "*.png")))
        t0 = time.perf_counter()
        for path in files:
            read_png(path)
        out["read_png_ms_480x640_rgb"] = (time.perf_counter() - t0) * 1e3 / len(files)
    print(f"trainer from disk: {out['train_img_per_s_steps_2_to_n']:.1f} img/s over steps 2-"
          f"{n_steps} ({out['train_ms_per_step_steps_2_to_n']:.1f} ms per step, host clock, "
          f"loader included); loader alone {out['loader_samples_per_s']:.0f} samples/s "
          f"(8 threads); read_png {out['read_png_ms_480x640_rgb']:.2f} ms per 480x640 RGB file; "
          f"checkpoint save {out['checkpoint_save_ms']:.1f} ms, load "
          f"{out['checkpoint_load_ms']:.1f} ms, {out['checkpoint_bytes']} bytes; {card}")
    print(json.dumps({"trainer_from_disk": {k: v for k, v in out.items() if k != "losses"}}))
    return out


def grid_sample_yardstick(image, mask, params, out_hw):
    """``F.grid_sample`` (one-pass bilinear, zero padding) of the float NCHW
    canvas + mask through the same rotated window: the gather sampler's
    function, timed beside the kernels as a yardstick only."""
    import torch.nn.functional as F

    b, h, w, _ = image.shape
    oh, ow = out_hw
    x = torch.cat([image.float(), mask[..., None].float()], -1).permute(0, 3, 1, 2).contiguous()
    u = torch.arange(oh, device=image.device, dtype=torch.float32)
    v = torch.arange(ow, device=image.device, dtype=torch.float32)
    py = (u[None, :, None] + 0.5) * params.scale[:, 0, None, None] - 0.5 + params.origin[:, 0, None, None]
    px = (v[None, None, :] + 0.5) * params.scale[:, 1, None, None] - 0.5 + params.origin[:, 1, None, None]
    cth, sth = params.cos_sin[:, 0, None, None], params.cos_sin[:, 1, None, None]
    cy, cx = params.center[:, 0, None, None], params.center[:, 1, None, None]
    sy = cy - sth * (px - cx) + cth * (py - cy) - params.t[:, 0, None, None]
    sx = cx + cth * (px - cx) + sth * (py - cy) - params.t[:, 1, None, None]
    grid = torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], -1)
    return lambda: F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch
        from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
        from instancesegmentation_tpu_torch.infer import proposals
        from instancesegmentation_tpu_torch.infer.server import ServingFrontend
        from instancesegmentation_tpu_torch.models.export import fold_batchnorm
        from instancesegmentation_tpu_torch.ops import _build
        from instancesegmentation_tpu_torch.ops import fused_chain as fc
        from instancesegmentation_tpu_torch.ops import matching, nms, roi_align
        from instancesegmentation_tpu_torch.infer import pipeline
        from instancesegmentation_tpu_torch.ops.fused_block import (
            bottleneck3x3_fused,
            bottleneck3x3_reference,
        )
        from instancesegmentation_tpu_torch.ops.fused_block import (
            reset_launches as reset_block_launches,
        )
        from instancesegmentation_tpu_torch.data.pipeline import (
            batch_to,
            draw_augment,
            preprocess_batch,
            rotated_warp_params,
        )
        from instancesegmentation_tpu_torch.models.layers import init_weights_
        from instancesegmentation_tpu_torch.models.segment import Segment
        from instancesegmentation_tpu_torch.ops import warp_2level as w2
        from instancesegmentation_tpu_torch.ops.warp import SRC_PAD
        from instancesegmentation_tpu_torch.train.config import TrainConfig
        from instancesegmentation_tpu_torch.train.state import TrainState
        from instancesegmentation_tpu_torch.train.steps import (
            augment_config,
            make_eval_step,
            make_train_step,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    # ptxas reports (registers, spills, stack, static shared memory) of the
    # two banded chain kernels, the nms and tiled warp kernels, roi_align's
    # order and gather (its first instantiation) and the cluster matcher
    ptxas = {}
    for src, kernel in (("fused_chain.cu", "fused_chain_banded_kernel"),
                        ("fused_chain.cu", "fused_chain_banded_f32_kernel"),
                        ("nms.cu", "nms_kernel"), ("warp_2level.cu", "warp_2level_tiled_kernel"),
                        ("roi_align.cu", "roi_order_kernel"),
                        ("roi_align.cu", "roi_align_kernel"),
                        ("matching.cu", "match_cluster_kernel")):
        log = _build.build_log.get(src)
        if log is None:
            print(f"{src} was built before this run: no ptxas report")
            continue
        ptxas[kernel] = ptxas_report(log, kernel)
        print(f"ptxas {kernel}: {ptxas[kernel]}")
        check("spill" not in ptxas[kernel] or
              "0 bytes spill stores, 0 bytes spill loads" in ptxas[kernel],
              f"{kernel} spills registers")

    # -- 3. kernels against their plain versions ---------------------------
    sd20 = random_state_dict(20, SEED)
    sd3 = random_state_dict(3, SEED + 1)
    folded = fold_batchnorm(sd20)
    specs = {"s1": fc.extract_s1_chain(folded, 60, 60),
             "s23": fc.extract_s23_chain(folded, 30, 30)}
    # both chains of the 480 px instance and the 512 px whole-image programs
    folded3 = fold_batchnorm(sd3)
    chains = {(480, "s1"): specs["s1"], (480, "s23"): specs["s23"],
              (512, "s1"): fc.extract_s1_chain(folded3, 64, 64),
              (512, "s23"): fc.extract_s23_chain(folded3, 32, 32)}
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}
    for name, spec in specs.items():
        ref_spec = spec.to(dev)
        x = torch.randn((8, spec.h, spec.w, spec.c_in), generator=g, device=dev)
        # float32 I/O on the SIMT form (what a spec no cluster holds runs)
        got = fc._launch(x, spec)
        want = fc.fused_chain_reference(x, ref_spec)
        check(got.dtype == torch.float32 and got.shape == want.shape, f"{name} f32 shape")
        errs[(name, "simt_f32")] = max_err(got, want, 1e-3, 1e-4,
                                           f"fused_chain simt {name} float32 {list(x.shape)}")
        # bf16 I/O on the SIMT form (what a spec no cluster holds runs)
        xd = x.to(torch.bfloat16)
        got = fc._launch(xd, spec)
        want = fc.fused_chain_reference(xd, ref_spec)
        check(got.dtype == torch.bfloat16 and got.shape == want.shape, f"{name} bf16 shape")
        errs[(name, "simt_bf16")] = max_err(got, want, 0.1, 0.1,
                                            f"fused_chain simt {name} bfloat16 {list(x.shape)}")

    # bf16 I/O: the banded cluster form, at batch 8 and a full grid of clusters
    banded = {}
    for (prog, name), spec in chains.items():
        ref_spec = spec.to(dev)
        plan = fc.plan_banded(spec)
        check(fc.chain_form(spec, torch.bfloat16) == "banded", f"{prog} {name}: banded plan")
        resident = fc.banded_occupancy(spec)
        print(f"banded plan {prog} {name} [{spec.h}, {spec.w}, {spec.c_in}]: cluster "
              f"{plan.cluster}, bands of {plan.band_px} px, {plan.smem_bytes} B of shared "
              f"memory per CTA, {len(plan.ops())} ops, {plan.n_phases} cluster barriers; "
              f"cudaOccupancyMaxActiveClusters {resident}")
        for n in (8, BATCH):
            x = torch.randn((n, spec.h, spec.w, spec.c_in), generator=g,
                            device=dev).bfloat16()
            before = fc.fused_chain.launches_by_form["banded"]
            got = fc.fused_chain(x, spec)
            check(fc.fused_chain.launches_by_form["banded"] == before + 1,
                  f"{prog} {name}: banded form")
            check(got.dtype == torch.bfloat16 and got.shape == (n, spec.h, spec.w, spec.c_out),
                  f"{prog} {name}: banded output")
            r32 = fc.fused_chain_reference(x, ref_spec, act_dtype=torch.bfloat16)
            r64 = fc.fused_chain_reference(x, ref_spec, act_dtype=torch.bfloat16,
                                           compute_dtype=torch.float64)
            f32 = fc.fused_chain_reference(x, ref_spec)
            banded[(prog, name, n)] = dict(
                banded_check(got, r32, r64, f32,
                             f"fused_chain banded {prog} {name} {list(x.shape)}"),
                cluster=plan.cluster, smem_bytes=plan.smem_bytes, resident_clusters=resident)
            del r32, r64, f32

    # float32 I/O: the banded float32 cluster form, at batch 8 and 128,
    # against the float32 plain version (TF32 off) within atol 1e-3 + rtol
    # 1e-4 (the SIMT check's limit: the sums run in another order)
    banded32 = {}
    for (prog, name), spec in chains.items():
        ref_spec = spec.to(dev)
        plan = fc.plan_banded(spec, dtype=torch.float32)
        check(fc.chain_form(spec, torch.float32) == "banded_f32", f"{prog} {name}: f32 plan")
        resident = fc.banded_occupancy(spec, torch.float32)
        tiles = sorted({(int(r[19]), int(r[21])) for r in plan.ops() if r[0] == fc.B_MM})
        chunked = sum(int(r[0] == fc.B_MM and r[20] != fc.MM_FIRST | fc.MM_LAST)
                      for r in plan.ops())
        print(f"banded f32 plan {prog} {name} [{spec.h}, {spec.w}, {spec.c_in}]: cluster "
              f"{plan.cluster}, bands of {plan.band_px} px, {plan.smem_bytes} B of shared "
              f"memory per CTA (slots {plan.slot_bytes}), {len(plan.ops())} ops ({chunked} "
              f"product K-chunks; rows x columns per thread {tiles}), {plan.n_phases} cluster "
              f"barriers; "
              f"cudaOccupancyMaxActiveClusters {resident}")
        for n in (8, BATCH):
            x = torch.randn((n, spec.h, spec.w, spec.c_in), generator=g, device=dev)
            before = fc.fused_chain.launches_by_form["banded_f32"]
            got = fc.fused_chain(x, spec)
            check(fc.fused_chain.launches_by_form["banded_f32"] == before + 1,
                  f"{prog} {name}: banded f32 form")
            check(got.dtype == torch.float32 and got.shape == (n, spec.h, spec.w, spec.c_out),
                  f"{prog} {name}: banded f32 output")
            banded32[(prog, name, n)] = dict(
                max_abs_err=max_err(got, fc.fused_chain_reference(x, ref_spec), 1e-3, 1e-4,
                                    f"fused_chain banded_f32 {prog} {name} {list(x.shape)}"),
                cluster=plan.cluster, smem_bytes=plan.smem_bytes, resident_clusters=resident)

    # bottleneck3x3_fused on the folded weights of the first section-1 block
    _, mm1, dw_op, mm2, res = specs["s1"].ops[:5]
    block_args = dict(
        w1=mm1.w, b1=mm1.b, a1=mm1.alpha, dw=dw_op.w.reshape(3, 3, -1),
        b_dw=dw_op.b, a2=dw_op.alpha, w2=mm2.w, b2=mm2.b, a_out=res.alpha)
    block_args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in block_args.items()}
    for shape in ((8, 64, 64, 48), (8, 60, 60, 48)):
        xb = torch.randn(shape, generator=g, device=dev)
        before = bottleneck3x3_fused.launches_by_form["banded_f32"]
        got = bottleneck3x3_fused(xb, **block_args)
        check(bottleneck3x3_fused.launches_by_form["banded_f32"] == before + 1,
              f"bottleneck3x3_fused {list(shape)}: the banded f32 form")
        errs["block"] = max(errs.get("block", 0.0), max_err(
            got, bottleneck3x3_reference(xb, **block_args), 1e-3, 1e-4,
            f"bottleneck3x3_fused {list(shape)}"))

    # the detection kernels: NMS and matching bit-equal, roi_align within
    # atol 1e-4 + rtol 1e-4 of the reference's magnitude (sums in another
    # order); NMS in one launch per call, sorting in the kernel up to its
    # limit and after the wrapper's torch sort above it
    print(f"nms: the kernel sorts up to {nms.SORT_LIMIT} boxes per image")
    for n in (48, 128, 1024, 4096, nms.SORT_LIMIT + 1000):
        boxes, scores = nms_inputs(g, n, dev)
        for thr in (0.5, 0.7):
            for k in (n // 4, n + 7):
                before = nms.nms.launches
                got = nms.nms(boxes, scores, thr, max_outputs=k)
                check(nms.nms.launches == before + 1, f"nms N={n}: one launch")
                exact(got, nms.nms_reference(boxes, scores, thr, max_outputs=k),
                      f"nms N={n} thr={thr} K={k}")
        exact(nms.nms(boxes, scores, 0.5, score_threshold=0.3),
              nms.nms_reference(boxes, scores, 0.5, score_threshold=0.3),
              f"nms N={n} thr=0.5 score_threshold=0.3")
    # the walk from a global mask in forced small column windows of 32-box
    # words, and one image above the old ~54,000-box limit, against the
    # row-blocked plain version (nms_reference's [N, N, 2] intermediates
    # would take ~29 GB each at this N)
    boxes, scores = nms_inputs(g, 1024, dev)
    for window in (1, 3, 8):
        before = nms.nms.launches
        got = nms._launch(boxes[None], scores[None], 0.5, 1024, float("-inf"), window=window)
        check(nms.nms.launches == before + 1, f"nms window {window}: one launch")
        exact((got[0][0], got[1][0]), nms.nms_reference(boxes, scores, 0.5),
              f"nms N=1024 thr=0.5 in column windows of {window} words")
    boxes, scores = nms_inputs(g, 60_000, dev)
    # spread over a 4,800 px field: thousands of boxes survive
    boxes = boxes + (torch.rand((60_000, 2), generator=g, device=dev) * 4200).repeat(1, 2)
    t_big = time.perf_counter()
    got = nms.nms(boxes, scores, 0.5)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t_big
    exact(got, nms.nms_reference_blocked(boxes, scores, 0.5),
          f"nms N=60000 thr=0.5 ({int(got[1].sum())} kept, {t_big:.2f} s with its mask)")
    del boxes, scores, got
    torch.cuda.empty_cache()
    bb, bs = nms_inputs(g, 1000, dev, batch=(8,))
    before = nms.nms.launches
    got = nms.nms_batch(bb, bs, 0.7)
    check(nms.nms.launches == before + 1, "nms_batch: one launch for 8 images")
    refs = [nms.nms_reference(bb[i], bs[i], 0.7) for i in range(8)]
    exact(got, (torch.stack([r[0] for r in refs]), torch.stack([r[1] for r in refs])),
          "nms_batch [8, 1000] thr=0.7")

    # roi_align with and without the locality order at both poolers, float32
    # and bfloat16, within atol 1e-4 + rtol 1e-4 of the reference's
    # magnitude (sums in another order); boxes with NaN and infinite
    # coordinates give zeros, and indices -1, N and -N-1 take JAX's gather
    # rule
    feats = torch.randn((2, 200, 336, 256), generator=g, device=dev)
    roi_cases = {"box_head": (1000, (7, 7)), "mask_head": (100, (14, 14))}
    roi_in = {name: roi_inputs(g, r, dev) for name, (r, _) in roi_cases.items()}
    errs["roi_align"] = 0.0
    roi_align.roi_align.launches_by_kernel.update(direct=0, order=0)
    for name, (r, out_hw) in roi_cases.items():
        boxes, idx = roi_in[name]
        rb, ri = roi_repair_inputs(boxes, idx, feats.shape[0])
        for aligned, dtype, (bx, ix, what) in (
                (False, torch.float32, (boxes, idx, "")), (True, torch.float32, (boxes, idx, "")),
                (False, torch.bfloat16, (boxes, idx, "")),
                (True, torch.float32, (rb, ri, " with NaN/inf boxes and indices -1, N, -N-1"))):
            f = feats.to(dtype)
            args = (f, bx, ix, out_hw, 0.25, 2, aligned)
            want = roi_align.roi_align_reference(*args)
            for order in (False, True):
                got = roi_align._launch(*args, order=order)
                errs["roi_align"] = max(errs["roi_align"], max_err(
                    got, want, 1e-4, 1e-4,
                    f"roi_align {name} R={r} {out_hw} aligned={aligned} {dtype} order={order}"
                    f"{what}"))
                if what:
                    check(bool((got[:4] == 0).all()), "roi_align: NaN/inf boxes give zeros")
    by_kernel = dict(roi_align.roi_align.launches_by_kernel)
    print(f"roi_align checks: launches by kernel {by_kernel}")
    check(by_kernel == {"direct": 16, "order": 8}, "roi_align: both kernels at both poolers")

    # match_proposals: bit-equal, the cluster form against the plain version
    # and against the two-pass form, one launch per call in the cluster form
    iou = torch.rand((2000, 64), generator=g, device=dev)
    iou[5] = iou[3]                      # tied rows
    iou[7, [2, 9]] = iou[7].max()        # a tie inside a row: the first index wins
    iou[100, 3] = iou[:, 3].max()        # two proposals reach one column's max
    iou[:, 7] = 0.0                      # a ground truth nobody overlaps
    match_cases = {"[2000, 64]": iou, "[256, 8]": torch.rand((256, 8), generator=g, device=dev),
                   "[60000, 64]": torch.rand((60000, 64), generator=g, device=dev),
                   **nan_matrices(iou)}
    for what, m in match_cases.items():
        for lq, form in ((True, "cluster"), (False, "two_pass")):
            plain = matching.match_proposals_reference(m, allow_low_quality=lq)
            before = dict(matching.match_proposals.launches_by_form)
            got = matching.match_proposals(m, allow_low_quality=lq)
            check(matching.match_proposals.launches_by_form[form] == before[form] + 1,
                  f"match_proposals {what} allow_low_quality={lq}: the {form} form")
            exact(got, plain, f"match_proposals {what} allow_low_quality={lq}")
            if lq:
                exact(got, matching._launch(m, 0.5, 0.3, lq, form="two_pass"),
                      f"match_proposals {what}: cluster vs two-pass form")
    # one kernel per call in a trace, with the rescue (the cluster form) and
    # without it (the two-pass form's row pass)
    for lq in (True, False):
        _, per_call = device_calls(lambda: matching.match_proposals(iou, allow_low_quality=lq))
        print(f"match_proposals [2000, 64] allow_low_quality={lq}: {per_call} kernel per call")
        check(per_call == 1.0, "match_proposals: one launch per call")
    print(f"match_proposals plan at [2000, 64]: "
          f"{matching.plan_cluster(2000, 64, matching.max_cluster())._asdict()}")

    # the two-level rotated warp at the training shape, on the params the
    # training path gives it; f32 sums of a few terms in another order
    tcfg = TrainConfig(in_channels=20, rotate=25.0, flip_prob=0.5, jitter=0.1,
                       brightness=0.2, contrast=0.2, noise_std=5.0, batch_size=TRAIN_BATCH)
    aug = augment_config(tcfg, train=True)
    tbatch = batch_to(training_batch(TRAIN_BATCH, tcfg.canvas, SEED), dev)
    draws = draw_augment(TRAIN_BATCH, aug, torch.Generator(device=dev).manual_seed(SEED))
    wparams, _ = rotated_warp_params(tbatch, draws, aug)
    n_rot = int((draws["theta"] != 0).sum())
    n_cut = int(((wparams.src_lo > 0) | (wparams.src_hi < wparams.canvas_hw)).any(1).sum())
    print(f"warp inputs: {n_rot} of {TRAIN_BATCH} samples rotated, {int(draws['flip'].sum())} "
          f"flipped, {n_cut} with a translation cut")
    check(0 < n_rot < TRAIN_BATCH and n_cut > 0, "warp inputs: rotations, zeros and cuts")
    wargs = (tbatch["image"], tbatch["mask"], wparams, aug.out_size, aug.rotate,
             aug.rotate_block)
    want = w2.warp_2level_reference(*wargs)
    shape = list(want.shape)
    plan = w2.plan_tiles(float(aug.rotate), aug.rotate_block,
                         (tcfg.canvas + 2 * SRC_PAD) / aug.out_size[1], tuple(aug.out_size))
    print(f"warp_2level tile plan: {plan._asdict()}")
    before = w2.warp_2level.launches
    tiled = w2.warp_2level(*wargs)
    check(w2.warp_2level.launches == before + 1, "warp_2level: one launch per call")
    errs["warp_2level"] = max_err(tiled, want, 1e-2, 0.0, f"warp_2level {shape}")
    fused = w2.warp_2level_fused(*wargs)
    errs["warp_2level_fused"] = max_err(fused, want, 1e-2, 0.0, f"warp_2level_fused {shape}")
    exact((tiled,), (fused,), "warp_2level vs warp_2level_fused (bit-equal)")
    # plans too small for these samples: sub-tiles along u, and one-row
    # sub-tiles read straight from pass 1; both still bit-equal
    for cap in (plan.cap_rows // 3, 8):
        small = plan._replace(cap_rows=cap, smem_bytes=cap * w2.ROW_BYTES)
        exact((w2._tiled(*wargs[:5], aug.rotate_block, None, small),), (fused,),
              f"warp_2level with {cap} rows of shared tmp (bit-equal to the fused form)")
    del tiled, fused
    torch.cuda.synchronize()

    # -- 4. serving at full width -----------------------------------------
    batch = synthetic_host_batch(BATCH, 640, seed=SEED)
    eng = InferenceEngine(sd20, in_channels=20, size=480, dtype=torch.bfloat16)
    fc.reset_launches()
    reset_block_launches()
    probs, masks = eng.predict_instances(batch)  # the main path, once
    launches = {"fused_chain": fc.fused_chain.launches,
                "fused_chain_by_form": dict(fc.fused_chain.launches_by_form),
                "bottleneck3x3_fused": bottleneck3x3_fused.launches}
    print(f"main path (instance 480, batch {BATCH}, bf16): launches {launches}")
    check(launches["fused_chain_by_form"] == {"banded": 2, "banded_f32": 0, "simt": 0},
          "fused_chain: 2 banded launches per bf16 dispatch")
    check(probs.shape == (BATCH, 480, 480, 1) and masks.shape == (BATCH, 640, 640),
          "instance output shapes")
    check(bool(np.isfinite(probs).all()) and probs.min() >= 0 and probs.max() <= 1,
          "instance probabilities finite in [0, 1]")
    check(set(np.unique(masks)) <= {0, 255}, "instance masks are 0/255")

    eng32 = InferenceEngine(sd20, in_channels=20, size=480, dtype=torch.float32)
    fc.reset_launches()
    probs32, masks32 = eng32.predict_instances(batch)  # the float32 main path, once
    f32_launches = dict(fc.fused_chain.launches_by_form)
    print(f"instance 480, batch {BATCH}, f32: fused_chain launches {f32_launches}")
    check(f32_launches == {"banded": 0, "banded_f32": 2, "simt": 0},
          "fused_chain: 2 banded f32 launches per f32 dispatch")
    bf16_vs_f32 = {
        "crop_prob_mean_abs_diff": float(np.abs(probs - probs32).mean()),
        "crop_prob_max_abs_diff": float(np.abs(probs - probs32).max()),
        "canvas_mask_agreement": float((masks == masks32).mean()),
    }
    print(f"bf16 vs f32 engine on the card: {json.dumps(bf16_vs_f32)} "
          "(limits: mean abs prob diff <= 0.02, mask agreement >= 0.98)")
    check(bf16_vs_f32["crop_prob_mean_abs_diff"] <= 0.02, "bf16 vs f32 probabilities")
    check(bf16_vs_f32["canvas_mask_agreement"] >= 0.98, "bf16 vs f32 masks")

    small = {k: v[:2] for k, v in batch.items()}
    cpu = InferenceEngine(sd20, in_channels=20, size=480, dtype=torch.float32,
                          device="cpu")
    p_cpu, m_cpu = cpu.predict_instances(small)
    p_gpu, m_gpu = eng32.predict_instances(small)
    gpu_vs_cpu = {"crop_prob_max_abs_diff": float(np.abs(p_gpu - p_cpu).max()),
                  "canvas_mask_agreement": float((m_gpu == m_cpu).mean())}
    # float32 sums run in other orders on the card and the host through ~60
    # layers whose random-weight logits reach |x| ~ 1e2, so a pixel with a
    # logit near 0 may move by ~1e-2 in logit and ~2e-3 in probability
    print(f"f32 card (kernel) vs f32 CPU (plain) on 2 rows: {json.dumps(gpu_vs_cpu)} "
          "(limits: max abs prob diff <= 1e-2, mask agreement >= 0.999)")
    check(gpu_vs_cpu["crop_prob_max_abs_diff"] <= 1e-2, "card vs CPU probabilities")
    check(gpu_vs_cpu["canvas_mask_agreement"] >= 0.999, "card vs CPU masks")

    rng = np.random.default_rng(SEED)
    with ServingFrontend(eng, max_batch=16, max_delay_ms=20.0) as fe:
        inst, whole = [], []
        for h, w in [(480, 640), (640, 480), (720, 960), (300, 400)]:
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            kps = np.concatenate([rng.uniform(0.3, 0.7, (17, 2)) * [w, h],
                                  np.ones((17, 1))], 1)
            inst.append((fe.submit_instance(img, [w * .2, h * .1, w * .8, h * .9], kps),
                         (h, w)))
        for h, w in [(512, 512), (375, 500), (800, 600)]:
            whole.append((fe.submit(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)),
                          (h, w)))
        for fut, hw in inst:
            r = fut.result(timeout=300)
            check(r["mask"].shape == hw and 0.0 <= r["mask_score"] <= 1.0,
                  "frontend instance result")
        for fut, hw in whole:
            check(fut.result(timeout=300).shape == hw, "frontend image result")
        print(f"frontend: {len(inst)} instance + {len(whole)} image requests resolved "
              f"in {fe.dispatches} dispatches")

    eng3 = InferenceEngine(sd3, in_channels=3, size=512, dtype=torch.bfloat16)
    images = [rng.integers(0, 255, (int(rng.integers(360, 800)), int(rng.integers(360, 800)), 3),
                           dtype=np.uint8) for _ in range(BATCH)]
    # the uint8 bilinear resize (cv2's fixed-point INTER_LINEAR, as integer
    # torch ops) gives the same bits on the card and on the host
    for img in images[:3]:
        for out_hw in ((512, 512), (img.shape[0] // 2, img.shape[1] // 2), (37, 901)):
            on_card = pipeline.resize(torch.from_numpy(img).to(dev), out_hw).cpu()
            exact((on_card,), (pipeline.resize(torch.from_numpy(img), out_hw),),
                  f"uint8 resize {list(img.shape)} -> {list(out_hw)}, card vs host")
    u8_resizes = [0]
    resize_u8 = pipeline._resize_u8_linear

    def counted_resize_u8(*args):
        u8_resizes[0] += 1
        return resize_u8(*args)

    pipeline._resize_u8_linear = counted_resize_u8
    try:
        fc.reset_launches()
        img_masks = eng3.predict_images(images)
    finally:
        pipeline._resize_u8_linear = resize_u8
    whole_launches = dict(fc.fused_chain.launches_by_form)
    print(f"whole-image path (512, batch {BATCH}, bf16): fused_chain launches {whole_launches}, "
          f"{u8_resizes[0]} uint8 integer resizes")
    check(whole_launches == {"banded": 2, "banded_f32": 0, "simt": 0},
          "whole-image: 2 banded chain launches per dispatch")
    check(u8_resizes[0] == BATCH, "whole-image: one integer uint8 resize per image")
    check(all(m.shape == im.shape[:2] and m.dtype == np.uint8
              for m, im in zip(img_masks, images)), "whole-image mask shapes")

    # the proposal path at full width: NMS on the card, then one 480 px crop
    # per surviving box through the bf16 instance engine
    reqs = proposal_requests(rng, 64)
    calls, nms_s = [], [0.0]
    predict = InferenceEngine.predict_instances
    nms_keep = proposals._nms_keep

    def counted_predict(self, batch):
        calls.append(batch["image"].shape[0])
        return predict(self, batch)

    def timed_nms_keep(*args):
        t = time.perf_counter()
        keep = nms_keep(*args)  # ends in a copy to the host: synchronous
        nms_s[0] += time.perf_counter() - t
        return keep

    forwards = []  # one per dispatch of the program: a call above 128 crops is chunked
    forward_instance = eng._forward_instance

    def counted_forward(*args):
        forwards.append(args[0].shape[0])
        return forward_instance(*args)

    InferenceEngine.predict_instances = counted_predict
    proposals._nms_keep = timed_nms_keep
    eng._forward_instance = counted_forward
    pipeline._resize_u8_linear = counted_resize_u8
    u8_resizes[0] = 0
    try:
        nms.nms.launches = 0
        fc.reset_launches()
        t0 = time.perf_counter()
        results = list(proposals.iter_segment_proposals(
            eng, reqs, nms_threshold=0.7, max_instances=16, batch_cap=128))
        torch.cuda.synchronize()
        prop_s = time.perf_counter() - t0
        prop_launches = {"nms": nms.nms.launches,
                         "fused_chain": dict(fc.fused_chain.launches_by_form)}
    finally:
        InferenceEngine.predict_instances = predict
        proposals._nms_keep = nms_keep
        eng._forward_instance = forward_instance
        pipeline._resize_u8_linear = resize_u8
    larger = sum(max(r["image"].shape[:2]) > 640 for r in reqs)
    kept = [len(r) for r in results]
    crops = sum(kept)
    print(f"proposal path ({len(reqs)} images x 48 proposals, bf16 480): {crops} crops, "
          f"{len(calls)} predict_instances calls {calls} in {len(forwards)} program dispatches "
          f"{forwards}, launches {prop_launches}, {u8_resizes[0]} uint8 integer resizes "
          f"({larger} images larger than the canvas)")
    check(len(results) == len(reqs), "proposal path: one result list per image")
    check(prop_launches["nms"] == len(reqs), "proposal path: one nms launch per image")
    check(prop_launches["fused_chain"] == {"banded": 2 * len(forwards), "banded_f32": 0,
                                           "simt": 0},
          "proposal path: 2 banded chain launches per program dispatch")
    check(larger > 0 and u8_resizes[0] == larger,
          "proposal path: one integer uint8 resize per image larger than the canvas")
    check(len(calls) == packed_dispatches(kept, 128),
          "proposal path: dispatches follow the packing rule")
    for req, res in zip(reqs, results):
        idx, valid = nms.nms_reference(torch.from_numpy(req["boxes"]),
                                       torch.from_numpy(req["scores"]), 0.7, max_outputs=16)
        check([r["box"] for r in res] == req["boxes"][idx[valid].numpy()].tolist(),
              "proposal path: kept boxes equal the plain NMS on the CPU")
        check(all(r["mask"].shape == req["image"].shape[:2] and r["mask"].dtype == np.uint8
                  and set(np.unique(r["mask"])) <= {0, 255} for r in res),
              "proposal path: masks are 0/255 at the image's shape")

    # the first two images, two instances each, through the f32 card engine
    # and the f32 CPU engine, held to the instance program's card-vs-CPU limits
    on_card = list(proposals.iter_segment_proposals(eng32, reqs[:2], 0.7, max_instances=2))
    on_cpu = list(proposals.iter_segment_proposals(cpu, reqs[:2], 0.7, max_instances=2))
    prop_vs_cpu = {"mask_agreement_min": 1.0, "mask_score_max_abs_diff": 0.0}
    for a, b in zip(on_card, on_cpu):
        check([r["box"] for r in a] == [r["box"] for r in b], "card vs CPU: kept boxes")
        for ra, rb in zip(a, b):
            prop_vs_cpu["mask_agreement_min"] = min(prop_vs_cpu["mask_agreement_min"],
                                                    float((ra["mask"] == rb["mask"]).mean()))
            prop_vs_cpu["mask_score_max_abs_diff"] = max(
                prop_vs_cpu["mask_score_max_abs_diff"], abs(ra["mask_score"] - rb["mask_score"]))
    print(f"proposal path f32 card vs f32 CPU on 2 images: {json.dumps(prop_vs_cpu)} "
          "(limits: mask agreement >= 0.999, |d mask_score| <= 1e-2)")
    check(sum(len(a) for a in on_card) == 4, "card vs CPU: 4 crops")
    check(prop_vs_cpu["mask_agreement_min"] >= 0.999, "card vs CPU: proposal masks")
    check(prop_vs_cpu["mask_score_max_abs_diff"] <= 1e-2, "card vs CPU: mask scores")

    # roi_align and match_proposals through their own entry points, at the
    # poolers' shapes and one matching batch
    roi_align.roi_align.launches = 0
    matching.match_proposals.launches = 0
    roi_align.roi_align.launches_by_kernel.update(direct=0, order=0)
    matching.match_proposals.launches_by_form.update(cluster=0, two_pass=0)
    for name, (r, out_hw) in roi_cases.items():
        out = roi_align.roi_align(feats, *roi_in[name], out_hw, 0.25, 2, False)
        check(out.shape == (r,) + out_hw + feats.shape[-1:] and bool(torch.isfinite(out).all()),
              f"roi_align {name}: shape and finite values")
    matched, labels = matching.match_proposals(iou)
    check(bool(((labels >= -1) & (labels <= 1)).all()) and int(matched.max()) < 64,
          "match_proposals: labels in {-1, 0, 1}, indices in range")
    torch.cuda.synchronize()
    det_launches = {"roi_align": roi_align.roi_align.launches,
                    "match_proposals": matching.match_proposals.launches}
    det_by_form = {"roi_align": dict(roi_align.roi_align.launches_by_kernel),
                   "match_proposals": dict(matching.match_proposals.launches_by_form)}
    print(f"detection ops through their entry points: launches {det_launches}, by kernel "
          f"or form {det_by_form}")
    # roi_align: a gather per call, and the locality order of the box head's
    # 1000 ROIs (the mask head's 100 stay unordered)
    check(det_launches == {"roi_align": 3, "match_proposals": 1}, "detection op launches")
    check(det_by_form == {"roi_align": {"direct": 2, "order": 1},
                          "match_proposals": {"cluster": 1, "two_pass": 0}},
          "detection op launches by kernel and form")

    # training at full width: the training slice's main path
    model = Segment(20)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    state = TrainState.create(model.to(dev), tcfg.learning_rate)
    train_step = make_train_step(tcfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    w2.warp_2level.launches = 0
    w2.warp_2level_fused.launches = 0
    fc.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = train_step(state, tbatch, draw_augment(TRAIN_BATCH, aug, gen))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {"warp_2level": w2.warp_2level.launches,
                      "warp_2level_fused": w2.warp_2level_fused.launches,
                      "fused_chain": fc.fused_chain.launches}
    losses = [float(v) for v in losses]
    print(f"main path (train, Segment(20) 640 -> 480, batch {TRAIN_BATCH}, bf16, rotate 25 "
          f"2level, {TRAIN_STEPS} steps): losses {[round(v, 4) for v in losses]}, "
          f"launches {train_launches}")
    check(train_launches["warp_2level"] == TRAIN_STEPS, "train: 1 warp_2level launch per step")
    check(all(np.isfinite(losses)), "train: finite losses")
    check(np.mean(losses[-3:]) < losses[0], "train: the mean of the last 3 losses is below the first")
    _, probs_e, _, ious = make_eval_step(tcfg)(state.model, tbatch)
    check(tuple(ious.shape) == (TRAIN_BATCH,) and bool(torch.isfinite(ious).all())
          and bool(((ious >= 0) & (ious <= 1)).all()), "eval step: per-sample IoUs [32]")
    check(tuple(probs_e.shape) == (TRAIN_BATCH, 480, 480, 1), "eval step: probabilities")
    print(f"eval step: mean IoU {float(ious.mean()):.4f} over {TRAIN_BATCH} samples")

    w2.warp_2level_fused.launches = 0
    out = w2.warp_2level_fused(*wargs)
    torch.cuda.synchronize()
    fused_launches = w2.warp_2level_fused.launches
    check(fused_launches == 1 and bool(torch.isfinite(out).all()),
          "warp_2level_fused: one launch through its entry point")

    # one float32 step on the card against the same step on the CPU: same
    # weights (random running statistics), batch and draws
    small_cfg = TrainConfig(canvas=192, out_size=64, in_channels=20, bfloat16=False,
                            rotate=25.0, flip_prob=0.5, jitter=0.1, brightness=0.2,
                            contrast=0.2, noise_std=5.0, batch_size=2)
    small_aug = augment_config(small_cfg, train=True)
    small_batch = training_batch(2, 192, SEED + 2)
    small_draws = draw_augment(2, small_aug, torch.Generator().manual_seed(SEED + 2))
    sd_small = random_state_dict(20, SEED + 3)
    steps = {}
    for where in ("cpu", dev):
        m = Segment(20)
        m.load_state_dict(sd_small)
        st = TrainState.create(m.to(where), small_cfg.learning_rate)
        st, met = make_train_step(small_cfg)(st, small_batch, small_draws)
        steps[str(where)] = (float(met["loss"]),
                             {k: v.detach().cpu() for k, v in st.model.state_dict().items()
                              if k.endswith(("running_mean", "running_var"))})
    (l_cpu, s_cpu), (l_gpu, s_gpu) = steps["cpu"], steps[str(dev)]
    step_vs_cpu = {"loss_cpu": l_cpu, "loss_card": l_gpu,
                   "loss_rel_diff": abs(l_gpu - l_cpu) / abs(l_cpu),
                   "batch_stats_max_abs_diff": max((s_gpu[k] - s_cpu[k]).abs().max().item()
                                                   for k in s_cpu)}
    print(f"f32 train step, card vs CPU (batch 2, 192 -> 64): {json.dumps(step_vs_cpu)} "
          "(limits: loss rel 1e-4, batch_stats 1e-4)")
    check(step_vs_cpu["loss_rel_diff"] <= 1e-4, "train step card vs CPU: loss")
    check(step_vs_cpu["batch_stats_max_abs_diff"] <= 1e-4, "train step card vs CPU: batch_stats")

    # the trainer from disk to a served checkpoint (its own launch counts)
    disk = trainer_from_disk(dev, card, w2, fc)

    # -- 5. times ------------------------------------------------------------
    # the chain at batch 128, both programs: the banded form (bf16) beside
    # each launch's bound, its rounding plain version, the float32 plain
    # version and the cuDNN bf16 yardstick; the banded float32 form beside
    # its bound, the float32 plain version, the SIMT form (what float32 ran
    # before it) and the cuDNN float32 yardstick (TF32 off); the SIMT form's
    # own parts for the 480 program
    parts = []
    eng3_32 = InferenceEngine(sd3, in_channels=3, size=512, dtype=torch.float32)
    models = {480: eng.model, 512: eng3.model}
    models32 = {480: eng32.model, 512: eng3_32.model}
    for (prog, name), spec in chains.items():
        ref_spec = spec.to(dev)
        x = torch.randn((BATCH, spec.h, spec.w, spec.c_in), generator=g,
                        device=dev).bfloat16()
        xf = x.float()
        with torch.inference_mode():
            yard = section_yardstick(models[prog], name)
            yard32 = section_yardstick(models32[prog], name)
            want = fc.fused_chain_reference(xf, ref_spec)
            top = want.abs().max().item()
            d = (yard(x).float() - want).abs().max().item()
            check(d <= 0.1 + 0.1 * top, f"{prog} {name}: the cuDNN yardstick computes the chain")
            d32 = (yard32(xf) - want).abs().max().item()
            check(d32 <= 1e-3 + 1e-3 * top,
                  f"{prog} {name}: the cuDNN f32 yardstick computes the chain ({d32:.2e})")
            del want
            ms = cuda_ms(lambda: fc.fused_chain(x, spec), iters=20)
            plain = cuda_ms(lambda: fc.fused_chain_reference(x, ref_spec,
                                                             act_dtype=torch.bfloat16), iters=5)
            plain_f32 = cuda_ms(lambda: fc.fused_chain_reference(x, ref_spec), iters=5)
            cudnn = cuda_ms(lambda: yard(x), iters=10)
            # the two float32 forms in turns: SIMT, banded, banded, SIMT
            simt_a = cuda_ms(lambda: fc._launch(xf, spec), iters=10)
            f32_a = cuda_ms(lambda: fc.fused_chain(xf, spec), iters=20)
            f32_b = cuda_ms(lambda: fc.fused_chain(xf, spec), iters=20)
            simt_b = cuda_ms(lambda: fc._launch(xf, spec), iters=10)
            ms32, simt = (f32_a + f32_b) / 2, (simt_a + simt_b) / 2
            cudnn32 = cuda_ms(lambda: yard32(xf), iters=10)
        b_ms, b_by, flops, io = chain_bound(spec, BATCH, torch.bfloat16)
        chk = banded[(prog, name, BATCH)]
        parts.append({"program": prog, "spec": name, "form": "banded", "shape": list(x.shape),
                      "dtype": "bfloat16", "flops": flops, "bytes": io, "ms": ms,
                      "plain_ms": plain, "plain_f32_ms": plain_f32, "bound_ms": b_ms,
                      "bound_by": b_by, "cudnn_bf16_yardstick_ms": cudnn,
                      **{k: chk[k] for k in ("max_abs_err", "limit", "max_abs_err_f32",
                                             "cluster", "smem_bytes", "resident_clusters")}})
        print(f"time fused_chain banded {prog} {name} {list(x.shape)} bf16: {ms:.4f} ms "
              f"(bound {b_ms:.4f} ms by {b_by}; rounding plain {plain:.3f} ms, f32 plain "
              f"{plain_f32:.3f} ms; cuDNN bf16 yardstick {cudnn:.3f} ms)")
        s_ms, s_by, s_flops, s_io = chain_bound(spec, BATCH, torch.float32)
        chk = banded32[(prog, name, BATCH)]
        parts.append({"program": prog, "spec": name, "form": "banded_f32",
                      "shape": list(x.shape), "dtype": "float32", "flops": s_flops,
                      "bytes": s_io, "ms": ms32, "ms_runs": [f32_a, f32_b], "plain_ms": plain_f32,
                      "bound_ms": s_ms, "bound_by": s_by, "simt_ms": simt,
                      "simt_ms_runs": [simt_a, simt_b], "cudnn_f32_yardstick_ms": cudnn32,
                      **chk})
        print(f"time fused_chain banded_f32 {prog} {name} {list(x.shape)} f32: {ms32:.4f} ms "
              f"({f32_a:.4f}, {f32_b:.4f}; bound {s_ms:.4f} ms by {s_by}; f32 plain "
              f"{plain_f32:.3f} ms; SIMT form {simt:.4f} ms ({simt_a:.4f}, {simt_b:.4f}); "
              f"cuDNN f32 yardstick {cudnn32:.3f} ms)")
        if prog == 480:
            parts.append({"program": prog, "spec": name, "form": "simt", "shape": list(x.shape),
                          "dtype": "float32", "flops": s_flops, "bytes": s_io, "ms": simt,
                          "plain_ms": plain_f32, "bound_ms": s_ms, "bound_by": s_by,
                          "max_abs_err": errs[(name, "simt_f32")]})

    xb = torch.randn((BATCH, 60, 60, 48), generator=g, device=dev)
    one_block = fc.ChainSpec(60, 60, 48, 48, specs["s1"].ops[:5])  # the same weights
    blk_simt_a = cuda_ms(lambda: fc._launch(xb, one_block), iters=20)
    blk_a = cuda_ms(lambda: bottleneck3x3_fused(xb, **block_args), iters=20)
    blk_b = cuda_ms(lambda: bottleneck3x3_fused(xb, **block_args), iters=20)
    blk_simt_b = cuda_ms(lambda: fc._launch(xb, one_block), iters=20)
    blk_ms, blk_simt = (blk_a + blk_b) / 2, (blk_simt_a + blk_simt_b) / 2
    blk_plain = cuda_ms(lambda: bottleneck3x3_reference(xb, **block_args), iters=5)
    blk_bound, blk_by, _, _ = chain_bound(one_block, BATCH, torch.float32)
    print(f"time bottleneck3x3_fused [{BATCH}, 60, 60, 48] f32 (banded f32 form): "
          f"{blk_ms:.4f} ms ({blk_a:.4f}, {blk_b:.4f}; SIMT form {blk_simt:.4f} ms "
          f"({blk_simt_a:.4f}, {blk_simt_b:.4f}); plain {blk_plain:.3f} ms, bound "
          f"{blk_bound:.4f} ms by {blk_by})")

    e2e = {}
    for label, fn, n in (
        ("instance480_bf16", lambda: eng.predict_instances(batch), BATCH),
        ("whole512_bf16", lambda: eng3.predict_images(images), BATCH),
    ):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        e2e[f"{label}_img_per_s"] = n * reps / (time.perf_counter() - t0)
    keys = ("image", "mask", "image_hw", "obj_box", "mask_box", "mask_valid", "keypoints")
    dev_batch = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev) for k in keys]
    with torch.inference_mode():
        inst_ms = cuda_ms(lambda: eng._forward_instance(*dev_batch), iters=5)
        # the float32 program in turns with its chain on the SIMT form (what
        # float32 engines ran before the banded float32 form): SIMT, banded,
        # banded, SIMT
        chain_form = fc.chain_form
        runs32 = {"simt": [], "banded_f32": []}
        for form in ("simt", "banded_f32", "banded_f32", "simt"):
            fc.chain_form = (lambda spec, dtype: "simt") if form == "simt" else chain_form
            try:
                runs32[form].append(cuda_ms(lambda: eng32._forward_instance(*dev_batch), iters=5))
            finally:
                fc.chain_form = chain_form
        inst32_ms, inst32_simt_ms = (sum(runs32[k]) / 2 for k in ("banded_f32", "simt"))
        u8 = torch.randint(0, 255, (BATCH, 512, 512, 3), generator=g, device=dev,
                           dtype=torch.uint8)
        whole_ms = cuda_ms(lambda: eng3._forward_whole(u8), iters=5)
    e2e["instance480_bf16_program_ms"] = inst_ms
    e2e["instance480_bf16_program_img_per_s"] = BATCH / inst_ms * 1e3
    e2e["instance480_f32_program_ms"] = inst32_ms
    e2e["instance480_f32_program_img_per_s"] = BATCH / inst32_ms * 1e3
    e2e["instance480_f32_program_simt_chain_ms"] = inst32_simt_ms
    print(f"time instance480 program [{BATCH}] (CUDA events): bf16 {inst_ms:.2f} ms, "
          f"f32 {inst32_ms:.2f} ms {runs32['banded_f32']} (with the SIMT chain "
          f"{inst32_simt_ms:.2f} ms {runs32['simt']})")
    e2e["whole512_bf16_program_ms"] = whole_ms
    e2e["whole512_bf16_program_img_per_s"] = BATCH / whole_ms * 1e3
    print(json.dumps({"e2e": e2e, "bf16_vs_f32": bf16_vs_f32, "gpu_vs_cpu": gpu_vs_cpu,
                      "card": card}))

    # the detection kernels beside their plain versions; NMS at the proposal
    # path's N = 48 and at detector sizes, at the path's threshold 0.7: the
    # call (one launch; at small N the host's launch cost) and the kernel's
    # device time
    nms_parts = []
    for n in (48, 128, 256, 512, 1024):
        boxes, scores = nms_inputs(g, n, dev)
        ms = cuda_ms(lambda: nms.nms(boxes, scores, 0.7), iters=50)
        kernel_ms = device_ms(lambda: nms.nms(boxes, scores, 0.7), "nms_kernel", iters=20)
        plain = cuda_ms(lambda: nms.nms_reference(boxes, scores, 0.7), iters=3, warmup=1)
        pairs = nms_work(boxes, scores, 0.7)
        b_ms, b_by = nms_bound(n, n, pairs)
        nms_parts.append({"shape": [n, 4], "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain,
                          "bound_ms": b_ms, "bound_by": b_by, "iou_pairs": pairs})
        print(f"time nms N={n}: {ms:.4f} ms per call, kernel {kernel_ms:.4f} ms (plain "
              f"{plain:.3f} ms, bound {b_ms:.5f} ms by {b_by}; {pairs} IoU pairs)")
    batch_ms = cuda_ms(lambda: nms.nms_batch(bb, bs, 0.7), iters=20)
    batch_kernel = device_ms(lambda: nms.nms_batch(bb, bs, 0.7), "nms_kernel", iters=20)
    batch_plain = cuda_ms(lambda: [nms.nms_reference(bb[i], bs[i], 0.7) for i in range(8)],
                          iters=1, warmup=1)
    pairs = sum(nms_work(bb[i], bs[i], 0.7) for i in range(8))
    b_ms, b_by = nms_bound(1000, 1000, pairs, images=8)
    nms_parts.append({"shape": [8, 1000, 4], "entry": "nms_batch", "ms": batch_ms,
                      "kernel_ms": batch_kernel, "plain_ms": batch_plain, "bound_ms": b_ms,
                      "bound_by": b_by, "iou_pairs": pairs})
    print(f"time nms_batch [8, 1000]: {batch_ms:.4f} ms per call, kernel {batch_kernel:.4f} ms "
          f"(plain {batch_plain:.3f} ms, bound {b_ms:.5f} ms by {b_by})")

    # roi_align: the call (CUDA events) and kernel device time (profiler;
    # the order launch counted where it runs) without and with the locality
    # order, in turns without, with, with, without; the gather traffic
    # beside the bound
    roi_parts = []
    for name, (r, out_hw), dtype in (("box_head", roi_cases["box_head"], torch.float32),
                                     ("mask_head", roi_cases["mask_head"], torch.float32),
                                     ("box_head", roi_cases["box_head"], torch.bfloat16)):
        f = feats.to(dtype)
        args = (f, *roi_in[name], out_hw, 0.25, 2, False)
        runs = {"unordered": [], "ordered": []}
        for order in (False, True, True, False):
            call = cuda_ms(lambda: roi_align._launch(*args, order=order), iters=20)
            kern, _ = device_calls(lambda: roi_align._launch(*args, order=order))
            runs["ordered" if order else "unordered"].append((call, kern))
        entry = "ordered" if r >= roi_align.ORDER_MIN_ROIS else "unordered"
        other = "unordered" if entry == "ordered" else "ordered"
        plain = cuda_ms(lambda: roi_align.roi_align_reference(*args), iters=2, warmup=1)
        traffic = roi_traffic(f, *roi_in[name], out_hw, 0.25, 2, False)
        b_ms, b_by = bound_f32(0.0, traffic["union"] + r * 20 + r * out_hw[0] * out_hw[1]
                               * f.shape[-1] * 4)
        part = {"pooler": name, "shape": [r, *out_hw, f.shape[-1]], "features": list(f.shape),
                "dtype": str(dtype).replace("torch.", ""), "form": entry,
                "ms": sum(c for c, _ in runs[entry]) / 2,
                "kernel_ms": sum(k for _, k in runs[entry]) / 2,
                f"{other}_ms": sum(c for c, _ in runs[other]) / 2,
                f"{other}_kernel_ms": sum(k for _, k in runs[other]) / 2,
                "ms_runs": {o: [c for c, _ in v] for o, v in runs.items()},
                "kernel_ms_runs": {o: [k for _, k in v] for o, v in runs.items()},
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "traffic_bytes": traffic}
        roi_parts.append(part)
        print(f"time roi_align {name} R={r} {out_hw} {part['dtype']}: {entry} {part['ms']:.4f} "
              f"ms per call, kernel {part['kernel_ms']:.4f} ms; {other} "
              f"{part[other + '_ms']:.4f} / {part[other + '_kernel_ms']:.4f} ms (turns "
              f"{json.dumps(part['kernel_ms_runs'])}); plain {plain:.3f} ms, bound "
              f"{b_ms:.5f} ms by {b_by}")
        print(f"roi_align {name} {part['dtype']} gather traffic (bytes): {json.dumps(traffic)}")

    # match_proposals at [2000, 64]: the call (CUDA events) and the kernels'
    # device time of each form, in turns two-pass, cluster, cluster, two-pass
    mruns = {"two_pass": [], "cluster": []}
    for form in ("two_pass", "cluster", "cluster", "two_pass"):
        call = cuda_ms(lambda: matching._launch(iou, 0.5, 0.3, True, form=form), iters=200)
        kern, per_call = device_calls(lambda: matching._launch(iou, 0.5, 0.3, True, form=form), 50)
        mruns[form].append((call, kern, per_call))
    match_ms = cuda_ms(lambda: matching.match_proposals(iou), iters=200)
    match_kernel = sum(k for _, k, _ in mruns["cluster"]) / 2
    match_plain = cuda_ms(lambda: matching.match_proposals_reference(iou), iters=20)
    # matrix read once, matched (int64) and labels (int32) written once; a
    # few comparisons per element
    match_bound, match_by = bound_f32(3.0 * iou.numel(), iou.numel() * 4 + 2000 * 12)
    print(f"time match_proposals [2000, 64]: {match_ms:.4f} ms per call, cluster kernel "
          f"{match_kernel:.4f} ms (turns {json.dumps(mruns)}; plain {match_plain:.3f} ms, "
          f"bound {match_bound:.5f} ms by {match_by})")

    nms_s[0], predict_s = 0.0, [0.0]

    def timed_predict(self, batch):
        t = time.perf_counter()
        out = predict(self, batch)  # returns host arrays: synchronous
        predict_s[0] += time.perf_counter() - t
        return out

    InferenceEngine.predict_instances = timed_predict
    proposals._nms_keep = timed_nms_keep
    try:
        t0 = time.perf_counter()
        n_crops = sum(len(r) for r in proposals.iter_segment_proposals(
            eng, reqs, nms_threshold=0.7, max_instances=16, batch_cap=128))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        InferenceEngine.predict_instances = predict
        proposals._nms_keep = nms_keep
    prop = {"images": len(reqs), "crops": n_crops, "first_run_s": prop_s, "wall_s": wall,
            "img_per_s": len(reqs) / wall, "crops_per_s": n_crops / wall,
            "nms_s": nms_s[0], "nms_share": nms_s[0] / wall,
            "predict_instances_s": predict_s[0],
            "host_rest_s": wall - nms_s[0] - predict_s[0]}
    print(json.dumps({"proposal_path_bf16_480": prop, "card": card}))

    # the train step (bf16, batch 32) and its warp kernels; the step updates
    # the state as it is timed
    step_ms = cuda_ms(lambda: train_step(state, tbatch, draws), iters=5)
    pre_ms = cuda_ms(lambda: preprocess_batch(tbatch, draws, aug), iters=5)
    warp_ms = cuda_ms(lambda: w2.warp_2level(*wargs), iters=20)
    warp_kernel = device_ms(lambda: w2.warp_2level(*wargs), "warp_2level_tiled_kernel")
    fused_ms = cuda_ms(lambda: w2.warp_2level_fused(*wargs), iters=20)
    fused_kernel = device_ms(lambda: w2.warp_2level_fused(*wargs), "warp_2level_fused_kernel")
    warp_plain = cuda_ms(lambda: w2.warp_2level_reference(*wargs), iters=3, warmup=1)
    grid_ms = cuda_ms(grid_sample_yardstick(tbatch["image"], tbatch["mask"], wparams,
                                                   aug.out_size), iters=20)
    warp_bound, warp_by = bound_f32(*warp_cost(w2.coefficients(wparams), tbatch["image"].shape,
                                                aug.out_size))
    train = {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "losses": losses,
             "first_steps_s": train_s, "step_ms": step_ms, "img_per_s": TRAIN_BATCH / step_ms * 1e3,
             "preprocess_ms": pre_ms, "warp_2level_ms": warp_ms,
             "warp_2level_kernel_ms": warp_kernel, "warp_2level_fused_ms": fused_ms,
             "warp_2level_fused_kernel_ms": fused_kernel,
             "warp_plain_ms": warp_plain, "warp_bound_ms": warp_bound, "warp_bound_by": warp_by,
             "grid_sample_yardstick_ms": grid_ms, "step_vs_cpu": step_vs_cpu}
    print(f"time train step [{TRAIN_BATCH}, 640 -> 480] bf16: {step_ms:.2f} ms "
          f"({TRAIN_BATCH / step_ms * 1e3:.1f} img/s), of which preprocessing {pre_ms:.2f} ms, "
          f"warp_2level {warp_ms:.3f} ms per call, kernel {warp_kernel:.4f} ms (fused "
          f"{fused_ms:.3f} ms, kernel {fused_kernel:.4f} ms; plain {warp_plain:.2f} ms, bound "
          f"{warp_bound:.4f} ms by {warp_by}; grid_sample yardstick {grid_ms:.3f} ms)")
    print(json.dumps({"train_bf16_480": train, "card": card}))

    print(f"profiler traces: {json.dumps(trace_stats)}")

    # -- 6. summary ----------------------------------------------------------
    # the main path's two launches (banded, 480 program): each launch's own
    # bound, summed; what bounds the chain is what bounds its larger part
    main = [p for p in parts if p["program"] == 480 and p["form"] == "banded"]
    main32 = [p for p in parts if p["program"] == 480 and p["form"] == "banded_f32"]
    kernels = [
        {"name": "fused_chain", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/fused_chain.cu",
         "replaces": "instancesegmentation_tpu/ops/fused_chain.py:308",
         "launches": launches["fused_chain"],
         "launches_by_form": launches["fused_chain_by_form"],
         "launches_trainer_from_disk_serve": disk["serve_launches"]["total"],
         "max_abs_err": max(p["max_abs_err"] for p in main),
         "ms": sum(p["ms"] for p in main),
         "plain_ms": sum(p["plain_ms"] for p in main),
         "bound_ms": sum(p["bound_ms"] for p in main),
         "bound_by": max(main, key=lambda p: p["bound_ms"])["bound_by"],
         "library_ms": None, "ptxas": ptxas.get("fused_chain_banded_kernel"), "parts": parts},
        {"name": "fused_chain_f32", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/fused_chain.cu",
         "replaces": "instancesegmentation_tpu/ops/fused_chain.py:308",
         "form": "banded_f32", "launches": f32_launches["banded_f32"],
         "launches_by_form": f32_launches,
         "max_abs_err": max(p["max_abs_err"] for p in main32),
         "ms": sum(p["ms"] for p in main32),
         "plain_ms": sum(p["plain_ms"] for p in main32),
         "bound_ms": sum(p["bound_ms"] for p in main32),
         "bound_by": max(main32, key=lambda p: p["bound_ms"])["bound_by"],
         "library_ms": None, "simt_ms": sum(p["simt_ms"] for p in main32),
         "cudnn_f32_yardstick_ms": sum(p["cudnn_f32_yardstick_ms"] for p in main32),
         "ptxas": ptxas.get("fused_chain_banded_f32_kernel")},
        {"name": "bottleneck3x3_fused", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/fused_chain.cu",
         "replaces": "instancesegmentation_tpu/ops/fused_block.py:52",
         "launches": launches["bottleneck3x3_fused"], "on_main_path": False,
         "form": "banded_f32", "max_abs_err": errs["block"], "ms": blk_ms,
         "ms_runs": [blk_a, blk_b], "simt_ms": blk_simt, "simt_ms_runs": [blk_simt_a, blk_simt_b],
         "plain_ms": blk_plain, "bound_ms": blk_bound, "bound_by": blk_by, "library_ms": None,
         "shape": [BATCH, 60, 60, 48], "dtype": "float32"},
        {"name": "nms", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/nms.cu",
         "replaces": "instancesegmentation_tpu/ops/nms.py:105",
         "launches": prop_launches["nms"], "max_abs_err": 0.0, "sort_limit": nms.SORT_LIMIT,
         **{k: nms_parts[0][k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "ptxas": ptxas.get("nms_kernel"), "parts": nms_parts},
        {"name": "roi_align", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/roi_align.cu",
         "replaces": "instancesegmentation_tpu/ops/roi_align.py:99",
         "launches": det_launches["roi_align"],
         "launches_by_kernel": det_by_form["roi_align"], "on_main_path": False,
         "max_abs_err": errs["roi_align"],
         **{k: roi_parts[0][k] for k in ("form", "ms", "kernel_ms", "ms_runs", "plain_ms",
                                         "bound_ms", "bound_by")},
         "library_ms": None, "ptxas": ptxas.get("roi_align_kernel"),
         "order_ptxas": ptxas.get("roi_order_kernel"), "parts": roi_parts},
        {"name": "match_proposals", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/matching.cu",
         "replaces": "instancesegmentation_tpu/ops/matching.py:61",
         "launches": det_launches["match_proposals"],
         "launches_by_form": det_by_form["match_proposals"], "on_main_path": False,
         "form": "cluster", "max_abs_err": 0.0, "ms": match_ms, "kernel_ms": match_kernel,
         "ms_runs": {fm: [c for c, _, _ in v] for fm, v in mruns.items()},
         "kernel_ms_runs": {fm: [k for _, k, _ in v] for fm, v in mruns.items()},
         "two_pass_kernel_ms": sum(k for _, k, _ in mruns["two_pass"]) / 2,
         "plain_ms": match_plain, "bound_ms": match_bound, "bound_by": match_by,
         "library_ms": None, "ptxas": ptxas.get("match_cluster_kernel"), "shape": [2000, 64]},
        {"name": "warp_2level", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/warp_2level.cu",
         "replaces": "tools/rot_pallas_probe.py:74",
         "launches": train_launches["warp_2level"],
         "launches_trainer_from_disk": disk["launches"]["warp_2level"],
         "max_abs_err": errs["warp_2level"],
         "ms": warp_ms, "kernel_ms": warp_kernel, "plain_ms": warp_plain,
         "bound_ms": warp_bound, "bound_by": warp_by, "library_ms": None,
         "grid_sample_yardstick_ms": grid_ms, "shape": shape, "tile_plan": plan._asdict(),
         "ptxas": ptxas.get("warp_2level_tiled_kernel")},
        {"name": "warp_2level_fused", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/warp_2level.cu",
         "replaces": "tools/rot_pallas_probe.py:211",
         "launches": fused_launches, "on_main_path": False,
         "max_abs_err": errs["warp_2level_fused"], "ms": fused_ms, "kernel_ms": fused_kernel,
         "plain_ms": warp_plain,
         "bound_ms": warp_bound, "bound_by": warp_by, "library_ms": None,
         "grid_sample_yardstick_ms": grid_ms, "shape": shape},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
