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
   warp kernels (``warp_2level``, one tiled launch, and ``warp_2level_fused``,
   one launch of the sweep that allocates nothing beyond its output)
   at the training shape (batch 32, 640 -> 480, draws with rotate 25 incl.
   samples at 0, flips, jitter 0.1, boxes moved so the centring translation
   cuts content off) within 1e-2 on the 0-255 scale of the plain version,
   and bit-equal to each other, also with tile plans too small for the
   samples (sub-tiles, and rows read straight from pass 1), and on a harder
   set (``warp_hard_cases``: +-25 deg at the scale bound, batch 1 and 33,
   an output width off the strip, a canvas row of 1,914 bytes from an
   unaligned address, a NaN sample, sweep plans with a small ring and small
   stage buffers);
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
   the same training through ``main`` with ``--loader grain`` at 0, 4 and 8
   worker processes and then ``--loader threads`` again, in turns (img/s
   over steps 2-8, each epoch's first-batch seconds, 1 ``warp_2level``
   launch per step, losses within 1e-3 relative of the threaded run's: one
   batch order for every loader), and with ``--checkpoint-backend orbax``
   (the ``.orbax`` directory and sidecar, a resume bit for bit, save and
   load ms); then the JPEG decoder (``ops/native/jpeg.cpp``, built with g++):
   the fixtures of ``tests/data/jpeg`` (every JPEG form cv2 reads, and
   forms it refuses) bit-equal to the cv2 arrays stored beside them in both
   modes or refused where cv2 returns None, and ms per 480 x 640 baseline,
   progressive, CMYK and arithmetic-coded file beside ``read_png``'s ms per
   480 x 640 PNG, and (C6) the ``c6_*`` fixtures' bytes through ``imdecode``
   equal to the ``cv2.imdecode`` arrays stored beside them or refused where
   it returns None; then the small image
   decoders (``image_forms_phase``: PNM / PAM / PFM, Sun raster, Radiance
   HDR, GIF, RLE BMP, their codes in ``ops/native/image_codes.cpp`` built
   with g++): the fixtures of ``tests/data/imread`` bit-equal to the cv2
   arrays stored beside them in both modes, and ms per 480 x 640 GIF and
   HDR file beside ``read_png``'s; then TIFF and BigTIFF (``tiff_phase``:
   ``core/tiff.py`` with its codes in ``image_codes.cpp`` and ``jpeg.cpp``):
   the fixtures of ``tests/data/tiff`` (CIELab, SGILog, CCITT RLEW and
   damaged CCITT strips among them), the EXIF fixtures of
   ``tests/data/exif`` and the 32 scenes of ``tests/data/coco_forms``
   through ``imread`` and ``imdecode`` in both modes, bit-equal to cv2's
   stored outcomes, ms per 480 x 640 LZW, Deflate, JPEG-in-TIFF, 8-bit
   CIELab and LogLuv24 file beside ``read_png``'s, and a COCO tree of the
   32 scenes (CIELab, LogLuv, JPEGs whose EXIF cv2 gives up on) converted,
   trained (batch 32, 2 steps, 1 ``warp_2level`` launch per step) and
   served (2 ``fused_chain`` launches per dispatch); then WebP
   (``webp_phase``: ``core/webp.py`` with its bit streams in
   ``ops/native/webp.cpp``): the fixtures of ``tests/data/webp`` through
   ``imread`` and ``imdecode`` in both modes, bit-equal to cv2's stored
   outcomes, ms per 480 x 640 lossy q75, lossy q90 and lossless file beside
   ``read_png``'s, and a COCO tree of the 32 committed 480 x 640 WebP
   scenes converted by ``transfer_coco``, trained by ``main``
   (``TrainConfig`` defaults, batch 32, 2 steps: finite losses, 1
   ``warp_2level`` launch per step) and served (2 ``fused_chain`` launches
   per dispatch); then JPEG 2000 (``jpeg2000_phase``: ``core/jpeg2000.py``
   with its codestream decoder in ``ops/native/jpeg2000.cpp``): the
   fixtures of ``tests/data/jpeg2000`` through ``imread`` and ``imdecode``
   in both modes, bit-equal to cv2's stored outcomes, ms per 480 x 640 file
   of cv2's default, PIL 5/3 with RCT and PIL 9/7 with ICT beside
   ``read_png``'s, and a COCO tree of the 32 committed 480 x 640 JPEG 2000
   scenes (cv2's, 5/3, 9/7, tiled, RPCL, layered) converted, trained (batch
   32, 2 steps, 1 ``warp_2level`` launch per step) and served (2
   ``fused_chain`` launches per dispatch); then AVIF (``avif_phase``:
   ``core/avif.py`` with its AV1 decoder in ``ops/native/av1.cpp``): the
   fixtures of ``tests/data/avif`` through ``imread`` and ``imdecode`` in
   both modes, bit-equal to cv2's stored outcomes (intra block copy and
   4:2:2 among them), ms per 480 x 640 file of cv2's default, cv2 at speed
   2, PIL 4:4:4 in two tiles, PIL's default of a scene that codes intra
   block copy and PIL 4:2:2 beside ``read_png``'s, and two COCO trees of the
   32 committed 480 x 640 AVIF scenes, avif480 (cv2's default, speed 2,
   gray 4:0:0, PIL 4:4:4 tiles, BGRA) and avif_pil480 (PIL's default with
   intra block copy, 4:2:2, 4:4:4 tiles with intra block copy), each
   converted, trained (batch 32, 2 steps, 1 ``warp_2level`` launch per
   step) and served (2 ``fused_chain`` launches per dispatch); then the
   encoders
   (``encoders_phase``: ``core/imwrite.py`` over ``core/{pnm,sunras,hdr,
   gif,tiff}.py`` and ``image_codes.cpp``): ``imencode`` of the inputs of
   ``tests/data/imwrite`` in every extension ``cv2.imwrite`` writes but the
   three codecs, equal to cv2's stored digests or refused where cv2
   refuses (with what ``cv2.imwrite`` leaves on disk), ms per 480 x 640
   colour image per encoder, the encoders480 COCO tree (the 32 WebP scenes
   under those names) converted equal to the JAX package's tree, trained
   (batch 32, 2 steps) and served, and C12's ``infer --dataset-mode`` mask
   writes; then the WebP encoder (``webp_encoder_phase``: ``core/webp.py:
   encode_webp`` over ``ops/native/webp_enc.cpp``, a lossless VP8L stream as
   cv2 writes by default): the port's bytes for every input of
   ``tests/data/imwrite`` equal to their stored digests and decoding to the
   input, the bytes against cv2's over the 32 scenes, ms per 480 x 640
   image beside ``.png``, and the webp_named480 COCO tree (the 32 scenes
   under ``.webp`` names) converted (every file but the mix previews equal
   to the JAX package's, each preview's pixels equal to cv2's decode of
   the JAX package's), trained (batch 32, 2 steps), served and run through
   ``infer --dataset-mode`` with ``.webp`` mask paths; then the JPEG 2000
   encoder (``jpeg2000_encoder_phase``: ``core/jpeg2000.py:encode_jpeg2000``
   over ``ops/native/jpeg2000_enc.cpp``, OpenJPEG 2.5.3's file as cv2 writes
   it at rate 4): ``imencode(".jp2")`` of every input of
   ``tests/data/imwrite`` equal to cv2's stored digest (or refused, leaving
   cv2's JP2 boxes on disk) and decoding to cv2's stored decode, ms per 480
   x 640 image beside ``.png``, and the jp2_named480 COCO tree (the 32 JPEG
   2000 scenes under ``.jp2`` names) converted equal to the JAX package's
   tree byte for byte, its ``.jp2`` mix previews included, trained (batch
   32, 2 steps), served and run through ``infer --dataset-mode`` with
   ``.jp2`` mask paths;
   then the dataset converters (``converters_phase``): the port writes a
   COCO (64 JPEGs of 480 x 640, two people each, polygons, compressed and
   uncompressed RLE, 17 keypoints), an OCHuman (16 images, 19 keypoints,
   polygons with holes) and a Supervisely source tree (16 images, 1-bit
   palette PNG bitmaps, polygons with holes, point keypoints), converts each
   (images/s per converter), holds ``encode_jpeg`` byte for byte against
   cv2's encoder fixtures of ``tests/data/jpeg`` (ms per 480 x 640 file),
   trains ``main`` on the converted COCO tree (``TrainConfig`` defaults,
   batch 32, 8 steps, ``--loader threads`` and ``--loader grain``: finite
   losses, 1 ``warp_2level`` launch per step, img/s over steps 2-8) and
   serves the checkpoint over its 128 instances (2 ``fused_chain`` launches
   per dispatch);
   then evaluation and the inference command (``eval_and_cli``):
   ``examples/crossed_demo.ckpt`` on 8 crossed-pair images in float32
   (conditioned AP 1.0, unconditioned AP75 <= 0.2) and bfloat16, ``python
   -m instancesegmentation_tpu_torch.eval``'s ``main`` in both protocols on
   a 32-image 480 x 640 ``make_hard_dataset`` set with the trainer's
   checkpoint (the full-image run from a proposals file with 2 chain
   launches per dispatch, one NMS launch per image whose keeps equal the
   plain NMS on the CPU, and the native RLE IoU on every image; images/s
   and the host split), and ``python -m
   instancesegmentation_tpu_torch.infer``'s ``main`` in its three modes over
   4 of the images, and in float32 on 2 of them against a CPU run (mask
   agreement >= 0.999); the trainer from disk also runs data-parallel over
   one NCCL rank through ``main``'s ``--data-parallel --multihost`` flags
   (the first loss bit-equal to the single-process run's, every loss within
   1e-3 relative and val IoU within 1e-2, the same ``warp_2level``
   launches; where a value differs, the single-process run is repeated to
   show its own spread); then the parallel modules (``parallel_phase``):
   two ranks on ``cuda:0`` over gloo (this script with ``--gloo-worker``,
   twice), 3 float32 train steps at global batch 8, 640 -> 480, the
   train480 augmentations: bit-identical states on both ranks, the first
   step against one process (loss 2e-5, gradient vector 5e-2 relative, BN
   statistics 1e-3), the later losses within 1e-3 relative, one
   ``warp_2level`` launch per step and 149 all-reduces per step on each
   rank; ``ParallelInferenceEngine`` at instance480, one bf16 replica
   bit-equal to ``InferenceEngine`` (2 banded launches per dispatch), two
   float32 replicas on ``cuda:0`` (2 banded float32 launches each; max prob
   diff <= 1e-4, masks >= 0.999 equal), and requests through
   ``ServingFrontend``; its images/s beside ``InferenceEngine``'s in turns,
   and the bf16 train480 step data-parallel over one NCCL rank beside the
   single-process step (CUDA events, in turns), its all-reduces and
   ``warp_2level`` launches per step, and both steps' device idle share;
   then int8 post-training quantisation (``int8_phase``):
   ``calibrate_on_dataset`` over 16 images at 480 px on the card and on the
   CPU (the 76 scales within 1e-4 relative), the int8 conv kernel
   (``csrc/int8_conv.cu``) bit-equal to its plain version (int32
   accumulators and outputs) on every quantised conv of the instance480
   program (bf16 and float32) and of the 3-channel whole512 program, on the
   activations the programs give them; the instance480 batch served under
   "int8_mxu" and "int8", each main path read alone (2 / 0 banded chain
   launches, one int8_conv launch per quantised conv: 6 / 76, no copy of
   an input before it), masks
   agreeing >= 0.9 with the float engine's, one ``ParallelInferenceEngine``
   replica bit-equal to the int8_mxu engine, float32 card vs CPU on 2 rows
   (the quantised inputs that flip between them counted; masks >= 0.9, the
   bound JAX's tests hold int8 to), img/s and program ms in turns with the
   float engine, and each conv's kernel ms beside its plain version, its
   bound and ``torch._int_mm`` over an int8 im2col (a yardstick); ``eval_and_cli``
   also runs ``eval --int8`` (the crossed demo in float32 and bfloat16, the
   hard set's full-image protocol: 2 chain and 6 int8_conv launches per
   dispatch) and ``infer --int8`` in whole-image mode on 4 images; the
   kernel's ragged edges (``int8_ragged_phase``: every form at odd sizes on
   the quantiser's ties and beyond +-127 steps, float32 and bfloat16 in,
   float32, bfloat16 and int32 out, the plan's tiles and imposed small ones,
   dense convs of 129, 136 and 256 outputs in slices of 128 channels,
   bit-equal to the plain version, one launch per call) and the dense
   kernel's tensor-core MMA
   (``IMMA`` in ``cuobjdump -sass``);
   then the keypoint-patch stem and the last options (``fused_stem_phase``):
   instance480 at batch 128 with ``fused_stem=True`` in bf16, float32 and
   int8_mxu, each main path read alone (2 chain launches; 4 int8_conv
   launches under int8_mxu), against the dense engines (bf16: masks >= 0.98,
   mean abs prob diff <= 0.02; float32: max prob diff <= 1e-3, masks >=
   0.999) and float32 against the CPU on 2 rows; the patches bit-equal to
   the card's dense render; ``fold_bn=False`` in float32 (0 chain launches,
   probabilities within 2e-3 + 1e-4 relative of the folded engine's); one
   bf16 ``ParallelInferenceEngine(fused_stem=True)`` replica bit-equal to
   the engine; the dense and fused programs, the stem alone and the folded
   and unfolded float32 programs in turns; ``utils/profiling.trace`` around
   a dispatch (the chain kernel's spans); and train480 at batch 32 for 3
   steps with ``remat`` and twice without (the first loss bit-equal, the
   state within twice the spread of the two runs without, 1 ``warp_2level``
   launch per step, step ms and peak memory); ``eval_and_cli`` also runs
   ``eval --fused-stem`` on the crossed demo (float32, AP equal to the dense
   stem's) and on the hard set (one NMS launch per image), and ``infer
   --fused-stem`` in dataset mode on 2 images in float32 (masks >= 0.999
   equal to the dense stem's and to the CPU's); then ``visual_qa_phase``:
   the labels (cv2 5.0's TrueType ``putText``, ``core/text.py`` with
   ``ops/native/text.cpp`` built with g++ and the package's own fonts,
   Rubik and the fallback WenQuanYi Micro Hei) on every case of
   ``tests/data/text/labels.npz`` bit-equal to cv2's stored ``draw_label``
   and ``draw_keypoint(labeled=True)`` outputs (CJK, mixed and
   multi-line labels and characters in neither font among them; ms per
   CJK label beside "person"), then the
   ``show_aug`` tool over 8 synthetic 480 x 640 images the port writes:
   ``show-dataset``, and ``show-aug --rotate 25`` on the card (one
   ``warp_2level`` launch per grid) against the same run on the CPU with
   the card's draws (at most 1 off in at most 1 % of the values; overlay
   pixels whose mask crosses its threshold excepted, at most 0.1 %), with ms
   per label, per labeled skeleton and per grid (host clock);
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
6. stop the loaders' fork server and resource tracker and fail if any
   process the run started is still alive (``child_pids``); print the
   per-kernel JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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


def child_pids(pid: int | None = None) -> list[int]:
    """The live children of process ``pid`` (this one by default)."""
    pid = os.getpid() if pid is None else pid
    out = []
    for task in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{task}/children") as f:
                out += [int(c) for c in f.read().split()]
        except FileNotFoundError:  # the thread ended meanwhile
            pass
    return out


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


def tf32_off() -> None:
    """float32 products in float32 on the card (cuDNN's convs default to
    TF32), as on the host, in every process of the script."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def int8_ptxas(log: str, kernel: str) -> dict:
    """nvcc -Xptxas -v's reports of every instantiation of a template
    kernel: how many, their registers, and which spill."""
    regs, spilling, n = [], [], 0
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        if kernel not in name:
            continue
        n += 1
        found = re.search(r"Used (\d+) registers", entry)
        regs.append(int(found.group(1)) if found else -1)
        if "spill" in entry and "0 bytes spill stores, 0 bytes spill loads" not in entry:
            spilling.append(name)
    return {"instances": n, "registers": [min(regs, default=-1), max(regs, default=-1)],
            "spilling": spilling}


def int8_sass_mma() -> dict:
    """The dense int8 kernel's instantiations in the built library's SASS
    (``cuobjdump -sass``) and their IMMA instructions (the int8 tensor-core
    MMA): instances, IMMA per instance, instances without one."""
    from instancesegmentation_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.target("int8_conv.cu"))],
                          capture_output=True, text=True, timeout=120).stdout
    counts = {}
    name = None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            if "int8_conv_dense_kernel" in name:
                counts[name] = 0
        elif name in counts and "IMMA" in line:
            counts[name] += 1
    imma = sorted(counts.values())
    return {"tool": tool, "instances": len(counts), "imma_per_instance": imma[:1] + imma[-1:],
            "without_imma": sum(v == 0 for v in imma),
            "example": next((ln.strip() for ln in sass.splitlines() if "IMMA" in ln), None)}


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


def metric_rows(out_dir: str) -> list:
    """The records of a trainer's ``metrics.jsonl``, in file order."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


def tree_leaves(t, prefix=()):
    """(path, numpy array) of each leaf of a nested dict of arrays."""
    for k, v in t.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def same_tree(a: dict, b: dict) -> bool:
    """Two state trees with the same leaves, dtypes and bits."""
    got, want = dict(tree_leaves(a)), dict(tree_leaves(b))
    return got.keys() == want.keys() and all(
        got[k].dtype == v.dtype and np.array_equal(got[k], v) for k, v in want.items())


def trainer_from_disk(dev, card: str, w2, fc, keep_checkpoint: str) -> dict:
    """The trainer's path from a dataset directory to a served checkpoint, at
    full width: write a COCO-sized synthetic train and val set with the port,
    ``python -m instancesegmentation_tpu_torch.train``'s ``main`` on it
    (``TrainConfig`` defaults: ``Segment(20)``, 640 -> 480, bf16, folded head,
    Adam 1e-3; batch 32, 2 epochs, the train480 augmentations), resume it in a
    fresh ``Trainer`` (bit for bit), serve the checkpoint through
    ``load_any_checkpoint`` and ``InferenceEngine``, and time the loader,
    ``read_png`` and the checkpoint codec.  The branch-best checkpoint is
    copied to ``keep_checkpoint``."""
    import glob
    import shutil

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
        def run_argv(run: str) -> list:
            return ["--train-dataset-dir", train_dir, "--val-dataset-dir", val_dir,
                    "--checkpoint-dir", os.path.join(tmp, run, "ckpt"),
                    "--out-dir", os.path.join(tmp, run, "runs"),
                    "--batch-size", str(DISK_BATCH), "--epochs", str(DISK_EPOCHS),
                    "--rotate", "25", "--flip-prob", "0.5", "--jitter", "0.1",
                    "--brightness", "0.2", "--contrast", "0.2", "--noise-std", "5",
                    "--save-iou-gate", "0", "--show-iter", "1", "--log-images", "true"]

        argv = run_argv("single")
        cfg = parse_args(argv)
        check((cfg.in_channels, cfg.canvas, cfg.out_size, cfg.bfloat16, cfg.fused_head,
               cfg.learning_rate) == (20, 640, 480, True, True, 1e-3),
              "trainer from disk: TrainConfig defaults")

        # -- train through the entry point; counts read around this run only
        w2.warp_2level.launches = 0
        fc.reset_launches()
        firsts = []
        undo = first_batch_seconds(loop, firsts)
        t0 = time.perf_counter()
        try:
            loop.main(argv)
            torch.cuda.synchronize()
        finally:
            undo()
        out["train_wall_s"] = time.perf_counter() - t0
        launches = {"warp_2level": w2.warp_2level.launches,
                    "fused_chain": fc.fused_chain.launches}
        out["launches"] = launches
        n_steps = DISK_EPOCHS * (DISK_TRAIN // DISK_BATCH)
        aug = augment_config(cfg, train=True)
        rotated = sum(bool((draw_augment(DISK_BATCH, aug, torch.Generator(device=dev).manual_seed(
            loop.step_seed(cfg.seed, s)))["theta"] != 0).any()) for s in range(n_steps))
        rows = metric_rows(cfg.out_dir)
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
        shutil.copyfile(ckpt_path, keep_checkpoint)
        grids = sorted(glob.glob(os.path.join(cfg.out_dir, "viz", "*.png")))
        check(len(grids) == DISK_EPOCHS and all(
            read_png(g).shape == (4 * 480, 4 * 480, 3) for g in grids),
            "trainer from disk: the viz grids decode")
        secs, steps = step_ms_from_log(rows)
        out.update({"steps": n_steps, "rotated_steps": rotated, "losses": losses,
                    "val_iou": vals, "train_img_per_s_steps_2_to_n": steps * DISK_BATCH / secs,
                    "train_ms_per_step_steps_2_to_n": secs / steps * 1e3})

        # -- the same run data-parallel over one NCCL rank, through the entry
        # point's --multihost flags (the counts read around this run only)
        dp_argv = run_argv("dp") + [
            "--data-parallel", "true", "--multihost", "true",
            "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
            "--process-id", "0"]
        w2.warp_2level.launches = 0
        t0 = time.perf_counter()
        loop.main(dp_argv)
        torch.cuda.synchronize()
        out["dp_train_wall_s"] = time.perf_counter() - t0
        out["dp_launches"] = {"warp_2level": w2.warp_2level.launches}
        dp_rows = metric_rows(parse_args(dp_argv).out_dir)
        dp = {"losses": [r["loss"] for r in dp_rows if "loss" in r],
              "val_iou": [r["val_iou"] for r in dp_rows if "val_iou" in r]}
        dp["bit_equal"] = {k: [a == b for a, b in zip(dp[k], out[k])] for k in ("losses", "val_iou")}
        dp["max_rel_loss_diff"] = max(abs(a - b) / abs(b) for a, b in zip(dp["losses"], losses))
        dp["max_abs_val_iou_diff"] = max(abs(a - b) for a, b in zip(dp["val_iou"], vals))
        if not all(dp["bit_equal"]["losses"] + dp["bit_equal"]["val_iou"]):
            # how far the single-process trainer is from itself on a rerun
            loop.main(run_argv("single_again"))
            again = [r["loss"] for r in metric_rows(os.path.join(tmp, "single_again", "runs"))
                     if "loss" in r]
            dp["single_rerun_max_rel_loss_diff"] = max(
                abs(a - b) / abs(b) for a, b in zip(again, losses))
        out["data_parallel_world1"] = dp
        print(f"trainer from disk, data-parallel over 1 NCCL rank (--multihost): losses "
              f"{[round(v, 4) for v in dp['losses']]}, val IoU "
              f"{[round(v, 4) for v in dp['val_iou']]}, bit-equal to the single-process run "
              f"{json.dumps(dp['bit_equal'])}, max rel loss diff {dp['max_rel_loss_diff']:.3g}, "
              f"max val IoU diff {dp['max_abs_val_iou_diff']:.3g}; launches {out['dp_launches']}"
              + (f"; the single-process run against itself: max rel loss diff "
                 f"{dp['single_rerun_max_rel_loss_diff']:.3g}"
                 if "single_rerun_max_rel_loss_diff" in dp else ""))
        check(len(dp["losses"]) == n_steps and len(dp["val_iou"]) == DISK_EPOCHS,
              "data-parallel trainer: one loss row per step, one validation per epoch")
        check(dp["bit_equal"]["losses"][0],
              "data-parallel trainer at world 1: the first step's loss bit-equal to one process's")
        check(dp["max_rel_loss_diff"] <= 1e-3 and dp["max_abs_val_iou_diff"] <= 1e-2,
              "data-parallel trainer at world 1: losses within rel 1e-3, val IoU within 1e-2")
        check(out["dp_launches"]["warp_2level"] == launches["warp_2level"],
              "data-parallel trainer: the single-process run's warp_2level launches")

        # -- the worker loader in turns beside the threaded one, and the
        # directory checkpoint backend (each run's own warp_2level count)
        out["loaders"] = loader_turns(run_argv, w2, n_steps, {
            "img_per_s_steps_2_to_n": out["train_img_per_s_steps_2_to_n"],
            "ms_per_step_steps_2_to_n": out["train_ms_per_step_steps_2_to_n"],
            "first_batch_s_per_epoch": firsts,
            "warp_2level_per_step": launches["warp_2level"] / n_steps, "losses": losses})
        out["orbax"] = orbax_backend(run_argv, w2, n_steps)

        # -- resume: a fresh Trainer holds the saved state bit for bit
        saved, meta = load_checkpoint(ckpt_path)
        resumed = loop.Trainer(cfg)
        resumed.logger.close()
        check(resumed.start_epoch == meta["epoch"] and resumed.iou_max == meta["best"],
              "resume: the saved epoch and best")
        want = dict(tree_leaves(saved))
        check(same_tree(to_state_tree(resumed.state), saved),
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


#: train_disk480 again with the worker loader, in turns beside the threaded
#: one (whose first run is the phase's own): (loader, worker processes)
LOADER_TURNS = (("grain", 0), ("grain", 4), ("grain", 8), ("threads", None))


def first_batch_seconds(loop, firsts: list):
    """Patch the trainer's train streams (``batch_iterator`` with the tail
    dropped, ``GrainLoader.batches``) to append to ``firsts`` the seconds
    from opening each epoch's stream to its first batch (a worker pool
    starts inside its first epoch's stream).  Returns the undo."""
    make_threads, make_workers = loop.batch_iterator, loop.GrainLoader.batches

    def timed(make):
        def opened(*a, **k):
            t0 = time.perf_counter()
            stream = make(*a, **k)
            try:
                for i, b in enumerate(stream):
                    if i == 0:
                        firsts.append(time.perf_counter() - t0)
                    yield b
            finally:
                stream.close()
        return opened

    def threads(*a, **k):  # validation's streams keep their tail: not timed
        return (timed(make_threads) if k.get("drop_last", True) else make_threads)(*a, **k)

    loop.batch_iterator, loop.GrainLoader.batches = threads, timed(make_workers)

    def undo():
        loop.batch_iterator, loop.GrainLoader.batches = make_threads, make_workers
    return undo


def loader_turns(run_argv, w2, n_steps: int, first_run: dict) -> dict:
    """train_disk480 through ``main`` with ``--loader grain`` at 0, 4 and 8
    worker processes, then ``--loader threads`` again: per run the img/s
    over steps 2-8, each epoch's first-batch seconds, ``warp_2level``
    launches per step (1) and finite losses; ``first_run`` is the phase's
    threaded run."""
    from instancesegmentation_tpu_torch.train import loop

    runs = {"threads": [first_run]}
    for loader, workers in LOADER_TURNS:
        name = loader if workers is None else f"{loader}{workers}"
        argv = run_argv(f"loader_{name}_{len(runs)}") + ["--loader", loader]
        if workers is not None:
            argv += ["--grain-workers", str(workers)]
        firsts = []
        undo = first_batch_seconds(loop, firsts)
        w2.warp_2level.launches = 0
        try:
            loop.main(argv)
            torch.cuda.synchronize()
        finally:
            undo()
        rows = metric_rows(argv[argv.index("--out-dir") + 1])
        losses = [r["loss"] for r in rows if "loss" in r]
        secs, steps = step_ms_from_log(rows)
        run = {"img_per_s_steps_2_to_n": steps * DISK_BATCH / secs,
               "ms_per_step_steps_2_to_n": secs / steps * 1e3,
               "first_batch_s_per_epoch": firsts,
               "warp_2level_per_step": w2.warp_2level.launches / n_steps,
               "losses": losses}
        check(len(losses) == n_steps and all(np.isfinite(losses)),
              f"trainer from disk, --loader {name}: one finite loss per step")
        check(w2.warp_2level.launches == n_steps,
              f"trainer from disk, --loader {name}: 1 warp_2level launch per step")
        check(len(firsts) == DISK_EPOCHS, f"trainer from disk, --loader {name}: an epoch's "
              "first batch timed per epoch")
        runs.setdefault(name, []).append(run)
        print(f"trainer from disk, --loader {name}: {run['img_per_s_steps_2_to_n']:.1f} img/s "
              f"over steps 2-{n_steps} ({run['ms_per_step_steps_2_to_n']:.1f} ms per step), "
              f"first batch {[round(v, 3) for v in firsts]} s per epoch, "
              f"{run['warp_2level_per_step']:.0f} warp_2level launch per step")
    # one order (batch_iterator's) for every loader: the losses differ only
    # by the card's run-to-run spread, if at all
    for name, rs in runs.items():
        for run in rs:
            run["losses_bit_equal_to_first"] = [a == b for a, b in
                                                zip(run["losses"], first_run["losses"])]
            run["max_rel_loss_diff_to_first"] = max(
                abs(a - b) / abs(b) for a, b in zip(run["losses"], first_run["losses"]))
            check(run["max_rel_loss_diff_to_first"] <= 1e-3,
                  f"trainer from disk, --loader {name}: the threaded run's losses (rel 1e-3)")
    print("trainer from disk, loaders: losses bit-equal to the first threaded run's "
          + json.dumps({n: [all(r["losses_bit_equal_to_first"]) for r in rs]
                        for n, rs in runs.items()}))
    return runs


def orbax_backend(run_argv, w2, n_steps: int) -> dict:
    """train_disk480 through ``main`` with ``--checkpoint-backend orbax``: the
    ``.orbax`` directory and its sidecar, a fresh ``Trainer`` resuming from it
    bit for bit (epoch, best, state tree), and its save and load times."""
    from instancesegmentation_tpu_torch.train import loop
    from instancesegmentation_tpu_torch.train.checkpoint_orbax import (
        PAYLOAD,
        OrbaxBranchBestCheckpoint,
    )
    from instancesegmentation_tpu_torch.train.config import parse_args
    from instancesegmentation_tpu_torch.train.state import from_state_tree, to_state_tree

    argv = run_argv("orbax") + ["--checkpoint-backend", "orbax"]
    cfg = parse_args(argv)
    w2.warp_2level.launches = 0
    loop.main(argv)
    torch.cuda.synchronize()
    out = {"warp_2level_launches": w2.warp_2level.launches}
    ckpt = OrbaxBranchBestCheckpoint(cfg.checkpoint_dir)
    check(ckpt.exists() and sorted(os.listdir(ckpt.path)) == [PAYLOAD],
          "orbax backend: the .orbax directory with its payload, and the sidecar")
    saved, meta = ckpt.load()
    resumed = loop.Trainer(cfg)
    resumed.logger.close()
    check(resumed.start_epoch == meta["epoch"] and resumed.iou_max == meta["best"] == ckpt.best(),
          "orbax backend: the resumed trainer's epoch and best are the sidecar's")
    check(same_tree(to_state_tree(resumed.state), saved),
          "orbax backend: the resumed state bit-equal to the saved tree")
    check(out["warp_2level_launches"] == n_steps,
          "orbax backend: 1 warp_2level launch per step")
    t0 = time.perf_counter()
    ckpt.save(to_state_tree(resumed.state), best=meta["best"], epoch=meta["epoch"])
    out["save_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    from_state_tree(ckpt.load()[0], resumed.state)
    torch.cuda.synchronize()
    out["load_ms"] = (time.perf_counter() - t0) * 1e3
    out["payload_bytes"] = os.path.getsize(os.path.join(ckpt.path, PAYLOAD))
    out.update(epoch=meta["epoch"], best=meta["best"])
    print(f"orbax backend: resumed at epoch {meta['epoch']}, best {meta['best']:.4f}, state "
          f"bit-equal; save {out['save_ms']:.1f} ms, load {out['load_ms']:.1f} ms, "
          f"{out['payload_bytes']} bytes; {out['warp_2level_launches']} warp_2level launches")
    return out


JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jpeg")
JPEG_TIMED = ("base_480x640_420_q95", "prog_480x640_420_q95", "form_cmyk_480x640_q95",
              "form_arith_480x640_420")


def jpeg_phase(card: str, png_ms: float, iters: int = 30) -> dict:
    """The JPEG decoder (``ops/native/jpeg.cpp``, built with g++ here): each
    committed fixture of ``tests/data/jpeg`` decoded in both modes, bit-equal
    to the cv2 arrays stored beside it, or ``FileNotFoundError`` for a read
    mode cv2 returns None for (a 12-bit file, a hierarchical SOF5 header, a
    sampling ratio that is not a whole number in colour, a lossless RGB file
    as gray); ms per 480 x 640 file, baseline and progressive 4:2:0 at
    quality 95, CMYK at quality 95 and arithmetic-coded 4:2:0, beside
    ``read_png``'s ms per 480 x 640 PNG (``png_ms``, the trainer phase's),
    host clock.  C6: each ``c6_*`` fixture's bytes through ``imdecode`` equal
    the ``cv2.imdecode`` arrays stored beside it, or raise
    ``FileNotFoundError`` where none is stored, while ``imread`` of the file
    equals the ``cv2.imread`` ones (the loop above)."""
    import glob

    from instancesegmentation_tpu_torch.core.imread import imdecode, imread
    from instancesegmentation_tpu_torch.ops.native import jpeg as native_jpeg

    t0 = time.perf_counter()
    native_jpeg.load_jpeg()
    out = {"card": card, "build_or_load_s": time.perf_counter() - t0}
    files = sorted(glob.glob(os.path.join(JPEG_FIXTURES, "*.jpg")))
    check(len(files) >= 24, "jpeg: the committed fixtures are present")
    refused = 0
    for path in files:
        stored = np.load(path[:-4] + ".npz")
        for mode in ("color", "gray"):
            if mode in stored:
                check(np.array_equal(imread(path, mode), stored[mode]),
                      f"jpeg: {os.path.basename(path)} in {mode} mode equals cv2's stored decode")
                continue
            try:
                imread(path, mode)
                ok = False
            except FileNotFoundError:
                ok = True
            check(ok, f"jpeg: {os.path.basename(path)} in {mode} mode raises FileNotFoundError "
                      "where cv2 returns None")
            refused += 1
    out["fixtures_bit_equal"] = len(files)
    out["reads_refused_as_cv2"] = refused
    # C6: the c6_* files, whose end cv2.imread and cv2.imdecode read apart
    c6 = [p for p in files if os.path.basename(p).startswith("c6_")]
    check(len(c6) >= 5, "jpeg: the C6 fixtures are present")
    c6_refused = 0
    for path in c6:
        stored = np.load(path[:-4] + ".npz")
        with open(path, "rb") as f:
            data = f.read()
        for mode in ("color", "gray"):
            name = f"jpeg C6: {os.path.basename(path)} in {mode} mode"
            if "decode_" + mode in stored:
                check(np.array_equal(imdecode(data, mode), stored["decode_" + mode]),
                      f"{name}: imdecode equals cv2.imdecode's stored decode")
                continue
            try:
                imdecode(data, mode)
                ok = False
            except FileNotFoundError:
                ok = True
            check(ok, f"{name}: imdecode raises FileNotFoundError where cv2.imdecode returns None")
            c6_refused += 1
    out["c6_fixtures"], out["c6_imdecode_refused_as_cv2"] = len(c6), c6_refused
    for name in JPEG_TIMED:
        path = os.path.join(JPEG_FIXTURES, name + ".jpg")
        imread(path)
        t0 = time.perf_counter()
        for _ in range(iters):
            imread(path)
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / iters
        out[f"{name}_bytes"] = os.path.getsize(path)
    out["read_png_ms_480x640_rgb"] = png_ms
    labels = ("baseline", "progressive", "CMYK", "arithmetic")
    times = ", ".join(f"{label} {out[n + '_ms']:.2f} ms ({out[n + '_bytes']} bytes)"
                      for label, n in zip(labels, JPEG_TIMED))
    print(f"jpeg: {len(files)} fixtures bit-equal to cv2's stored decodes in both modes "
          f"({refused} reads refused where cv2 returns None; C6: {len(c6)} files through "
          f"imdecode, {c6_refused} reads refused where cv2.imdecode returns None); "
          f"480x640 4:2:0 q95 {times}; "
          f"read_png {png_ms:.2f} ms per 480x640 RGB PNG (host clock); {card}")
    print(json.dumps({"jpeg": out}))
    return out


IMREAD_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                               "imread")
IMREAD_TIMED = ("screen_480x640.gif", "rle_480x640.hdr")


def image_forms_phase(card: str, png_ms: float, iters: int = 20) -> dict:
    """The small image decoders (PNM / PAM / PFM, Sun raster, Radiance HDR,
    GIF, RLE BMP; their codes in ``ops/native/image_codes.cpp``, built with
    g++ here): each committed fixture of ``tests/data/imread`` read in both
    modes, bit-equal to the cv2 arrays stored beside it (``FileNotFoundError``
    for a mode cv2 returns None for); ms per 480 x 640 GIF and HDR file
    beside ``read_png``'s ms per 480 x 640 PNG (``png_ms``, the trainer
    phase's), host clock."""
    import glob

    from instancesegmentation_tpu_torch.core.imread import imread
    from instancesegmentation_tpu_torch.ops.native.image_codes import load_image_codes

    t0 = time.perf_counter()
    load_image_codes()
    out = {"card": card, "build_or_load_s": time.perf_counter() - t0}
    files = sorted(p for p in glob.glob(os.path.join(IMREAD_FIXTURES, "*"))
                   if not p.endswith((".npz", ".py")))
    exts = {os.path.splitext(p)[1] for p in files}
    check(len(files) >= 20 and {".pbm", ".pgm", ".ppm", ".pam", ".pfm", ".ras", ".hdr", ".gif",
                                ".bmp"} <= exts, "image forms: the committed fixtures are present")
    checked = 0
    for path in files:
        stored = np.load(path + ".npz")
        for mode in ("color", "gray"):
            if mode in stored:
                check(np.array_equal(imread(path, mode), stored[mode]),
                      f"image forms: {os.path.basename(path)} in {mode} mode equals cv2's stored "
                      "decode")
            else:
                try:
                    imread(path, mode)
                    ok = False
                except FileNotFoundError:
                    ok = True
                check(ok, f"image forms: {os.path.basename(path)} in {mode} mode raises "
                          "FileNotFoundError where cv2 returns None")
            checked += 1
    out["fixtures"], out["reads_checked"] = len(files), checked
    for name in IMREAD_TIMED:
        path = os.path.join(IMREAD_FIXTURES, name)
        imread(path)
        t0 = time.perf_counter()
        for _ in range(iters):
            imread(path)
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / iters
        out[f"{name}_bytes"] = os.path.getsize(path)
    out["read_png_ms_480x640_rgb"] = png_ms
    gif, hdr = (out[f"{n}_ms"] for n in IMREAD_TIMED)
    print(f"image forms: {len(files)} fixtures ({checked} reads) bit-equal to cv2's stored decodes "
          f"in both modes; 480x640 GIF {gif:.2f} ms, HDR {hdr:.2f} ms, read_png {png_ms:.2f} ms "
          f"per 480x640 RGB PNG (host clock); {card}")
    print(json.dumps({"image_forms": out}))
    return out


TIFF_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                             "tiff")
TIFF_TIMED = ("lzw_480x640.tif", "deflate_480x640.tif", "jpeg_480x640.tif",
              "cielab8_480x640.tif", "logluv24_480x640.tif")
#: the committed TIFF fixtures (tests/data/tiff/make_fixtures.py writes them)
TIFF_COUNT = 53
EXIF_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                             "exif")
#: the COCO tree of the forms read last: 32 committed 480 x 640 scenes
#: (tests/data/coco_forms), batch, epochs
FORMS_SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                            "coco_forms")
FORMS_COCO, FORMS_BATCH, FORMS_EPOCHS = 32, 32, 1


def _stored_matches(stored, mode: str, decode: bool, got) -> bool:
    """Whether a read (an array, or None where it raised) is the cv2 result
    stored beside a TIFF, EXIF or WebP fixture (``tests/data/{tiff,webp}/
    make_fixtures.py``'s ``matches``: ``imread``'s arrays, ``imdecode``'s
    where they differ, the 480 x 640 ones as SHA-256)."""
    key = ("decode_" + mode) if decode and "decode_same" not in stored else mode
    if key + "_sha256" in stored:
        return got is not None and tuple(got.shape) == tuple(stored[key + "_shape"]) and \
            hashlib.sha256(np.ascontiguousarray(got)).hexdigest() == str(stored[key + "_sha256"])
    if key in stored:
        return got is not None and got.shape == stored[key].shape and \
            np.array_equal(got, stored[key])
    return got is None


def _check_stored(label: str, pairs) -> tuple[int, int]:
    """Each (file, stored npz) read in both modes through ``imread`` (the
    file) and ``imdecode`` (its bytes), held to cv2's stored outcome
    (``_stored_matches``); returns the reads checked and those refused."""
    from instancesegmentation_tpu_torch.core.imread import imdecode, imread

    checked = refused = 0
    for path, npz in pairs:
        stored = np.load(npz)
        with open(path, "rb") as f:
            data = f.read()
        for mode in ("color", "gray"):
            for decode, read in ((False, lambda: imread(path, mode)),
                                 (True, lambda: imdecode(data, mode))):
                try:
                    got = read()
                except FileNotFoundError:
                    got = None
                    refused += 1
                check(_stored_matches(stored, mode, decode, got),
                      f"{label}: {os.path.basename(path)} in {mode} mode through "
                      f"{'imdecode' if decode else 'imread'} equals cv2's stored outcome")
                checked += 1
    return checked, refused


def scene_coco_tree(root: str, sources: list, scenes: dict,
                    exts: tuple = (".jpg",)) -> tuple[str, str]:
    """A COCO tree of committed 480 x 640 scenes: ``sources[i]`` copied as
    image ``i`` under the name ``<i><ext>``, ``ext`` taken from ``exts`` in
    turn (cv2 and the port read by content), its people
    (``scenes["people"][i]``, each ``(cx, cy, ax, ay)``) as 24-point
    polygons with 17 visible keypoints."""
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, annotations = [], []
    for i, source in enumerate(sources):
        name = f"{i:012d}{exts[i % len(exts)]}"
        shutil.copyfile(source, os.path.join(img_dir, name))
        images.append({"id": i, "file_name": name, "height": scenes["height"],
                       "width": scenes["width"]})
        for j, (cx, cy, ax, ay) in enumerate(scenes["people"][i]):
            annotations.append({
                "id": 2 * i + j, "image_id": i, "category_id": 1,
                "segmentation": [ring(cx, cy, ax, ay, 24)],
                "bbox": [round(cx - ax, 2), round(cy - ay, 2), round(2 * ax, 2), round(2 * ay, 2)],
                "keypoints": keypoints_in(cx, cy, ax, ay, (2,) * 17)})
    ann = os.path.join(root, "instances.json")
    with open(ann, "w") as f:
        json.dump({"categories": [{"id": 1, "name": "person"}], "images": images,
                   "annotations": annotations}, f)
    return img_dir, ann


def tree_digests(root: str, img_dir: str) -> dict:
    """SHA-256 of every file of a converted tree by its path under ``root``
    (``/`` separated); in the records (``data/*.json``) the source
    directory ``img_dir``, which they name, reads ``<images>``."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                data = f.read()
            if name.endswith(".json"):
                data = data.replace(img_dir.encode(), b"<images>")
            out[os.path.relpath(path, root).replace(os.sep, "/")] = \
                hashlib.sha256(data).hexdigest()
    return dict(sorted(out.items()))


def train_and_serve_tree(label: str, common: str, batch: int, epochs: int, tmp: str, w2, fc,
                         card: str) -> dict:
    """The main path on a converted tree of two people per image: ``python
    -m instancesegmentation_tpu_torch.train``'s ``main`` (``TrainConfig``
    defaults, ``batch``, ``epochs``: at least 2 finite losses, 1
    ``warp_2level`` launch per step), then the checkpoint served over the
    tree's instances by the instance engine (2 ``fused_chain`` launches per
    dispatch, finite outputs)."""
    import glob

    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.data.pipeline import host_batch
    from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine, load_any_checkpoint
    from instancesegmentation_tpu_torch.train import loop

    ds = InstanceCommonDataset(common, 640)
    n_steps = epochs * (len(ds) // batch)
    argv = ["--train-dataset-dir", common, "--val-dataset-dir", common,
            "--checkpoint-dir", os.path.join(tmp, "ckpt"), "--out-dir", os.path.join(tmp, "runs"),
            "--batch-size", str(batch), "--epochs", str(epochs),
            "--rotate", "25", "--flip-prob", "0.5", "--jitter", "0.1",
            "--save-iou-gate", "0", "--show-iter", "1"]
    w2.warp_2level.launches = 0
    loop.main(argv)
    torch.cuda.synchronize()
    launches = w2.warp_2level.launches
    losses = [r["loss"] for r in metric_rows(os.path.join(tmp, "runs")) if "loss" in r]
    out = {"train": {"steps": n_steps, "losses": losses, "warp_2level": launches}}
    print(f"train on the {label} COCO tree ({len(ds)} instances, batch {batch}): losses "
          f"{[round(v, 4) for v in losses]}, {launches} warp_2level launches; {card}")
    check(n_steps >= 2 and len(losses) == n_steps and all(np.isfinite(losses)),
          f"{label}: {n_steps} finite losses")
    check(launches == n_steps, f"{label}: 1 warp_2level launch per step")

    found = glob.glob(os.path.join(tmp, "ckpt", "*_best.ckpt"))
    check(len(found) == 1, f"{label}: the trainer's checkpoint exists")
    eng = InferenceEngine(load_any_checkpoint(found[0]), in_channels=20, size=480)
    fc.reset_launches()
    dispatches = 0
    for start in range(0, len(ds), batch):
        probs, masks = eng.predict_instances(
            host_batch([ds.fetch(i) for i in range(start, start + batch)]))
        dispatches += 1
        check(probs.shape == (batch, 480, 480, 1) and np.isfinite(probs).all(),
              f"{label} serve: finite crop probabilities")
    torch.cuda.synchronize()
    serve = {"dispatches": dispatches, "fused_chain": fc.fused_chain.launches,
             "by_form": dict(fc.fused_chain.launches_by_form)}
    out["serve"] = serve
    print(f"served the {label} COCO tree's {len(ds)} instances: {json.dumps(serve)}; {card}")
    check(serve["fused_chain"] == 2 * dispatches
          and serve["by_form"].get("banded") == 2 * dispatches,
          f"{label} serve: 2 fused_chain launches per dispatch")
    return out


def tiff_phase(card: str, w2, fc, png_ms: float, iters: int = 20) -> dict:
    """The TIFF decoder (``core/tiff.py``; its LZW, PackBits, CCITT,
    ThunderScan and SGILog codes and its CIELab conversion in
    ``ops/native/image_codes.cpp``, JPEG strips through
    ``ops/native/jpeg.cpp``, both built with g++ here): each committed
    fixture of ``tests/data/tiff`` read in both modes through ``imread``
    (the file) and ``imdecode`` (its bytes), bit-equal to the cv2 decodes
    stored beside them or ``FileNotFoundError`` where cv2 returned None,
    and so the EXIF fixtures of ``tests/data/exif`` (C10: JPEG, PNG and
    WebP files whose EXIF block makes cv2 stop, or not) and the 32 scenes
    of ``tests/data/coco_forms``; ms per 480 x 640 file for cv2's LZW,
    Deflate with the predictor, JPEG 4:2:0 strips, 8-bit CIELab and
    LogLuv24, beside ``read_png``'s ms per 480 x 640 PNG (``png_ms``, the
    trainer phase's), host clock.  Then the main path on these forms: a
    COCO tree of the 32 scenes (``scene_coco_tree``), converted by
    ``transfer_coco``, trained with ``python -m
    instancesegmentation_tpu_torch.train``'s ``main`` (``TrainConfig``
    defaults, batch 32, 2 steps: finite losses, 1 ``warp_2level`` launch per
    step), and the checkpoint served over the tree's 64 instances (2
    ``fused_chain`` launches per dispatch, finite outputs)."""
    import glob

    from instancesegmentation_tpu_torch.core.imread import imread
    from instancesegmentation_tpu_torch.data import converters
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.ops.native import jpeg as native_jpeg
    from instancesegmentation_tpu_torch.ops.native.image_codes import load_image_codes

    t0 = time.perf_counter()
    load_image_codes()
    native_jpeg.load_jpeg()
    out = {"card": card, "build_or_load_s": time.perf_counter() - t0}
    files = sorted(glob.glob(os.path.join(TIFF_FIXTURES, "*.tif")))
    check(len(files) >= TIFF_COUNT and all(os.path.exists(os.path.join(TIFF_FIXTURES, n))
                                           for n in TIFF_TIMED),
          f"tiff: the {TIFF_COUNT} committed fixtures are present")
    checked, refused = _check_stored("tiff", [(p, p[:-4] + ".npz") for p in files])
    out["fixtures"], out["reads_checked"], out["reads_refused_as_cv2"] = len(files), checked, \
        refused
    exif = sorted(p for p in glob.glob(os.path.join(EXIF_FIXTURES, "*.*"))
                  if p.endswith((".jpg", ".png", ".webp")))
    check(len(exif) >= 20, "exif: the committed EXIF fixtures are present")
    exif_checked, _ = _check_stored("exif", [(p, p.rsplit(".", 1)[0] + "_" + p.rsplit(".", 1)[1]
                                              + ".npz") for p in exif])
    unturned = sum(np.load(p.rsplit(".", 1)[0] + "_" + p.rsplit(".", 1)[1] + ".npz")["color"]
                   .shape[0] == 24 for p in exif)
    out["exif"] = {"fixtures": len(exif), "reads_checked": exif_checked,
                   "unturned_as_cv2": unturned}
    with open(os.path.join(FORMS_SCENES, "coco_scenes.json")) as f:
        scene_files = json.load(f)["files"]
    scenes_checked, _ = _check_stored("coco_forms", [
        (os.path.join(FORMS_SCENES, n), os.path.join(FORMS_SCENES, f"coco_{i:02d}.npz"))
        for i, n in enumerate(scene_files)])
    out["scenes"] = {"files": len(scene_files), "reads_checked": scenes_checked}
    for name in TIFF_TIMED:
        path = os.path.join(TIFF_FIXTURES, name)
        imread(path)
        t0 = time.perf_counter()
        for _ in range(iters):
            imread(path)
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / iters
        out[f"{name}_bytes"] = os.path.getsize(path)
    out["read_png_ms_480x640_rgb"] = png_ms
    lzw, deflate, jpg, lab, luv = (out[f"{n}_ms"] for n in TIFF_TIMED)
    print(f"tiff: {len(files)} fixtures ({checked} reads through imread and imdecode, {refused} "
          f"refused where cv2 returns None), {len(exif)} EXIF fixtures ({unturned} left unturned "
          f"as cv2 leaves them) and {len(scene_files)} scenes bit-equal to cv2's stored "
          f"outcomes; 480x640 LZW {lzw:.2f} ms, Deflate {deflate:.2f} ms, JPEG 4:2:0 {jpg:.2f} "
          f"ms, CIELab 8-bit {lab:.2f} ms, LogLuv24 {luv:.2f} ms, read_png {png_ms:.2f} ms per "
          f"480x640 RGB PNG (host clock); {card}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiff_") as tmp:
        # the TIFF scenes under .jpg names: under .tif names the converters'
        # mix preview would need a TIFF encoder (ROADMAP A15)
        with open(os.path.join(FORMS_SCENES, "coco_scenes.json")) as f:
            scenes = json.load(f)
        img_dir, ann = scene_coco_tree(
            os.path.join(tmp, "src"),
            [os.path.join(FORMS_SCENES, n) for n in scenes["files"][:FORMS_COCO]], scenes)
        common = os.path.join(tmp, "common")
        t0 = time.perf_counter()
        n = converters.transfer_coco(img_dir, ann, common, progress=False)
        out["convert_s"] = time.perf_counter() - t0
        check(n == FORMS_COCO, f"tiff: transfer_coco converted {n} of {FORMS_COCO} scenes")
        for i in (0, 8, 16, 24):
            with open(os.path.join(common, "image", f"{i:012d}.jpg"), "rb") as a, \
                    open(os.path.join(img_dir, f"{i:012d}.jpg"), "rb") as b:
                check(a.read() == b.read(), "tiff: the converted tree holds the scenes as they were")
        ds = InstanceCommonDataset(common, 640)
        check(len(ds) == 2 * FORMS_COCO, f"tiff: {len(ds)} eligible instances, 2 per image")
        check(all(tuple(ds.fetch(i).image_hw) == (480, 640) for i in range(48, 64)),
              "tiff: the EXIF scenes are read unturned, as cv2 reads them")
        out.update(train_and_serve_tree("CIELab / LogLuv / EXIF", common, FORMS_BATCH,
                                        FORMS_EPOCHS, tmp, w2, fc, card))
    print(json.dumps({"tiff": out}))
    return out


WEBP_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                             "webp")
#: the timed 480 x 640 WebP files and what each is
WEBP_TIMED = (("lossy_q75_480x640.webp", "lossy q75"), ("lossy_q90_480x640.webp", "lossy q90"),
              ("lossless_480x640.webp", "lossless"))
#: the WebP COCO tree: images (the committed scenes), batch, epochs
WEBP_COCO, WEBP_BATCH, WEBP_EPOCHS = 32, 32, 1
JPEG2000_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                                 "jpeg2000")
#: the timed 480 x 640 JPEG 2000 files and what each is
JPEG2000_TIMED = (("cv2_480x640.jp2", "cv2 default"), ("pil53_rct_480x640.jp2", "PIL 5/3 RCT"),
                  ("pil97_ict_480x640.jp2", "PIL 9/7 ICT"))
#: the JPEG 2000 COCO tree: images (the committed scenes), batch, epochs
JPEG2000_COCO, JPEG2000_BATCH, JPEG2000_EPOCHS = 32, 32, 1
AVIF_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "avif")
#: the timed 480 x 640 AVIF files and what each is
AVIF_TIMED = (("cv2_480x640.avif", "cv2 default"),
              ("cv2_s2_480x640.avif", "cv2 speed 2 (loop restoration)"),
              ("pil444_tiles_480x640.avif", "PIL 4:4:4 two tiles"),
              ("pil480_00.avif", "PIL default scene (intra block copy)"),
              ("pil422_480x640.avif", "PIL 4:2:2"))
#: the avif480 and avif_pil480 COCO trees: images (the committed scenes),
#: batch, epochs; the avif_pil480 scenes' fixture prefix
AVIF_COCO, AVIF_BATCH, AVIF_EPOCHS = 32, 32, 1
AVIF_PIL_PREFIX = "pil480_"


def codec_phase(tag: str, label: str, fixtures: str, ext: str, timed, magic, load,
                n_coco: int, batch: int, epochs: int, card: str, w2, fc, png_ms: float,
                iters: int = 20, prefix: str = "coco_", check_fixtures: bool = True) -> dict:
    """A decoder of the reader (its native part built with g++ here by
    ``load``): each committed fixture ``*<ext>`` of ``fixtures`` read in
    both modes through ``imread`` (the file) and ``imdecode`` (its bytes),
    bit-equal to the cv2 decodes stored beside it or ``FileNotFoundError``
    where cv2 returned None; ms per ``timed`` 480 x 640 file beside
    ``read_png``'s ms per 480 x 640 PNG (``png_ms``), host clock.  Then the
    main path on that format: a COCO tree of the ``n_coco`` committed 480 x
    640 scenes ``<prefix>NN<ext>`` (``scene_coco_tree``), converted by
    ``transfer_coco`` (which copies the files, starting ``magic``, bytes or a
    tuple of them), trained
    with ``python -m instancesegmentation_tpu_torch.train``'s ``main``
    (``TrainConfig`` defaults, ``batch``, ``epochs``: finite losses, 1
    ``warp_2level`` launch per step), and the checkpoint served over the
    tree's instances (2 ``fused_chain`` launches per dispatch, finite
    outputs).  ``check_fixtures`` False: the tree alone (a second tree of
    the same format)."""
    import glob

    from instancesegmentation_tpu_torch.core.imread import imread
    from instancesegmentation_tpu_torch.data import converters
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset

    t0 = time.perf_counter()
    load()
    out = {"card": card, "build_or_load_s": time.perf_counter() - t0}
    if check_fixtures:
        out.update(_check_codec_fixtures(tag, fixtures, ext, timed, png_ms, card, iters))
    out.update(_codec_tree(tag, label, fixtures, ext, magic, n_coco, batch, epochs, card, w2, fc,
                           prefix))
    print(json.dumps({tag: out}))
    return out


def _check_codec_fixtures(tag: str, fixtures: str, ext: str, timed, png_ms: float, card: str,
                          iters: int) -> dict:
    """``codec_phase``'s fixture reads and timed files."""
    import glob

    from instancesegmentation_tpu_torch.core.imread import imread

    out = {}
    files = sorted(glob.glob(os.path.join(fixtures, "*" + ext)))
    check(len(files) >= 100 and all(os.path.exists(os.path.join(fixtures, n)) for n, _ in timed),
          f"{tag}: the committed fixtures are present")
    checked, refused = _check_stored(tag, [(p, p[:-len(ext)] + ".npz") for p in files])
    out["fixtures"], out["reads_checked"], out["reads_refused_as_cv2"] = len(files), checked, \
        refused
    for name, _ in timed:
        path = os.path.join(fixtures, name)
        imread(path)
        t0 = time.perf_counter()
        for _ in range(iters):
            imread(path)
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / iters
        out[f"{name}_bytes"] = os.path.getsize(path)
    out["read_png_ms_480x640_rgb"] = png_ms
    times = ", ".join(f"{what} {out[f'{name}_ms']:.2f} ms" for name, what in timed)
    print(f"{tag}: {len(files)} fixtures ({checked} reads through imread and imdecode, {refused} "
          f"refused where cv2 returns None) bit-equal to cv2's stored outcomes; 480x640 {times}, "
          f"read_png {png_ms:.2f} ms per 480x640 RGB PNG (host clock); {card}")
    return out


def _codec_tree(tag: str, label: str, fixtures: str, ext: str, magic: bytes, n_coco: int,
                batch: int, epochs: int, card: str, w2, fc, prefix: str) -> dict:
    """``codec_phase``'s COCO tree: converted, trained and served."""
    from instancesegmentation_tpu_torch.data import converters
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset

    out = {}
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{tag}_") as tmp:
        # the scenes under .jpg names, as scraped datasets hold them (.jp2
        # names: jpeg2000_encoder_phase; .webp names: webp_encoder_phase)
        with open(os.path.join(fixtures, "coco_scenes.json")) as f:
            scenes = json.load(f)
        img_dir, ann = scene_coco_tree(
            os.path.join(tmp, "src"),
            [os.path.join(fixtures, f"{prefix}{i:02d}{ext}") for i in range(n_coco)], scenes)
        common = os.path.join(tmp, "common")
        t0 = time.perf_counter()
        n = converters.transfer_coco(img_dir, ann, common, progress=False)
        out["convert_s"] = time.perf_counter() - t0
        check(n == n_coco, f"{tag}: transfer_coco converted {n} of {n_coco} {label} images")
        for i in (0, 1):
            with open(os.path.join(common, "image", f"{i:012d}.jpg"), "rb") as a, \
                    open(os.path.join(img_dir, f"{i:012d}.jpg"), "rb") as b:
                copied, source = a.read(), b.read()
            check(copied.startswith(magic) and copied == source,
                  f"{tag}: the converted tree holds the {label} files as they were")
        samples = len(InstanceCommonDataset(common, 640))
        check(samples == 2 * n_coco, f"{tag}: {samples} eligible instances, 2 per image")
        out.update(train_and_serve_tree(label, common, batch, epochs, tmp, w2, fc, card))
    return out


def webp_phase(card: str, w2, fc, png_ms: float) -> dict:
    """WebP (``core/webp.py``, its bit streams in ``ops/native/webp.cpp``):
    ``codec_phase`` over ``tests/data/webp`` (lossy q75, q90 and lossless
    timed) and its 32 WebP scenes (lossy and lossless), batch 32, 2 steps."""
    from instancesegmentation_tpu_torch.ops.native.webp import load_webp

    return codec_phase("webp", "WebP", WEBP_FIXTURES, ".webp", WEBP_TIMED, b"RIFF", load_webp,
                       WEBP_COCO, WEBP_BATCH, WEBP_EPOCHS, card, w2, fc, png_ms)


def jpeg2000_phase(card: str, w2, fc, png_ms: float) -> dict:
    """JPEG 2000 (``core/jpeg2000.py``, the codestream decoder in
    ``ops/native/jpeg2000.cpp``): ``codec_phase`` over
    ``tests/data/jpeg2000`` (cv2's default ``.jp2``, a PIL 5/3 file with RCT
    and a PIL 9/7 file with ICT timed) and its 32 JPEG 2000 scenes (cv2's,
    5/3, 9/7, tiled, RPCL, layered), batch 32, 2 steps."""
    from instancesegmentation_tpu_torch.core.jpeg2000 import JP2_SIGNATURE
    from instancesegmentation_tpu_torch.ops.native.jpeg2000 import load_jpeg2000

    return codec_phase("jpeg2000", "JPEG 2000", JPEG2000_FIXTURES, ".jp2", JPEG2000_TIMED,
                       JP2_SIGNATURE, load_jpeg2000, JPEG2000_COCO, JPEG2000_BATCH,
                       JPEG2000_EPOCHS, card, w2, fc, png_ms)

def avif_phase(card: str, w2, fc, png_ms: float) -> dict:
    """AVIF (``core/avif.py``, the AV1 stream in ``ops/native/av1.cpp``):
    ``codec_phase`` over ``tests/data/avif`` (cv2's default, cv2 at speed 2
    with loop restoration, PIL 4:4:4 in two tiles, PIL's default of a scene
    that codes intra block copy and PIL 4:2:2 timed) and its 32 AVIF scenes
    (cv2's default, speed 2, gray 4:0:0, PIL 4:4:4 in two tiles, BGRA with
    its alpha item: the avif480 tree), batch 32, 2 steps; then
    ``codec_phase`` a second time over the same scenes as PIL writes them
    (its defaults, where libaom codes intra block copy, 4:2:2, 4:4:4 in two
    tiles with intra block copy: the avif_pil480 tree, under ``pil480``)."""
    from instancesegmentation_tpu_torch.ops.native.av1 import load_av1

    out = codec_phase("avif", "AVIF", AVIF_FIXTURES, ".avif", AVIF_TIMED,
                      b"\x00\x00\x00\x20ftypavif", load_av1, AVIF_COCO, AVIF_BATCH,
                      AVIF_EPOCHS, card, w2, fc, png_ms)
    out["pil480"] = codec_phase(
        "avif_pil480", "AVIF (PIL)", AVIF_FIXTURES, ".avif", (),
        (b"\x00\x00\x00\x20ftypavif", b"\x00\x00\x00\x1cftypavif"), load_av1, AVIF_COCO,
        AVIF_BATCH, AVIF_EPOCHS, card, w2, fc, png_ms, prefix=AVIF_PIL_PREFIX,
        check_fixtures=False)
    return out

IMWRITE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                                "imwrite")
#: the encoders timed per 480 x 640 colour image (the aliases share these)
ENCODERS_TIMED = (".png", ".jpg", ".bmp", ".ppm", ".pam", ".pfm", ".sr", ".hdr", ".gif",
                  ".tif", ".webp", ".jp2")
#: the encoders480 tree: images (the committed WebP scenes), batch, epochs
ENCODERS_COCO, ENCODERS_BATCH, ENCODERS_EPOCHS = 32, 32, 1
#: C12: the extensions ``infer --dataset-mode``'s instance-mask paths take in turn
C12_EXTS = (".bmp", ".jpg", ".tif", ".pgm", ".ppm")
C12_SIZE = 480


def _encode_matches(got, stored: dict) -> bool:
    """Whether the port's bytes (None where it refuses) are the cv2 outcome
    stored by ``tests/data/imwrite/make_fixtures.py`` (``cut``: the last
    byte, which cv2 reads from past its image, left out; the port's is 0)."""
    if stored.get("refused"):
        return got is None
    cut = stored["cut"]
    return (got is not None and len(got) == stored["bytes"] and (not cut or got[-1] == 0)
            and hashlib.sha256(got[:len(got) - cut]).hexdigest() == stored["sha256"])


def c12_infer(common: str, ckpt: str, tmp: str, fc, card: str, exts: tuple = C12_EXTS,
              label: str = "C12") -> dict:
    """ROADMAP C12 on the card: ``python -m instancesegmentation_tpu_torch.infer
    --dataset-mode``'s ``main`` with the trainer's checkpoint, first on the
    converted tree (``.png`` masks, run ``png``), then on a copy whose
    instance-mask paths end in turn in ``exts`` (run ``renamed``).  Each
    mask of the second run is in its path's format: its bytes are
    ``imencode(ext, m)`` of the first run's mask ``m`` (the encoders' bytes
    are held to their stored digests before), a lossless one reads back as
    ``m``, a ``.jp2`` one too where its bytes are the lossless file's
    (``_encode_jp2`` at ``IMWRITE_JPEG2000_COMPRESSION_X1000`` 1000; rate 4
    cuts a mask whose lossless stream passes its budget, as cv2 does), and
    where cv2 refuses a gray mask (``.ppm``) no file is written while the
    run goes on."""
    from instancesegmentation_tpu_torch.core.imread import imread
    from instancesegmentation_tpu_torch.core.imwrite import imencode
    from instancesegmentation_tpu_torch.core.jpeg2000 import _encode_jp2
    from instancesegmentation_tpu_torch.core.keys import key_combine
    from instancesegmentation_tpu_torch.infer import cli

    k_obj, k_mask = key_combine("object", "sub_list"), key_combine("instance_mask", "mask_path")
    renamed = os.path.join(tmp, label.lower() + "_tree")
    shutil.copytree(common, renamed)
    paths, n = [], 0
    for name in sorted(os.listdir(os.path.join(renamed, "data"))):
        with open(os.path.join(renamed, "data", name)) as f:
            rec = json.load(f)
        for obj in rec[k_obj]:
            old = obj[k_mask]
            obj[k_mask] = os.path.splitext(old)[0] + exts[n % len(exts)]
            os.rename(os.path.join(renamed, old), os.path.join(renamed, obj[k_mask]))
            paths.append((old, obj[k_mask]))
            n += 1
        with open(os.path.join(renamed, "data", name), "w") as f:
            json.dump(rec, f)
    argv = ["--dataset-mode", "--size", str(C12_SIZE), "--batch", str(ENCODERS_BATCH),
            "--checkpoint", ckpt]
    out = {}
    for tag, tree in (("png", common), ("renamed", renamed)):
        fc.reset_launches()
        t0 = time.perf_counter()
        _run_main(cli.main, ["-i", tree, "-o", os.path.join(tmp, f"masks_{label}_{tag}")] + argv)
        torch.cuda.synchronize()
        out[tag] = {"s": time.perf_counter() - t0, "fused_chain": fc.fused_chain.launches}
    by_ext = dict.fromkeys(exts, 0)
    lossless_equal = nonempty = refused = cut_by_rate = 0
    for old, new in paths:
        ext = os.path.splitext(new)[1]
        mask = imread(os.path.join(tmp, f"masks_{label}_png", old), "gray")
        nonempty += bool(mask.any())
        path = os.path.join(tmp, f"masks_{label}_renamed", new)
        want = imencode(ext, mask)
        if want is None:
            check(not os.path.exists(path), f"{label}: no mask file where cv2 refuses ({new})")
            refused += 1
            continue
        with open(path, "rb") as f:
            data = f.read()
        check(hashlib.sha256(data).hexdigest() == hashlib.sha256(want).hexdigest(),
              f"{label}: {new} holds imencode({ext!r})'s bytes of the mask")
        back = imread(path, "gray")
        check(back.shape == mask.shape, f"{label}: {new} reads back")
        if ext.lower() == ".jp2" and want != _encode_jp2(mask, 1000):
            cut_by_rate += 1
        elif ext.lower() not in (".jpg", ".jpe", ".jpeg"):
            check(np.array_equal(back, mask), f"{label}: {new} reads back as the mask")
            lossless_equal += 1
        by_ext[ext] += 1
    out.update({"masks": len(paths), "nonempty_masks": nonempty, "written_by_ext": by_ext,
                "refused": refused, "lossless_read_back_equal": lossless_equal,
                "cut_by_rate": cut_by_rate})
    print(f"{label}: infer --dataset-mode wrote {json.dumps(by_ext)} of {len(paths)} masks "
          f"({refused} refused as cv2 refuses them, {cut_by_rate} .jp2 cut by the rate), each "
          f"imencode's bytes of the PNG run's mask; fused_chain launches "
          f"{out['png']['fused_chain']} / "
          f"{out['renamed']['fused_chain']}; {card}")
    check(sum(by_ext.values()) + refused == len(paths),
          f"{label}: every mask written but those cv2 refuses")
    return out


def encoders_phase(card: str, w2, fc, iters: int = 10) -> dict:
    """The encoders behind ``core/imwrite.py`` (``core/{pnm,sunras,hdr,gif,
    tiff}.py``, their loops in ``ops/native/image_codes.cpp`` built with g++
    here): every stored outcome of ``tests/data/imwrite/cv2_digests.json``
    (``cv2.imencode`` of the synthetic inputs of ``inputs.npz`` and the 32
    480 x 640 scenes of ``tests/data/webp`` as the port decodes them, in
    each of ``.jpe .dib .pbm .pgm .ppm .pnm .pam .pfm .sr .ras .hdr .pic
    .gif .tif .tiff``) matched by ``imencode``: the same SHA-256, or None
    where cv2 refuses, and ``imwrite`` leaving what ``cv2.imwrite`` left;
    ms per 480 x 640 colour image for each encoder of ``ENCODERS_TIMED``,
    host clock.  Then the main path on those formats, cell encoders480: the
    32 scenes as a COCO tree named in turn ``.jpe .dib .ppm .pnm .pam .pfm
    .sr .ras .hdr .pic .gif .tif .tiff .pgm .pbm .JPE``, converted by
    ``transfer_coco`` equal to the JAX package's tree file for file (its
    stored digests; the ``.pgm`` and ``.pbm`` mix previews absent), trained
    with ``python -m instancesegmentation_tpu_torch.train``'s ``main``
    (``TrainConfig`` defaults, batch 32, 1 epoch: finite losses, 1
    ``warp_2level`` launch per step), the checkpoint served over the 64
    instances (2 "banded" ``fused_chain`` launches per dispatch, finite
    outputs), and C12's ``infer --dataset-mode`` flow (``c12_infer``)."""
    import glob

    from instancesegmentation_tpu_torch.core.imread import imread
    from instancesegmentation_tpu_torch.core.imwrite import imencode, imwrite
    from instancesegmentation_tpu_torch.data import converters
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.ops.native.image_codes import load_image_codes
    from instancesegmentation_tpu_torch.ops.native.jpeg import load_jpeg_encoder

    t0 = time.perf_counter()
    load_image_codes()
    load_jpeg_encoder()
    out = {"card": card, "build_or_load_s": time.perf_counter() - t0}
    with open(os.path.join(IMWRITE_FIXTURES, "cv2_digests.json")) as f:
        digests = json.load(f)
    inputs = np.load(os.path.join(IMWRITE_FIXTURES, "inputs.npz"))
    checked = refused = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_encoders_") as tmp:
        for name, outcomes in digests["encodes"].items():
            image = imread(os.path.join(WEBP_FIXTURES, name + ".webp")) \
                if name.startswith("coco_") else inputs[name]
            for ext, stored in outcomes.items():
                check(_encode_matches(imencode(ext, image), stored),
                      f"encoders: imencode({ext!r}) of {name} is cv2's stored outcome")
                checked += 1
                if stored.get("refused"):
                    path = os.path.join(tmp, "refused" + ext)
                    check(imwrite(path, image) is False, f"encoders: {ext} refuses {name}")
                    left = None
                    if os.path.exists(path):
                        with open(path, "rb") as f:
                            left = f.read().hex()
                        os.remove(path)
                    check(left == stored["left"],
                          f"encoders: imwrite({ext!r}) of {name} leaves what cv2 leaves")
                    refused += 1
    out["encodes_checked"], out["refused_as_cv2"] = checked, refused
    scene = imread(os.path.join(WEBP_FIXTURES, "coco_00.webp"))
    for ext in ENCODERS_TIMED:
        imencode(ext, scene)
        t0 = time.perf_counter()
        for _ in range(iters):
            imencode(ext, scene)
        out[f"{ext[1:]}_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    times = ", ".join(f"{ext} {out[f'{ext[1:]}_ms']:.2f}" for ext in ENCODERS_TIMED)
    print(f"encoders: {checked} encodes ({refused} refused as cv2 refuses) equal to cv2's stored "
          f"digests; ms per 480x640 colour image: {times} (host clock); {card}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_encoders480_") as tmp:
        with open(os.path.join(WEBP_FIXTURES, "coco_scenes.json")) as f:
            scenes = json.load(f)
        tree = digests["encoders480"]
        img_dir, ann = scene_coco_tree(
            os.path.join(tmp, "src"),
            [os.path.join(WEBP_FIXTURES, f"coco_{i:02d}.webp") for i in range(ENCODERS_COCO)],
            scenes, tuple(tree["exts"]))
        common = os.path.join(tmp, "common")
        t0 = time.perf_counter()
        n = converters.transfer_coco(img_dir, ann, common, progress=False)
        out["convert_s"] = time.perf_counter() - t0
        check(n == ENCODERS_COCO, f"encoders480: transfer_coco converted {n} of {ENCODERS_COCO}")
        got = tree_digests(common, img_dir)
        same = sum(got.get(k) == v for k, v in tree["files"].items())
        mixes = sorted(k for k in got if k.startswith("mix/"))
        out.update({"tree_files": len(got), "tree_files_equal_jax": same, "mix_files": len(mixes)})
        print(f"encoders480: transfer_coco {out['convert_s']:.2f} s; {same} of "
              f"{len(tree['files'])} files equal to the JAX package's tree ({len(mixes)} mix "
              f"previews; the .pgm and .pbm ones absent as in cv2); {card}")
        check(sorted(got) == sorted(tree["files"]) and same == len(tree["files"]),
              "encoders480: the converted tree equals the JAX package's, file for file")
        check(len(mixes) == 28 and not any(m.endswith((".pgm", ".pbm")) for m in mixes),
              "encoders480: the .pgm and .pbm mix previews are absent")
        samples = len(InstanceCommonDataset(common, 640))
        check(samples == 2 * ENCODERS_COCO, f"encoders480: {samples} eligible instances")
        out.update(train_and_serve_tree("encoders480", common, ENCODERS_BATCH, ENCODERS_EPOCHS,
                                        tmp, w2, fc, card))
        ckpt = glob.glob(os.path.join(tmp, "ckpt", "*_best.ckpt"))[0]
        out["c12"] = c12_infer(common, ckpt, tmp, fc, card)
        c12 = out["c12"]
        ppm = sum(C12_EXTS[k % len(C12_EXTS)] == ".ppm" for k in range(c12["masks"]))
        check(c12["written_by_ext"][".ppm"] == 0 and c12["refused"] == ppm,
              "C12: every mask but the refused .ppm ones written")
    print(json.dumps({"encoders": out}))
    return out


def webp_read_back(image: np.ndarray) -> np.ndarray:
    """What a reader gets back from the port's lossless ``.webp`` of
    ``image``, RGB(A): gray as three equal channels, an opaque alpha
    dropped, RGB under alpha 0 as 0 (where libwebp writes what its
    predictors make cheapest)."""
    a = image if image.ndim == 3 else image[..., None]
    if a.shape[2] == 1:
        return np.repeat(a, 3, -1)
    if a.shape[2] == 4:
        if (a[..., 3] == 255).all():
            return a[..., :3]
        a = a.copy()
        a[a[..., 3] == 0] = 0
    return a


def webp_encoder_phase(card: str, w2, fc, enc: dict) -> dict:
    """The WebP encoder (``core/webp.py:encode_webp``, its VP8L stream in
    ``ops/native/webp_enc.cpp`` built with g++ here; cv2 writes a lossless
    file by default, and the port's bytes decode to its pixels, not to its
    bytes): for every input of ``tests/data/imwrite/inputs.npz`` and the 32
    scenes, ``imencode(".webp", x)`` has the stored SHA-256 of the port's
    bytes (``cv2_digests.json``'s ``webp`` section: integer decisions, so
    every host writes them) and ``decode_webp`` of them gives ``x``'s
    pixels (``webp_read_back``); the bytes against cv2's stored bytes over
    the scenes (at most 1.5 x); ms per 480 x 640 image beside ``.png``
    (``encoders_phase``'s, host clock).  Then the main path on WebP names,
    cell webp_named480: the 32 scenes as a COCO tree named ``.webp`` (two
    ``.WEBP``), converted by ``transfer_coco`` (every file but the mix
    previews equal to the JAX package's stored digests, each preview's RGB
    decode equal to the stored digest of cv2's decode of the JAX package's
    preview), trained with ``main`` (batch 32, 1 epoch: finite losses, 1
    ``warp_2level`` launch per step), served over the 64 instances (2
    "banded" ``fused_chain`` launches per dispatch), and ``infer
    --dataset-mode`` with ``.webp`` / ``.WEBP`` mask paths (``c12_infer``:
    each mask ``imencode``'s bytes of the ``.png`` run's mask, reading back
    as it)."""
    import glob

    from instancesegmentation_tpu_torch.core.imread import imread
    from instancesegmentation_tpu_torch.core.imwrite import imencode
    from instancesegmentation_tpu_torch.core.webp import decode_webp
    from instancesegmentation_tpu_torch.data import converters
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.ops.native.webp import load_webp_encoder

    t0 = time.perf_counter()
    load_webp_encoder()
    out = {"card": card, "build_or_load_s": time.perf_counter() - t0}
    with open(os.path.join(IMWRITE_FIXTURES, "cv2_digests.json")) as f:
        stored = json.load(f)["webp"]
    inputs = np.load(os.path.join(IMWRITE_FIXTURES, "inputs.npz"))
    ours = theirs = checked = 0
    for name, want in stored["encodes"].items():
        image = imread(os.path.join(WEBP_FIXTURES, name + ".webp")) \
            if name.startswith("coco_") else inputs[name]
        data = imencode(".webp", image)
        check(data is not None and len(data) == want["port_bytes"]
              and hashlib.sha256(data).hexdigest() == want["port_sha256"],
              f"webp: imencode('.webp') of {name} is the port's stored bytes")
        check(np.array_equal(decode_webp(data), webp_read_back(image)[..., :3]),
              f"webp: the port's .webp of {name} decodes to its pixels")
        checked += 1
        if name.startswith("coco_"):
            ours += len(data)
            theirs += want["cv2_bytes"]
    out.update({"encodes_checked": checked, "scene_bytes": ours, "scene_cv2_bytes": theirs,
                "scene_ratio": ours / theirs, "webp_ms": enc["webp_ms"], "png_ms": enc["png_ms"]})
    print(f"webp encoder: {checked} encodes equal to the stored digests, each decoding to its "
          f"input; the 32 scenes in {ours} bytes against cv2's {theirs} "
          f"({ours / theirs:.4f} x); ms per 480x640 colour image .webp {enc['webp_ms']:.2f}, "
          f".png {enc['png_ms']:.2f} (host clock); {card}")
    check(ours <= 1.5 * theirs, "webp: the scenes in at most 1.5 x cv2's bytes")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_webp_named480_") as tmp:
        with open(os.path.join(WEBP_FIXTURES, "coco_scenes.json")) as f:
            scenes = json.load(f)
        tree = stored["webp_named480"]
        img_dir, ann = scene_coco_tree(
            os.path.join(tmp, "src"),
            [os.path.join(WEBP_FIXTURES, f"coco_{i:02d}.webp") for i in range(ENCODERS_COCO)],
            scenes, tuple(tree["exts"]))
        common = os.path.join(tmp, "common")
        t0 = time.perf_counter()
        n = converters.transfer_coco(img_dir, ann, common, progress=False)
        out["convert_s"] = time.perf_counter() - t0
        check(n == ENCODERS_COCO, f"webp_named480: transfer_coco converted {n} of "
              f"{ENCODERS_COCO}")
        got = tree_digests(common, img_dir)
        previews = {k: got.pop(k) for k in list(got) if k.startswith("mix/")}
        same = sum(got.get(k) == v for k, v in tree["files"].items())
        pixels_same = preview_bytes = 0
        for rel in previews:
            with open(os.path.join(common, rel), "rb") as f:
                data = f.read()
            preview_bytes += len(data)
            rgb = decode_webp(data)
            pixels_same += hashlib.sha256(rgb).hexdigest() == tree["previews"].get(rel)
        cv2_preview_bytes = sum(tree["preview_cv2_bytes"].values())
        out.update({"tree_files": len(got), "tree_files_equal_jax": same,
                    "previews": len(previews), "previews_pixels_equal_jax": pixels_same,
                    "preview_bytes": preview_bytes, "preview_cv2_bytes": cv2_preview_bytes})
        print(f"webp_named480: transfer_coco {out['convert_s']:.2f} s; {same} of "
              f"{len(tree['files'])} files equal to the JAX package's tree, {pixels_same} of "
              f"{len(tree['previews'])} .webp mix previews decoding to the JAX package's "
              f"pixels ({preview_bytes} bytes against cv2's {cv2_preview_bytes}); {card}")
        check(sorted(got) == sorted(tree["files"]) and same == len(tree["files"]),
              "webp_named480: every file but the previews equals the JAX package's")
        check(sorted(previews) == sorted(tree["previews"]) and pixels_same == len(previews),
              "webp_named480: each .webp mix preview decodes to the JAX package's pixels")
        samples = len(InstanceCommonDataset(common, 640))
        check(samples == 2 * ENCODERS_COCO, f"webp_named480: {samples} eligible instances")
        out.update(train_and_serve_tree("webp_named480", common, ENCODERS_BATCH,
                                        ENCODERS_EPOCHS, tmp, w2, fc, card))
        ckpt = glob.glob(os.path.join(tmp, "ckpt", "*_best.ckpt"))[0]
        out["infer"] = c12_infer(common, ckpt, tmp, fc, card, exts=(".webp",) * 15 + (".WEBP",),
                                 label="webp_named480")
        check(out["infer"]["refused"] == 0
              and out["infer"]["lossless_read_back_equal"] == out["infer"]["masks"],
              "webp_named480: every .webp mask written and read back")
    print(json.dumps({"webp_encoder": out}))
    return out


def jpeg2000_encoder_phase(card: str, w2, fc, enc: dict) -> dict:
    """The JPEG 2000 encoder (``core/jpeg2000.py:encode_jpeg2000``, its
    codestream in ``ops/native/jpeg2000_enc.cpp`` built with g++ here; cv2
    has OpenJPEG 2.5.3 write one layer at rate 4, and the port writes its
    bytes): for every input of ``tests/data/imwrite/inputs.npz`` and the 32
    scenes, ``imencode(".jp2", x)`` has the SHA-256 of cv2's bytes
    (``cv2_digests.json``'s ``jp2`` section) and the port's reader gives
    cv2's stored decode of them, or, where cv2 refuses (a side under 32),
    ``imencode`` gives None and ``imwrite`` leaves cv2's JP2 boxes; ms per
    480 x 640 image beside ``.png`` (``encoders_phase``'s, host clock).
    Then the main path on JPEG 2000 names, cell jp2_named480: the 32 JPEG
    2000 scenes of ``tests/data/jpeg2000`` as a COCO tree named ``.jp2``
    (two ``.JP2``), converted by ``transfer_coco`` equal to the JAX
    package's stored digests file for file, the ``.jp2`` mix previews
    included, trained with ``main`` (batch 32, 1 epoch: finite losses, 1
    ``warp_2level`` launch per step), served over the 64 instances (2
    "banded" ``fused_chain`` launches per dispatch), and ``infer
    --dataset-mode`` with ``.jp2`` / ``.JP2`` mask paths (``c12_infer``:
    each mask ``imencode``'s bytes of the ``.png`` run's mask, reading back
    as it unless rate 4 cut it)."""
    import glob

    from instancesegmentation_tpu_torch.core.imread import imdecode, imread
    from instancesegmentation_tpu_torch.core.imwrite import imencode, imwrite
    from instancesegmentation_tpu_torch.data import converters
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.ops.native.jpeg2000 import load_jpeg2000_encoder

    t0 = time.perf_counter()
    load_jpeg2000_encoder()
    out = {"card": card, "build_or_load_s": time.perf_counter() - t0}
    with open(os.path.join(IMWRITE_FIXTURES, "cv2_digests.json")) as f:
        stored = json.load(f)["jp2"]
    inputs = np.load(os.path.join(IMWRITE_FIXTURES, "inputs.npz"))
    checked = refused = scene_bytes = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jp2_refused_") as tmp:
        for name, want in stored["encodes"].items():
            image = imread(os.path.join(WEBP_FIXTURES, name + ".webp")) \
                if name.startswith("coco_") else inputs[name]
            data = imencode(".jp2", image)
            if want.get("refused"):
                path = os.path.join(tmp, name + ".jp2")
                check(data is None and imwrite(path, image) is False,
                      f"jp2: {name} refused as cv2 refuses it")
                with open(path, "rb") as f:
                    check(f.read().hex() == want["left"],
                          f"jp2: imwrite of {name} leaves what cv2 leaves")
                refused += 1
                continue
            check(data is not None and len(data) == want["bytes"]
                  and hashlib.sha256(data).hexdigest() == want["sha256"],
                  f"jp2: imencode('.jp2') of {name} is cv2's stored bytes")
            check(hashlib.sha256(np.ascontiguousarray(imdecode(data))).hexdigest()
                  == want["decode_sha256"], f"jp2: the .jp2 of {name} reads as cv2 reads it")
            checked += 1
            scene_bytes += len(data) if name.startswith("coco_") else 0
    out.update({"encodes_checked": checked, "refused_as_cv2": refused,
                "scene_bytes": scene_bytes, "jp2_ms": enc["jp2_ms"], "png_ms": enc["png_ms"]})
    print(f"jp2 encoder: {checked} encodes equal to cv2's stored bytes, each read back as cv2 "
          f"reads it, {refused} refused as cv2 refuses them; the 32 scenes in {scene_bytes} "
          f"bytes; ms per 480x640 colour image .jp2 {enc['jp2_ms']:.2f}, .png "
          f"{enc['png_ms']:.2f} (host clock); {card}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_jp2_named480_") as tmp:
        with open(os.path.join(JPEG2000_FIXTURES, "coco_scenes.json")) as f:
            scenes = json.load(f)
        tree = stored["jp2_named480"]
        img_dir, ann = scene_coco_tree(
            os.path.join(tmp, "src"),
            [os.path.join(JPEG2000_FIXTURES, f"coco_{i:02d}.jp2") for i in range(JPEG2000_COCO)],
            scenes, tuple(tree["exts"]))
        common = os.path.join(tmp, "common")
        t0 = time.perf_counter()
        n = converters.transfer_coco(img_dir, ann, common, progress=False)
        out["convert_s"] = time.perf_counter() - t0
        check(n == JPEG2000_COCO, f"jp2_named480: transfer_coco converted {n} of "
              f"{JPEG2000_COCO}")
        got = tree_digests(common, img_dir)
        same = sum(got.get(k) == v for k, v in tree["files"].items())
        previews = sorted(k for k in got if k.startswith("mix/"))
        out.update({"tree_files": len(got), "tree_files_equal_jax": same,
                    "previews": len(previews)})
        print(f"jp2_named480: transfer_coco {out['convert_s']:.2f} s; {same} of "
              f"{len(tree['files'])} files equal to the JAX package's tree, its "
              f"{len(previews)} .jp2 mix previews included; {card}")
        check(sorted(got) == sorted(tree["files"]) and same == len(tree["files"]),
              "jp2_named480: the converted tree equals the JAX package's, byte for byte")
        check(len(previews) == JPEG2000_COCO
              and all(p.lower().endswith(".jp2") for p in previews),
              "jp2_named480: a .jp2 mix preview per image")
        samples = len(InstanceCommonDataset(common, 640))
        check(samples == 2 * JPEG2000_COCO, f"jp2_named480: {samples} eligible instances")
        out.update(train_and_serve_tree("jp2_named480", common, JPEG2000_BATCH,
                                        JPEG2000_EPOCHS, tmp, w2, fc, card))
        ckpt = glob.glob(os.path.join(tmp, "ckpt", "*_best.ckpt"))[0]
        out["infer"] = c12_infer(common, ckpt, tmp, fc, card, exts=(".jp2",) * 15 + (".JP2",),
                                 label="jp2_named480")
        inf = out["infer"]
        check(inf["refused"] == 0
              and inf["lossless_read_back_equal"] + inf["cut_by_rate"] == inf["masks"],
              "jp2_named480: every .jp2 mask written and read back")
    print(json.dumps({"jpeg2000_encoder": out}))
    return out


# -- the dataset converters ---------------------------------------------------------

#: the converters phase: source images per converter, their size, and the
#: training on the converted COCO tree (batch, steps: 2 epochs of 4)
CONV_COCO, CONV_OCHUMAN, CONV_SUPERVISELY = 64, 16, 16
CONV_HW = (480, 640)
CONV_BATCH, CONV_EPOCHS = 32, 2
#: visibility of each of the 17 COCO keypoints (0 missing, 1 occluded, 2 visible)
CONV_VIS17 = (2, 2, 2, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 0, 0)


def person_scene(rng, n_people: int):
    """An RGB ``CONV_HW`` image of a textured background with ``n_people``
    brighter ellipses side by side, and each person's (mask, cx, cy, ax, ay)."""
    h, w = CONV_HW
    img = rng.integers(20, 90, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    people = []
    for k in range(n_people):
        cx = rng.uniform(0.15, 0.35) * w + k * w / 2
        cy, ax, ay = rng.uniform(0.35, 0.65) * h, rng.uniform(50, 90), rng.uniform(110, 160)
        inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
        img[inside] = np.clip(img[inside].astype(np.int32) + 130, 0, 255).astype(np.uint8)
        people.append(((inside * 255).astype(np.uint8), cx, cy, ax, ay))
    return img, people


def ring(cx, cy, ax, ay, n: int) -> list:
    """``n`` points on an ellipse as a flat [x0, y0, x1, y1, ...] list."""
    ang = 2 * np.pi * np.arange(n) / n
    return np.stack([cx + ax * np.cos(ang), cy + ay * np.sin(ang)], 1).round(2).ravel().tolist()


def keypoints_in(cx, cy, ax, ay, visibility) -> list:
    flat = []
    for i, v in enumerate(visibility):
        ang = 2 * np.pi * i / len(visibility)
        flat += [int(cx + 0.6 * ax * np.cos(ang)), int(cy + 0.6 * ay * np.sin(ang)), int(v)]
    return flat


def palette_bitmap_png(bits: np.ndarray) -> bytes:
    """A bitmap as Supervisely's library writes it: a 1-bit palette PNG,
    palette black and white, black transparent (``tRNS``)."""
    import struct
    import zlib

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    raw = b"".join(b"\x00" + r.tobytes() for r in rows)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 1, 3, 0, 0, 0))
            + chunk(b"PLTE", bytes([0, 0, 0, 255, 255, 255])) + chunk(b"tRNS", b"\x00")
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_sources(root: str, seed: int) -> dict:
    """The three source trees, written with the port's own codecs: COCO
    (``CONV_COCO`` JPEGs, two people each, segmentations cycling through
    polygons, compressed and uncompressed RLE, 17 keypoints, a non-person
    annotation per image), OCHuman (``CONV_OCHUMAN`` JPEGs, 19 keypoints,
    outer and inner polygons) and a Supervisely project (``CONV_SUPERVISELY``
    PNGs; a bitmap person as a 1-bit palette PNG, a polygon person with a
    hole, point keypoints, a neutral object).  Returns the converters'
    arguments."""
    import base64
    import zlib

    from instancesegmentation_tpu_torch.core.imwrite import imwrite
    from instancesegmentation_tpu_torch.core.rasterize import rle_encode, rle_to_string

    rng = np.random.default_rng(seed)
    h, w = CONV_HW
    coco_img = os.path.join(root, "coco", "images")
    och_img = os.path.join(root, "ochuman", "images")
    os.makedirs(coco_img)
    os.makedirs(och_img)
    images, annotations = [], []
    for i in range(CONV_COCO):
        img, people = person_scene(rng, 2)
        name = f"{i:012d}.jpg"
        imwrite(os.path.join(coco_img, name), img)
        images.append({"id": i, "file_name": name, "height": h, "width": w})
        for j, (mask, cx, cy, ax, ay) in enumerate(people):
            kind = (2 * i + j) % 3
            segm = ([ring(cx, cy, ax, ay, 24)] if kind == 0 else
                    {"size": [h, w], "counts": rle_to_string(rle_encode(mask))} if kind == 1
                    else rle_encode(mask))
            ys, xs = np.nonzero(mask)
            annotations.append({
                "id": 2 * i + j, "image_id": i, "category_id": 1, "segmentation": segm,
                "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min()),
                         int(ys.max() - ys.min())],
                "keypoints": keypoints_in(cx, cy, ax, ay, CONV_VIS17)})
        annotations.append({"id": 10 ** 6 + i, "image_id": i, "category_id": 2,
                            "bbox": [0, 0, 10, 10], "segmentation": [[0, 0, 9, 0, 9, 9]]})
    coco_ann = os.path.join(root, "coco", "instances.json")
    with open(coco_ann, "w") as f:
        json.dump({"categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "dog"}],
                   "images": images, "annotations": annotations}, f)

    och = []
    for i in range(CONV_OCHUMAN):
        img, people = person_scene(rng, 2)
        name = f"{i:06d}.jpg"
        imwrite(os.path.join(och_img, name), img)
        anns = [{"bbox": [int(cx - ax), int(cy - ay), int(cx + ax), int(cy + ay)],
                 "keypoints": keypoints_in(cx, cy, ax, ay, rng.integers(0, 4, 19)),
                 "segms": {"outer": [ring(cx, cy, ax, ay, 20)],
                           "inner": [ring(cx, cy + ay / 3, ax / 4, ay / 6, 8)]}}
                for _, cx, cy, ax, ay in people]
        och.append({"file_name": name, "width": w, "height": h, "annotations": anns})
    och_ann = os.path.join(root, "ochuman", "ochuman.json")
    with open(och_ann, "w") as f:
        json.dump({"images": och}, f)

    project = os.path.join(root, "supervisely")
    for sub in ("img", "ann"):
        os.makedirs(os.path.join(project, "ds0", sub))
    parts = ("nose", "left_eye", "right_eye", "left_shoulder", "right_shoulder")
    for i in range(CONV_SUPERVISELY):
        img, ((mask, cx, cy, ax, ay), (_, qx, qy, bx, by)) = person_scene(rng, 2)
        imwrite(os.path.join(project, "ds0", "img", f"frame{i:04d}.png"), img)
        ys, xs = np.nonzero(mask)
        y0, x0 = int(ys.min()), int(xs.min())
        png = palette_bitmap_png(mask[y0:ys.max() + 1, x0:xs.max() + 1] > 0)
        objects = [{"classTitle": "person_bmp", "geometryType": "bitmap", "instance": "a",
                    "bitmap": {"data": base64.b64encode(zlib.compress(png)).decode(),
                               "origin": [x0, y0]}},
                   {"classTitle": "person_poly", "geometryType": "polygon", "instance": "b",
                    "points": {"exterior": np.reshape(ring(qx, qy, bx, by, 16), (-1, 2)).tolist(),
                               "interior": [np.reshape(ring(qx, qy, bx / 4, by / 5, 6),
                                                       (-1, 2)).tolist()]}},
                   {"classTitle": "neutral", "geometryType": "polygon", "instance": "n",
                    "points": {"exterior": [[0, 0], [9, 0], [9, 9]], "interior": []}}]
        for k, part in enumerate(parts):
            for inst, (px, py) in (("a", (cx, cy)), ("b", (qx, qy))):
                objects.append({"classTitle": part, "geometryType": "point", "instance": inst,
                                "points": {"exterior": [[int(px) + 5 * k, int(py) - 20]],
                                           "interior": []}})
        with open(os.path.join(project, "ds0", "ann", f"frame{i:04d}.json"), "w") as f:
            json.dump({"size": {"height": h, "width": w}, "objects": objects}, f)
    return {"coco": (coco_img, coco_ann), "ochuman": (och_ann, och_img),
            "supervisely": (project,)}


def converters_phase(dev, card: str, w2, fc, jpeg: dict) -> dict:
    """The dataset converters (``data/converters/``) at COCO sizes: the port
    writes a COCO, an OCHuman and a Supervisely source tree
    (``write_sources``), converts each to the common format (images/s per
    converter), holds ``encode_jpeg`` byte for byte against cv2's encoder
    fixtures of ``tests/data/jpeg`` (ms per 480 x 640 file beside
    ``jpeg_phase``'s decode), trains ``python -m
    instancesegmentation_tpu_torch.train``'s ``main`` on the converted COCO
    tree (``TrainConfig`` defaults, batch 32, 8 steps, the threaded loader
    and the worker loader: finite losses, 1 ``warp_2level`` launch per step,
    img/s over steps 2-8) and serves the checkpoint over the converted
    samples (2 ``fused_chain`` launches per dispatch, finite outputs)."""
    import glob

    from instancesegmentation_tpu_torch.core.imread import imread
    from instancesegmentation_tpu_torch.data import converters
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.data.pipeline import host_batch
    from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine, load_any_checkpoint
    from instancesegmentation_tpu_torch.ops.native.jpeg import encode_jpeg, load_jpeg_encoder
    from instancesegmentation_tpu_torch.train import loop

    out = {"card": card}
    t0 = time.perf_counter()
    load_jpeg_encoder()
    out["encoder_build_or_load_s"] = time.perf_counter() - t0
    fixtures = sorted(glob.glob(os.path.join(JPEG_FIXTURES, "enc_*.jpg")))
    check(len(fixtures) >= 6, "converters: the encoder's fixtures are present")
    for path in fixtures:
        with open(path, "rb") as f:
            want = f.read()
        check(encode_jpeg(np.load(path[:-4] + ".npz")["pixels"]) == want,
              f"converters: encode_jpeg of {os.path.basename(path)}'s pixels equals cv2's bytes")
    out["encoder_fixtures_byte_equal"] = len(fixtures)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_converters_") as tmp:
        t0 = time.perf_counter()
        sources = write_sources(os.path.join(tmp, "src"), SEED + 12)
        out["write_sources_s"] = time.perf_counter() - t0
        big = imread(os.path.join(sources["coco"][0], f"{0:012d}.jpg"))
        encode_jpeg(big)
        t0 = time.perf_counter()
        for _ in range(20):
            encode_jpeg(big)
        out["jpeg_encode_ms_480x640"] = (time.perf_counter() - t0) * 1e3 / 20
        out["jpeg_decode_ms_480x640"] = jpeg[JPEG_TIMED[0] + "_ms"]

        calls = {"coco": converters.transfer_coco, "ochuman": converters.transfer_ochuman,
                 "supervisely": converters.transfer_supervisely_to_common}
        counts = {"coco": CONV_COCO, "ochuman": CONV_OCHUMAN, "supervisely": CONV_SUPERVISELY}
        dirs = {}
        for name, convert in calls.items():
            dirs[name] = os.path.join(tmp, "common_" + name)
            t0 = time.perf_counter()
            n = convert(*sources[name], dirs[name], progress=False)
            secs = time.perf_counter() - t0
            check(n == counts[name], f"converters: {name} converted {n} of {counts[name]} images")
            records = sorted(glob.glob(os.path.join(dirs[name], "data", "*.json")))
            mixes = os.listdir(os.path.join(dirs[name], "mix"))
            check(len(records) == len(mixes) == n, f"converters: {name} wrote a record and a "
                  "mix preview per image")
            masks = glob.glob(os.path.join(dirs[name], "instance_mask", "*", "*.png"))
            check(len(masks) == 2 * n and all(imread(m, "gray").max() == 255 for m in masks[:8]),
                  f"converters: {name} wrote two non-empty instance masks per image")
            out[name] = {"images": n, "seconds": secs, "images_per_s": n / secs}
        samples = {name: len(InstanceCommonDataset(d, 640)) for name, d in dirs.items()}
        out["eligible_instances"] = samples
        check(samples["coco"] == 2 * CONV_COCO, "converters: every COCO person is eligible")
        print(f"converters ({CONV_HW[0]}x{CONV_HW[1]}, the port's codecs): " + ", ".join(
            f"{name} {out[name]['images']} images in {out[name]['seconds']:.2f} s "
            f"({out[name]['images_per_s']:.1f} images/s)" for name in calls)
              + f"; eligible instances {samples}; encode_jpeg "
              f"{out['jpeg_encode_ms_480x640']:.2f} ms per 480x640 file (decode "
              f"{out['jpeg_decode_ms_480x640']:.2f} ms), {len(fixtures)} encoder fixtures "
              f"byte-equal to cv2's; host clock; {card}")

        # -- train on the converted COCO tree, both loaders (counts per run)
        n_steps = CONV_EPOCHS * (samples["coco"] // CONV_BATCH)
        runs = {}
        for loader in ("threads", "grain"):
            argv = ["--train-dataset-dir", dirs["coco"], "--val-dataset-dir", dirs["coco"],
                    "--checkpoint-dir", os.path.join(tmp, loader, "ckpt"),
                    "--out-dir", os.path.join(tmp, loader, "runs"),
                    "--batch-size", str(CONV_BATCH), "--epochs", str(CONV_EPOCHS),
                    "--rotate", "25", "--flip-prob", "0.5", "--jitter", "0.1",
                    "--save-iou-gate", "0", "--show-iter", "1", "--loader", loader]
            if loader == "grain":
                argv += ["--grain-workers", "4"]
            w2.warp_2level.launches = 0
            loop.main(argv)
            torch.cuda.synchronize()
            rows = metric_rows(os.path.join(tmp, loader, "runs"))
            losses = [r["loss"] for r in rows if "loss" in r]
            secs, steps = step_ms_from_log(rows)
            runs[loader] = {"losses": losses, "warp_2level": w2.warp_2level.launches,
                            "img_per_s_steps_2_to_n": steps * CONV_BATCH / secs}
            print(f"train on the converted COCO tree (--loader {loader}): losses "
                  f"{[round(v, 4) for v in losses]}, {w2.warp_2level.launches} warp_2level "
                  f"launches, {runs[loader]['img_per_s_steps_2_to_n']:.1f} img/s over steps "
                  f"2-{n_steps} (host clock, loader included); {card}")
            check(len(losses) == n_steps == 8 and all(np.isfinite(losses)),
                  f"converters, --loader {loader}: 8 finite losses")
            check(w2.warp_2level.launches == n_steps,
                  f"converters, --loader {loader}: 1 warp_2level launch per step")
        out["train"] = runs

        # -- serve the checkpoint over the converted samples
        found = glob.glob(os.path.join(tmp, "threads", "ckpt", "*_best.ckpt"))
        check(len(found) == 1, "converters: the trainer's checkpoint exists")
        eng = InferenceEngine(load_any_checkpoint(found[0]), in_channels=20, size=480)
        ds = InstanceCommonDataset(dirs["coco"], 640)
        fc.reset_launches()
        dispatches = 0
        nonempty = 0
        for start in range(0, len(ds), CONV_BATCH):
            probs, masks = eng.predict_instances(
                host_batch([ds.fetch(i) for i in range(start, start + CONV_BATCH)]))
            dispatches += 1
            check(probs.shape == (CONV_BATCH, 480, 480, 1) and np.isfinite(probs).all(),
                  "converters serve: finite crop probabilities")
            nonempty += int((masks.reshape(len(masks), -1) > 0).any(1).sum())
        torch.cuda.synchronize()
        serve = {"dispatches": dispatches, "fused_chain": fc.fused_chain.launches,
                 "by_form": dict(fc.fused_chain.launches_by_form), "nonempty_masks": nonempty}
        out["serve"] = serve
        print(f"served the converted COCO tree's {len(ds)} instances: {json.dumps(serve)}")
        check(serve["fused_chain"] == 2 * dispatches and serve["by_form"].get("banded") == 2 * dispatches,
              "converters serve: 2 fused_chain launches per dispatch")
    print(json.dumps({"converters": out}))
    return out


# -- the parallel modules ---------------------------------------------------------

#: the two-rank gloo phase: global batch, steps, and the f32 train config's
#: augmentations (train480's, in float32)
GLOO_BATCH, GLOO_STEPS, GLOO_TIMEOUT = 8, 3, 600


def gloo_config(data_parallel: bool):
    from instancesegmentation_tpu_torch.train.config import TrainConfig

    return TrainConfig(in_channels=20, bfloat16=False, rotate=25.0, flip_prob=0.5,
                       jitter=0.1, brightness=0.2, contrast=0.2, noise_std=5.0,
                       batch_size=GLOO_BATCH, data_parallel=data_parallel)


def gloo_steps(step, shard_batch, dev) -> dict:
    """``GLOO_STEPS`` f32 train steps at 640 -> 480 from seeded weights, batch
    and per-step draws (the same on every rank and in one process): the
    losses, the first step's gradients and BN statistics, the final state's
    digest, and the ``warp_2level`` launches and all-reduces they made."""
    import hashlib

    import torch.distributed as dist

    from instancesegmentation_tpu_torch.data.pipeline import batch_to, draw_augment
    from instancesegmentation_tpu_torch.models.segment import Segment
    from instancesegmentation_tpu_torch.ops import warp_2level as w2
    from instancesegmentation_tpu_torch.train.state import TrainState
    from instancesegmentation_tpu_torch.train.steps import augment_config

    cfg = gloo_config(False)
    aug = augment_config(cfg, train=True)
    model = Segment(20)
    model.load_state_dict(random_state_dict(20, SEED + 4))
    state = TrainState.create(model.to(dev), cfg.learning_rate)
    batch = shard_batch(batch_to(training_batch(GLOO_BATCH, cfg.canvas, SEED + 5), dev))
    all_reduce, calls = dist.all_reduce, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    out = {"losses": []}
    w2.warp_2level.launches = 0
    dist.all_reduce = counted
    try:
        for s in range(GLOO_STEPS):
            draws = draw_augment(GLOO_BATCH, aug,
                                 torch.Generator(device=dev).manual_seed(SEED + 10 + s))
            state, metrics = step(state, batch, draws)
            out["losses"].append(float(metrics["loss"]))
            if s == 0:
                out["grads"] = torch.cat([p.grad.reshape(-1) for p in
                                          state.model.parameters()]).cpu().numpy()
                out["stats"] = torch.cat([v.reshape(-1) for k, v in state.model.state_dict().items()
                                          if k.endswith(("running_mean", "running_var"))]).cpu().numpy()
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    digest = hashlib.sha256()
    for v in state.model.state_dict().values():
        digest.update(v.detach().cpu().numpy().tobytes())
    out.update(digest=digest.hexdigest(), warp_2level=w2.warp_2level.launches,
               all_reduces=calls[0])
    return out


def gloo_worker(port: int, rank: int, path: str, dev="cuda:0") -> int:
    """One of two ranks on ``dev`` over gloo (NCCL refuses two ranks on one
    device): ``gloo_steps`` through ``make_parallel_steps``, written to
    ``path`` as JSON."""
    from instancesegmentation_tpu_torch.parallel import multihost
    from instancesegmentation_tpu_torch.parallel.data_parallel import make_parallel_steps
    from instancesegmentation_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(dev)
    tf32_off()
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        _, step, _, shard_batch = make_parallel_steps(gloo_config(True), make_mesh(devices=[dev]))
        out = gloo_steps(step, shard_batch, dev)
    finally:
        multihost.shutdown()
    out["grads"] = out["grads"].tolist()
    out["stats"] = out["stats"].tolist()
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def idle_share(fn) -> dict:
    """Device busy and idle share of one call of ``fn`` (warmed up), from a
    ``torch.profiler`` trace: the device ops' time over the host's wall
    time of the call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_ops": len(events),
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms)}


def parallel_phase(dev, card: str, fc, w2, sd20, batch, probs, masks, probs32, masks32,
                   tcfg, tbatch, draws) -> dict:
    """The parallel modules on the one card:

    1. two ranks on ``cuda:0`` over gloo (this script as two subprocesses),
       ``GLOO_STEPS`` f32 train steps at global batch ``GLOO_BATCH``: the
       ranks' states bit-identical; the first step against one process's
       (loss within 2e-5, gradient vector within 5e-2 relative, BN
       statistics within 1e-3: the CPU tests' bounds), the later losses
       within 1e-3 relative; a ``warp_2level`` launch per step on each rank;
    2. ``ParallelInferenceEngine`` at instance480: one replica bf16 bit-equal
       to ``InferenceEngine`` with 2 banded chain launches per dispatch; two
       replicas on ``cuda:0`` in float32 (max prob diff <= 1e-4, masks >=
       0.999 equal, 2 launches per replica); a ``ServingFrontend`` run;
    3. times: the engine's images/s beside ``InferenceEngine``'s (host
       clock, in turns); the data-parallel bf16 train step at world 1 over
       NCCL beside the single-process step (CUDA events, in turns), its
       all-reduces per step and both steps' device idle share.
    """
    import dataclasses

    import torch.distributed as dist

    from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
    from instancesegmentation_tpu_torch.infer.server import ServingFrontend
    from instancesegmentation_tpu_torch.models.segment import Segment
    from instancesegmentation_tpu_torch.parallel import multihost
    from instancesegmentation_tpu_torch.parallel.data_parallel import (
        collectives_per_step,
        make_parallel_steps,
    )
    from instancesegmentation_tpu_torch.parallel.inference import ParallelInferenceEngine
    from instancesegmentation_tpu_torch.parallel.mesh import make_mesh
    from instancesegmentation_tpu_torch.models.layers import init_weights_
    from instancesegmentation_tpu_torch.train.state import TrainState
    from instancesegmentation_tpu_torch.train.steps import make_train_step

    out = {"card": card}

    # -- 1. two gloo ranks on one card, against one process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        port = free_port()
        paths = [os.path.join(tmp, f"rank{r}.json") for r in (0, 1)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-worker",
                                   str(port), str(r), paths[r]],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in (0, 1)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=GLOO_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                print(log[-4000:])
            check(p.returncode == 0, "gloo worker exited with an error")
        ranks = []
        for path in paths:
            with open(path) as f:
                ranks.append(json.load(f))
    out["gloo_wall_s"] = time.perf_counter() - t0
    ref = gloo_steps(make_train_step(gloo_config(False)), lambda b: b, dev)
    grads = np.asarray(ranks[0]["grads"])
    gloo = {
        "losses": [r["losses"] for r in ranks], "one_process_losses": ref["losses"],
        "step1_loss_abs_diff": abs(ranks[0]["losses"][0] - ref["losses"][0]),
        "later_max_rel_loss_diff": max(abs(a - b) / abs(b) for a, b in
                                       zip(ranks[0]["losses"][1:], ref["losses"][1:])),
        "step1_grad_rel_err": float(np.linalg.norm(grads - ref["grads"])
                                    / np.linalg.norm(ref["grads"])),
        "step1_stats_max_abs_diff": float(np.abs(np.asarray(ranks[0]["stats"])
                                                 - ref["stats"]).max()),
        "ranks_bit_identical": ranks[0]["digest"] == ranks[1]["digest"],
        "warp_2level_per_rank": [r["warp_2level"] for r in ranks],
        "all_reduces_per_rank": [r["all_reduces"] for r in ranks],
        "one_process_warp_2level": ref["warp_2level"],
    }
    out["gloo_two_ranks"] = gloo
    print(f"data-parallel f32 step, 2 gloo ranks on cuda:0 (global batch {GLOO_BATCH}, "
          f"640 -> 480, {GLOO_STEPS} steps, {out['gloo_wall_s']:.1f} s with start-up): "
          f"{json.dumps(gloo)} (limits: step 1 loss 2e-5, gradients rel 5e-2, BN statistics "
          f"1e-3, later losses rel 1e-3)")
    check(gloo["ranks_bit_identical"], "gloo ranks: bit-identical states")
    check(gloo["step1_loss_abs_diff"] <= 2e-5, "gloo ranks vs one process: step 1 loss")
    check(gloo["step1_grad_rel_err"] <= 5e-2, "gloo ranks vs one process: step 1 gradients")
    check(gloo["step1_stats_max_abs_diff"] <= 1e-3, "gloo ranks vs one process: BN statistics")
    check(gloo["later_max_rel_loss_diff"] <= 1e-3, "gloo ranks vs one process: later losses")
    check(gloo["warp_2level_per_rank"] == [GLOO_STEPS] * 2,
          "gloo ranks: one warp_2level launch per step on each rank")
    check(gloo["all_reduces_per_rank"] == [GLOO_STEPS * collectives_per_step(Segment(20))] * 2,
          "gloo ranks: 2 all-reduces per BN layer and one for the gradients per step")

    # -- 2. the replicated engine at instance480
    size = probs.shape[1]
    peng = ParallelInferenceEngine(sd20, in_channels=20, size=size, dtype=torch.bfloat16,
                                   devices=[dev])
    fc.reset_launches()
    pp, pm = peng.predict_instances(batch)
    torch.cuda.synchronize()
    launches = {"one_replica_bf16": dict(fc.fused_chain.launches_by_form)}
    check(launches["one_replica_bf16"] == {"banded": 2, "banded_f32": 0, "simt": 0},
          "ParallelInferenceEngine, one replica: 2 banded chain launches per dispatch")
    check(np.array_equal(pp, probs) and np.array_equal(pm, masks),
          "ParallelInferenceEngine, one replica: bit-equal to InferenceEngine")
    peng2 = ParallelInferenceEngine(sd20, in_channels=20, size=size, dtype=torch.float32,
                                    devices=[dev, dev])
    fc.reset_launches()
    pp2, pm2 = peng2.predict_instances(batch)
    torch.cuda.synchronize()
    launches["two_replicas_f32"] = dict(fc.fused_chain.launches_by_form)
    two = {"max_abs_prob_diff": float(np.abs(pp2 - probs32).max()),
           "mask_agreement": float((pm2 == masks32).mean())}
    out["engine"] = {"launches": launches, "two_replicas_vs_engine_f32": two}
    print(f"ParallelInferenceEngine at instance480 (batch {len(probs)}): one bf16 replica "
          f"bit-equal to InferenceEngine; two f32 replicas on {dev}: {json.dumps(two)} "
          f"(limits 1e-4, 0.999); chain launches {json.dumps(launches)}")
    check(launches["two_replicas_f32"] == {"banded": 0, "banded_f32": 4, "simt": 0},
          "ParallelInferenceEngine, two replicas: 2 banded f32 launches per replica")
    check(two["max_abs_prob_diff"] <= 1e-4 and two["mask_agreement"] >= 0.999,
          "ParallelInferenceEngine, two replicas vs InferenceEngine (float32)")
    rng = np.random.default_rng(SEED + 6)
    with ServingFrontend(peng2, max_batch=8, max_delay_ms=20.0) as fe:
        futs = [(fe.submit_instance(rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                                    [w * .2, h * .1, w * .8, h * .9]), (h, w))
                for h, w in [(480, 640), (640, 480), (300, 400)]]
        futs += [(fe.submit(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)), (h, w))
                 for h, w in [(512, 512), (375, 500)]]
        for fut, hw in futs:
            r = fut.result(timeout=300)
            check((r["mask"] if isinstance(r, dict) else r).shape == hw,
                  "ParallelInferenceEngine behind ServingFrontend: a mask per request")
        print(f"ParallelInferenceEngine behind ServingFrontend: {fe.served} requests in "
              f"{fe.dispatches} dispatches")

    # -- 3. times
    eng = InferenceEngine(sd20, in_channels=20, size=size, dtype=torch.bfloat16, device=dev)
    runs = {"engine": [], "parallel_one_replica": []}
    for name in ("engine", "parallel_one_replica", "parallel_one_replica", "engine"):
        e = eng if name == "engine" else peng
        e.predict_instances(batch)
        t0 = time.perf_counter()
        for _ in range(3):
            e.predict_instances(batch)  # returns host arrays: synchronous
        runs[name].append(3 * len(probs) / (time.perf_counter() - t0))
    out["engine"]["img_per_s_runs"] = runs
    print(f"time instance480 bf16 batch {len(probs)}, host clock, turns: InferenceEngine "
          f"{runs['engine']} img/s, ParallelInferenceEngine (1 replica) "
          f"{runs['parallel_one_replica']} img/s; {card}")

    dp_cfg = dataclasses.replace(tcfg, data_parallel=True)
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        _, dp_step, _, shard_batch = make_parallel_steps(dp_cfg, make_mesh(devices=[dev]))
        states = {}
        for name in ("single", "dp"):
            model = Segment(20)
            init_weights_(model, torch.Generator().manual_seed(SEED))
            states[name] = TrainState.create(model.to(dev), tcfg.learning_rate)
        single_step = make_train_step(tcfg)
        steps = {"single": lambda: single_step(states["single"], tbatch, draws),
                 "dp": lambda: dp_step(states["dp"], shard_batch(tbatch), draws)}
        all_reduce, calls = dist.all_reduce, [0]

        def counted(*args, **kwargs):
            calls[0] += 1
            return all_reduce(*args, **kwargs)

        w2.warp_2level.launches = 0
        dist.all_reduce = counted
        try:
            steps["dp"]()
            torch.cuda.synchronize()
        finally:
            dist.all_reduce = all_reduce
        dp_launches = {"warp_2level": w2.warp_2level.launches, "all_reduces": calls[0]}
        ms = {"single": [], "dp": []}
        for name in ("single", "dp", "dp", "single"):
            ms[name].append(cuda_ms(steps[name], iters=5))
        idle = {name: idle_share(fn) for name, fn in steps.items()}
    finally:
        multihost.shutdown()
    out["train_world1_nccl"] = {"ms_runs": ms, "launches_per_step": dp_launches, "trace": idle}
    print(f"time train480 bf16 step (batch {tcfg.batch_size}), CUDA events, turns: single "
          f"process {ms['single']} ms, data-parallel over 1 NCCL rank {ms['dp']} ms; per DP "
          f"step {json.dumps(dp_launches)}; traces {json.dumps(idle)}; {card}")
    check(dp_launches == {"warp_2level": 1, "all_reduces": collectives_per_step(Segment(20))},
          "data-parallel step at world 1: 1 warp_2level launch, 149 all-reduces")
    print(json.dumps({"parallel": out}))
    return out


# -- int8 post-training quantisation ------------------------------------------------

PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core rate
#: recorded readings, not measured by this run: the per-forward ms of the
#: int8 conv's first form (a quantise and a direct-conv launch per conv, CUDA
#: events around the calls), as PERF.md records them (H100 80GB HBM3 at 700
#: W); printed on their own line, labelled, beside this run's ``ms``
INT8_FIRST_FORM_MS = {"int8_mxu": [5.052, 5.111], "int8": [19.870, 20.216]}
INT8_CHECK_BATCH = 8      # rows of each program at which every conv is checked
INT8_CALIB_IMAGES = 16    # the calibration set: 2 batches of 8 instances
INT8_WHOLE_SIZE = 512     # the 3-channel whole-image program checked
#: float32 card (kernels) vs CPU (plain versions), int8: on the card's own
#: model input, the crop masks' agreement and the share of quantised inputs
#: that flip (an H100 read 1.0, and 1.6e-7 / 0 under int8_mxu / int8); end to
#: end, the share that flips at the stem from the crop warp's float rounding
#: (read 2.9e-4)
INT8_SAME_INPUT_MASKS, INT8_SAME_INPUT_FLIPS, INT8_STEM_FLIPS = 0.999, 1e-5, 1e-3


@contextlib.contextmanager
def int8_hooked(model, fn):
    """Within the block, each int8 conv of ``model`` computes ``fn(path,
    qconv, x_nhwc)`` (an NHWC output) in place of its kernel call."""
    from instancesegmentation_tpu_torch.models.layers import Int8

    saved = {p: m.quant for p, m in model.quant_convs().items() if isinstance(m.quant, Int8)}
    for path, q in saved.items():
        model.get_submodule(path).quant = (
            lambda mod, x, path=path, qc=q.qconv: fn(path, qc, x.permute(0, 2, 3, 1))
            .permute(0, 3, 1, 2))
    try:
        yield
    finally:
        for path, q in saved.items():
            model.get_submodule(path).quant = q


def int8_program_inputs(g, n: int, size: int, in_channels: int, dtype, dev):
    """Seeded inputs of the backbone: images in [-1, 1] and heatmaps in
    [0, 1] (None for 3 channels)."""
    x = (torch.rand((n, size, size, 3), generator=g, device=dev) * 2 - 1).to(dtype)
    hm = (torch.rand((n, size, size, in_channels - 3), generator=g, device=dev).to(dtype)
          if in_channels > 3 else None)
    return x, hm


def int8_bit_equal(x, q, what: str):
    """The kernel's int32 accumulators and outputs for conv ``q`` on ``x``
    bit-equal to the plain version's, on the card; returns the outputs."""
    from instancesegmentation_tpu_torch.ops.int8_conv import int8_conv, int8_conv_reference

    acc = int8_conv(x, q, torch.int32)
    y = int8_conv(x, q)
    for got, want in ((acc, int8_conv_reference(x, q, torch.int32)),
                      (y, int8_conv_reference(x, q))):
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"int8_conv {what} {list(x.shape)} -> {list(y.shape)} {x.dtype}, k {q.kh}x{q.kw} "
              f"s{q.stride[0]} groups {q.groups}: the kernel's "
              f"{'accumulators' if got is acc else 'outputs'} differ from the plain version's "
              f"(max diff {(got.double() - want.double()).abs().max().item():.3e})")
    return y


def int8_kernel_checks(dev, programs: dict, g) -> dict:
    """Every quantised conv of each program in "int8" mode, on the
    activations the program gives it at ``INT8_CHECK_BATCH`` rows: the
    kernel's int32 accumulators and outputs bit-equal to the plain version's
    on the card.  ``programs``: label -> (engine, in_channels, size)."""
    out = {}
    for label, (eng, in_channels, size) in programs.items():
        shapes = []

        def checked(path, q, x):
            x = x.contiguous()
            shapes.append((list(x.shape), q.groups))
            return int8_bit_equal(x, q, f"{label} {path}")

        x, hm = int8_program_inputs(g, INT8_CHECK_BATCH, size, in_channels, eng._dtype, dev)
        with int8_hooked(eng.model, checked), torch.inference_mode():
            eng._apply_model(x, hm)
        torch.cuda.synchronize()
        check(len(shapes) == 76, f"int8_conv {label}: all 76 convs checked")
        widths = sorted({shape[-1] for shape, groups in shapes if groups == 1})
        out[label] = {"convs": len(shapes), "dense_input_widths": widths}
        print(f"int8_conv {label}: the 76 convs bit-equal to the plain version "
              f"(accumulators and outputs; dense input widths {widths})")
    return out


def int8_im2col(xq, q):
    """The int8 im2col of ``xq [N, H, W, C]`` for conv ``q`` (groups 1),
    ``[M, K]`` with K = kh * kw * C zero-padded to a multiple of 8."""
    import torch.nn.functional as F

    (sh, sw), (ph, pw), (dh, dw) = q.stride, q.padding, q.dilation
    n, h, w, c = xq.shape
    ho, wo = q.out_hw(h, w)
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
    cols = [xp[:, ky * dh: ky * dh + sh * (ho - 1) + 1: sh, kx * dw: kx * dw + sw * (wo - 1) + 1: sw]
            for ky in range(q.kh) for kx in range(q.kw)]
    k = q.kh * q.kw * c
    pad = -k % 8
    if pad:
        cols.append(xq.new_zeros((n, ho, wo, pad)))
    return torch.cat(cols, dim=-1).reshape(n * ho * wo, k + pad)


def int8_conv_cost(x, y, q) -> tuple[float, float, float, str]:
    """(operations, bytes, bound ms, what bounds it) of one int8 conv of a
    float input: every multiply-add on the int8 tensor cores (2 operations),
    the float input read once, the output written once, the int8 weights,
    scales and bias read once."""
    macs = y.numel() * q.kh * q.kw * q.in_per_group
    io = (x.numel() * x.element_size() + y.numel() * y.element_size() + q.wq.numel()
          + 8 * q.out_channels)
    t_ops, t_io = 2 * macs / PEAK_INT8_OPS * 1e3, io / PEAK_BYTES * 1e3
    return 2.0 * macs, float(io), max(t_ops, t_io), "operations" if t_ops > t_io else "bytes"


def int8_conv_times(eng, dev_batch, mxu_paths) -> list:
    """Each of the 76 convs of the int8 instance program at the batch of
    ``dev_batch``, on the input the program gives it: ``ms``, CUDA events
    around back-to-back calls (the measure of the first form's times, and
    the host's launch time where it exceeds the kernel's), and
    ``kernel_ms``, the kernel's device time (``device_ms``); the plain
    version's, the bound, and as a yardstick ``torch._int_mm`` over an int8
    im2col where it takes the shape (groups 1, out channels a multiple of
    8), held to the kernel's accumulators, timed both ways
    (``int_mm_ms``, ``int_mm_kernel_ms``).  At
    this batch every conv's accumulators and outputs are also held bit-equal
    to the plain version's (the dense kernel's grid-stride loop runs here,
    not at ``INT8_CHECK_BATCH`` rows)."""
    from instancesegmentation_tpu_torch.ops import int8_conv as ic
    from instancesegmentation_tpu_torch.ops.int8_conv import (
        int8_conv,
        int8_conv_reference,
        quantize_input_reference,
    )

    captured = []

    def capture(path, q, x):
        x = x.contiguous()
        captured.append((path, q, x))
        return int8_conv(x, q)

    with int8_hooked(eng.model, capture), torch.inference_mode():
        eng._forward_instance(*dev_batch)
    parts = []
    for path, q, x in captured:
        y = int8_bit_equal(x, q, f"{path} at batch {len(x)}")
        ops, io, b_ms, b_by = int8_conv_cost(x, y, q)
        ms = cuda_ms(lambda: int8_conv(x, q), iters=10)
        kernel = device_ms(lambda: int8_conv(x, q), "int8_conv", iters=10)
        plain = cuda_ms(lambda: int8_conv_reference(x, q), iters=2, warmup=1)
        part = {"path": path, "int8_mxu": path in mxu_paths, "in": list(x.shape),
                "out": list(y.shape), "kernel": [q.kh, q.kw], "stride": q.stride[0],
                "groups": q.groups, "form": ic.plan(q, x.shape, x.dtype).form, "ops": ops,
                "bytes": io, "ms": ms, "kernel_ms": kernel, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by, "int_mm_ms": None, "int_mm_kernel_ms": None}
        if q.groups == 1 and q.out_channels % 8 == 0:
            a = int8_im2col(quantize_input_reference(x, q.s_in), q)
            wk = q.wq.permute(0, 2, 3, 1).reshape(q.out_channels, -1).to(x.device)
            wk = torch.nn.functional.pad(wk, (0, a.shape[1] - wk.shape[1])).contiguous()
            acc = torch._int_mm(a, wk.t())
            exact((acc.reshape(y.shape),), (int8_conv(x, q, torch.int32),),
                  f"torch._int_mm over the im2col of {path}: the kernel's accumulators")
            part["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(a, wk.t()), iters=10)
            part["int_mm_kernel_ms"] = device_ms(lambda: torch._int_mm(a, wk.t()), "", iters=10)
            del a, acc
        parts.append(part)
    del captured
    torch.cuda.empty_cache()
    print(f"int8_conv: the {len(parts)} convs at batch {len(dev_batch[0])} bit-equal to the "
          "plain version (accumulators and outputs)")
    return parts


def int8_vs_cpu(dev, sd20, size: int, scales: dict, small: dict) -> dict:
    """float32 card (kernels) against the CPU (plain versions) on the rows
    of ``small``, in both int8 modes; checks and returns the readings.

    End to end, the float ops before each quantiser (crop warp, heatmaps,
    float convs, chains) differ by float rounding, and where such a
    difference crosses a .5 boundary of x / s_in the quantised input flips
    by one step.  The model is then run on both from the card's own model
    input (the stem's input): a conv can flip only after the first float op
    whose rounding differs (int8_mxu: the chain of section 1; int8: the conv
    transpose of bottle4_1up), so the convs before it must flip none, and
    the masks must agree as the float engine's do (0.999)."""
    from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
    from instancesegmentation_tpu_torch.ops import int8_conv as ic

    vs_cpu = {}
    for mode in ("int8_mxu", "int8"):
        runs, stem_in = [], None
        for d in (dev, "cpu"):
            e = InferenceEngine(sd20, 20, size, torch.float32, quant=scales, quant_mode=mode,
                                device=d)
            seen = {"end_to_end": {}, "same_model_input": {}}

            def record(path, q, x, inputs):
                x = x.contiguous()
                inputs[path] = (q.s_in, x.cpu())
                return ic.int8_conv(x, q)

            with int8_hooked(e.model, lambda *a: record(*a, seen["end_to_end"])):
                p_end, m_end = e.predict_instances(small)
            if stem_in is None:
                stem_in = next(iter(seen["end_to_end"].values()))[1]
            xd = stem_in.to(d)
            with (int8_hooked(e.model, lambda *a: record(*a, seen["same_model_input"])),
                  torch.inference_mode()):
                p_same = torch.sigmoid(e._apply_model(xd[..., :3], xd[..., 3:])).cpu().numpy()
            runs.append({"end_to_end": (p_end, m_end, seen["end_to_end"]),
                         "same_model_input": (p_same, None, seen["same_model_input"])})
        vs_cpu[mode], flips_by = {}, {}
        for name in ("end_to_end", "same_model_input"):
            (pg, mg, xg), (pc, mc, xc) = (r[name] for r in runs)
            flips = flips_by[name] = {
                p: int((ic.quantize_input_reference(xg[p][1], s) !=
                        ic.quantize_input_reference(x, s)).sum()) for p, (s, x) in xc.items()}
            vs_cpu[mode][name] = {
                "prob_max_abs_diff": float(np.abs(pg - pc).max()),
                "crop_mask_agreement": float(((pg > 0.5) == (pc > 0.5)).mean()),
                "quantised_input_flips": sum(flips.values()),
                "quantised_inputs": sum(x.numel() for _, x in xc.values()),
                "first_flipping_conv": next((p for p, f in flips.items() if f), None),
                "stem_flip_share": next(iter(flips.values())) / next(iter(xc.values()))[1].numel()}
            if mg is not None:
                vs_cpu[mode][name]["canvas_mask_agreement"] = float((mg == mc).mean())
        exact_sections = (("init_conv", "bottle1_1") if mode == "int8_mxu" else
                          ("init_conv", "bottle1_1", "bottle1_x", "bottle2_1", "bottle2_x",
                           "bottle3_1", "bottle3_x"))
        exact = {p: f for p, f in flips_by["same_model_input"].items()
                 if p.split(".")[0] in exact_sections}
        same = vs_cpu[mode]["same_model_input"]
        same["convs_before_first_float_difference"] = len(exact)
        print(f"int8 float32 {mode}, card (kernel) vs CPU (plain) on {len(stem_in)} rows: "
              f"{json.dumps(vs_cpu[mode])} (limits: end to end canvas masks >= 0.9 and stem "
              f"flips <= {INT8_STEM_FLIPS} of its inputs; on the same model input crop masks >= "
              f"{INT8_SAME_INPUT_MASKS}, flips <= {INT8_SAME_INPUT_FLIPS} of the quantised "
              f"inputs and none in the {len(exact)} convs of {'/'.join(exact_sections)})")
        end = vs_cpu[mode]["end_to_end"]
        check(end["canvas_mask_agreement"] >= 0.9,
              f"{mode} float32: card (kernel) vs CPU (plain) canvas masks, end to end")
        check(end["stem_flip_share"] <= INT8_STEM_FLIPS,
              f"{mode} float32, end to end: quantised stem inputs flipping")
        check(len(exact) > 0 and not any(exact.values()),
              f"{mode} float32, same model input: no quantised input flips before the first "
              f"float op whose rounding differs ({ {p: f for p, f in exact.items() if f} })")
        check(same["quantised_input_flips"] <= INT8_SAME_INPUT_FLIPS * same["quantised_inputs"],
              f"{mode} float32, same model input: quantised inputs flipping")
        check(same["crop_mask_agreement"] >= INT8_SAME_INPUT_MASKS,
              f"{mode} float32, same model input: card vs CPU crop masks")
    return vs_cpu


#: the ragged-edge phase's convs: (name, in channels, out channels, kernel,
#: stride, padding, dilation, groups), every form and width the kernel
#: takes, with output widths that are not multiples of 8 or of 4
INT8_RAGGED_CONVS = (
    ("stem_k5s2_c20", 20, 16, (5, 5), 2, 2, 1, 1),
    ("stem_k5s2_c3", 3, 16, (5, 5), 2, 2, 1, 1),
    ("k2s2_c36", 36, 16, (2, 2), 2, 0, 1, 1),
    ("k2s2_c19", 19, 16, (2, 2), 2, 0, 1, 1),
    ("k3_c16", 16, 16, (3, 3), 1, 1, 1, 1),
    ("k3_c4_o4", 4, 4, (3, 3), 1, 1, 1, 1),
    ("1x1_c52", 52, 16, (1, 1), 1, 0, 1, 1),
    ("1x1_c35", 35, 16, (1, 1), 1, 0, 1, 1),
    ("1x1_c256_o128", 256, 128, (1, 1), 1, 0, 1, 1),
    ("1x1_c128_o48", 128, 48, (1, 1), 1, 0, 1, 1),
    ("1x1_c20_o12", 20, 12, (1, 1), 1, 0, 1, 1),
    ("1x1_c16_o5", 16, 5, (1, 1), 1, 0, 1, 1),
    ("dw3_d1_c48", 48, 48, (3, 3), 1, 1, 1, 48),
    ("dw3_d2_c48", 48, 48, (3, 3), 1, 2, 2, 48),
    ("dw3_d4_c48", 48, 48, (3, 3), 1, 4, 4, 48),
    ("dw3_c16", 16, 16, (3, 3), 1, 1, 1, 16),
    ("dw5x1_c48", 48, 48, (5, 1), 1, (2, 0), 1, 48),
    ("dw1x5_c48", 48, 48, (1, 5), 1, (0, 2), 1, 48),
    ("grouped_c8_o12_g4", 8, 12, (3, 3), 1, 1, 1, 4),
    ("grouped_c6_o6_g2", 6, 6, (3, 3), 2, 1, 1, 2),
    # dense convs wider than 128 outputs: slices of 128 channels
    ("1x1_c64_o129", 64, 129, (1, 1), 1, 0, 1, 1),
    ("k3_c32_o136", 32, 136, (3, 3), 1, 1, 1, 1),
    ("1x1_c48_o256", 48, 256, (1, 1), 1, 0, 1, 1),
    ("k3_c16_o256", 16, 256, (3, 3), 1, 1, 1, 1),
)
INT8_RAGGED_SHAPES = ((1, 37, 53), (2, 19, 23))


def int8_ragged_phase(dev) -> dict:
    """The int8 kernel's ragged edges and ties: every conv of
    ``INT8_RAGGED_CONVS`` at the odd sizes of ``INT8_RAGGED_SHAPES``, on
    inputs half of whose values sit on the quantiser's ties (k + 0.5) * s_in
    and some beyond +-127 steps, float32 and bfloat16 in, float32, bfloat16
    and int32 out, with the plan's tile, an imposed small one (ragged tiles
    in both directions) and an input 4 bytes off a 16-byte boundary (the
    loader's scalar path): bit-equal to the plain version on the card, one
    launch per call; the dense convs of 129, 136 and 256 outputs run in
    slices of 128 channels."""
    from instancesegmentation_tpu_torch.ops import int8_conv as ic

    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    rng = np.random.default_rng(SEED + 15)
    checked, forms, wide = 0, {"dense": 0, "grouped": 0}, {}
    for name, cin, cout, k, stride, pad, dil, groups in INT8_RAGGED_CONVS:
        w = torch.from_numpy(rng.normal(0, 0.3, (cout, cin // groups, *k)).astype(np.float32))
        b = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32))
        pair = (lambda v: v if isinstance(v, tuple) else (v, v))
        q = ic.Int8Conv(w, b, 1.7, pair(stride), pair(pad), pair(dil), groups, device=dev)
        small = (3, 16) if groups == 1 else (2, 5)
        for n, h, wd in INT8_RAGGED_SHAPES:
            shape = (n, h, wd, cin)
            steps = torch.randint(-140, 140, shape, generator=g, device=dev).float()
            free = torch.randn(shape, generator=g, device=dev) * 60 * float(q.s_in)
            x32 = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5,
                              (steps + 0.5) * float(q.s_in), free)
            spare = torch.empty(x32.numel() + 1, device=dev)
            offset = spare[1:].view(shape)  # 4 bytes past a 16-byte boundary
            offset.copy_(x32)
            for x in (x32, x32.bfloat16(), offset):
                for tile in (None, small):
                    for out_dtype in (torch.float32, torch.bfloat16, torch.int32):
                        before = ic.int8_conv.launches
                        got = ic._launch(x, q, out_dtype, tile)
                        check(ic.int8_conv.launches == before + 1,
                              f"int8_conv ragged {name}: one launch per conv")
                        want = ic.int8_conv_reference(x, q, out_dtype)
                        check(got.dtype == want.dtype and torch.equal(got, want),
                              f"int8_conv ragged {name} {list(x.shape)} {x.dtype} -> "
                              f"{out_dtype} tile {tile} (data_ptr % 16 = "
                              f"{x.data_ptr() % 16}): the kernel differs from the plain "
                              f"version (max diff "
                              f"{(got.double() - want.double()).abs().max().item():.3e})")
                        checked += 1
        p = ic.plan(q, (1, 37, 53, cin))
        forms[p.form] += 1
        if cout > ic.DENSE_SLICE:
            wide[name] = {"slices": ic.dense_slices(cout), "np": p.np, "smem": p.smem}
    torch.cuda.synchronize()
    out = {"convs": len(INT8_RAGGED_CONVS), "forms": forms, "launches_checked": checked,
           "shapes": [list(s) for s in INT8_RAGGED_SHAPES], "wide_dense": wide}
    print(f"int8_conv ragged edges and ties: {json.dumps(out)}, every launch bit-equal to the "
          "plain version")
    return out


def int8_phase(dev, card: str, fc, sd20, sd3, batch, probs, masks) -> dict:
    """int8 post-training quantisation on the card:

    1. calibration: ``calibrate_on_dataset`` over a 16-image set written by
       the port at 480 px (2 batches of 8 instances), on the card and on the
       CPU (TF32 off): the 76 scales within 1e-4 relative;
    2. the kernel against its plain version: every quantised conv of the
       instance480 program in "int8" mode (bf16 and float32) and of the
       3-channel whole512 program (input widths 3, 19, 35), at
       ``INT8_CHECK_BATCH`` rows, bit-equal accumulators and outputs;
    3. serving the instance480 batch in bf16 under "int8_mxu" and "int8"
       beside the float engine: each mode's main path read alone (fused_chain
       2 / 0 launches, int8_conv 1 per quantised conv: 6 / 76, by form, and
       no input copied before a conv), masks
       agreeing >= 0.9 with the float engine's, one ``ParallelInferenceEngine``
       replica bit-equal to the int8_mxu engine, float32 card vs CPU on 2
       rows in both modes, end to end (canvas masks >= 0.9, JAX's int8
       bound; the stem's flips bounded) and from the card's own model input
       (no quantised input flipping before the first float op whose rounding
       differs, flips and crop masks bounded), flipped inputs counted;
       img/s on the host clock and device ms, in turns;
    4. per conv at batch 128 (int8 mode): the kernel bit-equal to its plain
       version, kernel ms, plain ms, bound, ``torch._int_mm`` yardstick.
    """
    from instancesegmentation_tpu_torch.data.synthetic import make_synthetic_dataset
    from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
    from instancesegmentation_tpu_torch.models.layers import int8_selected
    from instancesegmentation_tpu_torch.models.quantize import (
        calibrate,
        calibrate_on_dataset,
    )
    from instancesegmentation_tpu_torch.models.segment import Segment
    from instancesegmentation_tpu_torch.ops import int8_conv as ic
    from instancesegmentation_tpu_torch.parallel.inference import ParallelInferenceEngine

    out = {"card": card}
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    n, size, whole = len(probs), probs.shape[1], INT8_WHOLE_SIZE

    # -- 1. calibration, card against CPU
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
        make_synthetic_dataset(tmp, num_images=INT8_CALIB_IMAGES, seed=SEED + 13)
        t0 = time.perf_counter()
        scales = calibrate_on_dataset(sd20, tmp, in_channels=20, size=size, device=dev)
        torch.cuda.synchronize()
        cal_s = time.perf_counter() - t0
        cpu_scales = calibrate_on_dataset(sd20, tmp, in_channels=20, size=size, device="cpu")
    rel = max(abs(scales[k] - cpu_scales[k]) / cpu_scales[k] for k in cpu_scales)
    vals = sorted(scales.values())
    out["calibration"] = {"scales": len(scales), "min": vals[0], "max": vals[-1],
                          "card_vs_cpu_max_rel_diff": rel, "card_s": cal_s}
    print(f"int8 calibration (calibrate_on_dataset, {INT8_CALIB_IMAGES} images at {size} px, 2 "
          f"batches of 8): {len(scales)} conv scales in [{vals[0]:.4g}, {vals[-1]:.4g}], "
          f"{cal_s:.2f} s on the card; card vs CPU max rel diff {rel:.2e} (limit 1e-4)")
    check(len(scales) == 76 and scales.keys() == cpu_scales.keys(), "int8 calibration: 76 scales")
    check(rel <= 1e-4, "int8 calibration: card vs CPU within 1e-4 relative")
    model3 = Segment(3).to(dev).eval()
    x3, _ = int8_program_inputs(g, 4, whole, 3, torch.float32, dev)
    scales3 = calibrate(model3, sd3, [x3])

    # -- 2. the kernel against its plain version, every conv
    programs = {
        f"instance{size}_bf16": (InferenceEngine(sd20, 20, size, torch.bfloat16, quant=scales,
                                                 quant_mode="int8", device=dev), 20, size),
        f"instance{size}_f32": (InferenceEngine(sd20, 20, size, torch.float32, quant=scales,
                                                quant_mode="int8", device=dev), 20, size),
        f"whole{whole}_bf16_c3": (InferenceEngine(sd3, 3, whole, torch.bfloat16, quant=scales3,
                                                  quant_mode="int8", device=dev), 3, whole),
    }
    out["kernel_checks"] = int8_kernel_checks(dev, programs, g)

    # -- 3. serving the instance480 batch under each mode, each main path alone
    engines = {"int8_mxu": InferenceEngine(sd20, 20, size, torch.bfloat16, quant=scales,
                                           device=dev),
               "int8": programs[f"instance{size}_bf16"][0]}
    serve = {}
    for mode, e in engines.items():
        fc.reset_launches()
        ic.reset_launches()
        p, m = e.predict_instances(batch)  # this mode's main path, once
        torch.cuda.synchronize()
        quantised = sum(q is not None for q in
                        (getattr(mm, "quant", None) for mm in e.model.quant_convs().values()))
        serve[mode] = {"quantised_convs": quantised,
                       "fused_chain": dict(fc.fused_chain.launches_by_form),
                       "int8_conv": ic.int8_conv.launches,
                       "launches_per_conv": ic.int8_conv.launches / max(quantised, 1),
                       "int8_conv_by_kernel": dict(ic.int8_conv.launches_by_kernel),
                       "int8_conv_copies": ic.int8_conv.copies,
                       "mask_agreement_vs_float": float((m == masks).mean()),
                       "crop_prob_mean_abs_diff_vs_float": float(np.abs(p - probs).mean())}
        serve[mode]["outputs"] = (p, m)
        chains = 2 if mode == "int8_mxu" else 0
        print(f"main path int8 (instance {size}, batch {n}, bf16, {mode}): {quantised} "
              f"quantised convs, launches fused_chain {serve[mode]['fused_chain']}, int8_conv "
              f"{serve[mode]['int8_conv']} ({serve[mode]['int8_conv_by_kernel']}: 1 per conv; "
              f"{serve[mode]['int8_conv_copies']} inputs copied); "
              f"masks vs the float engine {serve[mode]['mask_agreement_vs_float']:.4f} "
              f"(limit 0.9)")
        check(quantised == (6 if mode == "int8_mxu" else 76), f"{mode}: quantised convs")
        check(serve[mode]["fused_chain"] == {"banded": chains, "banded_f32": 0, "simt": 0},
              f"{mode}: {chains} banded fused_chain launches per forward")
        dense = sum(q is not None and mm.groups == 1 for mm, q in
                    ((mm, getattr(mm, "quant", None)) for mm in e.model.quant_convs().values()))
        check(serve[mode]["int8_conv_by_kernel"] == {"dense": dense, "grouped": quantised - dense}
              and (mode == "int8" or dense == quantised)
              and serve[mode]["launches_per_conv"] == 1,
              f"{mode}: one int8_conv launch per quantised conv, by form")
        check(serve[mode]["int8_conv_copies"] == 0,
              f"{mode}: no input copied before an int8 conv (each is a channels_last view)")
        check(p.shape == probs.shape and bool(np.isfinite(p).all()), f"{mode}: finite probabilities")
        check(serve[mode]["mask_agreement_vs_float"] >= 0.9, f"{mode}: masks agree with float")
    mxu_probs, mxu_masks = serve["int8_mxu"].pop("outputs")
    serve["int8"].pop("outputs")
    peng = ParallelInferenceEngine(sd20, in_channels=20, size=size, dtype=torch.bfloat16,
                                   quant=scales, devices=[dev])
    pp, pm = peng.predict_instances(batch)
    check(np.array_equal(pp, mxu_probs) and np.array_equal(pm, mxu_masks),
          "ParallelInferenceEngine(quant=...), one replica: bit-equal to the int8 engine")
    print("ParallelInferenceEngine(quant=..., int8_mxu), one replica: bit-equal to "
          "InferenceEngine(quant=...)")

    vs_cpu = int8_vs_cpu(dev, sd20, size, scales, {k: v[:2] for k, v in batch.items()})

    keys = ("image", "mask", "image_hw", "obj_box", "mask_box", "mask_valid", "keypoints")
    dev_batch = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev) for k in keys]
    float_eng = InferenceEngine(sd20, 20, size, torch.bfloat16, device=dev)
    turns = {"float": [], "int8_mxu": [], "int8": []}
    device = {"float": [], "int8_mxu": [], "int8": []}
    for mode in ("float", "int8_mxu", "int8", "int8", "int8_mxu", "float"):
        e = float_eng if mode == "float" else engines[mode]
        e.predict_instances(batch)
        t0 = time.perf_counter()
        for _ in range(3):
            e.predict_instances(batch)  # returns host arrays: synchronous
        turns[mode].append(3 * n / (time.perf_counter() - t0))
        with torch.inference_mode():
            device[mode].append(cuda_ms(lambda: e._forward_instance(*dev_batch), iters=5))
    for mode in turns:
        serve.setdefault(mode, {}).update(img_per_s_runs=turns[mode], program_ms_runs=device[mode])
    print(f"time instance{size} bf16 batch {n}, in turns (float, int8_mxu, int8, int8, "
          f"int8_mxu, float): img/s host clock {json.dumps(turns)}; program ms (CUDA events) "
          f"{json.dumps(device)}; {card}")
    out["serve"] = serve
    out["card_vs_cpu_f32"] = vs_cpu

    # -- 4. per conv at batch 128 (int8 mode), and the int8_mxu subset
    mxu_paths = {p for p, m in engines["int8"].model.quant_convs().items()
                 if int8_selected("int8_mxu", m.kernel_size, m.groups)}
    parts = int8_conv_times(engines["int8"], dev_batch, mxu_paths)
    check(len(parts) == 76, "int8_conv at batch 128: all 76 convs timed and checked")
    out["parts"] = parts
    for p in parts:
        print(f"time int8_conv {p['path']} {p['in']} -> {p['out']} k{p['kernel']} "
              f"s{p['stride']} g{p['groups']} {p['form']}: {p['ms']:.4f} ms (kernel "
              f"{p['kernel_ms']:.4f}, plain {p['plain_ms']:.3f}, "
              f"bound {p['bound_ms']:.4f} by {p['bound_by']}, _int_mm "
              f"{'-' if p['int_mm_ms'] is None else format(p['int_mm_ms'], '.4f')})")
    for name, sel in (("int8_mxu", [p for p in parts if p["int8_mxu"]]), ("int8", parts)):
        mm = [p for p in sel if p["int_mm_ms"] is not None]
        out[f"sum_{name}"] = {
            "convs": len(sel), "ms": sum(p["ms"] for p in sel),
            "kernel_ms": sum(p["kernel_ms"] for p in sel),
            "plain_ms": sum(p["plain_ms"] for p in sel),
            "bound_ms": sum(p["bound_ms"] for p in sel),
            "bound_by": max(sel, key=lambda p: p["bound_ms"])["bound_by"],
            "int_mm_convs": len(mm), "int_mm_ms": sum(p["int_mm_ms"] for p in mm),
            "int_mm_kernel_ms": sum(p["int_mm_kernel_ms"] for p in mm),
            "ms_same_convs_as_int_mm": sum(p["ms"] for p in mm),
            "kernel_ms_same_convs_as_int_mm": sum(p["kernel_ms"] for p in mm)}
        print(f"time int8_conv per forward ({name}, {len(sel)} convs, batch {n} bf16): "
              f"{json.dumps(out[f'sum_{name}'])}; {card}")
        print(f"recorded readings (PERF.md, not this run): the first form's ms per forward "
              f"({name}, CUDA events) {INT8_FIRST_FORM_MS[name]}")
    print(json.dumps({"int8": {k: v for k, v in out.items() if k != "parts"}}))
    out["scales"] = scales
    return out


# -- evaluation and the inference command --------------------------------------

EVAL_IMAGES, EVAL_HW, EVAL_SIZE = 32, (480, 640), 480
CLI_IMAGES, CLI_VS_CPU_IMAGES, CLI_WHOLE_SIZE = 4, 2, 512


def _run_main(fn, argv, device=None):
    """Run an entry point's ``main`` (``main(argv, device=...)``), check its
    exit code and return the lines it printed (passed through to stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv, device=device)
    print(buf.getvalue(), end="")
    check(rc == 0, f"{fn.__module__}.main returned {rc}")
    return buf.getvalue().strip().splitlines()


def hard_proposals(dataset_dir: str, path: str, seed: int) -> dict:
    """A proposals JSON for a common-format set: per image, each GT box with
    its keypoints at a score U(0.6, 1), and two copies of it moved by up to
    3 % of its size at lower scores.  Returns the counts written."""
    import glob

    from instancesegmentation_tpu_torch.core.keys import key_combine
    from instancesegmentation_tpu_torch.data.dataset import body_keypoint_array

    rng = np.random.default_rng(seed)
    props, n_gt = {}, 0
    for f in sorted(glob.glob(os.path.join(dataset_dir, "data", "*.json"))):
        with open(f) as fh:
            ann = json.load(fh)
        name = os.path.splitext(os.path.basename(ann[key_combine("image", "image_path")]))[0]
        boxes, scores, kps = [], [], []
        for obj in ann[key_combine("object", "sub_list")]:
            box = np.asarray(obj[key_combine("box", "box_xyxy")], np.float64)
            kp = body_keypoint_array(obj.get(key_combine("body_keypoint", "sub_dict"))).tolist()
            size = np.tile(box[2:] - box[:2], 2)
            score = rng.uniform(0.6, 1.0)
            boxes.append(box.tolist())
            scores.append(score)
            kps.append(kp)
            for _ in range(2):
                boxes.append((box + rng.uniform(-0.03, 0.03, 4) * size).tolist())
                scores.append(score * rng.uniform(0.3, 0.95))
                kps.append(kp)
            n_gt += 1
        props[name] = {"boxes": boxes, "scores": scores, "keypoints": kps}
    with open(path, "w") as fh:
        json.dump(props, fh)
    return {"images": len(props), "gt_boxes": n_gt, "proposals": 3 * n_gt}


def eval_and_cli(card: str, fc, nms_mod, trained_ckpt: str, tmp: str) -> dict:
    """Evaluation and the inference command on the card, at full width:

    1. quality: ``evaluate_full_image`` with ``examples/crossed_demo.ckpt`` on
       the 8 crossed-pair images (seed 300) at 256 (canvas 320), float32 and
       bfloat16, conditioned and not: float32 conditioned AP 1.0,
       unconditioned AP75 <= 0.2, 16 predictions of 16 GTs;
    2. ``python -m instancesegmentation_tpu_torch.eval --full-image
       --proposals`` on a 32-image 480 x 640 ``make_hard_dataset`` set with
       the trainer's checkpoint at 480, bf16: 2 chain launches per dispatch,
       one NMS launch per image with the CPU plain NMS's keeps, the native
       RLE IoU on every image; images/s and the host split;
    3. the per-crop protocol on the same set at batch 32: every eligible
       instance, 2 chain launches per batch;
    4. ``python -m instancesegmentation_tpu_torch.infer`` in its three modes
       over 4 of those images (whole image at 512 on seeded ``Segment(3)``
       weights, ``--dataset-mode`` and ``--proposals`` on the trainer's
       checkpoint), and on 2 images in float32 against a ``device="cpu"``
       run of the same command (mask agreement >= 0.999)."""
    import glob
    import shutil

    from instancesegmentation_tpu_torch import eval as teval
    from instancesegmentation_tpu_torch.core import evaluation
    from instancesegmentation_tpu_torch.core.keys import key_combine
    from instancesegmentation_tpu_torch.core.png import read_png
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.data.synthetic import (
        make_hard_dataset,
        make_synthetic_dataset,
    )
    from instancesegmentation_tpu_torch.infer import cli, proposals
    from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
    from instancesegmentation_tpu_torch.ops import int8_conv as ic
    from instancesegmentation_tpu_torch.ops.native.build import load_native

    out = {"card": card}
    check(load_native() is not None, "eval: the native RLE library builds with the host's g++")

    # -- 1. quality on the committed checkpoint
    crossed = os.path.join(tmp, "crossed")
    make_synthetic_dataset(crossed, num_images=8, seed=300, crossed_pairs=True)
    demo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "crossed_demo.ckpt")
    quality = {}
    for dtype in ("float32", "bfloat16"):
        for cond in (True, False):
            r = teval.evaluate_full_image(crossed, demo, size=256, in_channels=20, canvas=320,
                                          bfloat16=dtype == "bfloat16", use_keypoints=cond)
            quality[f"{dtype}_{'conditioned' if cond else 'unconditioned'}"] = r
            check(r["num_predictions"] == r["num_gt_instances"] == 16 and r["num_images"] == 8,
                  f"crossed demo {dtype}: 16 predictions of 16 GTs on 8 images")
    f32c, f32u = quality["float32_conditioned"], quality["float32_unconditioned"]
    b16c, b16u = quality["bfloat16_conditioned"], quality["bfloat16_unconditioned"]
    out["crossed_demo"] = {k: {m: v[m] for m in ("AP", "AP50", "AP75")}
                           for k, v in quality.items()}
    out["crossed_demo"]["bf16_minus_f32_AP"] = {"conditioned": b16c["AP"] - f32c["AP"],
                                                "unconditioned": b16u["AP"] - f32u["AP"]}
    print(f"crossed demo checkpoint (8 crossed-pair images, 256 px): "
          f"{json.dumps(out['crossed_demo'])}")
    check(f32c["AP"] == 1.0, "crossed demo: float32 conditioned AP 1.0")
    check(f32u["AP75"] <= 0.2, "crossed demo: float32 unconditioned AP75 <= 0.2")
    # eval --int8 (int8_mxu, calibrated on the evaluated set), conditioned
    for dtype in ("float32", "bfloat16"):
        r = teval.evaluate_full_image(crossed, demo, size=256, in_channels=20, canvas=320,
                                      bfloat16=dtype == "bfloat16", int8=True)
        check(r["num_predictions"] == r["num_gt_instances"] == 16,
              f"crossed demo int8 {dtype}: 16 predictions of 16 GTs")
        out["crossed_demo"][f"{dtype}_conditioned_int8"] = {m: r[m] for m in ("AP", "AP50",
                                                                              "AP75")}
    print(f"crossed demo, eval --int8 (conditioned) beside float: "
          f"{json.dumps({k: v for k, v in out['crossed_demo'].items() if 'conditioned' in k})}")
    # eval --fused-stem (the keypoint-patch stem) through the command, float32
    fc.reset_launches()
    r = json.loads(_run_main(teval.main, ["--dataset", crossed, "--checkpoint", demo, "--size",
                                          "256", "--canvas", "320", "--float32", "--full-image",
                                          "--fused-stem"])[-1])
    out["crossed_demo"]["float32_conditioned_fused_stem"] = {m: r[m] for m in ("AP", "AP50",
                                                                               "AP75")}
    print(f"crossed demo, eval --fused-stem (float32): {json.dumps(r)}; AP {r['AP']} beside "
          f"the dense stem's {f32c['AP']}; chain launches {dict(fc.fused_chain.launches_by_form)}")
    check(r["num_predictions"] == r["num_gt_instances"] == 16 and r["AP"] == f32c["AP"],
          "crossed demo, eval --fused-stem: AP equal to the dense stem's")

    # -- 2. the full-image protocol at 480 on the hard set
    hard = os.path.join(tmp, "hard")
    t0 = time.perf_counter()
    make_hard_dataset(hard, num_images=EVAL_IMAGES, image_hw=EVAL_HW, seed=SEED)
    out["write_hard_set_s"] = time.perf_counter() - t0
    props_path = os.path.join(tmp, "proposals.json")
    out["proposals"] = hard_proposals(hard, props_path, SEED)

    host = {k: 0.0 for k in ("decode", "rle_encode", "predict", "nms", "ap", "engine_build")}
    nms_calls, predict_rows = [], []
    originals = {"imread": teval.imread, "rle_encode": teval.rle_encode,
                 "mask_ap_rle": teval.mask_ap_rle, "_build_engine": teval._build_engine}
    nms_keep, predict = proposals._nms_keep, InferenceEngine.predict_instances

    def timed(name, fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[name] += time.perf_counter() - t
        return wrapped

    def recorded_nms_keep(boxes, scores, thr, max_instances, device):
        keep = nms_keep(boxes, scores, thr, max_instances, device)  # ends in a host copy
        nms_calls.append((boxes, scores, thr, max_instances, keep))
        return keep

    def counted_predict(self, batch):
        predict_rows.append(int(batch["image"].shape[0]))
        return predict(self, batch)  # returns host arrays: synchronous

    teval.imread = timed("decode", originals["imread"])
    teval.rle_encode = timed("rle_encode", originals["rle_encode"])
    teval.mask_ap_rle = timed("ap", originals["mask_ap_rle"])
    teval._build_engine = timed("engine_build", originals["_build_engine"])
    proposals._nms_keep = timed("nms", recorded_nms_keep)
    InferenceEngine.predict_instances = timed("predict", counted_predict)
    native0, numpy0 = evaluation.mask_ap_rle.native_calls, evaluation.mask_ap_rle.numpy_calls
    try:
        nms_mod.nms.launches = 0
        fc.reset_launches()
        t0 = time.perf_counter()
        lines = _run_main(teval.main, ["--dataset", hard, "--full-image", "--proposals",
                                       props_path, "--size", str(EVAL_SIZE), "--nms-threshold",
                                       "0.7",
                                       "--max-instances", "16", "--checkpoint", trained_ckpt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        full_launches = {"nms": nms_mod.nms.launches,
                         "fused_chain": dict(fc.fused_chain.launches_by_form)}
    finally:
        for k, v in originals.items():
            setattr(teval, k, v)
        proposals._nms_keep, InferenceEngine.predict_instances = nms_keep, predict
    full = json.loads(lines[-1])
    dispatches = sum(-(-n // 128) for n in predict_rows)
    native = evaluation.mask_ap_rle.native_calls - native0
    numpy_path = evaluation.mask_ap_rle.numpy_calls - numpy0
    print(f"full-image eval (hard set, {EVAL_IMAGES} images {EVAL_HW}, {EVAL_SIZE} px bf16, "
          f"{out['proposals']['proposals']} proposals): {json.dumps(full)}; predict_instances "
          f"calls {predict_rows} in {dispatches} dispatches; launches {full_launches}; RLE IoU "
          f"native {native}, numpy {numpy_path}")
    check(full["protocol"] == "full_image" and full["num_images"] == EVAL_IMAGES
          and full["num_gt_instances"] == out["proposals"]["gt_boxes"]
          and 0 < full["num_predictions"] <= 16 * EVAL_IMAGES,
          "full-image eval: the counts of the dataset and its proposals")
    check(all(0.0 <= full[k] <= 1.0 for k in ("AP", "AP50", "AP75")), "full-image eval: AP in [0, 1]")
    check(full["num_predictions"] == sum(len(c[4]) for c in nms_calls),
          "full-image eval: one prediction per box NMS kept")
    check(full_launches["fused_chain"] == {"banded": 2 * dispatches, "banded_f32": 0, "simt": 0},
          "full-image eval: 2 banded chain launches per dispatch")
    check(full_launches["nms"] == len(nms_calls) == EVAL_IMAGES,
          "full-image eval: one nms launch per image")
    for boxes, scores, thr, k, keep in nms_calls:
        idx, valid = nms_mod.nms_reference(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                                           max_outputs=min(k, boxes.shape[0]))
        check(np.array_equal(idx[valid].numpy(), keep),
              "full-image eval: the keeps equal the plain NMS on the CPU")
    check(native == EVAL_IMAGES and numpy_path == 0,
          "full-image eval: the native RLE IoU matrix on every image, no numpy path")
    run_s = wall - host["engine_build"]
    out["full_image"] = dict(full, wall_s=wall, images_per_s=EVAL_IMAGES / run_s,
                             host_s=host, host_rest_s=run_s - sum(
                                 v for k, v in host.items() if k != "engine_build"),
                             predict_calls=predict_rows, dispatches=dispatches,
                             launches=full_launches, rle_native_calls=native,
                             rle_numpy_calls=numpy_path)
    print(f"full-image eval: {EVAL_IMAGES / run_s:.2f} images/s ({run_s:.3f} s without the "
          f"engine's build, {host['engine_build']:.3f} s); host split (s): "
          f"{json.dumps({k: round(v, 4) for k, v in host.items()})}; {card}")

    # the same run with --int8 (int8_mxu, calibrated on the set's first 2
    # batches of 8): 2 chain launches and 6 quantised convs (6 dense
    # int8_conv launches) per dispatch
    nms_mod.nms.launches = 0
    fc.reset_launches()
    ic.reset_launches()
    t0 = time.perf_counter()
    full8 = json.loads(_run_main(teval.main, ["--dataset", hard, "--full-image", "--proposals",
                                              props_path, "--size", str(EVAL_SIZE),
                                              "--nms-threshold", "0.7", "--max-instances", "16",
                                              "--checkpoint", trained_ckpt, "--int8"])[-1])
    torch.cuda.synchronize()
    full8_launches = {"nms": nms_mod.nms.launches,
                      "fused_chain": dict(fc.fused_chain.launches_by_form),
                      "int8_conv": dict(ic.int8_conv.launches_by_kernel)}
    dispatches8 = full8_launches["fused_chain"]["banded"] // 2
    out["full_image_int8"] = dict(full8, wall_s=time.perf_counter() - t0,
                                  launches=full8_launches, dispatches=dispatches8)
    print(f"full-image eval --int8 (hard set, {EVAL_SIZE} px bf16): {json.dumps(full8)}; "
          f"AP {full8['AP']} beside float {full['AP']}; launches {full8_launches}")
    check(full8["num_images"] == full["num_images"]
          and full8["num_gt_instances"] == full["num_gt_instances"]
          and 0 < full8["num_predictions"] <= 16 * EVAL_IMAGES,
          "full-image eval --int8: the counts of the dataset and its proposals")
    check(all(0.0 <= full8[k] <= 1.0 for k in ("AP", "AP50", "AP75")),
          "full-image eval --int8: AP in [0, 1]")
    check(dispatches8 > 0 and full8_launches["fused_chain"]["simt"] == 0
          and full8_launches["int8_conv"] == {"dense": 6 * dispatches8, "grouped": 0},
          "full-image eval --int8: 2 chain and 6 int8_conv launches per dispatch")

    # the same run with --fused-stem: one NMS launch per image, 2 chain
    # launches per dispatch
    nms_mod.nms.launches = 0
    fc.reset_launches()
    t0 = time.perf_counter()
    fullf = json.loads(_run_main(teval.main, ["--dataset", hard, "--full-image", "--proposals",
                                              props_path, "--size", str(EVAL_SIZE),
                                              "--nms-threshold", "0.7", "--max-instances", "16",
                                              "--checkpoint", trained_ckpt, "--fused-stem"])[-1])
    torch.cuda.synchronize()
    fullf_launches = {"nms": nms_mod.nms.launches,
                      "fused_chain": dict(fc.fused_chain.launches_by_form)}
    out["full_image_fused_stem"] = dict(fullf, wall_s=time.perf_counter() - t0,
                                        launches=fullf_launches)
    print(f"full-image eval --fused-stem (hard set, {EVAL_SIZE} px bf16): {json.dumps(fullf)}; "
          f"AP {fullf['AP']} beside the dense stem's {full['AP']}; launches {fullf_launches}")
    check(fullf["num_predictions"] == full["num_predictions"]
          and fullf["num_gt_instances"] == full["num_gt_instances"],
          "full-image eval --fused-stem: the counts of the dense run")
    check(fullf_launches == {"nms": EVAL_IMAGES, "fused_chain": full_launches["fused_chain"]},
          "full-image eval --fused-stem: one nms launch per image, 2 chain launches per dispatch")

    # -- 3. the per-crop protocol on the same set
    eligible = len(InstanceCommonDataset(hard))
    fc.reset_launches()
    t0 = time.perf_counter()
    crop = json.loads(_run_main(teval.main, ["--dataset", hard, "--batch", "32", "--size",
                                             str(EVAL_SIZE), "--checkpoint", trained_ckpt])[-1])
    torch.cuda.synchronize()
    crop_s = time.perf_counter() - t0
    crop_launches = dict(fc.fused_chain.launches_by_form)
    batches = -(-eligible // 32)
    print(f"per-crop eval (batch 32, {EVAL_SIZE} px bf16): {json.dumps(crop)}; {eligible} eligible "
          f"instances in {batches} batches; launches {crop_launches}; {crop_s:.2f} s")
    check(crop["num_instances"] == eligible, "per-crop eval: every eligible instance once")
    check(crop_launches == {"banded": 2 * batches, "banded_f32": 0, "simt": 0},
          "per-crop eval: 2 banded chain launches per batch")
    out["per_crop"] = dict(crop, eligible=eligible, batches=batches, launches=crop_launches,
                           wall_s=crop_s)

    # -- 4. the inference command's three modes over 4 images of the set
    sub = os.path.join(tmp, "hard_sub")
    shutil.copytree(hard, sub)
    for f in sorted(glob.glob(os.path.join(sub, "data", "*.json")))[CLI_IMAGES:]:
        os.remove(f)
    images = os.path.join(tmp, "cli_images")
    os.makedirs(images)
    for f in sorted(glob.glob(os.path.join(hard, "image", "*.png")))[:CLI_IMAGES]:
        shutil.copy(f, images)
    k_mask = key_combine("instance_mask", "mask_path")
    ds = InstanceCommonDataset(sub)
    modes = {
        "whole": ["-i", images, "--size", str(CLI_WHOLE_SIZE), "--batch", "8"],
        "dataset": ["-i", sub, "--dataset-mode", "--size", str(EVAL_SIZE), "--batch", "8",
                    "--checkpoint", trained_ckpt],
        "proposals": ["-i", images, "--proposals", props_path, "--size", str(EVAL_SIZE),
                      "--in-channels", "20", "--checkpoint", trained_ckpt],
    }
    cli_out = {}
    for mode, argv in modes.items():
        dest = os.path.join(tmp, f"cli_{mode}")
        nms_mod.nms.launches = 0
        fc.reset_launches()
        t0 = time.perf_counter()
        _run_main(cli.main, argv + ["-o", dest])
        torch.cuda.synchronize()
        files = sorted(os.path.relpath(os.path.join(d, f), dest)
                       for d, _, fs in os.walk(dest) for f in fs)
        cli_out[mode] = {"s": time.perf_counter() - t0, "files": len(files),
                         "launches": {"nms": nms_mod.nms.launches,
                                      "fused_chain": dict(fc.fused_chain.launches_by_form)}}
        check(files and all(read_png(os.path.join(dest, f), "gray").shape == EVAL_HW
                            for f in files), f"cli {mode}: masks at the images' size")
        if mode == "whole":
            check(files == [f"{i:05d}.png" for i in range(CLI_IMAGES)],
                  "cli whole: one mask per image")
        elif mode == "dataset":
            check(files == sorted(r[k_mask] for r in ds.records),
                  "cli dataset mode: the instance_mask/<image>/<i>.png layout")
        else:
            check(cli_out[mode]["launches"]["nms"] == CLI_IMAGES,
                  "cli proposals: one nms launch per image")
        check(cli_out[mode]["launches"]["fused_chain"]["banded"] > 0,
              f"cli {mode}: the banded chain kernel ran")
    print(f"inference command on the card: {json.dumps(cli_out)}")

    # infer --int8 in whole-image mode on the 4 images (calibrated on them)
    dest = os.path.join(tmp, "cli_whole_int8")
    fc.reset_launches()
    ic.reset_launches()
    lines = _run_main(cli.main, modes["whole"] + ["--int8", "-o", dest])
    files = sorted(os.listdir(dest))
    cli_out["whole_int8"] = {"files": len(files),
                             "fused_chain": dict(fc.fused_chain.launches_by_form),
                             "int8_conv": dict(ic.int8_conv.launches_by_kernel)}
    print(f"infer --int8, whole image ({CLI_IMAGES} images, {CLI_WHOLE_SIZE} px bf16): "
          f"{json.dumps(cli_out['whole_int8'])}")
    check("int8: calibrated 76 conv scales" in lines, "infer --int8: calibrated 76 scales")
    check(files == [f"{i:05d}.png" for i in range(CLI_IMAGES)]
          and all(read_png(os.path.join(dest, f), "gray").shape == EVAL_HW for f in files),
          "infer --int8 whole: one mask per image at its size")
    check(cli_out["whole_int8"]["int8_conv"] == {"dense": 6, "grouped": 0}
          and cli_out["whole_int8"]["fused_chain"]["banded"] == 2,
          "infer --int8 whole: one dispatch with 6 quantised convs and 2 chain launches")

    # card (float32) against a device="cpu" run of the same command, 2 images
    sub2 = os.path.join(tmp, "hard_sub2")
    shutil.copytree(sub, sub2)
    for f in sorted(glob.glob(os.path.join(sub2, "data", "*.json")))[CLI_VS_CPU_IMAGES:]:
        os.remove(f)
    images2 = os.path.join(tmp, "cli_images2")
    os.makedirs(images2)
    for f in sorted(glob.glob(os.path.join(images, "*.png")))[:CLI_VS_CPU_IMAGES]:
        shutil.copy(f, images2)
    vs_cpu = {}
    for mode, argv in modes.items():
        argv = [images2 if a == images else sub2 if a == sub else a for a in argv]
        dests = {d: os.path.join(tmp, f"vs_{mode}_{d}") for d in ("card", "cpu")}
        _run_main(cli.main, argv + ["--float32", "-o", dests["card"]])
        _run_main(cli.main, argv + ["--float32", "-o", dests["cpu"]], device="cpu")
        files = sorted(os.path.relpath(os.path.join(d, f), dests["card"])
                       for d, _, fs in os.walk(dests["card"]) for f in fs)
        check(files == sorted(os.path.relpath(os.path.join(d, f), dests["cpu"])
                              for d, _, fs in os.walk(dests["cpu"]) for f in fs),
              f"cli {mode} card vs CPU: the same files")
        agree = [float((read_png(os.path.join(dests["card"], f), "gray")
                        == read_png(os.path.join(dests["cpu"], f), "gray")).mean())
                 for f in files]
        vs_cpu[mode] = {"files": len(files), "mask_agreement_min": min(agree)}
        check(min(agree) >= 0.999, f"cli {mode} float32: card vs CPU mask agreement >= 0.999")
    # infer --fused-stem in dataset mode on the same 2 images, float32: the card
    # against the dense stem's masks on the card and the same command on the CPU
    argv = [sub2 if a == sub else a for a in modes["dataset"]] + ["--float32", "--fused-stem"]
    dests = {d: os.path.join(tmp, f"fused_dataset_{d}") for d in ("card", "cpu")}
    fc.reset_launches()
    _run_main(cli.main, argv + ["-o", dests["card"]])
    fused_launches = dict(fc.fused_chain.launches_by_form)
    _run_main(cli.main, argv + ["-o", dests["cpu"]], device="cpu")
    files = sorted(os.path.relpath(os.path.join(d, f), dests["card"])
                   for d, _, fs in os.walk(dests["card"]) for f in fs)
    dense_dir = os.path.join(tmp, "vs_dataset_card")
    agree = {k: min(float((read_png(os.path.join(dests["card"], f), "gray")
                           == read_png(os.path.join(other, f), "gray")).mean()) for f in files)
             for k, other in (("vs_dense_card", dense_dir), ("vs_cpu", dests["cpu"]))}
    vs_cpu["dataset_fused_stem"] = {"files": len(files), "launches": fused_launches,
                                    **{f"mask_agreement_min_{k}": v for k, v in agree.items()}}
    batches2 = -(-len(InstanceCommonDataset(sub2)) // 8)
    check(files and all(v >= 0.999 for v in agree.values())
          and fused_launches == {"banded": 0, "banded_f32": 2 * batches2, "simt": 0},
          "infer --fused-stem float32: masks >= 0.999 equal to the dense stem's and the CPU's")
    print(f"inference command float32, card vs CPU ({CLI_VS_CPU_IMAGES} images): "
          f"{json.dumps(vs_cpu)} (limit 0.999)")
    out["cli"] = cli_out
    out["cli_vs_cpu"] = vs_cpu
    print(json.dumps({"eval_and_cli": out}))
    return out


# -- the fused stems and the last serving and training options ---------------------------

REMAT_STEPS = 3  # train480 steps per run, with remat and without


def chrome_kernels(path: str, name: str) -> int:
    """Kernel spans in a Chrome trace whose name holds ``name``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("cat") == "kernel" and name in e.get("name", "") for e in events)


def kernel_breakdown(fn, calls: int = 3, top: int = 6) -> dict:
    """Device ms per call of ``fn`` by kernel name, from one
    ``torch.profiler`` trace of ``calls`` calls after a warm-up: the
    total, the kernels per call and the ``top`` largest (a trace that
    lost spans reads low)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name, kernels = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6 / calls
            kernels += 1
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms": sum(by_name.values()), "kernels_per_call": kernels / calls,
            "largest": [[name[:80], ms] for name, ms in largest]}


def patches_vs_dense(dev, size: int, g) -> dict:
    """``render_heatmap_patches`` against the card's own ``render_heatmaps`` at
    the instance program's shape: every patch equal to the dense stack's
    window bit for bit, and the stack zero outside the windows."""
    from instancesegmentation_tpu_torch.models.fused_stem_hm import render_heatmap_patches
    from instancesegmentation_tpu_torch.ops.heatmap import render_heatmaps

    pts = torch.rand((BATCH, 17, 2), generator=g, device=dev) * (size + 60) - 30
    pts[:, 0] = torch.tensor([2.0, 3.0], device=dev)                # clamped at 0
    pts[:, 1] = torch.tensor([size - 2.0, size - 3.0], device=dev)  # clamped at size - 1
    pts[:, 2] = float("nan")                                        # non-finite
    vis = torch.rand((BATCH, 17), generator=g, device=dev) > 0.2
    patches, x0, y0 = render_heatmap_patches(pts, vis, (size, size))
    dense = render_heatmaps(pts, vis, (size, size))
    p = patches.shape[1]
    grid = torch.arange(p, device=dev)
    rows = (y0[:, None, :] + grid[None, :, None])[:, :, None, :].expand(-1, -1, p, -1)
    cols = (x0[:, None, :] + grid[None, :, None])[:, None, :, :].expand(-1, p, -1, -1)
    n = torch.arange(BATCH, device=dev)[:, None, None, None]
    k = torch.arange(17, device=dev)[None, None, None, :]
    window = dense[n, rows, cols, k]
    covered = torch.zeros_like(dense, dtype=torch.bool)
    covered[n, rows, cols, k] = True
    out = {"patches": list(patches.shape), "equal": bool(torch.equal(window, patches)),
           "zero_outside": bool((dense[~covered] == 0).all()),
           "nonzero_values": int((patches > 0).sum())}
    check(out["equal"] and out["zero_outside"] and out["nonzero_values"] > 0,
          "render_heatmap_patches: bit-equal to the card's dense render")
    return out


@contextlib.contextmanager
def deterministic_algorithms():
    """Within the block cuDNN takes only its deterministic algorithms (its
    heuristics may otherwise pick a weight gradient that sums with atomics,
    so that two runs of one step differ in the last bits), and PyTorch's
    deterministic mode warns of any other op that has no deterministic form
    on the card; the block receives the list those warnings land in."""
    import warnings

    from torch.utils import deterministic as det

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False  # keep the step's time its own
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        det.fill_uninitialized_memory = saved[4]


def remat_runs(dev, tcfg, tbatch) -> dict:
    """train480 at batch 32: ``REMAT_STEPS`` steps without remat twice and
    with it once, from the same weights and draws, under
    ``deterministic_algorithms``; step ms, peak memory, and the memory a
    train forward holds for its backward with and without."""
    import dataclasses

    from instancesegmentation_tpu_torch.data.pipeline import (
        batch_to,
        draw_augment,
        preprocess_batch,
    )
    from instancesegmentation_tpu_torch.models.layers import init_weights_
    from instancesegmentation_tpu_torch.models.segment import Segment
    from instancesegmentation_tpu_torch.ops import warp_2level as w2
    from instancesegmentation_tpu_torch.train.state import TrainState
    from instancesegmentation_tpu_torch.train.steps import (
        augment_config,
        make_fwd,
        make_train_step,
    )

    runs = {}
    with deterministic_algorithms() as caught:
        for name, remat in (("plain_a", False), ("remat", True), ("plain_b", False)):
            cfg = dataclasses.replace(tcfg, remat=remat)
            aug = augment_config(cfg, train=True)
            model = Segment(20)
            init_weights_(model, torch.Generator().manual_seed(SEED))
            state = TrainState.create(model.to(dev), cfg.learning_rate)
            step = make_train_step(cfg)
            gen = torch.Generator(device=dev).manual_seed(SEED + 1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)
            w2.warp_2level.launches = 0
            losses, ms = [], []
            for _ in range(REMAT_STEPS):
                t0 = time.perf_counter()
                state, m = step(state, tbatch, draw_augment(TRAIN_BATCH, aug, gen))
                losses.append(float(m["loss"]))  # a host copy: the step has ended
                ms.append((time.perf_counter() - t0) * 1e3)
            runs[name] = {"losses": losses, "step_ms": ms,
                          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
                          "resident_before_bytes": resident,
                          "warp_2level": w2.warp_2level.launches,
                          "state": {k: v.detach().clone() for k, v in state.model.state_dict().items()
                                    if not k.endswith("num_batches_tracked")}}
            check(runs[name]["warp_2level"] == REMAT_STEPS,
                  f"train480 {name}: 1 warp_2level launch per step")
            del state, model
    flagged = sorted({str(w.message).splitlines()[0] for w in caught})
    print(f"train480 under deterministic algorithms: {len(flagged)} ops flagged as "
          f"nondeterministic{': ' + json.dumps(flagged) if flagged else ''}")
    a, b, r = (runs[k].pop("state") for k in ("plain_a", "plain_b", "remat"))
    spread = max((a[k] - b[k]).abs().max().item() for k in a)
    diff = max((r[k] - a[k]).abs().max().item() for k in a)
    # what each forward keeps for its backward: the memory a train forward
    # holds when it returns (a model of its own; its BN update is discarded)
    held = {}
    for name, remat in (("plain", False), ("remat", True)):
        cfg = dataclasses.replace(tcfg, remat=remat)
        aug = augment_config(cfg, train=True)
        model = Segment(20).to(dev)
        draws = draw_augment(TRAIN_BATCH, aug, torch.Generator(device=dev).manual_seed(SEED + 1))
        images, heatmaps, _ = preprocess_batch(batch_to(tbatch, dev), draws, aug)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        logits = make_fwd(model, cfg, train=True)(images, heatmaps)
        torch.cuda.synchronize()
        held[name] = torch.cuda.memory_allocated(dev) - before
        del logits, model
    out = {"runs": runs, "plain_spread_max_abs": spread, "remat_vs_plain_max_abs": diff,
           "forward_held_bytes": held, "flagged_nondeterministic": flagged,
           "first_loss_bit_equal": runs["remat"]["losses"][0] == runs["plain_a"]["losses"][0]}
    print(f"train480 remat (batch {TRAIN_BATCH}, {REMAT_STEPS} steps): losses without "
          f"{runs['plain_a']['losses']} / {runs['plain_b']['losses']}, with "
          f"{runs['remat']['losses']}; parameters and BN statistics: two runs without remat "
          f"differ by up to {spread:.3e}, remat from the first by {diff:.3e} (limit: twice "
          f"that spread, 0 if it is 0); step ms without {runs['plain_a']['step_ms']}, with "
          f"{runs['remat']['step_ms']}; max_memory_allocated without "
          f"{runs['plain_a']['max_memory_allocated_bytes'] / 2**30:.3f} GiB, with "
          f"{runs['remat']['max_memory_allocated_bytes'] / 2**30:.3f} GiB (of which resident "
          f"before the run {runs['remat']['resident_before_bytes'] / 2**30:.3f} GiB); held by "
          f"a train forward for its backward: without {held['plain'] / 2**30:.3f} GiB, with "
          f"{held['remat'] / 2**30:.3f} GiB")
    check(out["first_loss_bit_equal"], "remat: the first loss bit-equal to the step without")
    check(diff <= 2 * spread, f"remat: parameters and BN statistics within twice the spread "
                              f"of two runs without it (remat {diff:.3e}, spread {spread:.3e})")
    return out


def fused_stem_phase(dev, card: str, fc, sd20, batch, eng, eng32, probs, masks, probs32,
                     masks32, scales, tcfg, tbatch) -> dict:
    """The keypoint-patch stem (``fused_stem``), ``fold_bn=False`` and
    ``remat`` on the card:

    1. instance480 at batch 128 with ``fused_stem=True``, each main path read
       alone: bf16 (2 banded chain launches) against the dense bf16 engine
       (masks >= 0.98, mean abs prob diff <= 0.02), float32 (2 banded f32
       launches) against the dense float32 engine, TF32 off (max prob diff
       <= 1e-3, masks >= 0.999), float32 card against CPU on 2 rows (1e-2,
       0.999); ``quant`` (int8_mxu) with the fused stem: 4 quantised convs
       run, 4 int8_conv launches, 2 chain launches;
    2. the patches against the card's own dense render, bit for bit;
    3. ``fold_bn=False`` in float32: 0 chain launches, probabilities within
       JAX's bound of the folded engine's (atol 2e-3, rtol 1e-4);
    4. ``ParallelInferenceEngine(fused_stem=True)``, one bf16 replica:
       bit-equal to ``InferenceEngine(fused_stem=True)``;
    5. times in turns (CUDA events; img/s on the host clock): the dense and
       fused programs, the stem alone (``stem_hm_apply`` against
       ``render_heatmaps`` + ``init_conv``), the folded and unfolded float32
       programs; the heatmap bytes the fused stem does not move;
    6. ``utils/profiling.trace`` around one fused dispatch: a Chrome trace
       with the chain kernel's spans;
    7. train480 with ``remat`` (``remat_runs``): the first loss bit-equal,
       the state after 3 steps within twice the spread of two runs without
       it, 1 ``warp_2level`` launch per step, step ms and peak memory."""
    from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
    from instancesegmentation_tpu_torch.models.fused_stem_hm import stem_hm_apply
    from instancesegmentation_tpu_torch.ops import int8_conv as ic
    from instancesegmentation_tpu_torch.ops.heatmap import render_heatmaps
    from instancesegmentation_tpu_torch.parallel.inference import ParallelInferenceEngine
    from instancesegmentation_tpu_torch.utils import profiling

    out = {"card": card}
    n, size = len(probs), probs.shape[1]
    g = torch.Generator(device=dev).manual_seed(SEED + 14)

    # -- 1. the fused stem's main paths, each read alone
    fused = {"bf16": InferenceEngine(sd20, 20, size, torch.bfloat16, fused_stem=True, device=dev),
             "f32": InferenceEngine(sd20, 20, size, torch.float32, fused_stem=True, device=dev),
             "int8_mxu": InferenceEngine(sd20, 20, size, torch.bfloat16, fused_stem=True,
                                         quant=scales, device=dev)}
    serve, outputs = {}, {}
    for name, e in fused.items():
        fc.reset_launches()
        ic.reset_launches()
        outputs[name] = e.predict_instances(batch)  # this path, once
        serve[name] = {"fused_chain": dict(fc.fused_chain.launches_by_form),
                       "int8_conv": ic.int8_conv.launches}
    print(f"main path fused stem (instance {size}, batch {n}): launches {json.dumps(serve)}")
    check(serve["bf16"] == {"fused_chain": {"banded": 2, "banded_f32": 0, "simt": 0},
                            "int8_conv": 0}, "fused stem bf16: 2 banded chain launches")
    check(serve["f32"] == {"fused_chain": {"banded": 0, "banded_f32": 2, "simt": 0},
                           "int8_conv": 0}, "fused stem f32: 2 banded f32 chain launches")
    check(serve["int8_mxu"] == {"fused_chain": {"banded": 2, "banded_f32": 0, "simt": 0},
                                "int8_conv": 4},
          "fused stem int8_mxu: 4 quantised convs run (4 int8_conv launches), 2 chain launches")
    (pf, mf), (pf32, mf32), (p8, m8) = (outputs[k] for k in ("bf16", "f32", "int8_mxu"))
    for p in (pf, pf32, p8):
        check(p.shape == probs.shape and bool(np.isfinite(p).all()), "fused stem: finite probs")
    vs = {"bf16_mean_abs_prob_diff": float(np.abs(pf - probs).mean()),
          "bf16_mask_agreement": float((mf == masks).mean()),
          "f32_max_abs_prob_diff": float(np.abs(pf32 - probs32).max()),
          "f32_mask_agreement": float((mf32 == masks32).mean()),
          "int8_mxu_mask_agreement_vs_fused_bf16": float((m8 == mf).mean())}
    small = {k: v[:2] for k, v in batch.items()}
    p_cpu, m_cpu = InferenceEngine(sd20, 20, size, torch.float32, fused_stem=True,
                                   device="cpu").predict_instances(small)
    p_gpu, m_gpu = fused["f32"].predict_instances(small)
    vs.update(card_vs_cpu_max_abs_prob_diff=float(np.abs(p_gpu - p_cpu).max()),
              card_vs_cpu_mask_agreement=float((m_gpu == m_cpu).mean()))
    print(f"fused stem against the dense stem: {json.dumps(vs)} (limits: bf16 mean 0.02, masks "
          f"0.98; f32 max 1e-3, masks 0.999; card vs CPU f32 max 1e-2, masks 0.999; int8_mxu "
          f"masks 0.9)")
    check(vs["bf16_mean_abs_prob_diff"] <= 0.02 and vs["bf16_mask_agreement"] >= 0.98,
          "fused stem bf16 against the dense stem")
    check(vs["f32_max_abs_prob_diff"] <= 1e-3 and vs["f32_mask_agreement"] >= 0.999,
          "fused stem f32 against the dense stem")
    check(vs["card_vs_cpu_max_abs_prob_diff"] <= 1e-2 and vs["card_vs_cpu_mask_agreement"] >= 0.999,
          "fused stem f32: card against CPU")
    check(vs["int8_mxu_mask_agreement_vs_fused_bf16"] >= 0.9, "fused stem int8_mxu masks")
    out["serve"], out["vs_dense"] = serve, vs

    # -- 2. the patches against the card's dense render
    out["patches"] = patches_vs_dense(dev, size, g)

    # -- 3. fold_bn=False, float32
    unfolded = InferenceEngine(sd20, 20, size, torch.float32, fold_bn=False, device=dev)
    fc.reset_launches()
    pu, mu = unfolded.predict_instances(batch)
    unfolded_launches = fc.fused_chain.launches
    err = np.abs(pu - probs32)
    over = float((err - (2e-3 + 1e-4 * np.abs(probs32))).max())
    out["fold_bn_false"] = {"fused_chain": unfolded_launches, "max_abs_prob_diff": float(err.max()),
                            "worst_excess_over_bound": over,
                            "mask_agreement": float((mu == masks32).mean())}
    print(f"fold_bn=False (instance {size}, batch {n}, f32): {json.dumps(out['fold_bn_false'])} "
          f"(limits: 0 chain launches, probs within 2e-3 + 1e-4 |p| of the folded engine)")
    check(unfolded_launches == 0, "fold_bn=False: no chain launch")
    check(over <= 0, "fold_bn=False: probabilities within atol 2e-3, rtol 1e-4 of the folded")

    # -- 4. the replicated engine, one bf16 replica
    par = ParallelInferenceEngine(sd20, in_channels=20, size=size, dtype=torch.bfloat16,
                                  fused_stem=True, devices=[dev])
    fc.reset_launches()
    pp, pm = par.predict_instances(batch)
    out["parallel_launches"] = fc.fused_chain.launches
    check(np.array_equal(pp, pf) and np.array_equal(pm, mf) and out["parallel_launches"] == 2,
          "ParallelInferenceEngine(fused_stem=True), one replica: bit-equal, 2 chain launches")
    print("ParallelInferenceEngine(fused_stem=True), one bf16 replica: bit-equal to "
          "InferenceEngine(fused_stem=True), 2 chain launches")

    # -- 5. times, in turns
    keys = ("image", "mask", "image_hw", "obj_box", "mask_box", "mask_valid", "keypoints")
    dev_batch = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev) for k in keys]
    engines = {"dense": eng, "fused": fused["bf16"], "folded_f32": eng32,
               "unfolded_f32": unfolded}
    program = {k: [] for k in engines}
    img_s = {"dense": [], "fused": []}
    with torch.inference_mode():
        for name in ("dense", "fused", "fused", "dense", "folded_f32", "unfolded_f32",
                     "unfolded_f32", "folded_f32"):
            e = engines[name]
            program[name].append(cuda_ms(lambda: e._forward_instance(*dev_batch), iters=5))
            if name in img_s:
                e.predict_instances(batch)
                t0 = time.perf_counter()
                for _ in range(3):
                    e.predict_instances(batch)  # returns host arrays: synchronous
                img_s[name].append(3 * n / (time.perf_counter() - t0))
        x = torch.rand((n, size, size, 3), generator=g, device=dev).bfloat16() * 2 - 1
        pts = torch.rand((n, 17, 2), generator=g, device=dev) * size
        vis = torch.rand((n, 17), generator=g, device=dev) > 0.3
        init_conv = eng.model.init_conv
        stem_fold = fused["bf16"]._stem_fold

        def dense_stem():
            hm = render_heatmaps(pts, vis, (size, size)).to(torch.bfloat16)
            return init_conv(torch.cat([x, hm], -1).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last))

        stem = {"dense": [], "fused": []}
        for name in ("dense", "fused", "fused", "dense"):
            fn = dense_stem if name == "dense" else (
                lambda: stem_hm_apply(x, pts, vis, stem_fold, dtype=torch.bfloat16))
            stem[name].append(cuda_ms(fn, iters=5))
        got = stem_hm_apply(x, pts, vis, stem_fold, dtype=torch.bfloat16).float()
        want = dense_stem().permute(0, 2, 3, 1).float()
        stem_err = (got - want).abs().max().item()
        # where each stem's device time goes: kernels per call and the
        # largest kernels by device time (one trace of 3 calls each)
        breakdown = {name: kernel_breakdown(fn) for name, fn in (
            ("dense", dense_stem),
            ("fused", lambda: stem_hm_apply(x, pts, vis, stem_fold, dtype=torch.bfloat16)))}
    stack_bytes = n * size * size * 17 * 2
    print(f"stem device time by kernel (one trace, per call): {json.dumps(breakdown)}")
    out["times"] = {"program_ms_runs": program, "img_per_s_runs": img_s, "stem_ms_runs": stem,
                    "stem_breakdown": breakdown, "stem_max_abs_diff_bf16": stem_err,
                    "heatmap_stack_bytes": stack_bytes,
                    "heatmap_bytes_avoided": 2 * stack_bytes}
    print(f"time instance{size} batch {n}, in turns (CUDA events): program ms "
          f"{json.dumps(program)}; img/s host clock {json.dumps(img_s)}; the stem alone (dense "
          f"render + init_conv against stem_hm_apply, bf16) ms {json.dumps(stem)} (outputs within "
          f"{stem_err:.3g}); the dense bf16 heatmap stack {stack_bytes / 1e9:.3f} GB, written "
          f"and read back: {2 * stack_bytes / 1e9:.3f} GB the fused stem does not move; {card}")
    check(stem_err <= 0.05 * want.abs().max().item(),
          "stem_hm_apply computes the dense stem (bf16, within 5 % of its largest value)")

    # -- 6. utils/profiling.trace around one fused dispatch
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        spans = []
        for attempt in range(TRACE_ATTEMPTS):
            with profiling.trace(tmp):
                fused["bf16"].predict_instances(batch)
            path = os.path.join(tmp, f"trace{attempt:04d}.pt.trace.json")
            spans.append(chrome_kernels(path, "fused_chain_banded"))
            if spans[-1] == 2:
                break
        out["trace"] = {"chain_kernel_spans_per_trace": spans,
                        "bytes": os.path.getsize(path)}
    print(f"utils/profiling.trace around one fused dispatch: chain kernel spans per trace {spans}")
    check(max(spans) > 0, "utils/profiling.trace: the chain kernel's spans in the trace")

    # -- 7. remat
    out["remat"] = remat_runs(dev, tcfg, tbatch)
    print(json.dumps({"fused_stem": out}))
    return out


TEXT_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "text",
                             "labels.npz")


def visual_qa_phase(dev, card: str, w2) -> dict:
    """The labels and the QA tool: ``core/text.py`` (the fonts from the
    package's own files, ``ops/native/text.cpp`` built with g++ here) holds
    every case of ``tests/data/text/labels.npz`` bit-equal to the cv2 output
    stored there (``draw_label`` and ``draw_keypoint(labeled=True)``; the
    labels with characters Rubik lacks drawn with the fallback font or as
    its "?"), and times a CJK label beside "person"; then
    ``tools/show_aug.py``'s port over a synthetic 480 x 640 dataset that the
    port writes here: ``show-dataset`` (one grid per record) and ``show-aug
    --rotate 25`` at its defaults on ``cuda:0`` (``preprocess_batch`` at
    batch 1, one ``warp_2level`` launch per grid), its grids held against the
    same run on the CPU with the card's draws (at most 1 off on the 0-255
    scale in at most 1 % of the values: the kernel's 1e-2 against its plain
    version; an overlay pixel whose mask value crosses the overlay's
    threshold of 127 may differ by the blend, in at most 0.1 % of the mask
    pixels); ms per label, per labeled skeleton and per grid, host clock."""
    from instancesegmentation_tpu_torch.core import text as ttext
    from instancesegmentation_tpu_torch.core import visualize as tvis
    from instancesegmentation_tpu_torch.core.png import read_png
    from instancesegmentation_tpu_torch.data.pipeline import draw_augment
    from instancesegmentation_tpu_torch.data.synthetic import make_synthetic_dataset
    from instancesegmentation_tpu_torch.tools import show_aug

    t0 = time.perf_counter()
    ttext._load()
    rubik = ttext.load_font()
    out = {"card": card, "build_and_font_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ttext.load_font(ttext.FALLBACK)
    out["fallback_font_s"] = time.perf_counter() - t0
    fixtures = np.load(TEXT_FIXTURES)
    cases = sorted(int(k[5:]) for k in fixtures.files if k.startswith("case_"))
    check(len(cases) >= 60, "visual QA: the committed text fixtures are present")
    n_labels = n_skeletons = n_fallback = 0
    skeleton = None
    for k in cases:
        case, bg = json.loads(str(fixtures[f"case_{k}"])), fixtures[f"bg_{k}"]
        if "label" in case:
            got = tvis.draw_label(bg.copy(), case["label"], case["origin"],
                                  color=tuple(case["color"]), thickness=case["thickness"],
                                  scale=case["scale"])
            n_labels += 1
            n_fallback += any(ord(c) not in rubik.cmap for c in case["label"].replace("\n", ""))
        else:
            skeleton = case["keypoints"]
            got = tvis.draw_keypoint(bg.copy(), case["keypoints"], labeled=True,
                                     radius=case["radius"])
            n_skeletons += 1
        check(np.array_equal(got, fixtures[f"out_{k}"]),
              f"visual QA: text fixture {k} ({case.get('label', 'keypoints')!r}) equals cv2's")
    check(n_fallback >= 14, f"visual QA: {n_fallback} stored labels need the fallback font")
    out["fixtures"] = {"labels": n_labels, "fallback_font_labels": n_fallback,
                       "labeled_skeletons": n_skeletons, "bit_equal": True}
    print(f"visual QA: {n_labels} labels ({n_fallback} of them with characters Rubik lacks: "
          f"WenQuanYi Micro Hei and the '?' of characters in neither font) and {n_skeletons} "
          f"labeled skeletons bit-equal to cv2's stored outputs (Rubik and text.cpp ready in "
          f"{out['build_and_font_s']:.2f} s, the fallback font read in "
          f"{out['fallback_font_s']:.3f} s)")

    # host times of the labels on a 480 x 640 RGB image ("pedestrian" in
    # Chinese beside "person"; its first call parses its two glyphs)
    img = np.full((480, 640, 3), 90, np.uint8)
    cjk = "\u884c\u4eba"
    ttext.face_glyph.cache_clear()
    ttext.glyph_bitmap.cache_clear()
    ttext.glyph_outline.cache_clear()
    t0 = time.perf_counter()
    tvis.draw_label(img, cjk, (4, 60))
    out["label_cjk_first_ms"] = (time.perf_counter() - t0) * 1e3
    for name, fn, iters in (
            ("label_person_ms", lambda: tvis.draw_label(img, "person", (4, 4)), 400),
            ("label_cjk_ms", lambda: tvis.draw_label(img, cjk, (4, 60)), 400),
            ("label_left_shoulder_035_ms",
             lambda: tvis.draw_label(img, "left_shoulder", (40, 40), scale=0.35), 400),
            ("labeled_skeleton_ms", lambda: tvis.draw_keypoint(img, skeleton, labeled=True), 100)):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = (time.perf_counter() - t0) / iters * 1e3

    with tempfile.TemporaryDirectory(prefix="chip_smoke_qa_") as tmp:
        data = make_synthetic_dataset(os.path.join(tmp, "data"), num_images=8, image_hw=(480, 640),
                                      seed=19)
        t0 = time.perf_counter()
        show_aug.main(["show-dataset", data, os.path.join(tmp, "ds"), "--limit", "8"])
        n_ds = len(os.listdir(os.path.join(tmp, "ds")))
        out["show_dataset_ms_per_grid"] = (time.perf_counter() - t0) / max(n_ds, 1) * 1e3
        check(n_ds == 8, "visual QA: show-dataset wrote one grid per record")
        grid = read_png(os.path.join(tmp, "ds", "dataset_0000.png"))
        check(grid.shape == (480, 640 * 3, 3), "visual QA: show-dataset grid of three panels")

        argv = ["show-aug", data, os.path.join(tmp, "card"), "--limit", "8", "--rotate", "25",
                "--seed", "3"]
        show_aug.main(argv[:2] + [os.path.join(tmp, "warm"), "--limit", "1", "--rotate", "25"])
        w2.warp_2level.launches = 0
        t0 = time.perf_counter()
        show_aug.main(argv)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = w2.warp_2level.launches
        n_aug = len(os.listdir(os.path.join(tmp, "card")))
        check(n_aug == 8 and launches == n_aug,
              f"visual QA: show-aug --rotate 25 on the card: {launches} warp_2level launches "
              f"for {n_aug} grids (one each)")

        def card_draws(i, cfg):
            g = torch.Generator(device=dev).manual_seed(3 + i)
            return {k: None if v is None else v.cpu()
                    for k, v in draw_augment(1, cfg, g).items()}

        w2.warp_2level.launches = 0
        t0 = time.perf_counter()
        show_aug.show_aug(data, os.path.join(tmp, "cpu"), limit=8, rotate=25.0, seed=3,
                          device="cpu", draws=card_draws)
        cpu_s = time.perf_counter() - t0
        check(w2.warp_2level.launches == 0, "visual QA: the CPU run launches no kernel")
        worst, share, flips = 0, 0.0, 0
        for i in range(n_aug):
            name = f"aug_{i:04d}.png"
            a = read_png(os.path.join(tmp, "card", name)).astype(np.int16)
            b = read_png(os.path.join(tmp, "cpu", name)).astype(np.int16)
            check(a.shape == b.shape == (480, 480 * 4, 3), f"visual QA: {name} shape")
            # panels: image | overlay | mask | heatmap max; the overlay blends
            # where the mask is above 127, so a mask value that the kernel's
            # 1e-2 moves across 127.5 changes that overlay pixel by the blend
            diff = np.abs(a - b)
            crossed = (a[:, 960:1440, 0] > 127) != (b[:, 960:1440, 0] > 127)
            flips += int(crossed.sum())
            diff[:, 480:960][crossed] = 0
            worst, share = max(worst, int(diff.max())), max(share, float((diff > 0).mean()))
        check(worst <= 1 and share <= 1e-2,
              f"visual QA: show-aug card grids against the CPU's: max diff {worst}, "
              f"share {share:.2e} (limits 1, 1e-2) outside {flips} overlay pixels whose "
              "mask crosses the overlay's threshold")
        check(flips <= 1e-3 * n_aug * 480 * 480,
              f"visual QA: {flips} mask pixels cross the overlay's threshold (limit 0.1 %)")
        out["show_aug"] = {"grids": n_aug, "warp_2level_launches": launches,
                           "card_ms_per_grid": card_s / n_aug * 1e3,
                           "cpu_ms_per_grid": cpu_s / n_aug * 1e3,
                           "max_abs_diff_vs_cpu": worst, "share_differing_vs_cpu": share,
                           "overlay_threshold_flips_vs_cpu": flips}
    print(f"visual QA ({card}): draw_label 'person' {out['label_person_ms']:.4f} ms, "
          f"{cjk!r} (CJK, fallback font) {out['label_cjk_ms']:.4f} ms "
          f"({out['label_cjk_first_ms']:.3f} ms the first time), 'left_shoulder' at 0.35 {out['label_left_shoulder_035_ms']:.4f} ms, a labeled "
          f"17-point skeleton {out['labeled_skeleton_ms']:.4f} ms; show-dataset "
          f"{out['show_dataset_ms_per_grid']:.2f} ms per grid; show-aug --rotate 25 "
          f"{out['show_aug']['card_ms_per_grid']:.2f} ms per grid on the card, "
          f"{out['show_aug']['cpu_ms_per_grid']:.2f} on the CPU, {launches} warp_2level "
          f"launches, card vs CPU max diff {worst} in {share:.2e} of the values and {flips} "
          "overlay pixels across the mask threshold (host clock)")
    print(json.dumps({"visual_qa": out}))
    return out


def warp_hard_cases(w2, wargs, plan, scale_x_max: float) -> dict:
    """The sweep (``warp_2level_fused``) against the tiled kernel, bit for
    bit, one launch per call, on inputs beyond the training draws: every
    sample at +-25 deg and +-``scale_x_max`` (the plan's bounds), batch 1 and
    33, an output width that is not a multiple of the strip, a canvas 638
    pixels wide (rows of 1,914 bytes) whose image and mask start 5 and 3
    bytes past an aligned address, a NaN sample, and plans too small for
    the samples (a ring a third of the plan's and one of 8 rows: halved
    steps and rows read straight from pass 1; stage buffers of 3 rows of 16
    bytes: rows staged in pieces or read from device memory).  Within 1e-2
    of the plain version where that has no NaN."""
    image, mask, params, out_hw, theta, block = wargs
    b = image.shape[0]
    th = torch.tensor([math.radians(theta), -math.radians(theta)] * (b // 2) + [0.0] * (b % 2),
                      device=image.device)
    sign = torch.tensor([1.0, -1.0], device=image.device).repeat(b // 2 + 1)[:b]
    bound = params._replace(
        scale=torch.stack([torch.full_like(sign, scale_x_max), sign * scale_x_max], 1),
        cos_sin=torch.stack([torch.cos(th), torch.sin(th)], 1))
    cat33 = type(params)(*(torch.cat([f, f[:1]]) for f in params))

    def offset_copy(t, skip):
        buf = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
        view = buf[skip:].view(t.shape)
        view.copy_(t)
        return view

    narrow = (offset_copy(image[:, :, :638].contiguous(), 5),
              offset_copy(mask[:, :, :638].contiguous(), 3))
    nan = params.cos_sin.clone()
    nan[3, 0] = float("nan")
    cases = {
        "pm25_at_scale_bound": (image, mask, bound, out_hw, None),
        "batch1": (image[:1], mask[:1], type(params)(*(f[:1] for f in params)), out_hw, None),
        "batch33": (torch.cat([image, image[:1]]), torch.cat([mask, mask[:1]]), cat33, out_hw,
                    None),
        "out_w_470": (image, mask, params, (out_hw[0], 470), None),
        "stride_1914_unaligned": (*narrow, params, out_hw, None),
        "nan_sample": (image, mask, params._replace(cos_sin=nan), out_hw, None),
        "small_ring": (image, mask, params, out_hw, plan._replace(ring_rows=plan.ring_rows // 3)),
        "ring_8_rows": (image, mask, params, out_hw, plan._replace(ring_rows=8)),
        "small_stage": (image, mask, params, out_hw,
                        plan._replace(stage_rows=3, stage_rgb=16, stage_mask=16)),
    }
    out = {}
    for name, (img, msk, prm, hw, small) in cases.items():
        tiled = w2.warp_2level(img, msk, prm, hw, theta, block)
        before = w2.warp_2level_fused.launches
        if small is None:
            sweep = w2.warp_2level_fused(img, msk, prm, hw, theta, block)
        else:
            sweep = w2._sweep(img, msk, prm, hw, theta, block, None, small)
        check(w2.warp_2level_fused.launches == before + 1,
              f"warp_2level_fused {name}: one launch per call")
        check(bool(torch.isfinite(sweep).all()), f"warp_2level_fused {name}: finite")
        exact((tiled,), (sweep,), f"warp_2level vs warp_2level_fused, {name} (bit-equal)")
        err = None
        if name != "nan_sample":
            err = max_err(sweep, w2.warp_2level_reference(img, msk, prm, hw, theta, block), 1e-2,
                          0.0, f"warp_2level_fused {name} {list(sweep.shape)}")
        out[name] = {"shape": list(sweep.shape), "bit_equal_to_tiled": True,
                     "max_abs_err_vs_plain": err}
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

    tf32_off()
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
    # two banded chain kernels, the nms kernel, both warp kernels (tiled and
    # the sweep), roi_align's order and gather (its first instantiation) and
    # the cluster matcher
    ptxas = {}
    for src, kernel in (("fused_chain.cu", "fused_chain_banded_kernel"),
                        ("fused_chain.cu", "fused_chain_banded_f32_kernel"),
                        ("nms.cu", "nms_kernel"), ("warp_2level.cu", "warp_2level_tiled_kernel"),
                        ("warp_2level.cu", "warp_2level_sweep_kernel"),
                        ("roi_align.cu", "roi_order_kernel"),
                        ("roi_align.cu", "roi_align_kernel"),
                        ("matching.cu", "match_cluster_kernel")):
        log = _build.build_log.get(src)
        if log is None:
            print(f"{src} was built before this run: no ptxas report")
            continue
        ptxas[kernel] = ptxas_report(log, kernel)
        print(f"ptxas {kernel}: {ptxas[kernel]}")
        # the kernel's own line (device functions it calls report theirs after it)
        own = next((part for part in ptxas[kernel].split(" | ") if "spill" in part), "")
        check(not own or "0 bytes spill stores, 0 bytes spill loads" in own,
              f"{kernel} spills registers")
    # the int8 conv's instantiations (input, output type, N tiles), each
    # checked for spills, and the dense ones' tensor-core MMAs in the SASS
    if "int8_conv.cu" in _build.build_log:
        for kernel in ("int8_conv_dense_kernel", "int8_conv_grouped_kernel"):
            ptxas[kernel] = int8_ptxas(_build.build_log["int8_conv.cu"], kernel)
            print(f"ptxas {kernel}: {json.dumps(ptxas[kernel])}")
            check(ptxas[kernel]["instances"] > 0 and not ptxas[kernel]["spilling"],
                  f"{kernel}: every instantiation built without spills")
    ptxas["int8_conv_dense_kernel_sass"] = int8_sass_mma()
    print(f"sass int8_conv_dense_kernel: {json.dumps(ptxas['int8_conv_dense_kernel_sass'])}")
    check(ptxas["int8_conv_dense_kernel_sass"]["instances"] > 0
          and ptxas["int8_conv_dense_kernel_sass"]["without_imma"] == 0,
          "int8_conv_dense_kernel: every instantiation issues the int8 tensor-core MMA (IMMA)")

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
    sweep_plan = w2.plan_sweep(float(aug.rotate), aug.rotate_block,
                               (tcfg.canvas + 2 * SRC_PAD) / aug.out_size[1], tuple(aug.out_size))
    print(f"warp_2level_fused sweep plan: {sweep_plan._asdict()}, "
          f"{sweep_plan.smem_bytes} bytes of dynamic shared memory per CTA")
    # one launch, and no device memory beyond the output, also at the peak
    torch.cuda.synchronize()
    before, mem0 = w2.warp_2level_fused.launches, torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused = w2.warp_2level_fused(*wargs)
    torch.cuda.synchronize()
    out_bytes = -(-fused.numel() * 4 // 512) * 512
    fused_mem = {"out_bytes": out_bytes, "delta": torch.cuda.memory_allocated() - mem0,
                 "peak_delta": torch.cuda.max_memory_allocated() - mem0}
    print(f"warp_2level_fused: device memory of one call {fused_mem}")
    check(w2.warp_2level_fused.launches == before + 1, "warp_2level_fused: one launch per call")
    check(fused_mem["delta"] == fused_mem["peak_delta"] == out_bytes,
          "warp_2level_fused: no device allocation beyond the output")
    errs["warp_2level_fused"] = max_err(fused, want, 1e-2, 0.0, f"warp_2level_fused {shape}")
    exact((tiled,), (fused,), "warp_2level vs warp_2level_fused (bit-equal)")
    warp_hard = warp_hard_cases(w2, wargs, sweep_plan, float(tcfg.canvas + 2 * SRC_PAD)
                                / aug.out_size[1])
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

    # the trainer from disk to a served checkpoint (its own launch counts),
    # then evaluation and the inference command on that checkpoint
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as eval_tmp:
        trained = os.path.join(eval_tmp, "trained.ckpt")
        disk = trainer_from_disk(dev, card, w2, fc, trained)
        jpeg = jpeg_phase(card, disk["read_png_ms_480x640_rgb"])
        image_forms_phase(card, disk["read_png_ms_480x640_rgb"])
        tiff = tiff_phase(card, w2, fc, disk["read_png_ms_480x640_rgb"])
        webp = webp_phase(card, w2, fc, disk["read_png_ms_480x640_rgb"])
        j2k = jpeg2000_phase(card, w2, fc, disk["read_png_ms_480x640_rgb"])
        avif = avif_phase(card, w2, fc, disk["read_png_ms_480x640_rgb"])
        enc = encoders_phase(card, w2, fc)
        wenc = webp_encoder_phase(card, w2, fc, enc)
        jenc = jpeg2000_encoder_phase(card, w2, fc, enc)
        conv = converters_phase(dev, card, w2, fc, jpeg)
        evals = eval_and_cli(card, fc, nms, trained, eval_tmp)

    # the parallel modules: two gloo ranks on the card, the replicated
    # engine, and the data-parallel step's times over one NCCL rank
    par = parallel_phase(dev, card, fc, w2, sd20, batch, probs, masks, probs32, masks32,
                         tcfg, tbatch, draws)

    # int8 post-training quantisation: calibration, the int8 conv kernel on
    # every conv, and the int8_mxu and int8 main paths
    q8 = int8_phase(dev, card, fc, sd20, sd3, batch, probs, masks)
    q8["ragged"] = int8_ragged_phase(dev)

    # the fused stem, fold_bn=False and remat: their main paths, checks and times
    fstem = fused_stem_phase(dev, card, fc, sd20, batch, eng, eng32, probs, masks, probs32,
                             masks32, q8["scales"], tcfg, tbatch)

    # the labels (cv2 5.0's TrueType putText) and the show_aug QA tool
    vqa = visual_qa_phase(dev, card, w2)

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
    fused_kernel = device_ms(lambda: w2.warp_2level_fused(*wargs), "warp_2level_sweep_kernel")
    # the two warp kernels in turns (tiled, sweep, sweep, tiled): kernel
    # device ms and call ms
    warp_turns = {"tiled": [], "sweep": []}
    for name in ("tiled", "sweep", "sweep", "tiled"):
        run, kname = ((functools.partial(w2.warp_2level, *wargs), "warp_2level_tiled_kernel")
                      if name == "tiled" else
                      (functools.partial(w2.warp_2level_fused, *wargs), "warp_2level_sweep_kernel"))
        warp_turns[name].append({"kernel_ms": device_ms(run, kname), "call_ms": cuda_ms(run, 20)})
    print(f"warp kernels in turns (tiled, sweep, sweep, tiled): {json.dumps(warp_turns)}")
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
             "warp_turns": warp_turns, "warp_2level_fused_plan": sweep_plan._asdict(),
             "warp_2level_fused_memory": fused_mem, "warp_2level_fused_hard_cases": warp_hard,
             "warp_plain_ms": warp_plain, "warp_bound_ms": warp_bound, "warp_bound_by": warp_by,
             "grid_sample_yardstick_ms": grid_ms, "step_vs_cpu": step_vs_cpu}
    print(f"time train step [{TRAIN_BATCH}, 640 -> 480] bf16: {step_ms:.2f} ms "
          f"({TRAIN_BATCH / step_ms * 1e3:.1f} img/s), of which preprocessing {pre_ms:.2f} ms, "
          f"warp_2level {warp_ms:.3f} ms per call, kernel {warp_kernel:.4f} ms (fused, the "
          f"sweep, {fused_ms:.3f} ms, kernel {fused_kernel:.4f} ms; plain {warp_plain:.2f} ms, bound "
          f"{warp_bound:.4f} ms by {warp_by}; grid_sample yardstick {grid_ms:.3f} ms)")
    print(json.dumps({"train_bf16_480": train, "card": card}))

    print(f"profiler traces: {json.dumps(trace_stats)}")

    # -- 6. summary ----------------------------------------------------------
    # every pool is closed by now: only the fork server and the resource
    # tracker may be left, with no child of their own; stop both, then
    # nothing this run started may still be alive
    from instancesegmentation_tpu_torch.data.grain_loader import stop_fork_server

    workers = {c: child_pids(c) for c in child_pids()}
    check(not any(workers.values()), f"worker processes left running: {workers}")
    stop_fork_server()
    check(not child_pids(), f"processes left running: {child_pids()}")
    print(f"processes: {len(workers)} helper(s) stopped, none left")
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
         "launches_eval": (evals["full_image"]["launches"]["fused_chain"]["banded"]
                           + evals["per_crop"]["launches"]["banded"]),
         "launches_parallel_engine": par["engine"]["launches"],
         "launches_converters_serve": conv["serve"]["fused_chain"],
         "launches_webp_serve": webp["serve"]["fused_chain"],
         "launches_jpeg2000_serve": j2k["serve"]["fused_chain"],
         "launches_avif_serve": avif["serve"]["fused_chain"],
         "launches_avif_pil480_serve": avif["pil480"]["serve"]["fused_chain"],
         "launches_encoders_serve": enc["serve"]["fused_chain"],
         "launches_encoders_c12_infer": enc["c12"]["renamed"]["fused_chain"],
         "launches_webp_named_serve": wenc["serve"]["fused_chain"],
         "launches_webp_named_infer": wenc["infer"]["renamed"]["fused_chain"],
         "launches_jp2_named_serve": jenc["serve"]["fused_chain"],
         "launches_jp2_named_infer": jenc["infer"]["renamed"]["fused_chain"],
         "launches_tiff_serve": tiff["serve"]["fused_chain"],
         "launches_fused_stem": fstem["serve"]["bf16"]["fused_chain"]["banded"],
         "launches_fused_stem_parallel_replica": fstem["parallel_launches"],
         "launches_fold_bn_false": fstem["fold_bn_false"]["fused_chain"],
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
         "launches_eval": evals["full_image"]["launches"]["nms"],
         "launches_eval_fused_stem": evals["full_image_fused_stem"]["launches"]["nms"],
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
         "launches_trainer_from_disk_by_loader": {
             name: [round(r["warp_2level_per_step"] * disk["steps"]) for r in rs]
             for name, rs in disk["loaders"].items()},
         "launches_trainer_from_disk_orbax": disk["orbax"]["warp_2level_launches"],
         "launches_dp_trainer_world1": disk["dp_launches"]["warp_2level"],
         "launches_dp_step_world1": par["train_world1_nccl"]["launches_per_step"]["warp_2level"],
         "launches_dp_gloo_per_rank": par["gloo_two_ranks"]["warp_2level_per_rank"],
         "launches_converters_train": {k: v["warp_2level"] for k, v in conv["train"].items()},
         "launches_webp_train": webp["train"]["warp_2level"],
         "launches_jpeg2000_train": j2k["train"]["warp_2level"],
         "launches_avif_train": avif["train"]["warp_2level"],
         "launches_avif_pil480_train": avif["pil480"]["train"]["warp_2level"],
         "launches_encoders_train": enc["train"]["warp_2level"],
         "launches_webp_named_train": wenc["train"]["warp_2level"],
         "launches_jp2_named_train": jenc["train"]["warp_2level"],
         "launches_tiff_train": tiff["train"]["warp_2level"],
         "launches_remat_train": fstem["remat"]["runs"]["remat"]["warp_2level"],
         "launches_show_aug_rotate": vqa["show_aug"]["warp_2level_launches"],
         "max_abs_err": errs["warp_2level"],
         "ms": warp_ms, "kernel_ms": warp_kernel, "plain_ms": warp_plain,
         "bound_ms": warp_bound, "bound_by": warp_by, "library_ms": None,
         "grid_sample_yardstick_ms": grid_ms, "shape": shape, "tile_plan": plan._asdict(),
         "ptxas": ptxas.get("warp_2level_tiled_kernel")},
        {"name": "int8_conv", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/int8_conv.cu",
         "replaces": None,
         "counterpart": "instancesegmentation_tpu/models/layers.py:85 _Int8Conv (an XLA conv, "
                        "no Pallas kernel)",
         "on_main_path": True,
         "launches": q8["serve"]["int8_mxu"]["int8_conv"],
         "launches_by_kernel": q8["serve"]["int8_mxu"]["int8_conv_by_kernel"],
         "launches_int8_mode": q8["serve"]["int8"]["int8_conv"],
         "launches_int8_mode_by_kernel": q8["serve"]["int8"]["int8_conv_by_kernel"],
         "launches_per_conv": {m: q8["serve"][m]["launches_per_conv"]
                               for m in ("int8_mxu", "int8")},
         "launches_eval_full_image_int8": evals["full_image_int8"]["launches"]["int8_conv"],
         "launches_infer_whole_int8": evals["cli"]["whole_int8"]["int8_conv"],
         "launches_int8_mxu_fused_stem": fstem["serve"]["int8_mxu"]["int8_conv"],
         "max_abs_err": 0.0,
         **{k: q8["sum_int8_mxu"][k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms",
                                               "bound_by")},
         "library_ms": q8["sum_int8_mxu"]["int_mm_ms"],
         "library": "torch._int_mm over an int8 im2col, on the convs it takes "
                    f"({q8['sum_int8_mxu']['int_mm_convs']} of {q8['sum_int8_mxu']['convs']}; "
                    "the kernel on those: ms_same_convs_as_int_mm), a yardstick only",
         **{k: q8["sum_int8_mxu"][k] for k in ("int_mm_kernel_ms", "ms_same_convs_as_int_mm",
                                               "kernel_ms_same_convs_as_int_mm")},
         "int8_mode": q8["sum_int8"], "shape": [BATCH, 480, 480, 20], "dtype": "bfloat16",
         "ragged": q8["ragged"],
         "ptxas": {k: ptxas.get(k) for k in ("int8_conv_dense_kernel", "int8_conv_grouped_kernel",
                                             "int8_conv_dense_kernel_sass")},
         "parts": q8["parts"]},
        {"name": "warp_2level_fused", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/warp_2level.cu",
         "replaces": "tools/rot_pallas_probe.py:211",
         "launches": fused_launches, "on_main_path": False,
         "max_abs_err": errs["warp_2level_fused"], "ms": fused_ms, "kernel_ms": fused_kernel,
         "plain_ms": warp_plain,
         "bound_ms": warp_bound, "bound_by": warp_by, "library_ms": None,
         "grid_sample_yardstick_ms": grid_ms, "shape": shape,
         "plan": sweep_plan._asdict(), "turns_with_tiled": warp_turns, "memory": fused_mem,
         "hard_cases": sorted(warp_hard), "ptxas": ptxas.get("warp_2level_sweep_kernel")},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-worker"] and torch.cuda.is_available():
        sys.exit(gloo_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
