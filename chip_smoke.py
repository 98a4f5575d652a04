"""Smoke run of the PyTorch/CUDA port (``instancesegmentation_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero; nothing is caught and continued):

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``instancesegmentation_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   serving shapes, with TF32 off: the chain kernel on the section-1 and
   section-2+3 specs of the 480 px program in float32 (atol 1e-3 plus rtol
   1e-4 of the reference's magnitude: the sums run in another order) and
   bfloat16 I/O (atol 0.1, rtol 0.1), and ``bottleneck3x3_fused`` in float32
   (atol 1e-3, rtol 1e-4);
4. serve at full width from seeded random weights with random running
   statistics: the 20-channel instance program at 480 px over a batch of 128
   in bfloat16 (with the launch counts read around that one dispatch),
   the same engine in float32 on the card, a float32 CPU engine on two rows
   of the batch, a few requests through ``ServingFrontend``, and the 3-channel
   whole-image program at 512 px over 128 images;
5. time each kernel and its plain version with CUDA events at batch 128, and
   the two programs end to end;
6. print the per-kernel JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
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


def chain_cost(spec, n: int, elt: int) -> tuple[float, float]:
    """(operations, bytes) the chain needs on ``n`` images: 1x1 products,
    depthwise taps and residual adds; input read once, output written once,
    weights read once."""
    from instancesegmentation_tpu_torch.ops import fused_chain as fc

    p = n * spec.h * spec.w
    flops, weights, c = 0.0, 0, spec.c_in
    for op in spec.ops:
        if isinstance(op, (fc.MatmulOp, fc.DepthwiseOp)):
            flops += 2.0 * p * op.w.size
            weights += op.w.size + op.b.size
            c = op.w.shape[1]
        elif isinstance(op, fc.ResidualAdd):
            if op.proj is not None:
                flops += 2.0 * p * op.proj.w.size
                weights += op.proj.w.size + op.proj.b.size
                c = op.proj.w.shape[1]
            flops += p * c
        elif isinstance(op, fc.ConcatChainInput):
            c += spec.c_in
    io = p * (spec.c_in + spec.c_out) * elt + 4 * weights
    return flops, io


def bound(flops: float, io: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, io / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def max_err(got, want, atol, rtol, what) -> float:
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    print(f"check {what}: max_abs_err={err.max().item():.3e} "
          f"max|ref|={want.float().abs().max().item():.3e} (atol {atol}, rtol {rtol})")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(bool((err <= limit).all()), f"{what}: outside tolerance")
    return err.max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch
        from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
        from instancesegmentation_tpu_torch.infer.server import ServingFrontend
        from instancesegmentation_tpu_torch.models.export import fold_batchnorm
        from instancesegmentation_tpu_torch.ops import _build
        from instancesegmentation_tpu_torch.ops import fused_chain as fc
        from instancesegmentation_tpu_torch.ops.fused_block import (
            bottleneck3x3_fused,
            bottleneck3x3_reference,
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

    # -- 3. kernels against their plain versions ---------------------------
    sd20 = random_state_dict(20, SEED)
    folded = fold_batchnorm(sd20)
    specs = {"s1": fc.extract_s1_chain(folded, 60, 60),
             "s23": fc.extract_s23_chain(folded, 30, 30)}
    g = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}
    for name, spec in specs.items():
        ref_spec = spec.to(dev)
        x = torch.randn((8, spec.h, spec.w, spec.c_in), generator=g, device=dev)
        for dtype, atol, rtol in ((torch.float32, 1e-3, 1e-4), (torch.bfloat16, 0.1, 0.1)):
            xd = x.to(dtype)
            got = fc.fused_chain(xd, spec)
            want = fc.fused_chain_reference(xd, ref_spec)
            check(got.dtype == dtype and got.shape == want.shape, f"{name} {dtype} shape")
            errs[(name, dtype)] = max_err(got, want, atol, rtol,
                                          f"fused_chain {name} {dtype} {list(x.shape)}")

    # bottleneck3x3_fused on the folded weights of the first section-1 block
    _, mm1, dw_op, mm2, res = specs["s1"].ops[:5]
    block_args = dict(
        w1=mm1.w, b1=mm1.b, a1=mm1.alpha, dw=dw_op.w.reshape(3, 3, -1),
        b_dw=dw_op.b, a2=dw_op.alpha, w2=mm2.w, b2=mm2.b, a_out=res.alpha)
    block_args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in block_args.items()}
    xb = torch.randn((8, 64, 64, 48), generator=g, device=dev)
    errs["block"] = max_err(bottleneck3x3_fused(xb, **block_args),
                            bottleneck3x3_reference(xb, **block_args), 1e-3, 1e-4,
                            "bottleneck3x3_fused [8, 64, 64, 48]")
    torch.cuda.synchronize()

    # -- 4. serving at full width -----------------------------------------
    batch = synthetic_host_batch(BATCH, 640, seed=SEED)
    eng = InferenceEngine(sd20, in_channels=20, size=480, dtype=torch.bfloat16)
    fc.fused_chain.launches = 0
    bottleneck3x3_fused.launches = 0
    probs, masks = eng.predict_instances(batch)  # the main path, once
    launches = {"fused_chain": fc.fused_chain.launches,
                "bottleneck3x3_fused": bottleneck3x3_fused.launches}
    print(f"main path (instance 480, batch {BATCH}, bf16): launches {launches}")
    check(launches["fused_chain"] == 2, "fused_chain: 2 launches per dispatch")
    check(probs.shape == (BATCH, 480, 480, 1) and masks.shape == (BATCH, 640, 640),
          "instance output shapes")
    check(bool(np.isfinite(probs).all()) and probs.min() >= 0 and probs.max() <= 1,
          "instance probabilities finite in [0, 1]")
    check(set(np.unique(masks)) <= {0, 255}, "instance masks are 0/255")

    eng32 = InferenceEngine(sd20, in_channels=20, size=480, dtype=torch.float32)
    probs32, masks32 = eng32.predict_instances(batch)
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

    sd3 = random_state_dict(3, SEED + 1)
    eng3 = InferenceEngine(sd3, in_channels=3, size=512, dtype=torch.bfloat16)
    images = [rng.integers(0, 255, (int(rng.integers(360, 800)), int(rng.integers(360, 800)), 3),
                           dtype=np.uint8) for _ in range(BATCH)]
    fc.fused_chain.launches = 0
    img_masks = eng3.predict_images(images)
    whole_launches = fc.fused_chain.launches
    print(f"whole-image path (512, batch {BATCH}, bf16): fused_chain launches {whole_launches}")
    check(whole_launches == 2, "whole-image: 2 chain launches per dispatch")
    check(all(m.shape == im.shape[:2] and m.dtype == np.uint8
              for m, im in zip(img_masks, images)), "whole-image mask shapes")

    # -- 5. times ------------------------------------------------------------
    parts = []
    for name, spec in specs.items():
        ref_spec = spec.to(dev)
        x = torch.randn((BATCH, spec.h, spec.w, spec.c_in), generator=g,
                        device=dev).bfloat16()
        ms = cuda_ms(lambda: fc.fused_chain(x, spec), iters=20)
        plain = cuda_ms(lambda: fc.fused_chain_reference(x, ref_spec), iters=5)
        flops, io = chain_cost(spec, BATCH, 2)
        b_ms, b_by = bound(flops, io)
        parts.append({"spec": name, "shape": list(x.shape), "dtype": "bfloat16",
                      "flops": flops, "bytes": io,
                      "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                      "f32_cuda_core_bound_ms": 1e3 * flops / PEAK_F32_FLOPS,
                      "max_abs_err_f32": errs[(name, torch.float32)],
                      "max_abs_err_bf16": errs[(name, torch.bfloat16)]})
        print(f"time fused_chain {name} {list(x.shape)} bf16: {ms:.3f} ms "
              f"(plain {plain:.3f} ms, bound {b_ms:.4f} ms by {b_by})")

    xb = torch.randn((BATCH, 60, 60, 48), generator=g, device=dev)
    blk_ms = cuda_ms(lambda: bottleneck3x3_fused(xb, **block_args), iters=20)
    blk_plain = cuda_ms(lambda: bottleneck3x3_reference(xb, **block_args), iters=5)
    one_block = fc.ChainSpec(60, 60, 48, 48, specs["s1"].ops[:5])
    blk_bound, blk_by = bound(*chain_cost(one_block, BATCH, 4))
    print(f"time bottleneck3x3_fused [{BATCH}, 60, 60, 48] f32: {blk_ms:.3f} ms "
          f"(plain {blk_plain:.3f} ms, bound {blk_bound:.4f} ms by {blk_by})")

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
        u8 = torch.randint(0, 255, (BATCH, 512, 512, 3), generator=g, device=dev,
                           dtype=torch.uint8)
        whole_ms = cuda_ms(lambda: eng3._forward_whole(u8), iters=5)
    e2e["instance480_bf16_program_ms"] = inst_ms
    e2e["instance480_bf16_program_img_per_s"] = BATCH / inst_ms * 1e3
    e2e["whole512_bf16_program_ms"] = whole_ms
    e2e["whole512_bf16_program_img_per_s"] = BATCH / whole_ms * 1e3
    print(json.dumps({"e2e": e2e, "bf16_vs_f32": bf16_vs_f32, "gpu_vs_cpu": gpu_vs_cpu,
                      "card": card}))

    # -- 6. summary ----------------------------------------------------------
    # the chain's bound is that of its two launches' work taken together
    chain_bound, chain_by = bound(sum(p["flops"] for p in parts),
                                  sum(p["bytes"] for p in parts))
    kernels = [
        {"name": "fused_chain", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/fused_chain.cu",
         "replaces": "instancesegmentation_tpu/ops/fused_chain.py:308",
         "launches": launches["fused_chain"],
         "max_abs_err": max(p["max_abs_err_f32"] for p in parts),
         "ms": sum(p["ms"] for p in parts),
         "plain_ms": sum(p["plain_ms"] for p in parts),
         "bound_ms": chain_bound, "bound_by": chain_by,
         "library_ms": None, "parts": parts},
        {"name": "bottleneck3x3_fused", "route": "cuda",
         "source": "instancesegmentation_tpu_torch/csrc/fused_chain.cu",
         "replaces": "instancesegmentation_tpu/ops/fused_block.py:52",
         "launches": launches["bottleneck3x3_fused"], "on_main_path": False,
         "max_abs_err": errs["block"], "ms": blk_ms, "plain_ms": blk_plain,
         "bound_ms": blk_bound, "bound_by": blk_by, "library_ms": None,
         "shape": [BATCH, 60, 60, 48], "dtype": "float32"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
