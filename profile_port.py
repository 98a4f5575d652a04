"""Where the time goes in the port's serving programs and its train step on
one NVIDIA GPU.

    python3 profile_port.py          # from the repository root; needs one CUDA card
    python3 profile_port.py --train  # the train step only
    python3 profile_port.py --trainer  # the trainer from disk beside its step
    python3 profile_port.py --detection  # roi_align and match_proposals forms
    python3 profile_port.py --trace-check  # the profiler's spans per trace

On seeded random weights, at batch 128 in bfloat16, it times with CUDA
events each stage of the 480 px instance program (warp parameters, crop
warp, normalisation, heatmap render, backbone with its two chain launches,
folded head, sigmoid + inverse warp) and of the 512 px whole-image program,
the host-side parts of a dispatch with the host clock (upload, download,
resizes), counts each program's chain launches by kernel form (banded,
banded_f32 or SIMT), and takes one ``torch.profiler`` trace of each program for the device
busy share and the largest device ops.  The train step (the
``chip_smoke.py`` training cell: ``Segment(20)`` in bf16, batch 32, 640 ->
480, rotate 25 through the 2level sampler, flips, jitter, photometric draws)
is split the same way into preprocessing (of which the warp kernel, by
call and by its device time, and its launches per step), the train-mode
forward and loss, the backward and the Adam update, with one trace.
``--trainer`` sets the trainer from disk beside its step and its loader
(``trainer_breakdown``).  ``--detection`` times the detection kernels alone at ``chip_smoke.py``'s
shapes (``detection_breakdown``): ``roi_align`` with and without its
locality order over a range of ROI counts at both poolers, and
``match_proposals``' two forms.  ``--trace-check`` counts the spans
``torch.profiler`` returns per trace, in a child process per CUPTI
setting (``trace_check``).  Each prints one JSON object as its last line,
after the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from chip_smoke import (
    BATCH,
    LAUNCH_RECORDS,
    SEED,
    TRAIN_BATCH,
    card_line,
    cuda_ms,
    device_calls,
    device_ms,
    random_state_dict,
    roi_inputs,
    training_batch,
)


def host_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def trace(fn, top: int = 12) -> dict:
    """Device busy share of one call of ``fn`` and its largest device ops."""
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
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "n_device_ops": len(events),
            "largest_ms": {k[:90]: v for k, v in largest}}


def trace_check(dev, traces: int = 60, iters: int = 20) -> dict:
    """What ``torch.profiler`` returns per trace in this process's
    environment: each trace holds ``iters`` calls of a function that
    launches one kernel (a torch add, the nms kernel at N = 48, the cluster
    matcher at [2000, 64]), with the same calls timed untraced by CUDA events
    between traces, as ``chip_smoke.py``'s timing phase runs them, and a
    second of other work every ten traces.  Per function: the traces whose
    kernel spans or launch records are not ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    from instancesegmentation_tpu_torch.ops import matching as mp
    from instancesegmentation_tpu_torch.ops import nms

    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.zeros(256, device=dev)
    xy = torch.rand((48, 2), generator=g, device=dev) * 600
    boxes = torch.cat([xy, xy + 50], 1)
    scores = torch.rand(48, generator=g, device=dev)
    iou = torch.rand((2000, 64), generator=g, device=dev)
    big = torch.randn((4096, 4096), device=dev)
    fns = {"add": lambda: x.add_(1.0), "nms": lambda: nms.nms(boxes, scores, 0.7),
           "match": lambda: mp.match_proposals(iou)}
    res = {name: {"traces": 0, "bad": []} for name in fns}
    t0 = time.perf_counter()
    for s in range(traces):
        if s % 10 == 9:
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < 1.0:
                big @ big
                torch.cuda.synchronize()
        for name, fn in fns.items():
            cuda_ms(fn, iters)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            spans: dict = {}
            records = 0
            for e in prof.events():
                if e.device_type.name == "CUDA":
                    spans[e.name[:40]] = spans.get(e.name[:40], 0) + 1
                elif any(k in e.name for k in LAUNCH_RECORDS):
                    records += 1
            res[name]["traces"] += 1
            if list(spans.values()) != [iters] or records != iters:
                res[name]["bad"].append({"trace": s, "spans": spans, "launch_records": records})
    res["seconds"] = time.perf_counter() - t0
    return res


def trace_check_children() -> dict:
    """``trace_check`` in a child process per environment: the default, and
    with ``TEARDOWN_CUPTI=0`` (the profiler keeps CUPTI set up between
    traces instead of tearing it down at each trace's end)."""
    import os
    import subprocess

    out = {}
    for label, env in (("default", {}), ("TEARDOWN_CUPTI=0", {"TEARDOWN_CUPTI": "0"})):
        child = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        proc = subprocess.run([sys.executable, __file__, "--trace-check-child"],
                              env={**child, **env}, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        out[label] = json.loads(lines[-1]) if proc.returncode == 0 and lines else {
            "rc": proc.returncode, "stderr": proc.stderr[-2000:]}
        print(json.dumps({label: out[label]}), flush=True)
    return out


def train_breakdown(dev) -> dict:
    """The bf16 train step at batch 32, stage by stage, and one trace."""
    from instancesegmentation_tpu_torch.data.pipeline import (
        batch_to,
        draw_augment,
        preprocess_batch,
        rotated_warp_params,
    )
    from instancesegmentation_tpu_torch.models.layers import init_weights_
    from instancesegmentation_tpu_torch.models.segment import Segment
    from instancesegmentation_tpu_torch.ops import warp_2level as w2
    from instancesegmentation_tpu_torch.train.config import TrainConfig
    from instancesegmentation_tpu_torch.train.state import TrainState
    from instancesegmentation_tpu_torch.train.steps import (
        augment_config,
        bce_loss,
        make_fwd,
        make_train_step,
    )

    cfg = TrainConfig(in_channels=20, rotate=25.0, flip_prob=0.5, jitter=0.1,
                      brightness=0.2, contrast=0.2, noise_std=5.0, batch_size=TRAIN_BATCH)
    aug = augment_config(cfg, train=True)
    batch = batch_to(training_batch(TRAIN_BATCH, cfg.canvas, SEED), dev)
    draws = draw_augment(TRAIN_BATCH, aug, torch.Generator(device=dev).manual_seed(SEED))
    model = Segment(20)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    state = TrainState.create(model.to(dev), cfg.learning_rate)
    step = make_train_step(cfg)
    fwd = make_fwd(state.model, cfg, train=True)
    images, heatmaps, masks = preprocess_batch(batch, draws, aug)
    params, _ = rotated_warp_params(batch, draws, aug)

    def forward_loss():
        return bce_loss(fwd(images, heatmaps), masks)

    def forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        forward_loss().backward()

    forward_backward()
    w2.warp_2level.launches = 0
    step(state, batch, draws)
    launches = w2.warp_2level.launches
    warp_args = (batch["image"], batch["mask"], params, aug.out_size, aug.rotate,
                 aug.rotate_block)
    st = {
        "step": cuda_ms(lambda: step(state, batch, draws), 5),
        "preprocess": cuda_ms(lambda: preprocess_batch(batch, draws, aug), 5),
        "warp_params": cuda_ms(lambda: rotated_warp_params(batch, draws, aug), 5),
        "warp_2level": cuda_ms(lambda: w2.warp_2level(*warp_args), 20),
        "warp_2level_kernel": device_ms(lambda: w2.warp_2level(*warp_args),
                                        "warp_2level_tiled_kernel"),
        "forward_loss": cuda_ms(forward_loss, 5),
        "forward_backward": cuda_ms(forward_backward, 5),
        "adam": cuda_ms(state.optimizer.step, 10),
    }
    with torch.no_grad():
        st["forward_no_grad"] = cuda_ms(forward_loss, 5)
    st["backward"] = st["forward_backward"] - st["forward_loss"]
    return {"ms": st, "img_per_s": TRAIN_BATCH / st["step"] * 1e3,
            "warp_2level_launches_per_step": launches,
            "trace": trace(lambda: step(state, batch, draws), top=16)}


ORDER_SWEEP_ROIS = (100, 200, 300, 400, 600, 800, 1000)


def trainer_breakdown(dev) -> dict:
    """Why the trainer from disk runs slower than its step: on
    ``chip_smoke.py``'s trainer-from-disk data (128 + 32 synthetic 480 x 640
    images) and config, with the host clock around synchronised work:

    - ``step_alone_ms``: the train step on one fixed batch already on the
      card, and ``step_with_loader_ms``: the same while another thread
      drains ``batch_iterator`` (8 threads) as fast as it can, with the
      samples/s it drained; each in turns (alone, with, with, alone);
    - ``loader_alone_samples_per_s``: ``batch_iterator`` drained alone;
    - ``trainer``: ``train.loop.main`` runs (2 epochs, batch 32, the train480
      augmentations) at ``--num-threads`` 8 and 2 and with the interpreter's
      switch interval at 0.2 ms, in turns, ms per step over steps 2-8 from
      ``metrics.jsonl`` (``chip_smoke.step_ms_from_log``).
    """
    import os
    import tempfile
    import threading

    from chip_smoke import (DISK_BATCH, DISK_EPOCHS, DISK_HW, DISK_TRAIN, DISK_VAL,
                            step_ms_from_log)
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.data.pipeline import (batch_iterator, batch_to,
                                                               draw_augment, host_batch)
    from instancesegmentation_tpu_torch.data.synthetic import make_synthetic_dataset
    from instancesegmentation_tpu_torch.models.layers import init_weights_
    from instancesegmentation_tpu_torch.models.segment import Segment
    from instancesegmentation_tpu_torch.train import loop
    from instancesegmentation_tpu_torch.train.config import parse_args
    from instancesegmentation_tpu_torch.train.state import TrainState
    from instancesegmentation_tpu_torch.train.steps import augment_config, make_train_step

    out = {}
    with tempfile.TemporaryDirectory(prefix="profile_trainer_") as tmp:
        train_dir, val_dir = os.path.join(tmp, "train"), os.path.join(tmp, "val")
        make_synthetic_dataset(train_dir, DISK_TRAIN, DISK_HW, 1, seed=SEED)
        make_synthetic_dataset(val_dir, DISK_VAL, DISK_HW, 1, seed=SEED + 1)
        base = ["--train-dataset-dir", train_dir, "--val-dataset-dir", val_dir,
                "--batch-size", str(DISK_BATCH), "--epochs", str(DISK_EPOCHS),
                "--rotate", "25", "--flip-prob", "0.5", "--jitter", "0.1",
                "--brightness", "0.2", "--contrast", "0.2", "--noise-std", "5",
                "--save-iou-gate", "0", "--show-iter", "1"]
        cfg = parse_args(base)
        trainset = InstanceCommonDataset(train_dir, cfg.canvas)

        # the step on a fixed batch, alone and beside a draining loader
        model = Segment(20)
        init_weights_(model, torch.Generator().manual_seed(SEED))
        state = TrainState.create(model.to(dev), cfg.learning_rate)
        step = make_train_step(cfg)
        aug = augment_config(cfg, train=True)
        batch = batch_to(host_batch([trainset.fetch(i) for i in range(DISK_BATCH)]), dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def steps(n: int = 8) -> float:
            step(state, batch, draw_augment(DISK_BATCH, aug, gen))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                step(state, batch, draw_augment(DISK_BATCH, aug, gen))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        def drained(fn) -> tuple[float, float]:
            """``fn()``'s result while a thread drains the loader, and the
            loader's samples/s meanwhile."""
            stop, count = threading.Event(), [0]

            def drain():
                stream = batch_iterator(trainset, DISK_BATCH, epochs=None, num_threads=8)
                next(stream)  # the loader is running before fn starts
                ready.set()
                for b in stream:
                    count[0] += b["image"].shape[0]
                    if stop.is_set():
                        break
                stream.close()

            ready = threading.Event()
            th = threading.Thread(target=drain)
            th.start()
            ready.wait()
            t0 = time.perf_counter()
            value = fn()
            rate = count[0] / (time.perf_counter() - t0)
            stop.set()
            th.join()
            return value, rate

        runs = {"alone": [], "with_loader": [], "loader_during_step": []}
        for kind in ("alone", "with_loader", "with_loader", "alone"):
            if kind == "alone":
                runs["alone"].append(steps())
            else:
                ms, rate = drained(steps)
                runs["with_loader"].append(ms)
                runs["loader_during_step"].append(rate)
        t0 = time.perf_counter()
        n = sum(b["image"].shape[0] for b in batch_iterator(
            trainset, DISK_BATCH, epochs=2, num_threads=8))
        out.update({"step_alone_ms": runs["alone"], "step_with_loader_ms": runs["with_loader"],
                    "loader_samples_per_s_during_step": runs["loader_during_step"],
                    "loader_alone_samples_per_s": n / (time.perf_counter() - t0)})
        print(f"train step on a fixed batch: alone {runs['alone']} ms, beside a draining "
              f"loader {runs['with_loader']} ms (loader {runs['loader_during_step']} "
              f"samples/s); loader alone {out['loader_alone_samples_per_s']:.0f} samples/s")

        # the trainer itself, in turns
        trainer = {}
        interval = sys.getswitchinterval()
        variants = (("threads8", 8, None), ("threads2", 2, None),
                    ("threads8_switch_0.2ms", 8, 2e-4), ("threads8", 8, None))
        for i, (name, threads, switch) in enumerate(variants):
            run_dir = os.path.join(tmp, f"run{i}")
            argv = base + ["--num-threads", str(threads),
                           "--checkpoint-dir", os.path.join(run_dir, "ckpt"),
                           "--out-dir", os.path.join(run_dir, "runs")]
            if switch is not None:
                sys.setswitchinterval(switch)
            try:
                loop.main(argv)
            finally:
                sys.setswitchinterval(interval)
            with open(os.path.join(run_dir, "runs", "metrics.jsonl")) as f:
                secs, n_steps = step_ms_from_log([json.loads(line) for line in f])
            trainer.setdefault(name, []).append(secs / n_steps * 1e3)
        out["trainer_ms_per_step_steps_2_to_n"] = trainer
        print(f"trainer from disk, ms per step over steps 2-{DISK_EPOCHS * DISK_TRAIN // DISK_BATCH}: "
              f"{json.dumps(trainer)}")
    return out


def detection_breakdown(dev) -> dict:
    """``roi_align`` with and without the locality order, in turns (without,
    with, with, without), at both poolers over ``ORDER_SWEEP_ROIS`` ROIs:
    device ms per call (the order launch included) and call ms by CUDA
    events, which place the order's crossover; ``match_proposals``' two
    forms in turns (two-pass, cluster, cluster, two-pass), device and call
    ms, also at other cluster sizes and without the rescue."""
    from instancesegmentation_tpu_torch.ops import matching as mp
    from instancesegmentation_tpu_torch.ops import roi_align as ra

    g = torch.Generator(device=dev).manual_seed(SEED)
    feats = torch.randn((2, 200, 336, 256), generator=g, device=dev)
    out = {}
    for pooler, hw in (("box_head", (7, 7)), ("mask_head", (14, 14))):
        for r in ORDER_SWEEP_ROIS:
            boxes, idx = roi_inputs(g, r, dev)
            args = (feats, boxes, idx, hw, 0.25, 2, False)
            turns = {False: [], True: []}
            for order in (False, True, True, False):
                turns[order].append(
                    (device_calls(lambda: ra._launch(*args, order=order))[0],
                     cuda_ms(lambda: ra._launch(*args, order=order), 20)))
            res = {"default_order": r >= ra.ORDER_MIN_ROIS}
            for order, key in ((False, "unordered"), (True, "ordered")):
                res[key] = {"device_ms": sum(d for d, _ in turns[order]) / 2,
                            "call_ms": sum(c for _, c in turns[order]) / 2,
                            "device_ms_turns": [d for d, _ in turns[order]]}
            print(json.dumps({f"roi_align {pooler} R={r}": res}), flush=True)
            out[f"roi_align {pooler} R={r}"] = res
    iou = torch.rand((2000, 64), generator=g, device=dev)
    res = {"max_cluster": mp.max_cluster()}
    for form in ("two_pass", "cluster", "cluster", "two_pass"):
        fn = (lambda: mp._launch(iou, 0.5, 0.3, True, form))
        ms, kernels = device_calls(fn, 50)
        res.setdefault(form, []).append({"device_ms": ms, "kernels_per_call": kernels,
                                         "call_ms": cuda_ms(fn, 200)})
    res["entry_call_ms"] = cuda_ms(lambda: mp.match_proposals(iou), 200)
    for key, lq, form, plan in (
            *((f"cluster {k}", True, "cluster", mp.plan_cluster(2000, 64, cluster=k))
              for k in (4, 8, 16)),
            ("two_pass no_rescue", False, "two_pass", None)):
        fn = (lambda: mp._launch(iou, 0.5, 0.3, lq, form, plan))
        ms, kernels = device_calls(fn, 50)
        res[key] = {"device_ms": ms, "kernels_per_call": kernels, "call_ms": cuda_ms(fn, 200)}
    print(json.dumps({"match_2000x64": res}), flush=True)
    out["match_2000x64"] = res
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 1
    if "--trace-check-child" in sys.argv[1:]:
        print(json.dumps(trace_check(torch.device("cuda:0"))))
        return 0
    if "--trace-check" in sys.argv[1:]:
        card = card_line()
        print(card)
        print(json.dumps({"card": card, "trace_check": trace_check_children()}))
        return 0
    if "--detection" in sys.argv[1:]:
        card = card_line()
        print(card)
        print(json.dumps({"card": card, "detection": detection_breakdown(torch.device("cuda:0"))}))
        print(card)
        return 0
    if "--trainer" in sys.argv[1:]:
        card = card_line()
        print(card)
        out = {"card": card, "trainer_from_disk": trainer_breakdown(torch.device("cuda:0"))}
        print(json.dumps(out))
        return 0
    if "--train" in sys.argv[1:]:
        card = card_line()
        print(card)
        out = {"card": card, "train_bf16_480": train_breakdown(torch.device("cuda:0"))}
        print(json.dumps(out))
        return 0
    from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch
    from instancesegmentation_tpu_torch.infer import pipeline as pl
    from instancesegmentation_tpu_torch.models.fused_head import fold_head, head_apply
    from instancesegmentation_tpu_torch.ops import fused_chain as fc
    from instancesegmentation_tpu_torch.ops import warp as wp
    from instancesegmentation_tpu_torch.ops.heatmap import render_heatmaps

    dev = torch.device("cuda:0")
    card = card_line()
    print(card)
    bf16 = torch.bfloat16
    out = {"card": card, "batch": BATCH, "dtype": "bfloat16"}

    # -- the 480 px instance program, stage by stage -----------------------
    eng = pl.InferenceEngine(random_state_dict(20, SEED), in_channels=20,
                             size=480, dtype=bf16)
    head = fold_head(eng.variables).to(dev)
    batch = synthetic_host_batch(BATCH, 640, seed=SEED)
    keys = ("image", "mask", "image_hw", "obj_box", "mask_box", "mask_valid", "keypoints")
    st = {"upload_host": host_ms(lambda: [
        torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev) for k in keys])}
    canvas, mask, hw, obj, mbox, mvalid, kps = (
        torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev) for k in keys)
    out_hw = (480, 480)

    def params():
        t = wp.center_translation(obj, hw)
        box, ok = wp.clipped_mask_box(mask, t, hw)
        use = torch.where(ok[:, None], box, mbox)
        return wp.instance_warp_params(obj, use, hw, out_hw, 16, ok | mvalid)

    with torch.inference_mode():
        p = params()
        imgs = wp.warp_image(canvas, wp.WarpParams(p.scale, p.offset), out_hw)
        x = (torch.clamp(imgs, 0.0, 255.0) / 127.5 - 1.0).to(bf16)
        pts = wp.warp_points(kps[..., :2], p)
        hm = render_heatmaps(pts, kps[..., 2] > 0.5, out_hw).to(bf16)
        feats = eng.model(x, hm, truncate_head=True)
        probs = torch.sigmoid(head_apply(feats, head, bf16).float())
        inv = wp.WarpParams(1.0 / p.scale, -p.offset / p.scale)
        back = wp.warp_image(probs, inv, (640, 640))
        s1, s23 = eng.model.chains
        x1 = torch.randn((BATCH, 60, 60, 48), device=dev).to(bf16)
        x23 = torch.randn((BATCH, 30, 30, 128), device=dev).to(bf16)
        st.update({
            "warp_params": cuda_ms(params, 5),
            "crop_warp": cuda_ms(lambda: wp.warp_image(
                canvas, wp.WarpParams(p.scale, p.offset), out_hw), 5),
            "normalize": cuda_ms(lambda: (torch.clamp(imgs, 0.0, 255.0) / 127.5 - 1.0)
                                 .to(bf16), 5),
            "heatmaps": cuda_ms(lambda: render_heatmaps(
                pts, kps[..., 2] > 0.5, out_hw).to(bf16), 5),
            "backbone": cuda_ms(lambda: eng.model(x, hm, truncate_head=True), 5),
            "backbone_chain_s1": cuda_ms(lambda: fc.fused_chain(x1, s1), 10),
            "backbone_chain_s23": cuda_ms(lambda: fc.fused_chain(x23, s23), 10),
            "head": cuda_ms(lambda: head_apply(feats, head, bf16).float(), 5),
            "sigmoid_inverse_warp": cuda_ms(lambda: wp.warp_image(
                torch.sigmoid(head_apply(feats, head, bf16).float()), inv, (640, 640)), 5),
            "threshold_download_host": host_ms(lambda: (
                pl._mask_u8(back[..., 0], 0.5).cpu().numpy(), probs.cpu().numpy())),
            "program": cuda_ms(lambda: eng._forward_instance(
                canvas, mask, hw, obj, mbox, mvalid, kps), 5),
        })
        fc.reset_launches()
        eng._forward_instance(canvas, mask, hw, obj, mbox, mvalid, kps)
        out["instance480_chain_launches"] = dict(fc.fused_chain.launches_by_form)
        out["instance480_trace"] = trace(lambda: eng._forward_instance(
            canvas, mask, hw, obj, mbox, mvalid, kps))
    st["sigmoid_inverse_warp"] -= st["head"]
    st["predict_instances_host"] = host_ms(lambda: eng.predict_instances(batch))
    out["instance480_ms"] = st

    # -- the 512 px whole-image program ------------------------------------
    eng3 = pl.InferenceEngine(random_state_dict(3, SEED + 1), in_channels=3,
                              size=512, dtype=bf16)
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 255, (int(rng.integers(360, 800)),
                                    int(rng.integers(360, 800)), 3), dtype=np.uint8)
              for _ in range(BATCH)]
    u8 = torch.zeros((BATCH, 512, 512, 3), dtype=torch.uint8, device=dev)

    def resize_in():
        for i, img in enumerate(images):
            u8[i] = pl.to_u8(pl.resize(torch.from_numpy(img).to(dev), (512, 512)))

    with torch.inference_mode():
        probs3 = eng3._forward_whole(u8)

        def resize_back():
            return [pl._mask_u8(pl.resize(probs3[i, ..., 0], img.shape[:2]), 0.5)
                    .cpu().numpy() for i, img in enumerate(images)]

        out["whole512_ms"] = {
            "upload_resize_host": host_ms(resize_in),
            "program": cuda_ms(lambda: eng3._forward_whole(u8), 5),
            "resize_back_download_host": host_ms(resize_back),
            "predict_images_host": host_ms(lambda: eng3.predict_images(images)),
        }
        fc.reset_launches()
        eng3._forward_whole(u8)
        out["whole512_chain_launches"] = dict(fc.fused_chain.launches_by_form)
        out["whole512_trace"] = trace(lambda: eng3._forward_whole(u8))
    out["train_bf16_480"] = train_breakdown(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
