"""The trainer: epoch loop, periodic validation, checkpoint contract.

Port of ``instancesegmentation_tpu/train/loop.py`` (``Trainer``, ``main``),
in one process (the single-process branch of the JAX package's
``parallel/multihost.py:process_info``):

- Adam + BCE over ``batch_iterator`` batches in the JAX package's order,
  sent ahead to the device by ``device_prefetch``;
- validation of mean mask IoU over the whole val set, padded tail rows
  dropped (``max_val_batches`` caps it), at the show/val cadence of
  ``show_iter`` / ``val_iter``;
- the regression guard: a val IoU more than ``regression_threshold`` below
  the best reloads the branch-best checkpoint and rewinds the epoch;
- syn_train: a better (or ``stale_epochs`` staler) checkpoint of a peer
  process is adopted;
- save-best gated at ``save_iou_gate``, written atomically in the JAX
  package's ISEG format (``train/checkpoint.py``), so either package
  resumes the other's run; restarts bounded by ``max_restarts``.

Where it differs from the JAX package:

- each step's augmentation draws come from a generator on the model's
  device seeded from ``(cfg.seed, host step)``, so a resumed run draws what
  an unbroken one would have (JAX folds the step into its key);
- ``Trainer(cfg, device=None)`` runs on ``cuda:0`` and raises without CUDA
  unless ``device="cpu"`` is passed; a train step on the card runs the
  ``warp_2level`` kernel whenever ``rotate > 0``;
- ``profile_steps`` traces with ``torch.profiler`` into ``out_dir/profile``;
- data parallelism, multi-host runs, the grain loader and the orbax
  backend are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from instancesegmentation_tpu_torch.core.device import pick_device
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.pipeline import (
    batch_iterator,
    device_prefetch,
    draw_augment,
)
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.train.checkpoint import BranchBestCheckpoint, load_checkpoint
from instancesegmentation_tpu_torch.train.config import TrainConfig, parse_args
from instancesegmentation_tpu_torch.train.metrics import MetricLogger, dump_image_grid
from instancesegmentation_tpu_torch.train.state import TrainState, from_state_tree, to_state_tree
from instancesegmentation_tpu_torch.train.steps import (
    augment_config,
    make_eval_step,
    make_train_step,
)


def _host(t) -> np.ndarray:
    """A device tensor (bfloat16 ones as float32) or an array, as numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()
    return np.asarray(t)


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s augmentation generator: ``seed`` and
    ``step`` mixed by numpy's ``SeedSequence`` (both non-negative)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def _not_ported(cfg: TrainConfig) -> Optional[str]:
    if cfg.data_parallel:
        return "data_parallel is not ported yet (ROADMAP A5)"
    if cfg.multihost:
        return "multihost is not ported yet (ROADMAP A5)"
    if cfg.loader != "threads":
        return f"loader={cfg.loader!r} is not ported yet (ROADMAP A8); use 'threads'"
    if cfg.checkpoint_backend != "file":
        return (f"checkpoint_backend={cfg.checkpoint_backend!r} is not ported yet "
                "(ROADMAP A8); use 'file'")
    return None


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None):
        reason = _not_ported(cfg)
        if reason:
            raise NotImplementedError(reason)
        self.cfg = cfg
        self.device = pick_device(device)
        model = Segment(cfg.in_channels)
        init_weights_(model, torch.Generator().manual_seed(cfg.seed))
        self.state = TrainState.create(model.to(self.device), cfg.learning_rate)
        self.train_step = make_train_step(cfg)
        self.eval_step = make_eval_step(cfg)
        self.ckpt = BranchBestCheckpoint(cfg.checkpoint_dir,
                                         explicit_path=cfg.checkpoint_save_path)
        self.logger = MetricLogger(cfg.out_dir)
        self.start_epoch = 0
        self.iou_max = 0.0

        ckpt_exists, peer_best = self._ckpt_obs()
        if ckpt_exists:
            self.iou_max = peer_best
        if cfg.continue_train and ckpt_exists:
            print(f"loading checkpoint from {self.ckpt.path}")
            self._load_best()
        elif cfg.pretrained_path and os.path.exists(cfg.pretrained_path):
            print(f"pretrained loading checkpoint from {cfg.pretrained_path}")
            tree, _ = load_checkpoint(cfg.pretrained_path)
            from_state_tree(tree, self.state)
            self.start_epoch = 0

    # ------------------------------------------------------------------
    def _ckpt_obs(self) -> tuple[bool, float]:
        """(exists, best) of the shared checkpoint."""
        exists = self.ckpt.exists()
        return exists, (self.ckpt.best() or 0.0) if exists else 0.0

    def _load_best(self) -> bool:
        """Resume model, optimizer and epoch from the branch-best
        checkpoint.  Returns success; a failed load is reported and
        training goes on (as in the reference)."""
        try:
            tree, meta = self.ckpt.load()
            from_state_tree(tree, self.state)
        except (OSError, ValueError, KeyError) as e:
            print(f"load fail: {e!r}")
            return False
        self.start_epoch = int(meta.get("epoch", 0))
        return True

    def _validate(self, valset: InstanceCommonDataset, epoch: int, seed: int) -> float:
        """Mean mask IoU over the whole val set: the incomplete tail batch
        is padded (``drop_last=False`` repeats its first sample) and the
        padded rows are dropped from the mean, so every sample counts
        once."""
        cfg = self.cfg
        iou_sum, iou_count = 0.0, 0
        cap = cfg.max_val_batches or None
        first = None
        n_total = len(valset)
        for k, batch in enumerate(batch_iterator(
                valset, cfg.batch_size, shuffle=True, seed=seed, epochs=1,
                drop_last=False, num_threads=cfg.num_threads)):
            images, probs, masks, iou_vec = self.eval_step(self.state.model, batch)
            # padding repeats the tail's first sample at the END of the batch
            valid = min(cfg.batch_size, n_total - k * cfg.batch_size)
            vals = _host(iou_vec)[:valid]
            iou_sum += float(vals.sum())
            iou_count += len(vals)
            if first is None and cfg.log_images:
                first = (images, probs, masks)
            if cap and k + 1 >= cap:
                break
        if first is not None:
            images, probs, masks = first
            dump_image_grid(os.path.join(cfg.out_dir, "viz"), f"val_e{epoch:03d}",
                            _host(images), _host(masks), _host(probs))
        return float(iou_sum / iou_count) if iou_count else 0.0

    def _generator(self, host_step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.cfg.seed, host_step))

    # ------------------------------------------------------------------
    def train(self) -> float:
        cfg = self.cfg
        print(f"branch name: {self.ckpt.branch_name}")
        print(f"device: {self.device}")
        os.makedirs(cfg.out_dir, exist_ok=True)
        with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)

        trainset = InstanceCommonDataset(cfg.train_dataset_dir, cfg.canvas)
        valset = InstanceCommonDataset(cfg.val_dataset_dir, cfg.canvas)
        print(f"train samples: {len(trainset)}  val samples: {len(valset)}")

        aug = augment_config(cfg, train=True)
        epoch = self.start_epoch
        last_val = 0.0
        restarts = 0
        host_step = self.state.step

        # --profile-steps N: a torch.profiler trace of N steady-state steps
        # (step 0 of an epoch is skipped) into out_dir/profile
        profiler = None
        profile_done = cfg.profile_steps <= 0
        steps_profiled = 0
        profile_dir = os.path.join(cfg.out_dir, "profile")

        while epoch < cfg.epochs:
            restarted = False
            losses = []
            t_start = time.time()
            val_seconds = 0.0  # excluded from the reported img/s
            n_seen = 0
            stream = batch_iterator(trainset, cfg.batch_size, shuffle=True,
                                    seed=cfg.seed + epoch, epochs=1,
                                    num_threads=cfg.num_threads)
            batches = device_prefetch(stream, self.device)
            try:
                for i0, batch in enumerate(batches):
                    if not profile_done and profiler is None and i0 == 1:
                        profiler = _start_profiler(self.device)
                    draws = draw_augment(cfg.batch_size, aug, self._generator(host_step))
                    self.state, metrics = self.train_step(self.state, batch, draws)
                    host_step += 1
                    losses.append(metrics["loss"])
                    n_seen += cfg.batch_size

                    if profiler is not None and not profile_done:
                        steps_profiled += 1
                        if steps_profiled >= cfg.profile_steps:
                            _stop_profiler(profiler, self.device, profile_dir, host_step)
                            profile_done = True

                    if i0 % cfg.show_iter == cfg.show_iter - 1:
                        loss = float(torch.stack(losses).mean())
                        # train-only rate: validation passes are excluded
                        ips = n_seen / max(time.time() - t_start - val_seconds, 1e-9)
                        print(f" [epoch {epoch}] [{i0 * cfg.batch_size}/{len(trainset)}]"
                              f" [loss: {loss:.6f}] [{ips:.1f} img/s]")
                        self.logger.log(host_step, loss=loss, images_per_sec=ips,
                                        train_iou=float(metrics["train_iou"]), epoch=epoch)
                        losses = []

                    if i0 % cfg.val_iter == 0:
                        t_val = time.time()
                        val_iou = self._validate(valset, epoch, seed=cfg.seed + i0)
                        val_seconds += time.time() - t_val
                        last_val = val_iou
                        print(f"{self.ckpt.branch_name} [epoch {epoch}]"
                              f" [val_num:{len(valset)}]"
                              f" [train_batch_iou: {float(metrics['train_iou']):.6f}]"
                              f" [val_iou: {val_iou:.6f}]")
                        self.logger.log(host_step, val_iou=val_iou, epoch=epoch)

                        # restart budget: the reference can reload forever
                        # when a checkpoint's best IoU is unreachable
                        may_restart = restarts < cfg.max_restarts
                        ckpt_exists, peer_best = self._ckpt_obs()

                        # regression guard
                        if (may_restart and self.iou_max - val_iou > cfg.regression_threshold
                                and ckpt_exists):
                            print("val_iou too low, reload checkpoint from " + self.ckpt.path)
                            if self._load_best():
                                epoch = self.start_epoch - 1
                                restarted = True
                                restarts += 1
                                break

                        # syn_train adoption
                        if ckpt_exists:
                            stale = epoch - self.start_epoch > cfg.stale_epochs
                            if self.iou_max < peer_best or stale:
                                print(f"update model from {self.ckpt.path}")
                                self.iou_max = max(self.iou_max, peer_best)
                                if cfg.syn_train and may_restart:
                                    print("syn_train...")
                                    if self._load_best():
                                        epoch = self.start_epoch - 1
                                        restarted = True
                                        restarts += 1
                                        break

                        # save-best behind the quality gate
                        if val_iou > self.iou_max and val_iou > cfg.save_iou_gate:
                            self.iou_max = val_iou
                            print("save branch best checkpoint " + self.ckpt.path)
                            self.ckpt.save(to_state_tree(self.state), best=val_iou,
                                           epoch=epoch + 1)
            finally:
                batches.close()
                stream.close()

            epoch += 1
            if restarted:
                # the reloaded state's step
                host_step = self.state.step
        if profiler is not None and not profile_done:
            # training ended before profile_steps elapsed; close the trace
            _stop_profiler(profiler, self.device, profile_dir, host_step)
        self.logger.close()
        return last_val


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, device: torch.device, profile_dir: str, step: int) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"step{step:06d}.pt.trace.json")
    profiler.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def main(argv=None):
    """``python -m instancesegmentation_tpu_torch.train [flags]``: train on
    ``cuda:0`` (every ``TrainConfig`` field is a flag)."""
    Trainer(parse_args(argv)).train()


if __name__ == "__main__":
    main()
