"""The trainer: epoch loop, periodic validation, checkpoint contract.

Port of ``instancesegmentation_tpu/train/loop.py`` (``Trainer``, ``main``):

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
- ``Trainer(cfg, device=None)`` runs on ``cuda:<local rank>`` and raises
  without CUDA unless ``device="cpu"`` is passed; a train step on the card
  runs the ``warp_2level`` kernel whenever ``rotate > 0``;
- ``profile_steps`` traces with ``torch.profiler`` into ``out_dir/profile``
  (rank 0 only);
- ``loader="grain"`` decodes the train stream in ``grain_workers`` worker
  processes (``data/grain_loader.py``; a pool started once per ``Trainer``
  and kept across epochs), in ``batch_iterator``'s order rather than grain's;
- ``checkpoint_backend="orbax"`` keeps the orbax backend's directory
  contract with an ISEG payload inside (``train/checkpoint_orbax.py``).

Data parallelism (``data_parallel``, ``parallel/data_parallel.py``): one
process per device, joined by ``parallel/multihost.py:initialize`` before the
``Trainer`` is built (``main`` does so under ``--multihost``; torchrun's
environment works too).  ``batch_size`` is the GLOBAL batch; each rank loads
its rows (``batch_iterator(local_slice=...)``) and draws the global batch's
augmentations.  Rank 0 alone writes metrics, image grids and checkpoints;
checkpoint observations and reloads go through rank 0 and a broadcast, so
every rank takes the same branches (the JAX package's single-writer
contract).  The checkpoint directory must be shared by the ranks.
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
from instancesegmentation_tpu_torch.data.grain_loader import GrainLoader
from instancesegmentation_tpu_torch.data.pipeline import (
    batch_iterator,
    device_prefetch,
    draw_augment,
)
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.parallel import multihost
from instancesegmentation_tpu_torch.train.checkpoint import BranchBestCheckpoint, load_checkpoint
from instancesegmentation_tpu_torch.train.checkpoint_orbax import OrbaxBranchBestCheckpoint
from instancesegmentation_tpu_torch.train.config import TrainConfig, parse_args
from instancesegmentation_tpu_torch.train.metrics import MetricLogger, dump_image_grid
from instancesegmentation_tpu_torch.train.state import TrainState, from_state_tree, to_state_tree
from instancesegmentation_tpu_torch.train.steps import (
    augment_config,
    make_eval_step,
    make_train_step,
)
from instancesegmentation_tpu_torch.utils import profiling


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


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None):
        self.cfg = cfg
        self.proc_id, self.proc_count = multihost.process_info()
        self.is_main = self.proc_id == 0
        if self.proc_count > 1 and not cfg.data_parallel:
            raise ValueError("multi-host training requires --data-parallel")
        self.local_slice = (multihost.local_batch_slice(cfg.batch_size)
                            if self.proc_count > 1 else None)
        self.device = pick_device(device if device is not None
                                  else f"cuda:{multihost.local_rank()}")
        model = Segment(cfg.in_channels)
        init_weights_(model, torch.Generator().manual_seed(cfg.seed))
        self.state = TrainState.create(model.to(self.device), cfg.learning_rate)
        if cfg.data_parallel:
            from instancesegmentation_tpu_torch.parallel.data_parallel import (
                make_parallel_steps,
            )
            from instancesegmentation_tpu_torch.parallel.mesh import make_mesh

            self.mesh, self.train_step, self.eval_step, self.shard_batch = (
                make_parallel_steps(cfg, make_mesh(devices=[self.device])))
        else:
            self.mesh = None
            self.train_step = make_train_step(cfg)
            self.eval_step = make_eval_step(cfg)
            self.shard_batch = lambda b: b
        if cfg.checkpoint_backend == "orbax":
            self.ckpt = OrbaxBranchBestCheckpoint(cfg.checkpoint_dir)
        else:
            self.ckpt = BranchBestCheckpoint(cfg.checkpoint_dir,
                                             explicit_path=cfg.checkpoint_save_path)
        self.logger = MetricLogger(cfg.out_dir, enabled=self.is_main)
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
        """(exists, best) of the shared checkpoint: rank 0's observation on
        every rank, so the branches it gates (which gate collective calls)
        are the same everywhere even while the file is being written."""
        exists = self.ckpt.exists()
        obs = multihost.broadcast_from_main(
            [float(exists), (self.ckpt.best() or 0.0) if exists else 0.0])
        return bool(obs[0]), float(obs[1])

    def _load_best(self) -> bool:
        """Resume model, optimizer and epoch from the branch-best
        checkpoint.  Returns success; a failed load is reported and
        training goes on (as in the reference).

        Only rank 0 reads the file; the outcome and rank 0's state are
        broadcast, so no rank can see a torn or newer file than the others.
        """
        ok, epoch = 0.0, 0.0
        if self.is_main:
            try:
                tree, meta = self.ckpt.load()
                from_state_tree(tree, self.state)
                ok, epoch = 1.0, float(meta.get("epoch", 0))
            except (OSError, ValueError, KeyError) as e:
                print(f"load fail: {e!r}")
        flags = multihost.broadcast_from_main([ok, epoch])
        if not flags[0]:
            return False
        multihost.broadcast_state(self.state)
        self.start_epoch = int(flags[1])
        return True

    def _validate(self, valset: InstanceCommonDataset, epoch: int, seed: int) -> float:
        """Mean mask IoU over the whole val set: the incomplete tail batch
        is padded (``drop_last=False`` repeats its first sample) and the
        padded rows are dropped from the mean, so every sample counts
        once.  Each rank scores its rows; the sum and count are reduced
        over the ranks once, at the end."""
        cfg = self.cfg
        iou_sum, iou_count = 0.0, 0
        cap = cfg.max_val_batches or None
        first = None
        n_total = len(valset)
        per = cfg.batch_size // self.proc_count
        for k, batch in enumerate(batch_iterator(
                valset, cfg.batch_size, shuffle=True, seed=seed, epochs=1,
                drop_last=False, num_threads=cfg.num_threads,
                local_slice=self.local_slice)):
            images, probs, masks, iou_vec = self.eval_step(self.state.model,
                                                           self.shard_batch(batch))
            # padding repeats the tail's first sample at the END of the
            # global batch; this rank's rows are [proc_id*per, (proc_id+1)*per)
            valid = min(cfg.batch_size, n_total - k * cfg.batch_size)
            local = multihost.host_local_rows(iou_vec, cfg.batch_size)
            lv = int(np.clip(valid - self.proc_id * per, 0, per))
            iou_sum += float(local[:lv].sum())
            iou_count += lv
            if first is None and cfg.log_images and self.is_main:
                first = (images, probs, masks)
            if cap and k + 1 >= cap:
                break
        if first is not None:
            images, probs, masks = first
            dump_image_grid(os.path.join(cfg.out_dir, "viz"), f"val_e{epoch:03d}",
                            _host(images), _host(masks), _host(probs))
        iou_sum, iou_count = multihost.sum_across_processes([iou_sum, float(iou_count)])
        return float(iou_sum / iou_count) if iou_count else 0.0

    def _generator(self, host_step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.cfg.seed, host_step))

    # ------------------------------------------------------------------
    def train(self) -> float:
        cfg = self.cfg
        print(f"branch name: {self.ckpt.branch_name}")
        print(f"device: {self.device}, rank {self.proc_id} of {self.proc_count}")
        if self.is_main:
            os.makedirs(cfg.out_dir, exist_ok=True)
            with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2)

        trainset = InstanceCommonDataset(cfg.train_dataset_dir, cfg.canvas)
        valset = InstanceCommonDataset(cfg.val_dataset_dir, cfg.canvas)
        print(f"train samples: {len(trainset)}  val samples: {len(valset)}")

        aug = augment_config(cfg, train=True)
        # --loader grain: one pool of decoding processes for the whole run
        workers = None
        if cfg.loader == "grain":
            workers = GrainLoader(trainset, cfg.batch_size // self.proc_count,
                                  num_workers=cfg.grain_workers,
                                  shard_by_process=self.proc_count > 1,
                                  read_threads=cfg.num_threads,
                                  process=(self.proc_id, self.proc_count),
                                  pin_memory=self.device.type == "cuda")
        try:
            return self._epochs(trainset, valset, aug, workers)
        finally:
            if workers is not None:
                workers.close()

    def _epochs(self, trainset, valset, aug, workers: Optional[GrainLoader]) -> float:
        cfg = self.cfg
        epoch = self.start_epoch
        last_val = 0.0
        restarts = 0
        host_step = self.state.step

        # --profile-steps N: a torch.profiler trace of N steady-state steps
        # (step 0 of an epoch is skipped) into out_dir/profile
        profiler = None
        profile_done = cfg.profile_steps <= 0 or not self.is_main
        steps_profiled = 0
        profile_dir = os.path.join(cfg.out_dir, "profile")

        while epoch < cfg.epochs:
            restarted = False
            losses = []
            t_start = time.time()
            val_seconds = 0.0  # excluded from the reported img/s
            n_seen = 0
            if workers is not None:
                stream = workers.batches(seed=cfg.seed + epoch)
            else:
                stream = batch_iterator(trainset, cfg.batch_size, shuffle=True,
                                        seed=cfg.seed + epoch, epochs=1,
                                        num_threads=cfg.num_threads,
                                        local_slice=self.local_slice)
            batches = device_prefetch(stream, self.device)
            try:
                for i0, batch in enumerate(batches):
                    if not profile_done and profiler is None and i0 == 1:
                        profiler = profiling.start_trace(self.device)
                    draws = draw_augment(cfg.batch_size, aug, self._generator(host_step))
                    self.state, metrics = self.train_step(self.state,
                                                          self.shard_batch(batch), draws)
                    host_step += 1
                    losses.append(metrics["loss"])
                    n_seen += cfg.batch_size

                    if profiler is not None and not profile_done:
                        steps_profiled += 1
                        if steps_profiled >= cfg.profile_steps:
                            self._stop_profiler(profiler, profile_dir, host_step)
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

                        # save-best behind the quality gate; the state is
                        # replicated, so rank 0 alone writes (val_iou is
                        # the global mean: iou_max advances everywhere)
                        if val_iou > self.iou_max and val_iou > cfg.save_iou_gate:
                            self.iou_max = val_iou
                            if self.is_main:
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
            self._stop_profiler(profiler, profile_dir, host_step)
        self.logger.close()
        return last_val

    def _stop_profiler(self, profiler, profile_dir: str, step: int) -> None:
        path = os.path.join(profile_dir, f"step{step:06d}.pt.trace.json")
        profiling.stop_trace(profiler, path, self.device)
        print(f"profiler trace written to {path}")


def main(argv=None):
    """``python -m instancesegmentation_tpu_torch.train [flags]``: train on
    ``cuda:<local rank>`` (every ``TrainConfig`` field is a flag).  With
    ``--multihost`` the process first joins the process group: ``--coordinator
    host:port --num-processes N --process-id R``, or none of the three under
    torchrun; it leaves the group when training ends."""
    cfg = parse_args(argv)
    if cfg.multihost:
        multihost.initialize(
            coordinator=cfg.coordinator or None,
            num_processes=cfg.num_processes or None,
            process_id=cfg.process_id if cfg.process_id >= 0 else None,
        )
    try:
        Trainer(cfg).train()
    finally:
        if cfg.multihost:
            multihost.shutdown()


if __name__ == "__main__":
    main()
