"""Data-parallel train and eval steps over ``torch.distributed``.

Port of ``instancesegmentation_tpu/parallel/data_parallel.py``.  JAX shards
one process's global batch over a mesh with ``shard_map``; here one process
per device runs the single-process step (``train/steps.py``) on its rows of
the global batch:

- every train-mode BN takes the global batch's statistics (flax's biased
  variance) through one differentiable all-reduce of ``[E[x], E[x^2]]``
  per layer (``models/layers.py:sync_batchnorm``), forward and backward;
- after ``backward`` (and the dead PReLU's zero gradients), ONE all-reduce
  of every gradient flattened, with the loss and the train IoU appended,
  divided by the world size (JAX's ``pmean``); then the Adam step, the same
  on every rank, so the state stays replicated without a broadcast.

``Segment(20)`` has 74 BN layers: a step runs 2 x 74 + 1 = 149 collectives,
and 74 more with ``cfg.remat`` (the recompute takes each BN's batch
statistics again).

Augmentation draws differ from the JAX package's by design: JAX folds the
shard index into each shard's key, so its data-parallel draws differ from
one device's; here every rank draws the GLOBAL batch's draws from the same
generator and keeps its rows, so a run over N ranks sees exactly the draws
of the single-process run at the same global batch.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from instancesegmentation_tpu_torch.data.pipeline import batch_to, preprocess_batch
from instancesegmentation_tpu_torch.models.layers import sync_batchnorm
from instancesegmentation_tpu_torch.parallel.mesh import Mesh, make_mesh
from instancesegmentation_tpu_torch.train.state import TrainState
from instancesegmentation_tpu_torch.train.steps import (
    augment_config,
    batch_mask_iou,
    bce_loss,
    make_eval_step,
    make_fwd,
)

def _rows(draws: dict, rows: slice, global_batch: int) -> dict:
    """This rank's rows of the global batch's draws."""
    if draws["theta"].shape[0] != global_batch:
        raise ValueError(f"draws for {draws['theta'].shape[0]} rows; the step takes the "
                         f"global batch's {global_batch}")
    return {k: None if v is None else v[rows] for k, v in draws.items()}


def make_parallel_steps(cfg, mesh: Mesh = None):
    """Build ``(mesh, train_step, eval_step, shard_batch)`` for DP training.

    ``cfg.batch_size`` is the GLOBAL batch and must divide by the world size.
    The mesh holds this process's one device (default: ``cuda:<local
    rank>``).  ``train_step(state, batch, draws)`` takes this rank's rows
    (``shard_batch``) and the global batch's draws; ``eval_step(model,
    batch)`` returns this rank's ``images, probs, masks, ious``.
    """
    if mesh is None:
        from instancesegmentation_tpu_torch.parallel.multihost import local_rank

        mesh = make_mesh(devices=[torch.device("cuda", local_rank())])
    if mesh.size != 1:
        raise ValueError(f"the data-parallel step runs one device per process, not "
                         f"{mesh.size}: start one process per GPU (--multihost or torchrun)")
    n = mesh.world_size
    if cfg.batch_size % n:
        raise ValueError(f"global batch {cfg.batch_size} not divisible by {n} processes")
    per = cfg.batch_size // n
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    group = dist.group.WORLD if dist.is_initialized() else None
    aug = augment_config(cfg, train=True)
    device = mesh.devices[0]

    def shard_batch(batch: dict) -> dict:
        """This rank's rows of a global host batch; a batch of local rows
        (the loader's ``local_slice``) passes unchanged."""
        b = batch["image"].shape[0]
        if b == per:
            return batch
        if b != cfg.batch_size:
            raise ValueError(f"a batch of {b} rows is neither the global {cfg.batch_size} "
                             f"nor the local {per}")
        return {k: v[rows] for k, v in batch.items()}

    def train_step(state: TrainState, batch: dict, draws: dict):
        model = state.model
        images, heatmaps, masks = preprocess_batch(
            batch_to(batch, device), _rows(draws, rows, cfg.batch_size), aug)
        state.optimizer.zero_grad(set_to_none=True)
        with sync_batchnorm(model, group):
            logits = make_fwd(model, cfg, train=True)(images, heatmaps)
            loss = bce_loss(logits, masks)
            loss.backward()
        params = list(model.parameters())
        for p in params:
            # the dead PReLU's zero gradient, as in the single-process step
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            iou = batch_mask_iou(torch.sigmoid(logits), masks)
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [loss.detach().reshape(1), iou.reshape(1).to(loss.dtype)])
            if group is not None:
                dist.all_reduce(flat, group=group)
                flat /= n
            for p, g in zip(params, flat[:-2].split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
        state.optimizer.step()
        state.step += 1
        return state, {"loss": flat[-2], "train_iou": flat[-1]}

    # evaluation needs no collective: BN runs on its running statistics
    return mesh, train_step, make_eval_step(cfg), shard_batch


def collectives_per_step(model: torch.nn.Module, remat: bool = False) -> int:
    """All-reduces of one data-parallel train step of ``model``: one forward
    and one backward per train-mode BN layer (with ``remat`` one more
    forward, in the recompute), and one for the gradients."""
    return (3 if remat else 2) * sum(hasattr(m, "bn_group") for m in model.modules()) + 1
