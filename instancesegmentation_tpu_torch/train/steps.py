"""Train and eval steps with the preprocessing program in front of them.

Port of ``instancesegmentation_tpu/train/steps.py``.  A train step takes the
HOST batch (canvas uint8 + geometry) and the batch's augmentation draws
(``data/pipeline.py:draw_augment``), and runs preprocess -> forward -> loss
-> backward -> Adam update on the model's device.  The loss is
sigmoid-BCE-with-logits, averaged.  Compute runs in bfloat16 when
``cfg.bfloat16`` (parameters, BN statistics and the loss targets stay
float32), as the JAX package's ``dtype=bfloat16`` modules do; the rotated
crop warp of the 2level sampler runs the ``warp_2level`` kernels on the card.
"""
from __future__ import annotations

from typing import Callable

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from instancesegmentation_tpu_torch.data.pipeline import (
    AugmentConfig,
    batch_to,
    draw_augment,
    preprocess_batch,
)
from instancesegmentation_tpu_torch.models.fused_head import fold_head_live, head_apply
from instancesegmentation_tpu_torch.models.layers import recomputing
from instancesegmentation_tpu_torch.train.state import TrainState


def augment_config(cfg, train: bool) -> AugmentConfig:
    """The preprocessing of ``cfg``: its augmentations when ``train``, none
    for evaluation; model inputs in the compute dtype."""
    return AugmentConfig(
        out_size=cfg.out_hw,
        flip_prob=cfg.flip_prob if train else 0.0,
        jitter=cfg.jitter if train else 0.0,
        rotate=cfg.rotate if train else 0.0,
        rotate_prob=cfg.rotate_prob,
        rotate_chunk=cfg.rotate_chunk,
        rotate_impl=cfg.rotate_impl,
        rotate_block=cfg.rotate_block,
        brightness=cfg.brightness if train else 0.0,
        contrast=cfg.contrast if train else 0.0,
        noise_std=cfg.noise_std if train else 0.0,
        out_dtype=torch.bfloat16 if cfg.bfloat16 else None,
    )


def bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, targets)


def per_sample_mask_iou(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-sample mask IoU [B] (binarised at 0.5; empty vs empty counts as
    1.0)."""
    pred = probs > 0.5
    true = targets > 0.5
    inter = (pred & true).sum(dim=(1, 2, 3))
    union = (pred | true).sum(dim=(1, 2, 3))
    return torch.where(union > 0, inter / union.clamp_min(1),
                       torch.ones((), device=probs.device))


def batch_mask_iou(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Batch-mean mask IoU (see per_sample_mask_iou)."""
    return per_sample_mask_iou(probs, targets).mean()


def make_fwd(model, cfg, train: bool) -> Callable:
    """Build ``(images, heatmaps) -> float32 logits``.

    With ``cfg.fused_head`` the section-6 head runs in its folded form,
    re-derived from the live parameters at every call (``fold_head_live`` is
    differentiable, so gradients reach ``bottle6_1``/``bottle6_2``).  The head
    has no BN or activation, so the fold holds in train mode.

    With ``cfg.remat`` a train forward runs under ``torch.utils.checkpoint``
    (JAX's ``jax.checkpoint`` of the whole forward): it keeps its inputs
    only, and the backward recomputes it inside ``recomputing()``, where BN
    takes its batch statistics again (under sync BN, one more all-reduce per
    layer) but leaves the running statistics to the first pass.  The
    recompute repeats the forward's arithmetic, so the gradients are those of
    the step without remat.
    """
    dtype = torch.bfloat16 if cfg.bfloat16 else torch.float32

    def fwd(images, heatmaps):
        hm = heatmaps if cfg.use_heatmaps else None
        if not cfg.fused_head:
            return model(images, hm, train=train, dtype=dtype)
        feats = model(images, hm, truncate_head=True, train=train, dtype=dtype)
        return head_apply(feats, fold_head_live(model), dtype=dtype).float()

    if not (train and cfg.remat):
        return fwd
    return lambda images, heatmaps: checkpoint(
        fwd, images, heatmaps, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recomputing()))


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_train_step(cfg) -> Callable:
    """``step(state, batch, draws) -> (state, metrics)``: one Adam step of
    ``state`` (updated in place) on the host ``batch`` with the augmentation
    ``draws`` of ``draw_augment(b, augment_config(cfg, True), generator)``.
    ``metrics`` holds the device scalars ``loss`` and ``train_iou``."""
    aug = augment_config(cfg, train=True)

    def train_step(state: TrainState, batch: dict, draws: dict):
        model = state.model
        images, heatmaps, masks = preprocess_batch(batch_to(batch, _device(model)), draws, aug)
        state.optimizer.zero_grad(set_to_none=True)
        logits = make_fwd(model, cfg, train=True)(images, heatmaps)
        loss = bce_loss(logits, masks)
        loss.backward()
        for p in model.parameters():
            # a parameter the loss does not reach (a dead PReLU) gets a zero
            # gradient, as in optax, whose Adam still decays its moments and
            # applies them; torch's Adam would skip it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        with torch.no_grad():
            iou = batch_mask_iou(torch.sigmoid(logits), masks)
        state.step += 1
        return state, {"loss": loss.detach(), "train_iou": iou}

    return train_step


def make_eval_step(cfg) -> Callable:
    """``eval_step(model, batch) -> (images [B,H,W,3] in [-1,1], probs
    [B,H,W,1], masks, ious [B])``, with no augmentation; the per-sample IoUs
    let a caller drop padded tail samples."""
    aug = augment_config(cfg, train=False)

    def eval_step(model, batch: dict):
        batch = batch_to(batch, _device(model))
        with torch.no_grad():
            draws = draw_augment(batch["image"].shape[0], aug)
            images, heatmaps, masks = preprocess_batch(batch, draws, aug)
            probs = torch.sigmoid(make_fwd(model, cfg, train=False)(images, heatmaps))
        return images, probs, masks, per_sample_mask_iou(probs, masks)

    return eval_step
