"""Proposal-to-ground-truth matching (detection ``Matcher`` semantics).

Port of ``instancesegmentation_tpu/ops/matching.py`` (``match_proposals``,
the Pallas kernel ``match_proposals_pallas`` and ``subsample_labels``).
Each proposal gets the index of its best ground truth (the first one among
ties) and a label:

  label  1 (positive):   best IoU >= high_threshold
  label  0 (negative):   best IoU <  low_threshold
  label -1 (ignore):     in between

``allow_low_quality`` also makes positive every proposal that reaches some
ground truth's maximum IoU (when that maximum is above 0), keeping its own
best match (the torchvision / Detectron rule).

A CPU tensor runs ``match_proposals_reference``; a CUDA tensor runs the
kernels of ``csrc/matching.cu`` (counted in ``match_proposals.launches``).
"""
from __future__ import annotations

import ctypes

import torch

POSITIVE = 1
NEGATIVE = 0
IGNORE = -1


def match_proposals_reference(iou: torch.Tensor, high_threshold: float = 0.5,
                              low_threshold: float = 0.3, allow_low_quality: bool = True):
    """The plain version: ``iou [P, G]`` -> ``(matched [P] int64, labels [P]
    int32)``."""
    best, matched = iou.max(dim=1)
    labels = torch.where(
        best >= high_threshold,
        POSITIVE,
        torch.where(best < low_threshold, NEGATIVE, IGNORE),
    ).to(torch.int32)
    if allow_low_quality:
        gt_best = iou.max(dim=0).values  # [G]
        is_best = ((iou == gt_best[None, :]) & (gt_best[None, :] > 0)).any(dim=1)
        labels = torch.where(is_best, POSITIVE, labels).to(torch.int32)
    return matched, labels


def _library():
    from instancesegmentation_tpu_torch.ops import _build

    fn = _build.library("matching.cu").match_proposals_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(iou, high_threshold, low_threshold, allow_low_quality):
    fn = _library()
    p, g = iou.shape
    dev = iou.device
    matched = torch.empty(p, dtype=torch.int64, device=dev)
    labels = torch.empty(p, dtype=torch.int32, device=dev)
    gt_best = torch.empty(g, dtype=torch.float32, device=dev)  # scratch of the first pass
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(iou.data_ptr(), gt_best.data_ptr(), matched.data_ptr(), labels.data_ptr(),
                p, g, high_threshold, low_threshold, int(allow_low_quality), stream)
    if rc != 0:
        raise RuntimeError(f"match_proposals kernel launch failed: CUDA error {rc}")
    return matched, labels


def match_proposals(iou: torch.Tensor, high_threshold: float = 0.5,
                    low_threshold: float = 0.3, allow_low_quality: bool = True):
    """``iou [P, G]`` proposal-by-ground-truth IoU (G >= 1) -> ``(matched [P]
    int64, labels [P] int32)``.  The matrix is taken in float32.

    A CPU tensor runs ``match_proposals_reference``; a CUDA tensor launches
    the kernels (counted in ``match_proposals.launches``) or raises.
    """
    if iou.dim() != 2 or iou.shape[1] == 0:
        raise ValueError(f"match_proposals expects iou [P, G] with G >= 1, got "
                         f"{tuple(iou.shape)}")
    iou = iou.float().contiguous()
    if iou.device.type == "cpu":
        return match_proposals_reference(iou, high_threshold, low_threshold,
                                         allow_low_quality)
    if iou.device.type != "cuda":
        raise RuntimeError(f"match_proposals has no kernel for device {iou.device}")
    if iou.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int64, device=iou.device),
                torch.empty(0, dtype=torch.int32, device=iou.device))
    out = _launch(iou, high_threshold, low_threshold, allow_low_quality)
    match_proposals.launches += 1
    return out


match_proposals.launches = 0


def subsample_labels(labels: torch.Tensor, generator: torch.Generator, batch_size: int,
                     positive_fraction: float = 0.25) -> torch.Tensor:
    """Keep at random about ``batch_size`` labels, at most
    ``int(batch_size * positive_fraction)`` of them positive, and the rest
    negative as far as there are negatives; every other entry becomes
    IGNORE.  The noise is drawn from ``generator``, on its device."""
    pos = labels == POSITIVE
    neg = labels == NEGATIVE
    num_pos_target = int(batch_size * positive_fraction)

    def pick(mask, target):
        noise = torch.rand(mask.shape, generator=generator,
                           device=generator.device).to(mask.device)
        # rank the eligible entries by noise and keep the `target` smallest
        score = torch.where(mask, noise, torch.full_like(noise, 2.0))
        quota = torch.clamp(mask.sum(), max=target)
        kth = torch.sort(score).values[torch.clamp(quota - 1, min=0)]
        return mask & (score <= kth) & (quota > 0)

    keep_pos = pick(pos, num_pos_target)
    keep_neg = pick(neg, batch_size - keep_pos.sum())
    out = torch.full_like(labels, IGNORE)
    out = torch.where(keep_pos, POSITIVE, out)
    return torch.where(keep_neg, NEGATIVE, out).to(labels.dtype)
