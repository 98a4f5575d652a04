"""Evaluation metrics: mean mask IoU and COCO-style mask AP.

Copy of ``instancesegmentation_tpu/core/evaluation.py`` (numpy only, so the
results equal the JAX package's to the last bit): greedy score-ordered
matching per image at each IoU threshold and 101-point interpolated
precision (the COCOeval protocol).  ``mask_ap_rle`` takes the IoU matrix of
each image from the native run-merge walk (``ops/native``) when the library
builds, else decodes the RLEs; ``mask_ap_rle.native_calls`` and
``mask_ap_rle.numpy_calls`` count the images each path scored.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from instancesegmentation_tpu_torch.core.masks import mask_iou
from instancesegmentation_tpu_torch.core.rasterize import rle_decode
from instancesegmentation_tpu_torch.ops.native.build import rle_iou_matrix_native

COCO_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def mask_iou_matrix(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray]) -> np.ndarray:
    """[P, G] IoU matrix of binarized uint8 masks."""
    out = np.zeros((len(preds), len(gts)), dtype=np.float64)
    pred_bool = [np.asarray(p) > 127 for p in preds]
    gt_bool = [np.asarray(g) > 127 for g in gts]
    for i, p in enumerate(pred_bool):
        for j, g in enumerate(gt_bool):
            union = np.logical_or(p, g).sum()
            out[i, j] = (
                1.0 if union == 0 else np.logical_and(p, g).sum() / union
            )
    return out


def match_image(
    iou: np.ndarray, scores: np.ndarray, threshold: float
) -> np.ndarray:
    """Greedy COCO matching for one image.

    Predictions in descending score order claim the highest-IoU unmatched
    GT with IoU >= threshold.  Returns a bool TP flag per prediction (in
    the original prediction order).
    """
    order = np.argsort(-np.asarray(scores), kind="stable")
    gt_taken = np.zeros(iou.shape[1], dtype=bool)
    tp = np.zeros(iou.shape[0], dtype=bool)
    if iou.shape[1] == 0:
        return tp
    for p in order:
        # highest-IoU unmatched GT wins (vectorized over GTs; the outer
        # loop must stay sequential — matching is greedy in score order)
        row = np.where(gt_taken, -1.0, iou[p])
        j = int(np.argmax(row))
        if row[j] >= threshold:
            gt_taken[j] = True
            tp[p] = True
    return tp


def average_precision(
    tp_flags: np.ndarray, scores: np.ndarray, num_gt: int
) -> float:
    """101-point interpolated AP over the whole dataset."""
    if num_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores), kind="stable")
    tp = np.asarray(tp_flags, dtype=np.float64)[order]
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)

    # precision envelope + 101-point sampling (COCOeval)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    recall_points = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, recall_points, side="left")
    sampled = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(sampled.mean())


def _ap_over_thresholds(iou_mats, all_scores, num_gt, thresholds) -> dict:
    """Shared matching/AP assembly for mask_ap and mask_ap_rle."""
    per_threshold = {}
    for t in thresholds:
        flags = [match_image(iou, s, t) for iou, s in zip(iou_mats, all_scores)]
        per_threshold[float(t)] = average_precision(
            np.concatenate(flags) if flags else np.zeros(0),
            np.concatenate(all_scores) if all_scores else np.zeros(0),
            num_gt,
        )
    values = list(per_threshold.values())
    return {
        "AP": float(np.mean(values)),
        "AP50": per_threshold.get(0.5, float("nan")),
        "AP75": per_threshold.get(0.75, float("nan")),
        "per_threshold": per_threshold,
    }


def mask_ap(
    predictions: Sequence[dict],
    ground_truths: Sequence[Sequence[np.ndarray]],
    thresholds: Sequence[float] = COCO_THRESHOLDS,
) -> dict:
    """COCO-style mask AP over a dataset.

    predictions: per image, ``{"masks": [uint8 mask, ...],
                 "scores": [float, ...]}``.
    ground_truths: per image, list of uint8 GT masks.

    Returns {"AP": mAP over thresholds, "AP50": ..., "AP75": ...,
             "per_threshold": {t: AP}}.
    """
    assert len(predictions) == len(ground_truths)
    iou_mats = []
    all_scores = []
    for pred, gts in zip(predictions, ground_truths):
        iou_mats.append(mask_iou_matrix(pred["masks"], list(gts)))
        all_scores.append(np.asarray(pred["scores"], dtype=np.float64))
    num_gt = sum(len(g) for g in ground_truths)
    return _ap_over_thresholds(iou_mats, all_scores, num_gt, thresholds)


def mask_ap_rle(
    predictions: Sequence[dict],
    ground_truths: Sequence[Sequence[dict]],
    thresholds: Sequence[float] = COCO_THRESHOLDS,
) -> dict:
    """``mask_ap`` over RLE-encoded masks.

    Uses the native C++ run-merge IoU (ops/native) when a toolchain is
    available — O(runs) per pair instead of O(pixels) — with a
    decode-to-bitmap NumPy path.  predictions[i]["masks"] is a list of RLE
    dicts here.
    """
    assert len(predictions) == len(ground_truths)
    iou_mats = []
    all_scores = []
    for pred, gts in zip(predictions, ground_truths):
        mat = rle_iou_matrix_native(list(pred["masks"]), list(gts))
        if mat is None:
            mat = mask_iou_matrix(
                [rle_decode(r) for r in pred["masks"]],
                [rle_decode(r) for r in gts],
            )
            mask_ap_rle.numpy_calls += 1
        else:
            mask_ap_rle.native_calls += 1
        iou_mats.append(mat)
        all_scores.append(np.asarray(pred["scores"], dtype=np.float64))
    num_gt = sum(len(g) for g in ground_truths)
    return _ap_over_thresholds(iou_mats, all_scores, num_gt, thresholds)


mask_ap_rle.native_calls = 0
mask_ap_rle.numpy_calls = 0


def mean_mask_iou(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray]) -> float:
    """Paired mean IoU (the reference's val metric, ref :402-403)."""
    return float(np.mean([mask_iou(p, g) for p, g in zip(preds, gts)]))
