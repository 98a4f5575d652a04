"""Dataset evaluation: mean mask IoU and COCO-style mask AP, on the card.

Port of ``instancesegmentation_tpu/eval.py``, with its two protocols and
its JSON keys:

- per-crop (default): instance-mode inference per eligible object, scored
  against the GT mask warped by the same transform (the training
  validation's protocol, extended with AP).  With one GT per crop this AP
  is a per-crop accuracy; it is kept for comparison with the JAX package.
- ``--full-image``: multi-instance mask AP.  Per image, every GT (or
  ``--proposals``-provided) box is segmented through the proposal path
  (NMS, crop, forward, inverse warp) and the image's predictions are scored
  against its full GT instance set, with the mean in-mask probability as
  the confidence.

Usage:
  python -m instancesegmentation_tpu_torch.eval --dataset DIR \\
      [--checkpoint X.ckpt|X.pth] [--size 480] [--batch 8] \\
      [--in-channels 20] [--max-batches N] [--float32] [--int8] [--fused-stem] \\
      [--full-image] [--proposals boxes.json] [--nms-threshold T]

Prints one JSON line.  The engine runs on ``cuda:0``; the library
functions and ``main`` take ``device="cpu"`` to run on the host.  Without
``--checkpoint`` the weights are the port's seeded initialisation
(``init_weights_`` from ``torch.Generator().manual_seed(0)``), which are not
the JAX package's ``PRNGKey(0)`` weights.  GT masks are read with
``imread(..., "gray")`` and images with ``imread(..., "color")`` (RGB); a
mask file that ``cv2.imread`` could not decode skips its object, as in the
JAX package.
``--int8`` serves int8 (``models/quantize.py``), calibrated on the first 2
batches of 8 instances of the evaluated dataset; ``--fused-stem`` serves the
keypoint-patch stem (``models/fused_stem_hm.py``; 20-channel models).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from instancesegmentation_tpu_torch.core.evaluation import mask_ap, mask_ap_rle, mean_mask_iou
from instancesegmentation_tpu_torch.core.keys import key_combine
from instancesegmentation_tpu_torch.core.imread import imread
from instancesegmentation_tpu_torch.core.rasterize import rle_encode
from instancesegmentation_tpu_torch.core.records import ROOT_KEY, common_ann_loader
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset, body_keypoint_array
from instancesegmentation_tpu_torch.data.pipeline import (
    AugmentConfig,
    batch_iterator,
    batch_to,
    draw_augment,
    preprocess_batch,
)
from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine, load_any_checkpoint
from instancesegmentation_tpu_torch.infer.proposals import _mask_score, iter_segment_proposals
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.quantize import calibrate_on_dataset
from instancesegmentation_tpu_torch.models.segment import Segment


def load_weights(checkpoint: Optional[str], in_channels: int) -> dict:
    """The checkpoint's weights (``load_any_checkpoint``), or without one the
    port's seeded initialisation (``init_weights_``, generator seed 0)."""
    if checkpoint:
        return load_any_checkpoint(checkpoint)
    model = Segment(in_channels)
    init_weights_(model, torch.Generator().manual_seed(0))
    return model.state_dict()


def _build_engine(checkpoint, size, in_channels, bfloat16, device=None,
                  int8_dataset=None, fused_stem=False) -> InferenceEngine:
    """``int8_dataset``: a common-format directory to calibrate int8 serving
    on (its first batches; the scales live outside the checkpoint).
    ``fused_stem``: the keypoint-patch stem (20-channel models)."""
    dtype = torch.bfloat16 if bfloat16 else torch.float32
    weights = load_weights(checkpoint, in_channels)
    quant = None
    if int8_dataset:
        quant = calibrate_on_dataset(weights, int8_dataset, in_channels=in_channels, size=size,
                                     device=device)
    return InferenceEngine(weights, in_channels=in_channels, size=size, dtype=dtype,
                           fused_stem=fused_stem, quant=quant, device=device)


def evaluate_full_image(
    dataset_dir: str,
    checkpoint: str | None = None,
    size: int = 480,
    in_channels: int = 20,
    bfloat16: bool = True,
    proposals_path: str | None = None,
    nms_threshold: float = 0.9,
    max_instances: int = 16,
    max_images: int = 0,
    canvas: int = 640,
    use_keypoints: bool = True,
    int8: bool = False,
    fused_stem: bool = False,
    device=None,
    _segment_fn=None,
) -> dict:
    """Full-image multi-instance mask AP over a common-format dataset.

    Per image: GT boxes (or external proposals) -> proposal path ->
    predicted masks at image resolution, confidence = mean in-mask
    probability -> COCO mask AP against the image's full GT instance set.

    GT-box mode feeds each object's keypoints through the instance program
    (``use_keypoints``), so a conditioned checkpoint is scored conditioned;
    GT boxes are never NMS-deduplicated (two occluded instances can share
    one box).  External proposal entries may carry a ``"keypoints"`` list
    ([N, 17, 3]) and go through NMS.

    Predictions and GTs are kept as RLEs (``mask_ap_rle``), and the crops of
    consecutive images share dispatches of up to 128 rows
    (``iter_segment_proposals``).

    ``_segment_fn(image_rgb, boxes, scores, keypoints) ->
    list[{"mask", "mask_score"}]`` replaces the engine in tests.
    """
    proposal_map = None
    if proposals_path:
        with open(proposals_path) as f:
            proposal_map = json.load(f)

    k_img = key_combine("image", "image_path")
    k_objs = key_combine("object", "sub_list")
    k_mask = key_combine("instance_mask", "mask_path")
    k_box = key_combine("box", "box_xyxy")
    k_body = key_combine("body_keypoint", "sub_dict")

    gts_rle: list[list[dict]] = []

    def _requests():
        """Per-image request stream; GT masks are RLE-encoded into
        ``gts_rle`` as they are read, bitmaps dropped at once."""
        n_images = 0
        for ann in common_ann_loader(dataset_dir):
            if max_images and n_images >= max_images:
                break
            root = ann[ROOT_KEY]
            gt_rles, gt_boxes, gt_kps = [], [], []
            for obj in ann.get(k_objs, []):
                rel = obj.get(k_mask)
                if rel is None:
                    continue
                try:
                    m = imread(os.path.join(root, rel), "gray")
                except FileNotFoundError:
                    continue
                gt_rles.append(rle_encode(m))
                gt_boxes.append(obj.get(k_box))
                gt_kps.append(body_keypoint_array(obj.get(k_body)))
            if not gt_rles:
                continue

            img_path = os.path.join(root, ann[k_img])
            name = os.path.splitext(os.path.basename(img_path))[0]
            keypoints = None
            if proposal_map is not None:
                entry = proposal_map.get(name) or proposal_map.get(os.path.basename(img_path))
                if not entry:
                    # no proposals for this image: zero predictions (its GTs
                    # still count as misses)
                    boxes, scores = [], []
                else:
                    boxes, scores = entry["boxes"], entry["scores"]
                    if use_keypoints and entry.get("keypoints"):
                        keypoints = np.asarray(entry["keypoints"], np.float32)
            else:
                paired = [(b, k) for b, k in zip(gt_boxes, gt_kps) if b is not None]
                boxes = [b for b, _ in paired]
                scores = [1.0] * len(boxes)
                if use_keypoints and paired:
                    keypoints = np.stack([k for _, k in paired])

            img = np.zeros((1, 1, 3), np.uint8)
            if boxes:
                img = imread(img_path, "color")
            gts_rle.append(gt_rles)
            n_images += 1
            yield {"image": img, "boxes": boxes, "scores": scores, "keypoints": keypoints,
                   "nms": proposal_map is not None}

    preds_rle: list[dict] = []

    def _consume(results):
        preds_rle.append({"masks": [rle_encode(r["mask"]) for r in results],
                          "scores": [r["mask_score"] for r in results]})

    if _segment_fn is not None:
        for req in _requests():
            _consume(_segment_fn(req["image"], req["boxes"], req["scores"], req["keypoints"])
                     if req["boxes"] else [])
    else:
        engine = _build_engine(checkpoint, size, in_channels, bfloat16, device,
                               int8_dataset=dataset_dir if int8 else None,
                               fused_stem=fused_stem)
        for results in iter_segment_proposals(engine, _requests(), nms_threshold=nms_threshold,
                                              max_instances=max_instances, canvas=canvas):
            _consume(results)

    ap = mask_ap_rle(preds_rle, gts_rle)
    return {
        "protocol": "full_image",
        "AP": round(ap["AP"], 6),
        "AP50": round(ap["AP50"], 6),
        "AP75": round(ap["AP75"], 6),
        "num_images": len(gts_rle),
        "num_gt_instances": sum(len(g) for g in gts_rle),
        "num_predictions": sum(len(p["masks"]) for p in preds_rle),
        "conditioned": bool(use_keypoints),
        "confidence": "mean_in_mask_probability",
    }


def evaluate_dataset(
    dataset_dir: str,
    checkpoint: str | None = None,
    size: int = 480,
    batch_size: int = 8,
    in_channels: int = 20,
    max_batches: int = 0,
    bfloat16: bool = True,
    legacy_confidence: bool = False,
    int8: bool = False,
    fused_stem: bool = False,
    device=None,
) -> dict:
    """Per-crop protocol: each eligible instance's crop prediction against
    its GT mask warped into the crop by ``preprocess_batch`` with no
    augmentation (on the engine's device); mean IoU and singleton AP."""
    engine = _build_engine(checkpoint, size, in_channels, bfloat16, device,
                           int8_dataset=dataset_dir if int8 else None, fused_stem=fused_stem)
    ds = InstanceCommonDataset(dataset_dir)
    aug = AugmentConfig(out_size=(size, size))
    pred_masks: list[np.ndarray] = []
    gt_masks: list[np.ndarray] = []
    scores: list[float] = []

    for k, batch in enumerate(
        batch_iterator(ds, batch_size, shuffle=False, epochs=1, drop_last=False)
    ):
        probs, _ = engine.predict_instances(batch)
        draws = draw_augment(probs.shape[0], aug)
        _, _, masks = preprocess_batch(batch_to(batch, engine.device), draws, aug)
        masks = masks.cpu().numpy()
        for i in range(probs.shape[0]):
            p = probs[i, ..., 0]
            pred_masks.append((p > 0.5).astype(np.uint8) * 255)
            gt_masks.append((masks[i, ..., 0] > 0.5).astype(np.uint8) * 255)
            scores.append(float((p > 0.5).mean()) + 0.5 if legacy_confidence
                          else _mask_score(p, engine.threshold))
        if max_batches and k + 1 >= max_batches:
            break

    n = min(len(pred_masks), len(ds))  # drop the tail batch's repeats
    pred_masks, gt_masks, scores = pred_masks[:n], gt_masks[:n], scores[:n]

    miou = mean_mask_iou(pred_masks, gt_masks)
    # AP treats each crop as one image with one GT instance (a per-crop
    # accuracy; --full-image gives multi-instance AP)
    preds = [{"masks": [p], "scores": [s]} for p, s in zip(pred_masks, scores)]
    ap = mask_ap(preds, [[g] for g in gt_masks])
    return {
        "protocol": "per_crop",
        "mean_iou": round(float(miou), 6),
        "AP": round(ap["AP"], 6),
        "AP50": round(ap["AP50"], 6),
        "AP75": round(ap["AP75"], 6),
        "num_instances": n,
        "confidence": ("legacy_fg_fraction_proxy" if legacy_confidence
                       else "mean_in_mask_probability"),
        "ap_note": "per-crop singleton AP (crop accuracy), not "
                   "multi-instance AP; use --full-image for the latter",
    }


def main(argv=None, device=None) -> int:
    """``python -m instancesegmentation_tpu_torch.eval [flags]``: prints one
    JSON line; the engine runs on ``device`` (``cuda:0`` when None)."""
    parser = argparse.ArgumentParser(description="evaluate on a common-format dataset")
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--size", type=int, default=480)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--in-channels", type=int, default=20)
    parser.add_argument("--max-batches", type=int, default=0)
    parser.add_argument("--float32", action="store_true")
    parser.add_argument("--full-image", action="store_true",
                        help="multi-instance mask AP per image via the proposal path "
                             "(GT boxes unless --proposals is given)")
    parser.add_argument("--proposals", default=None,
                        help="JSON {image_name: {boxes, scores}} for --full-image mode")
    parser.add_argument("--nms-threshold", type=float, default=0.9)
    parser.add_argument("--max-instances", type=int, default=16)
    parser.add_argument("--max-images", type=int, default=0)
    parser.add_argument("--canvas", type=int, default=640)
    parser.add_argument("--no-keypoints", action="store_true",
                        help="score --full-image unconditioned (zero heatmaps) even "
                             "when GT keypoints exist")
    parser.add_argument("--legacy-confidence", action="store_true",
                        help="per-crop protocol: rank by the foreground-fraction proxy "
                             "instead of the mean in-mask probability")
    parser.add_argument("--int8", action="store_true",
                        help="int8 PTQ serving, calibrated on the eval set's first "
                             "batches (models/quantize.py)")
    parser.add_argument("--fused-stem", action="store_true",
                        help="patch-folded conditioned stem instead of the dense heatmap "
                             "render (models/fused_stem_hm.py; 20-channel only)")
    args = parser.parse_args(argv)
    if args.full_image:
        result = evaluate_full_image(
            args.dataset, args.checkpoint, args.size, args.in_channels,
            bfloat16=not args.float32, proposals_path=args.proposals,
            nms_threshold=args.nms_threshold, max_instances=args.max_instances,
            max_images=args.max_images, canvas=args.canvas,
            use_keypoints=not args.no_keypoints, int8=args.int8,
            fused_stem=args.fused_stem, device=device,
        )
    else:
        result = evaluate_dataset(
            args.dataset, args.checkpoint, args.size, args.batch, args.in_channels,
            args.max_batches, bfloat16=not args.float32,
            legacy_confidence=args.legacy_confidence, int8=args.int8,
            fused_stem=args.fused_stem, device=device,
        )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
