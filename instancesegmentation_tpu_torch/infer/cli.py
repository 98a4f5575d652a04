"""Inference command, flag-compatible with the JAX package's
(``instancesegmentation_tpu/infer/cli.py``):

    python -m instancesegmentation_tpu_torch.infer -i DIR -o OUT \\
        [--dataset-mode | --proposals boxes.json] [--checkpoint X.ckpt|X.pth] \\
        [--size 512] [--batch 8] [--threshold 0.5] [--in-channels 3|20] \\
        [--float32] [--continue-test] [--int8 [--int8-calib-batches 2]] [--fused-stem]

Three modes: whole image (one mask per image in ``DIR``, ``OUT/<name>.png``),
``--dataset-mode`` (instance crops with keypoint conditioning over a
common-format directory; the masks mirror its
``instance_mask/<image>/<i>.png`` layout) and ``--proposals`` (NMS over the
boxes of a JSON ``{image_name: {boxes, scores}}``, then one mask per
surviving box, ``OUT/<name>_<j>.png``).  ``--continue-test`` skips outputs
that exist.

The engine runs on ``cuda:0`` (``main(argv, device="cpu")`` runs it on the
host).  Images are decoded by ``core/imread.py:imread`` as ``cv2.imread``
decodes them; a listed file of a form the port does not decode (AVIF;
ROADMAP A10 part 3) raises ``UnsupportedImage`` naming it.  Dataset mode
writes each mask with ``core/imwrite.py:imwrite`` in the format of its
record's path, as ``cv2.imwrite`` does (where cv2 refuses a gray mask, as
for ``.ppm``, no file is written and the run goes on); the other modes
write PNG with ``write_png``.  Without ``--checkpoint`` the weights are the
port's seeded initialisation (``eval.load_weights``).  ``--int8`` serves int8
(``models/quantize.py``, the "int8_mxu" convs), calibrated on the input
itself: in dataset mode on its first ``--int8-calib-batches`` batches of
``--batch`` instances, otherwise on the first ``--int8-calib-batches *
--batch`` images of the directory.  ``--fused-stem`` serves the
keypoint-patch stem (``models/fused_stem_hm.py``) in dataset and proposal
mode with a 20-channel model.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from instancesegmentation_tpu_torch.core.keys import key_combine
from instancesegmentation_tpu_torch.core.imread import imread
from instancesegmentation_tpu_torch.core.imwrite import imwrite
from instancesegmentation_tpu_torch.core.png import write_png
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.pipeline import batch_iterator
from instancesegmentation_tpu_torch.eval import load_weights
from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
from instancesegmentation_tpu_torch.infer.proposals import segment_proposals
from instancesegmentation_tpu_torch.models.quantize import (
    calibrate_on_dataset,
    calibrate_on_images,
)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="inference image")
    parser.add_argument("-i", "--test-image-dir", required=True,
                        help="image test dir (or common-format dataset dir)")
    parser.add_argument("-o", "--output-dir", required=True, help="mask save dir")
    parser.add_argument("--continue-test", action="store_true", help="skip existing files")
    parser.add_argument("--checkpoint", default=None,
                        help=".ckpt (either package) or .pth (torch reference)")
    parser.add_argument("--dataset-mode", action="store_true",
                        help="treat input as a common-format dataset; per-instance "
                             "crops + keypoint conditioning")
    parser.add_argument("--proposals", default=None,
                        help="JSON file {image_name: {boxes: [[xyxy]...], scores: [...]}}: "
                             "proposal-based multi-instance mode (NMS on the card + "
                             "per-proposal segmentation)")
    parser.add_argument("--nms-threshold", type=float, default=0.7)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--in-channels", type=int, default=None,
                        help="3 or 20; default 20 in dataset mode else 3")
    parser.add_argument("--float32", action="store_true", help="disable bfloat16 compute")
    parser.add_argument("--int8", action="store_true",
                        help="int8 PTQ serving: calibrate on the first --int8-calib-batches "
                             "of the input source, then run the spatial backbone convs "
                             "s8xs8->s32 (models/quantize.py, the int8_mxu mode)")
    parser.add_argument("--int8-calib-batches", type=int, default=2)
    parser.add_argument("--fused-stem", action="store_true",
                        help="conditioned (20-channel) models: fold the heatmap "
                             "conditioning through the stem as keypoint patches instead "
                             "of rendering the dense 17-channel stack "
                             "(models/fused_stem_hm.py)")
    return parser.parse_args(argv)


def list_images(directory: str) -> list[str]:
    """The files of ``directory`` with an image extension, sorted."""
    return [p for p in sorted(glob.glob(os.path.join(directory, "*")))
            if os.path.splitext(p)[1].lower() in IMAGE_EXTS]


def main(argv=None, device=None) -> int:
    args = parse_args(argv)
    in_channels = args.in_channels or (20 if args.dataset_mode else 3)
    dtype = torch.float32 if args.float32 else torch.bfloat16
    weights = load_weights(args.checkpoint, in_channels)
    quant = None
    if args.int8:
        if args.dataset_mode:
            quant = calibrate_on_dataset(weights, args.test_image_dir, in_channels=in_channels,
                                         size=args.size, batches=args.int8_calib_batches,
                                         batch_size=args.batch, device=device)
        else:
            calib = list_images(args.test_image_dir)[:args.int8_calib_batches * args.batch]
            quant = calibrate_on_images(weights, [imread(p, "color") for p in calib],
                                        in_channels=in_channels, size=args.size, device=device)
        print(f"int8: calibrated {len(quant)} conv scales")
    engine = InferenceEngine(weights, in_channels=in_channels, size=args.size, dtype=dtype,
                             threshold=args.threshold, fused_stem=args.fused_stem,
                             quant=quant, device=device)
    os.makedirs(args.output_dir, exist_ok=True)

    if args.dataset_mode:
        k_maskrel = key_combine("instance_mask", "mask_path")
        ds = InstanceCommonDataset(args.test_image_dir)
        print(f"{len(ds)} eligible instances")
        # outputs mirror the common format's instance_mask/<image>/<i>.png
        # layout, so predictions join against data/*.json
        written = 0
        for batch in batch_iterator(ds, args.batch, shuffle=False, epochs=1,
                                    drop_last=False):
            _, canvas_masks = engine.predict_instances(batch)
            for i in range(canvas_masks.shape[0]):
                if written >= len(ds):
                    break  # the tail batch's padding repeats samples
                out_path = os.path.join(args.output_dir, ds.records[written][k_maskrel])
                written += 1
                if args.continue_test and os.path.exists(out_path):
                    continue
                os.makedirs(os.path.dirname(out_path), exist_ok=True)
                h, w = batch["image_hw"][i].astype(int)
                imwrite(out_path, canvas_masks[i, :h, :w])
        print(f"wrote {written} instance masks to {args.output_dir}")
        return 0

    paths = list_images(args.test_image_dir)
    if args.proposals:
        with open(args.proposals) as f:
            proposal_map = json.load(f)
        written = 0
        for path in paths:
            name = os.path.splitext(os.path.basename(path))[0]
            entry = proposal_map.get(name) or proposal_map.get(os.path.basename(path))
            if not entry:
                continue
            results = segment_proposals(engine, imread(path, "color"), entry["boxes"],
                                        entry["scores"], nms_threshold=args.nms_threshold)
            for j, r in enumerate(results):
                out_path = os.path.join(args.output_dir, f"{name}_{j}.png")
                if args.continue_test and os.path.exists(out_path):
                    continue
                write_png(out_path, r["mask"])
                written += 1
        print(f"wrote {written} proposal masks to {args.output_dir}")
        return 0

    print(f"{len(paths)} images")
    todo = []
    for p in paths:
        out_path = os.path.join(args.output_dir,
                                os.path.splitext(os.path.basename(p))[0] + ".png")
        if args.continue_test and os.path.exists(out_path):
            continue
        todo.append((p, out_path))
    for start in range(0, len(todo), args.batch):
        chunk = todo[start:start + args.batch]
        masks = engine.predict_images([imread(p, "color") for p, _ in chunk])
        for (_, out_path), mask in zip(chunk, masks):
            write_png(out_path, mask)
    print(f"wrote {len(todo)} masks to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
