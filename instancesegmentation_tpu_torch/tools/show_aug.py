"""Dataset / augmentation visual QA tool: the port's ``tools/show_aug.py``.

It writes PNG grids, so it works headless.

Modes:
  show-dataset  per annotation: image | overlay (keypoints with their names,
                masks, boxes) | union mask; on the host
  show-aug      per sample: replay the training preprocessing
                (``data/pipeline.py:preprocess_batch``, batch 1) and render
                image | overlay | mask | heatmap max; on ``cuda:0`` unless
                ``--device cpu`` (with ``--rotate`` the rotated warp launches
                ``csrc/warp_2level.cu`` once per grid)

Usage:
  python -m instancesegmentation_tpu_torch.tools.show_aug show-dataset <dataset_dir> <out_dir> [--limit N]
  python -m instancesegmentation_tpu_torch.tools.show_aug show-aug <dataset_dir> <out_dir> [--limit N]
      [--out-size S] [--flip-prob P] [--jitter J] [--rotate DEG] [--seed K] [--device cpu|cuda:0]

The files are ``dataset_NNNN.png`` / ``aug_NNNN.png``, as the JAX tool
names them; their pixels are the JAX tool's (``core/imwrite.py`` writes
them).
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from instancesegmentation_tpu_torch.core.imwrite import imwrite
from instancesegmentation_tpu_torch.core.keys import key_combine
from instancesegmentation_tpu_torch.core.records import common_ann_loader, common_transfer
from instancesegmentation_tpu_torch.core.visualize import (
    draw_box,
    draw_keypoint,
    draw_label,
    draw_mask,
    image_grid,
)


def show_dataset(dataset_dir: str, out_dir: str, limit: int = 16) -> int:
    """Write one grid per annotation (at most ``limit``); returns the count."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for ann in common_ann_loader(dataset_dir):
        if n >= limit:
            break
        common_transfer(ann)
        image = ann[key_combine("image", "image")]
        mask = ann.get(key_combine("segment_mask", "mask"))
        mix = image.copy()
        for obj in ann.get(key_combine("object", "sub_list"), []):
            if key_combine("body_keypoint", "sub_dict") in obj:
                draw_keypoint(mix, obj[key_combine("body_keypoint", "sub_dict")], labeled=True)
            if key_combine("instance_mask", "mask") in obj:
                draw_mask(mix, obj[key_combine("instance_mask", "mask")])
            if key_combine("box", "box_xyxy") in obj:
                draw_box(mix, obj[key_combine("box", "box_xyxy")])
        panels = [image, mix]
        if mask is not None:
            panels.append(np.repeat(mask[..., None], 3, axis=-1))
        imwrite(os.path.join(out_dir, f"dataset_{n:04d}.png"), image_grid([panels]))
        n += 1
    return n


def show_aug(dataset_dir: str, out_dir: str, limit: int = 16, out_size: int = 480,
             flip_prob: float = 0.0, jitter: float = 0.0, rotate: float = 0.0, seed: int = 0,
             device="cuda:0", draws: Optional[Callable[[int, object], dict]] = None) -> int:
    """Replay the training preprocess per sample and write one grid each
    (at most ``limit``); returns the count.

    Sample ``i``'s draws come from a ``torch.Generator`` seeded with
    ``seed + i`` on ``device`` (the JAX tool keys sample ``i`` with
    ``PRNGKey(seed + i)``); ``draws(i, cfg)``, where given, supplies them
    instead (a ``data/pipeline.py:draw_augment`` dict for batch 1)."""
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.data.pipeline import (
        AugmentConfig,
        batch_to,
        draw_augment,
        host_batch,
        preprocess_batch,
    )

    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    ds = InstanceCommonDataset(dataset_dir)
    cfg = AugmentConfig(out_size=(out_size, out_size), flip_prob=flip_prob, jitter=jitter,
                        rotate=rotate, rotate_prob=1.0 if rotate else 0.6)
    n = 0
    for i in range(min(limit, len(ds))):
        batch = batch_to(host_batch([ds.fetch(i)]), device)
        if draws is not None:
            d = draws(i, cfg)
        else:
            d = draw_augment(1, cfg, torch.Generator(device=device).manual_seed(seed + i))
        images, heatmaps, masks = preprocess_batch(batch, d, cfg)
        img = ((images[0].float().cpu().numpy() + 1) * 127.5).clip(0, 255).astype(np.uint8)
        mask = (masks[0, ..., 0].float().cpu().numpy() * 255).astype(np.uint8)
        hm = (heatmaps[0].float().cpu().numpy().max(axis=-1) * 255).astype(np.uint8)
        mix = img.copy()
        draw_mask(mix, mask)
        draw_label(mix, "person", (4, 4))
        grid = image_grid([[img, mix, np.repeat(mask[..., None], 3, -1),
                            np.repeat(hm[..., None], 3, -1)]])
        imwrite(os.path.join(out_dir, f"aug_{i:04d}.png"), grid)
        n += 1
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("mode", choices=["show-dataset", "show-aug"])
    parser.add_argument("dataset_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--limit", type=int, default=16)
    parser.add_argument("--out-size", type=int, default=480)
    parser.add_argument("--flip-prob", type=float, default=0.0)
    parser.add_argument("--jitter", type=float, default=0.0)
    parser.add_argument("--rotate", type=float, default=0.0,
                        help="max +-degrees; applied to every sample (QA mode) when set")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda:0",
                        help="device of show-aug's preprocess (cpu to force it)")
    args = parser.parse_args(argv)
    if args.mode == "show-dataset":
        n = show_dataset(args.dataset_dir, args.out_dir, args.limit)
    else:
        n = show_aug(args.dataset_dir, args.out_dir, args.limit, args.out_size,
                     flip_prob=args.flip_prob, jitter=args.jitter, rotate=args.rotate,
                     seed=args.seed, device=args.device)
    print(f"wrote {n} grids to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
