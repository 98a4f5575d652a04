"""Training configuration: one dataclass + CLI overrides.

Port of ``instancesegmentation_tpu/train/config.py`` (``TrainConfig``,
``parse_args``): the same field names and defaults, so a run is configured
alike in both packages.  Defaults mirror the reference's training defaults
(epoch=30, batch_size=8, show_iter=20, val_iter=120, Adam with lr=1e-3);
the augmentations are off, and ``rotate_impl`` is the two-level sampler.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # data
    train_dataset_dir: str = ""
    val_dataset_dir: str = ""
    checkpoint_dir: str = "checkpoints"
    out_dir: str = "runs"
    canvas: int = 640
    out_size: int = 480

    # model
    in_channels: int = 20          # 20 = RGB + 17 heatmaps; 3 = image-only
    bfloat16: bool = True          # bf16 compute (params stay f32)

    # optimization
    epochs: int = 30
    batch_size: int = 8
    learning_rate: float = 1e-3    # torch Adam default

    # cadence
    show_iter: int = 20
    val_iter: int = 120
    max_val_batches: int = 0       # 0 = full val set

    # checkpoint contract
    continue_train: bool = True
    syn_train: bool = False
    checkpoint_backend: str = "file"
    pretrained_path: Optional[str] = None
    checkpoint_save_path: Optional[str] = None
    save_iou_gate: float = 0.7     # save-best quality gate
    regression_threshold: float = 0.3  # reload-best threshold
    stale_epochs: int = 10         # syn_train staleness adoption
    max_restarts: int = 20         # bound on reload/adoption restarts

    # augmentation (off by default, as in the reference)
    flip_prob: float = 0.0
    jitter: float = 0.0
    rotate: float = 0.0            # max +- degrees
    rotate_prob: float = 0.6       # imgaug Sometimes(0.6, ...) gate
    rotate_chunk: int = 0          # stage the rotated warp in chunks of
                                   # this many samples (0 = impl default)
    rotate_impl: str = "2level"    # "2level" | "2pass" | "gather"
    rotate_block: int = 16         # "2level" hat block size
    brightness: float = 0.0
    contrast: float = 0.0
    noise_std: float = 0.0

    # parallelism
    data_parallel: bool = False
    multihost: bool = False
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1

    # recompute the forward during backward instead of storing activations
    remat: bool = False

    # run the training forward with the algebraically folded section-6
    # head, re-derived from the live parameters every step
    fused_head: bool = True

    # profiling (0 = off)
    profile_steps: int = 0

    # input pipeline
    loader: str = "threads"
    grain_workers: int = 0

    # misc
    seed: int = 0
    num_threads: int = 8
    log_images: bool = True

    @property
    def use_heatmaps(self) -> bool:
        return self.in_channels > 3

    @property
    def out_hw(self) -> tuple[int, int]:
        return (self.out_size, self.out_size)


def parse_args(argv=None) -> TrainConfig:
    """Build a TrainConfig from CLI flags (every field overridable)."""
    parser = argparse.ArgumentParser(description="train instance segmentation")
    for field in dataclasses.fields(TrainConfig):
        name = "--" + field.name.replace("_", "-")
        if field.type == "bool" or isinstance(field.default, bool):
            parser.add_argument(
                name,
                type=lambda s: s.lower() in ("1", "true", "yes"),
                default=field.default,
            )
        else:
            ftype = str if field.default is None else type(field.default)
            parser.add_argument(name, type=ftype, default=field.default)
    ns = parser.parse_args(argv)
    return TrainConfig(**vars(ns))
