"""Data-parallel batched inference over the devices of a mesh.

Port of ``instancesegmentation_tpu/parallel/inference.py``.  The engine holds
one replica of the folded serving program (``infer/pipeline.py:
InferenceEngine``) per device of its mesh.  A batch is split into one shard
per replica, each shard is launched on its replica without waiting for the
others, and the outputs are gathered.  Parameters are replicated: at 257K
parameters replication is free and the forward needs no collective.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from instancesegmentation_tpu_torch.infer.pipeline import (
    InferenceEngine,
    predict_masks_batched,
    run_instance_batch,
)
from instancesegmentation_tpu_torch.parallel.mesh import make_mesh


class ParallelInferenceEngine:
    """Shard-batched serving over ``num_devices`` visible CUDA devices (all
    by default) or an explicit ``devices`` list (the CPU tests pass
    ``[cpu] * n``); the same programs and contracts as ``InferenceEngine``,
    so ``ServingFrontend`` drives it unchanged.  ``quant`` and ``quant_mode``
    (int8 serving) and ``fused_stem`` (the keypoint-patch stem, 20-channel
    models only) go to every replica."""

    def __init__(
        self,
        variables: dict,
        in_channels: int = 3,
        size: int = 512,
        dtype=torch.bfloat16,
        num_devices: Optional[int] = None,
        threshold: float = 0.5,
        fused_stem: bool = False,
        quant: Optional[dict] = None,
        quant_mode: str = "int8_mxu",
        devices: Optional[Sequence] = None,
    ):
        self.mesh = make_mesh(num_devices, devices)
        self.n = self.mesh.size
        self.size = size
        self.in_channels = in_channels
        self.threshold = threshold
        self.replicas = [InferenceEngine(variables, in_channels, size, dtype, threshold,
                                         fused_stem=fused_stem, quant=quant,
                                         quant_mode=quant_mode, device=d)
                         for d in self.mesh.devices]
        self.device = self.replicas[0].device  # where outputs are gathered

    @property
    def variables(self) -> dict:
        """The BN-folded state dict being served."""
        return self.replicas[0].variables

    @variables.setter
    def variables(self, variables: dict) -> None:
        """Assigning weights refolds every replica."""
        for r in self.replicas:
            r.variables = variables

    def _sharded(self, fn, arrays) -> list:
        """``fn(replica, *shard)`` (a tuple of tensors) on each replica's rows of ``arrays``
        (split as evenly as the rows allow), launched one after another
        without waiting; each output gathered in row order on
        ``self.device``."""
        shards = [a.tensor_split(self.n) for a in arrays]
        outs = [fn(r, *(s[i].to(r.device, non_blocking=True) for s in shards))
                for i, r in enumerate(self.replicas)]
        return [torch.cat([o[j].to(self.device) for o in outs]) for j in range(len(outs[0]))]

    @torch.inference_mode()
    def __call__(self, images_u8) -> torch.Tensor:
        """images_u8 [B, S, S, 3] (numpy or tensor) -> probs [B, S, S, 1] on
        ``self.device``.  A batch not divisible by the mesh size is padded
        with zero images to the next multiple, and the padding sliced off."""
        images = (images_u8 if isinstance(images_u8, torch.Tensor)
                  else torch.from_numpy(np.ascontiguousarray(images_u8)))
        b = images.shape[0]
        pad = (-b) % self.n
        if pad:
            images = torch.cat([images, images.new_zeros((pad,) + tuple(images.shape[1:]))])
        (probs,) = self._sharded(lambda r, x: (r._forward_whole(x),), [images])
        return probs[:b]

    @torch.inference_mode()
    def predict_instances(self, batch: dict):
        """Instance mode over a host batch, sharded on the batch axis: the
        ``InferenceEngine.predict_instances`` contract, with the bucket floor
        at the mesh size so every replica gets a non-empty shard."""
        return run_instance_batch(
            lambda *arrays: self._sharded(lambda r, *a: r._forward_instance(*a), arrays),
            batch, self.threshold, InferenceEngine._bucket_size, torch.device("cpu"),
            min_bucket=self.n)

    @torch.inference_mode()
    def predict_images(self, images: list) -> list:
        """Whole-image mode: the ``InferenceEngine.predict_images``
        contract, buckets at least the mesh size."""
        return predict_masks_batched(self, images, self.size, self.threshold, self.device,
                                     min_bucket=self.n)
