"""Inference pipelines: the instance program and the whole-image program.

Port of ``instancesegmentation_tpu/infer/pipeline.py``.  Both programs run
the Segment backbone on BN-folded weights (sections 1 and 2+3 through the
chain kernel) and the algebraically folded section-6 head:

- whole-image: images are resized to the engine's square size, run
  image-only, and the probabilities are resized back to each image;
- instance: per object, the centring crop-warp from the canvas, the
  17-channel heatmap render, the backbone + head, a sigmoid, and the
  inverse warp back to the canvas frame.

Batches are padded to power-of-2 buckets (repeating row 0) and chunked
above ``MAX_BUCKET``.  The resizes the JAX package does with ``cv2.resize``
are done here by ``resize``: cv2's own fixed-point arithmetic on uint8
images, ``torch.nn.functional.interpolate`` on float maps.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from instancesegmentation_tpu_torch.core.device import pick_device
from instancesegmentation_tpu_torch.models.export import fold_batchnorm
from instancesegmentation_tpu_torch.models.fused_head import fold_head, head_apply
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.ops.fused_chain import (
    extract_s1_chain,
    extract_s23_chain,
)
from instancesegmentation_tpu_torch.ops.heatmap import render_heatmaps
from instancesegmentation_tpu_torch.train.checkpoint import load_checkpoint
from instancesegmentation_tpu_torch.ops.warp import (
    WarpParams,
    center_translation,
    clipped_mask_box,
    instance_warp_params,
    warp_image,
    warp_points,
)
from instancesegmentation_tpu_torch.utils.weights import jax_variables_to_torch

#: Largest dispatch batch; bursts above it are chunked into dispatches of
#: at most this size rather than padded to the next power of 2.
MAX_BUCKET = 128

_INSTANCE_KEYS = ("image", "mask", "image_hw", "obj_box", "mask_box",
                  "mask_valid", "keypoints")


@functools.lru_cache(maxsize=256)
def _linear_taps(n_in: int, n_out: int):
    """cv2's INTER_LINEAR taps along one axis, as ``cv::resize`` builds them
    for uint8: source ``(lo, hi)`` indices clamped into the image and 11-bit
    weights ``(w_lo, w_hi)`` (``INTER_RESIZE_COEF_BITS``) rounded from the
    float32 fraction.  At the edges the fraction is kept and only the
    indices are clamped (both taps read the edge pixel), which is what the
    sweep in ``tests/test_torch_port_ops.py`` finds cv2 doing."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    one = np.float32(2048)
    s = s.astype(np.int64)
    return (torch.from_numpy(np.clip(s, 0, n_in - 1)),
            torch.from_numpy(np.clip(s + 1, 0, n_in - 1)),
            torch.from_numpy(np.rint((np.float32(1) - f) * one).astype(np.int32)),
            torch.from_numpy(np.rint(f * one).astype(np.int32)))


def _resize_u8_linear(t: torch.Tensor, out_hw) -> torch.Tensor:
    """``cv2.resize(t, INTER_LINEAR)`` of uint8 ``t [H, W, C]``, bit for bit,
    in int32 torch ops on ``t``'s device.

    A horizontal pass of 11-bit weights gives exact sums ``S``; the vertical
    pass rounds as cv2's SIMD loop does, ``((S0>>4)*b0>>16) +
    ((S1>>4)*b1>>16)``, then ``(v + 2) >> 2``.  An exact 2x downscale in
    both axes is cv2's INTER_AREA instead: the rounded mean of 2x2 pixels.
    """
    (h, w), (oh, ow) = t.shape[:2], tuple(out_hw)
    x = t.to(torch.int32)
    if h == 2 * oh and w == 2 * ow:
        return (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2
    xl, xh, a0, a1 = (v.to(t.device) for v in _linear_taps(w, ow))
    yl, yh, b0, b1 = (v.to(t.device) for v in _linear_taps(h, oh))
    rows = (x[:, xl] * a0[:, None] + x[:, xh] * a1[:, None]) >> 4
    v = ((rows[yl] * b0[:, None, None]) >> 16) + ((rows[yh] * b1[:, None, None]) >> 16)
    return ((v + 2) >> 2).clamp(0, 255)


def resize(t: torch.Tensor, out_hw, mode: str = "bilinear") -> torch.Tensor:
    """Resize ``t [H, W]`` or ``[H, W, C]`` to ``out_hw``; float32 result.

    Stands in for ``cv2.resize``: ``"bilinear"`` is INTER_LINEAR (half-pixel
    centres, edge clamp, no antialias): a uint8 input goes through cv2's
    fixed-point arithmetic (``_resize_u8_linear``, equal to cv2 bit for
    bit), a float input through ``F.interpolate`` (equal to cv2 to float
    rounding); ``"nearest"`` is INTER_NEAREST (source index ``floor(dst *
    in/out)``, which is torch's ``"nearest"``; its ``"nearest-exact"``
    rounds half a pixel differently from cv2).
    """
    if mode == "bilinear" and t.dtype == torch.uint8:
        x = t.reshape(t.shape[0], t.shape[1], -1)
        y = _resize_u8_linear(x, out_hw).float()
        return y.reshape(tuple(out_hw) + tuple(t.shape[2:]))
    x = t.reshape(t.shape[0], t.shape[1], -1).permute(2, 0, 1)[None].float()
    if mode == "bilinear":
        y = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                          align_corners=False, antialias=False)
    elif mode == "nearest":
        y = F.interpolate(x, size=tuple(out_hw), mode="nearest")
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    return y[0].permute(1, 2, 0).reshape(tuple(out_hw) + tuple(t.shape[2:]))


def load_any_checkpoint(path: str) -> dict:
    """The Segment weights of a checkpoint file, for ``InferenceEngine``:

    - ``.ckpt``: an ISEG checkpoint of either package, holding the full
      train state or only ``{step, params, batch_stats}``; returns the flax
      layout ``{"params", "batch_stats"}``;
    - ``.pth`` / ``.pt``: a reference checkpoint (``{"state_dict": ...}``)
      or a bare state dict, read with ``weights_only=True``; returns the
      state dict, whose keys are the port's module names.
    """
    if path.endswith((".pth", ".pt")):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return ckpt.get("state_dict", ckpt)
    tree, _ = load_checkpoint(path)
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}


def to_u8(t: torch.Tensor) -> torch.Tensor:
    return t.round().clamp(0, 255).to(torch.uint8)


def _mask_u8(probs: torch.Tensor, threshold: float) -> torch.Tensor:
    return (probs > threshold).to(torch.uint8) * 255


def predict_masks_batched(forward_probs, images: list, size: int,
                          threshold: float, device, min_bucket: int = 1) -> list:
    """Whole-image serving: resize requests to the engine shape on
    ``device``, pad to the power-of-2 bucket (>= ``min_bucket``), run
    ``forward_probs`` (uint8 batch -> probability maps), resize each map
    back to its request's resolution and threshold to 0/255 masks.  Bursts
    larger than ``MAX_BUCKET`` are chunked."""
    n = len(images)
    if n == 0:
        return []
    cap = max(MAX_BUCKET, min_bucket)
    masks = []
    for start in range(0, n, cap):
        chunk = images[start:start + cap]
        bucket = max(InferenceEngine._bucket_size(len(chunk)), min_bucket)
        batch = torch.zeros((bucket, size, size, 3), dtype=torch.uint8, device=device)
        for i, img in enumerate(chunk):
            batch[i] = to_u8(resize(torch.from_numpy(np.asarray(img)).to(device),
                                    (size, size)))
        probs = forward_probs(batch)
        for i, img in enumerate(chunk):
            h, w = img.shape[:2]
            p = resize(probs[i, ..., 0], (h, w))
            masks.append(_mask_u8(p, threshold).cpu().numpy())
    return masks


def build_instance_forward(model: Segment, in_channels: int, size: int, dtype, head):
    """The instance program, shared by the engines: warp params, crop-warp,
    heatmap render, truncated backbone + folded head, sigmoid, and the
    inverse warp back to the canvas frame.  ``head`` is a FoldedHead on the
    model's device matching the model's weights.  Returns
    ``(apply_model, forward_instance)``."""

    def _apply_model(x, hm=None):
        """Backbone + folded section-6 head: float32 logits [N,S,S,1]."""
        feats = model(x, hm, truncate_head=True)
        return head_apply(feats, head, dtype=dtype).float()

    def _forward_instance(canvas_u8, batch_mask, image_hw, obj_box, mask_box,
                          mask_valid, keypoints):
        out_hw = (size, size)
        obj_box_f = obj_box.float()
        image_hw_f = image_hw.float()
        # the exact translated-clipped mask box when a real mask exists;
        # otherwise the host-provided box (proposal rows ship empty masks)
        t = center_translation(obj_box_f, image_hw_f)
        exact_box, exact_valid = clipped_mask_box(batch_mask, t, image_hw_f)
        use_box = torch.where(exact_valid[:, None], exact_box, mask_box.float())
        use_valid = exact_valid | mask_valid
        params = instance_warp_params(obj_box_f, use_box, image_hw_f, out_hw,
                                      16, use_valid)
        imgs = warp_image(canvas_u8, WarpParams(params.scale, params.offset), out_hw)
        x = (torch.clamp(imgs, 0.0, 255.0) / 127.5 - 1.0).to(dtype)
        if in_channels > 3:
            kps = keypoints.float()
            pts = warp_points(kps[..., :2], params)
            hm = render_heatmaps(pts, kps[..., 2] > 0.5, out_hw).to(dtype)
            logits = _apply_model(x, hm)
        else:
            logits = _apply_model(x)
        probs = torch.sigmoid(logits)
        # inverse warp back into the canvas frame
        inv = WarpParams(1.0 / params.scale, -params.offset / params.scale)
        back = warp_image(probs, inv, canvas_u8.shape[1:3])
        return probs, back

    return _apply_model, _forward_instance


def run_instance_batch(forward_instance, batch: dict, threshold: float,
                       bucket_size, device, min_bucket: int = 1):
    """Pad/bucket/chunk dispatch around an instance program.

    Pads the batch to a power-of-2 bucket (>= ``min_bucket``, repeating row
    0); padded rows are sliced off the outputs.  Batches above
    ``MAX_BUCKET`` are split into dispatches of at most that size.
    Returns (crop_probs [B,S,S,1] float32, canvas_masks uint8 [B,C,C]).
    """
    b = batch["image"].shape[0]
    if b == 0:
        raise ValueError("run_instance_batch: empty batch")
    cap = max(MAX_BUCKET, min_bucket)
    if b > cap:
        probs_parts, mask_parts = [], []
        for start in range(0, b, cap):
            chunk = {k: np.asarray(v)[start:start + cap] for k, v in batch.items()}
            p, m = run_instance_batch(forward_instance, chunk, threshold,
                                      bucket_size, device, min_bucket)
            probs_parts.append(p)
            mask_parts.append(m)
        return np.concatenate(probs_parts), np.concatenate(mask_parts)
    bucket = max(bucket_size(b), min_bucket)
    rows = {k: np.asarray(batch[k]) for k in _INSTANCE_KEYS}
    if bucket != b:
        rows = {k: np.concatenate([a, np.repeat(a[:1], bucket - b, axis=0)])
                for k, a in rows.items()}
    arrays = [torch.from_numpy(np.ascontiguousarray(rows[k])).to(device)
              for k in _INSTANCE_KEYS]
    probs, back = forward_instance(*arrays)
    canvas_masks = _mask_u8(back[..., 0], threshold).cpu().numpy()
    return probs.cpu().numpy()[:b], canvas_masks[:b]


class InferenceEngine:
    """Fixed-shape inference over Segment weights on one device.

    ``variables``: flax-layout variables (``{"params", "batch_stats"}`` as
    nested dicts of arrays, carried over with ``utils/weights.py``) or a
    port state dict.  ``device=None`` is ``cuda:0``; without CUDA it raises
    unless ``device="cpu"`` is passed.  ``dtype`` is the compute dtype
    (bfloat16 serves); the input is cast to it after normalisation, and the
    logits come out in float32.
    """

    def __init__(self, variables: dict, in_channels: int = 3, size: int = 512,
                 dtype=torch.bfloat16, threshold: float = 0.5,
                 device: Optional[str] = None):
        if size % 16:
            raise ValueError(f"size {size} is not divisible by 16")
        self.device = pick_device(device)
        self.size = size
        self.threshold = threshold
        self.in_channels = in_channels
        self._dtype = dtype
        self.model = Segment(in_channels).to(
            device=self.device, dtype=dtype, memory_format=torch.channels_last
        ).eval()
        self.variables = variables  # property: folds, loads, builds programs

    @property
    def variables(self) -> dict:
        """The BN-folded port state dict being served (float32, CPU)."""
        return self._variables

    @variables.setter
    def variables(self, variables: dict) -> None:
        """Assigning weights folds every BN into its conv, folds the head
        (float64, CPU), builds the two chain specs and the programs, once
        per assignment."""
        if "params" in variables:
            sd = jax_variables_to_torch(variables)
        else:
            sd = {k: (v.detach().cpu().float() if v.is_floating_point()
                      else v.detach().cpu()) for k, v in variables.items()}
        sd = fold_batchnorm(sd)
        self.model.load_state_dict(sd)
        s = self.size
        self.model.prepare_serving(extract_s1_chain(sd, s // 8, s // 8),
                                   extract_s23_chain(sd, s // 16, s // 16))
        self._variables = sd
        head = fold_head(sd).to(self.device)
        self._apply_model, self._forward_instance = build_instance_forward(
            self.model, self.in_channels, self.size, self._dtype, head)

    def _forward_whole(self, images_u8: torch.Tensor) -> torch.Tensor:
        dtype = self._dtype
        x = images_u8.to(dtype) / 127.5 - 1.0
        if self.in_channels > 3:
            # no keypoints in whole-image mode: condition on all-zero
            # heatmaps, what training renders when nothing is visible
            hm = torch.zeros(x.shape[:3] + (self.in_channels - 3,),
                             dtype=dtype, device=x.device)
            logits = self._apply_model(x, hm)
        else:
            logits = self._apply_model(x)
        return torch.sigmoid(logits)

    @torch.inference_mode()
    def predict_images(self, images: list) -> list:
        """Whole-image mode: list of RGB uint8 [H,W,3] -> list of uint8
        0/255 masks at the original resolutions."""
        return predict_masks_batched(self._forward_whole, images, self.size,
                                     self.threshold, self.device)

    @staticmethod
    def _bucket_size(b: int) -> int:
        """Next power-of-2 batch bucket (>= 1)."""
        return 1 << max(0, (b - 1).bit_length())

    @torch.inference_mode()
    def predict_instances(self, batch: dict):
        """Instance mode over a host batch (the ``synthetic_host_batch`` /
        data pipeline layout).  Returns (crop_probs [B,S,S,1],
        canvas_masks uint8 [B,C,C])."""
        return run_instance_batch(self._forward_instance, batch, self.threshold,
                                  self._bucket_size, self.device)
