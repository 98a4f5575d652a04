"""Batching, host -> device prefetch, and the device-side preprocessing
program of training and evaluation.

Port of ``instancesegmentation_tpu/data/pipeline.py`` (``_FLIP_PERM``,
``AugmentConfig``, ``host_batch``, ``preprocess_batch``, ``device_prefetch``,
``batch_iterator``).  ``preprocess_batch`` turns canvas uint8 batches into
normalised model inputs, soft mask targets and keypoint heatmaps, with the
reference's augmentations as options (window jitter, horizontal flip,
rotation, brightness, contrast, noise).  On the host, ``batch_iterator``
decodes samples with a thread pool behind a background producer, in the
JAX package's batch order, and ``device_prefetch`` keeps batches in flight
to the device.

jax.random cannot be matched from PyTorch, so the draws are split from the
transform: ``draw_augment`` draws every random quantity of a batch from an
explicit ``torch.Generator``, and ``preprocess_batch(batch, draws, cfg)`` is
deterministic given them.  A test can thus hand both packages the same
draws.

The rotated branch samples with ``rotate_impl``: ``"2level"`` (the default)
runs ``ops/warp_2level.py:warp_2level`` (on a CUDA tensor its kernels, one
pass-1 and one pass-2 launch per batch), ``"2pass"`` and ``"gather"`` the
plain samplers of ``ops/warp.py``; at ``rotate >= 60`` the two-pass forms
fall back to ``"gather"``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from instancesegmentation_tpu_torch.core.keys import ORDER_PART_NAMES
from instancesegmentation_tpu_torch.ops.heatmap import render_heatmaps
from instancesegmentation_tpu_torch.ops.warp import (
    RotWarpParams,
    WarpParams,
    center_translation,
    clipped_mask_box,
    flip_params_x,
    flip_rot_params_x,
    instance_warp_params,
    rotated_instance_warp_params,
    rotated_mask_box,
    warp_image,
    warp_image_rotated,
    warp_image_rotated_2pass,
    warp_points,
    warp_points_rotated,
)
from instancesegmentation_tpu_torch.ops.warp_2level import warp_2level

#: channel permutation under horizontal flip: left <-> right parts swap
_FLIP_PERM = tuple(
    ORDER_PART_NAMES.index(
        part.replace("left_", "@").replace("right_", "left_").replace("@", "right_")
    )
    for part in ORDER_PART_NAMES
)

ROTATE_IMPLS = ("2level", "2pass", "gather")

#: samples per stage of the rotated warp when ``rotate_chunk`` is 0: only
#: "2pass" must stage (its per-sample hats are ~786 MB at 640 -> 480); the
#: "2level" kernel materialises no hats and runs the whole batch at once
_DEFAULT_CHUNK = {"2pass": 4}

_BATCH_KEYS = ("image", "mask", "image_hw", "obj_box", "mask_box", "mask_valid", "keypoints")


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Device-side augmentation knobs; everything off by default (the
    reference's augmentations are commented out).

    ``rotate`` is the max |theta| in degrees (0 keeps the separable warp);
    ``rotate_prob`` the per-sample probability that a rotation is applied;
    ``rotate_impl`` the rotated sampler (``ROTATE_IMPLS``); ``rotate_chunk``
    stages the rotated warp in chunks of that many samples (0: the impl's
    default, ``_DEFAULT_CHUNK``); ``rotate_block`` the "2level" hat block.
    ``brightness``/``contrast`` are multiplicative ranges (+-),
    ``noise_std`` the std of additive Gaussian noise on the 0-255 scale.
    ``out_dtype`` is the dtype of images and heatmaps (None: float32); the
    mask targets stay float32.
    """

    out_size: tuple = (480, 480)
    pad: int = 16
    flip_prob: float = 0.0
    jitter: float = 0.0
    rotate: float = 0.0
    rotate_prob: float = 0.6
    rotate_chunk: int = 0
    rotate_impl: str = "2level"
    rotate_block: int = 16
    brightness: float = 0.0
    contrast: float = 0.0
    noise_std: float = 0.0
    out_dtype: Optional[torch.dtype] = None


def host_batch(samples: list) -> dict:
    """Stack host samples (objects with ``image``, ``mask``, ``image_hw``,
    ``obj_box``, ``mask_box``, ``mask_valid``, ``keypoints``) into one numpy
    batch dict."""
    out = {k: np.stack([getattr(s, k) for s in samples]) for k in _BATCH_KEYS}
    out["mask_valid"] = out["mask_valid"].astype(bool)
    return out


def batch_to(batch: dict, device) -> dict:
    """The batch dict's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v,
                               device=device) for k, v in batch.items()}


def draw_augment(b: int, cfg: AugmentConfig, generator: Optional[torch.Generator] = None) -> dict:
    """Every random quantity of one batch of ``b`` samples, drawn from
    ``generator`` on its device (the CPU when None, which needs no draws):

    - ``theta`` [b] radians: ``U(-1, 1) * rotate`` where a ``rotate_prob``
      gate passes, else 0 (zeros when ``rotate == 0``);
    - ``flip`` [b] bool, ``Bernoulli(flip_prob)``;
    - ``jitter`` [b, 4] ``U(-jitter, jitter)`` or None;
    - ``brightness``, ``contrast`` [b] ``U(1 -+ range)`` or None;
    - ``noise`` [b, out_h, out_w, 3] standard normal or None (scaled by
      ``noise_std`` in ``preprocess_batch``).
    """
    dev = generator.device if generator is not None else torch.device("cpu")

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    if generator is None and (cfg.rotate > 0 or cfg.flip_prob > 0 or cfg.jitter > 0
                              or cfg.brightness > 0 or cfg.contrast > 0
                              or cfg.noise_std > 0):
        raise ValueError("draw_augment needs a generator when an augmentation is on")
    theta = torch.zeros(b, device=dev)
    if cfg.rotate > 0:
        gate = torch.rand(b, generator=generator, device=dev) < cfg.rotate_prob
        theta = torch.where(gate, uniform(b, -1.0, 1.0) * (cfg.rotate * math.pi / 180.0), theta)
    flip = (torch.rand(b, generator=generator, device=dev) < cfg.flip_prob
            if cfg.flip_prob > 0 else torch.zeros(b, dtype=torch.bool, device=dev))
    out_h, out_w = cfg.out_size
    return {
        "theta": theta,
        "flip": flip,
        "jitter": uniform((b, 4), -cfg.jitter, cfg.jitter) if cfg.jitter > 0 else None,
        "brightness": (uniform(b, 1 - cfg.brightness, 1 + cfg.brightness)
                       if cfg.brightness > 0 else None),
        "contrast": (uniform(b, 1 - cfg.contrast, 1 + cfg.contrast)
                     if cfg.contrast > 0 else None),
        "noise": (torch.randn((b, out_h, out_w, 3), generator=generator, device=dev)
                  if cfg.noise_std > 0 else None),
    }


def _select(flip, flipped, base):
    return torch.where(flip[:, None], flipped, base)


def rotated_warp_params(batch: dict, draws: dict, cfg: AugmentConfig):
    """The rotated branch's warp of each sample: ``(params, base)``, the
    ``RotWarpParams`` the sampler takes (flips applied) and the unflipped ones
    the keypoints map through.  ``batch`` and ``draws`` on one device."""
    out_hw = tuple(cfg.out_size)
    obj_box = batch["obj_box"].float()
    image_hw = batch["image_hw"].float()
    t = center_translation(obj_box, image_hw)
    theta = draws["theta"]
    flip = draws["flip"].bool()
    rot_box, rot_valid = rotated_mask_box(batch["mask"], t, theta, image_hw)
    base = rotated_instance_warp_params(obj_box, rot_box, image_hw, theta, out_hw,
                                        cfg.pad, rot_valid, draws["jitter"])
    flipped = flip_rot_params_x(base, out_hw[1])
    params = base._replace(scale=_select(flip, flipped.scale, base.scale),
                           origin=_select(flip, flipped.origin, base.origin))
    return params, base


def _rotated_warp(batch, draws, cfg):
    """The rotated branch: (images [B,oh,ow,3], masks [B,oh,ow,1], keypoint
    positions [B,K,2] through the unflipped params)."""
    out_hw = tuple(cfg.out_size)
    params, base = rotated_warp_params(batch, draws, cfg)
    impl = cfg.rotate_impl
    if impl not in ROTATE_IMPLS:
        raise ValueError(f"unknown rotate_impl: {impl!r}")
    # the two-pass samplers divide by cos(theta)*scale (degenerate near 90 deg)
    if impl != "gather" and cfg.rotate >= 60.0:
        impl = "gather"

    def warp_pair(img, mask, p: RotWarpParams):
        if impl == "2level":
            both = warp_2level(img, mask, p, out_hw, theta_max_deg=cfg.rotate,
                               block=cfg.rotate_block)
        elif impl == "2pass":
            # one shared warp of image + mask: the hats are made once per sample
            both = warp_image_rotated_2pass(
                torch.cat([img.float(), mask[..., None].float()], dim=-1), p, out_hw)
        else:
            return (warp_image_rotated(img.float(), p, out_hw),
                    warp_image_rotated(mask[..., None].float(), p, out_hw))
        return both[..., :3], both[..., 3:]

    b = batch["image"].shape[0]
    chunk = cfg.rotate_chunk or _DEFAULT_CHUNK.get(impl, 0)
    if chunk and b > chunk:
        # staged: at most `chunk` samples' intermediates live at once;
        # numerically identical (no cross-sample math)
        parts = [warp_pair(batch["image"][s:s + chunk], batch["mask"][s:s + chunk],
                           params.index(slice(s, s + chunk)))
                 for s in range(0, b, chunk)]
        images = torch.cat([p[0] for p in parts])
        masks = torch.cat([p[1] for p in parts])
    else:
        images, masks = warp_pair(batch["image"], batch["mask"], params)
    kps = batch["keypoints"].float()
    return images, masks, warp_points_rotated(kps[..., :2], base)


def _separable_warp(batch, t, obj_box, image_hw, out_hw, cfg, jitter, flip):
    """The unrotated branch: one separable scale-and-translate per sample."""
    mask_box, mask_valid = clipped_mask_box(batch["mask"], t, image_hw)
    params = instance_warp_params(obj_box, mask_box, image_hw, out_hw, cfg.pad,
                                  mask_valid, jitter)
    flipped = flip_params_x(params, out_hw[1])
    warp_p = WarpParams(_select(flip, flipped.scale, params.scale),
                        _select(flip, flipped.offset, params.offset),
                        params.src_lo, params.src_hi)
    images = warp_image(batch["image"].float(), warp_p, out_hw)
    masks = warp_image(batch["mask"][..., None].float(), warp_p, out_hw)
    kps = batch["keypoints"].float()
    return images, masks, warp_points(kps[..., :2], params)


def preprocess_batch(batch: dict, draws: dict, cfg: AugmentConfig):
    """Canvas batch (tensors on one device) -> (images, heatmaps, masks):

    images   [B, oh, ow, 3]  in [-1, 1] (``cfg.out_dtype`` or float32)
    heatmaps [B, oh, ow, 17] in [0, 1]  (``cfg.out_dtype`` or float32)
    masks    [B, oh, ow, 1]  float32 in [0, 1] (soft, bilinear-resampled)

    ``draws`` is ``draw_augment``'s dict (moved to the batch's device here).
    """
    dev = batch["image"].device
    draws = {k: None if v is None else v.to(dev) for k, v in draws.items()}
    out_hw = tuple(cfg.out_size)
    out_h, out_w = out_hw
    obj_box = batch["obj_box"].float()
    image_hw = batch["image_hw"].float()
    flip = draws["flip"].bool()

    if cfg.rotate > 0:
        images, masks, pts = _rotated_warp(batch, draws, cfg)
    else:
        t = center_translation(obj_box, image_hw)
        images, masks, pts = _separable_warp(batch, t, obj_box, image_hw, out_hw, cfg,
                                             draws["jitter"], flip)

    # photometric augmentations on the [0, 255] scale (imgaug Multiply,
    # LinearContrast, AdditiveGaussianNoise)
    if cfg.brightness > 0:
        images = images * draws["brightness"].view(-1, 1, 1, 1)
    if cfg.contrast > 0:
        images = (images - 127.5) * draws["contrast"].view(-1, 1, 1, 1) + 127.5
    if cfg.noise_std > 0:
        images = images + cfg.noise_std * draws["noise"]

    images = torch.clamp(images, 0.0, 255.0) / 127.5 - 1.0
    # bilinear tap sums can overshoot 1 by ~1e-7: keep valid BCE targets
    masks = torch.clamp(masks / 255.0, 0.0, 1.0)

    # keypoints were mapped through the UNFLIPPED params: mirror them in
    # output space (x' = (w-1) - x) and swap left/right parts
    vis = batch["keypoints"][..., 2].float() > 0.5
    perm = torch.tensor(_FLIP_PERM, device=dev)
    pts_f = torch.stack([(out_w - 1.0) - pts[:, perm, 0], pts[:, perm, 1]], dim=-1)
    pts = torch.where(flip[:, None, None], pts_f, pts)
    vis = torch.where(flip[:, None], vis[:, perm], vis)
    heatmaps = render_heatmaps(pts, vis, out_hw)

    if cfg.out_dtype is not None:
        images = images.to(cfg.out_dtype)
        heatmaps = heatmaps.to(cfg.out_dtype)
    return images, heatmaps, masks


def device_prefetch(iterator: Iterator[dict], device, depth: int = 2) -> Iterator[dict]:
    """Keep ``depth`` batches in flight to ``device`` ahead of the consumer:
    yields each host batch's arrays (numpy arrays or CPU tensors, such as the
    worker loader's in shared memory) as tensors on ``device``.

    On a CUDA device the arrays are copied into pinned host memory and sent
    with ``non_blocking`` copies, so the transfer of batch n+1 overlaps the
    step on batch n; each pinned batch is held until the consumer asks for
    the batch after it, by which time its step has been enqueued behind the
    copy."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch: dict):
        host = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if pin:
            host = {k: v if v.is_pinned() else v.pin_memory() for k, v in host.items()}
        return host, {k: v.to(device, non_blocking=pin) for k, v in host.items()}

    in_flight: collections.deque = collections.deque()
    for item in iterator:
        in_flight.append(put(item))
        if len(in_flight) >= depth:
            _, on_device = in_flight.popleft()
            yield on_device
    while in_flight:
        _, on_device = in_flight.popleft()
        yield on_device


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = 1,
    drop_last: bool = True,
    num_threads: int = 8,
    prefetch: int = 2,
    local_slice: Optional[slice] = None,
    records: Optional[np.ndarray] = None,
) -> Iterator[dict]:
    """Yield host batch dicts (``host_batch``) of ``dataset.fetch`` samples,
    decoded by ``num_threads`` threads while a background producer keeps
    ``prefetch`` batches ready.

    The order is the JAX package's: one ``np.random.default_rng(seed)``
    shuffles ``arange(len(dataset))`` once per epoch.  ``epochs=None``
    streams forever.  An incomplete tail batch is dropped when
    ``drop_last``, else padded by repeating its first sample.  The producer
    never blocks forever: a consumer that stops iterating releases it.

    ``local_slice`` (multi-process data parallelism,
    ``parallel/multihost.py:local_batch_slice``): every process derives the
    same global batch order from ``seed``, then decodes and yields only its
    rows of each global batch.  The tail is padded before slicing, so the
    global rows (padding at the END) are the single-process batch's.

    ``records``: the sample indices to draw from (default all), shuffled in
    place of ``arange(len(dataset))`` (``data/grain_loader.py``'s shards).
    """
    rng = np.random.default_rng(seed)
    pool = ThreadPoolExecutor(max_workers=num_threads)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    failure: list = []

    def order_stream():
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(dataset)) if records is None else np.array(records)
            if shuffle:
                rng.shuffle(order)
            yield from (order[i:i + batch_size] for i in range(0, len(order), batch_size))
            epoch += 1

    def try_put(item) -> bool:
        # an abandoned consumer sets `stop`; a producer stuck in q.put on a
        # full queue would otherwise keep its thread and decoded batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        # the next batch's samples are decoded while this one is stacked
        pending: collections.deque = collections.deque()

        def put_oldest() -> bool:
            return try_put(host_batch([f.result() for f in pending.popleft()]))

        try:
            for idxs in order_stream():
                if stop.is_set():
                    break
                if len(idxs) < batch_size:
                    if drop_last:
                        continue
                    idxs = np.concatenate([idxs, np.repeat(idxs[:1], batch_size - len(idxs))])
                if local_slice is not None:
                    idxs = idxs[local_slice]
                pending.append([pool.submit(dataset.fetch, i) for i in idxs])
                if len(pending) > 1 and not put_oldest():
                    return
            while pending and not stop.is_set():
                if not put_oldest():
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            failure.append(e)
        finally:
            # waits for room like a batch, so that a consumer behind the
            # producer ends with the stream, not a poll interval later
            try_put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            try:
                item = q.get(timeout=1.0)
            except queue.Empty:
                if not thread.is_alive() and q.empty():
                    break  # the producer ended without a sentinel
                continue
            if item is None:
                break
            yield item
        if failure:
            raise failure[0]
    finally:
        stop.set()
        pool.shutdown(wait=False, cancel_futures=True)
