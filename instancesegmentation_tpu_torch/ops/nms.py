"""Greedy non-maximum suppression with static-shape outputs.

Port of ``instancesegmentation_tpu/ops/nms.py`` (``nms``, ``batched_nms``,
``nms_batch`` and the Pallas kernel ``nms_pallas``).  The contract is the
JAX one: ``(indices [K], valid [K])`` with the kept boxes' indices in
descending score order (a stable sort, so ties keep input order), strict
``IoU > threshold`` suppression, K = ``max_outputs`` (default N), padded with
-1 / False where fewer boxes survive or K > N.  ``indices`` is int64 and
``valid`` bool.

A CPU tensor runs ``nms_reference`` (the JAX package's scan over the
``IoU > thr`` matrix).  A CUDA tensor runs the kernel of ``csrc/nms.cu``,
one launch per call and one thread-block cluster per image: up to
``SORT_LIMIT`` boxes per image the kernel sorts them itself (a bitonic
network in shared memory), builds the ``IoU > thr`` bitmask across the
cluster, walks it greedily with one warp, 32 boxes at a time, and compacts
the survivors.  Above ``SORT_LIMIT`` the wrapper sorts with torch first and
the kernel skips its sort.  Above ~1,250 boxes the ``N x N/8``-byte mask
lives in a global scratch that the walk reads in column windows, so any N
whose scratch the card can allocate runs (the wrapper raises, naming the
bytes, when it cannot).  Launches are counted in ``nms.launches``.
``nms_reference_blocked`` is the plain version at large N: the same scan,
with the ``IoU > thr`` matrix built in row blocks.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

_NEG_INF = float("-inf")
#: boxes per image up to which the kernel sorts (``csrc/nms.cu:NMS_SORT_LIMIT``)
SORT_LIMIT = 4096


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of ``[N,4] x [M,4]`` xyxy boxes -> ``[N,M]`` float32.

    The operation order is the JAX ``box_iou_jnp``'s, which the kernel
    repeats with round-to-nearest intrinsics so that keeps are identical.
    """
    a, b = a.float(), b.float()
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12),
                       torch.zeros((), device=union.device))


def _pad_keep(kept: torch.Tensor, k: int):
    """Score-ordered kept indices -> (indices [k] int64, valid [k] bool)."""
    m = min(k, kept.numel())
    indices = torch.full((k,), -1, dtype=torch.int64, device=kept.device)
    indices[:m] = kept[:m]
    valid = torch.arange(k, device=kept.device) < m
    return indices, valid


def nms_reference(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
                  max_outputs: Optional[int] = None,
                  score_threshold: float = _NEG_INF):
    """The plain version: stable sort by descending score, the ``IoU > thr``
    matrix, then the N-step scan in which a surviving box i kills every
    later box of row i (JAX ``ops/nms.py:nms``)."""
    n = boxes.shape[0]
    k = n if max_outputs is None else max_outputs
    order = torch.argsort(-scores.float(), stable=True)
    suppress = box_iou(boxes[order], boxes[order]) > iou_threshold
    alive = scores.float()[order] > score_threshold
    later = torch.arange(n, device=boxes.device)
    for i in range(n):
        alive = alive & ~(suppress[i] & (later > i) & alive[i])
    return _pad_keep(order[alive], k)


def nms_reference_blocked(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
                          max_outputs: Optional[int] = None,
                          score_threshold: float = _NEG_INF, block_rows: int = 2048):
    """``nms_reference`` for N too large for its ``[N, N]`` intermediates:
    the same stable sort and the same scan, with ``box_iou`` of
    ``block_rows`` sorted boxes against all of them at a time (its
    operation order, on the boxes' device) and the scan on the host."""
    n = boxes.shape[0]
    k = n if max_outputs is None else max_outputs
    order = torch.argsort(-scores.float(), stable=True)
    sboxes = boxes[order]
    alive = (scores.float()[order] > score_threshold).cpu().numpy()
    for r0 in range(0, n, block_rows):
        rows = (box_iou(sboxes[r0:r0 + block_rows], sboxes) > iou_threshold).cpu().numpy()
        for r, row in enumerate(rows):
            i = r0 + r
            if alive[i]:
                alive[i + 1:] &= ~row[i + 1:]
    return _pad_keep(order[torch.from_numpy(alive).to(order.device)], k)


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.shape[-1:] != (4,) or boxes.shape[:-1] != scores.shape:
        raise ValueError(f"nms expects boxes [..., N, 4] and scores [..., N], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if not (boxes.is_floating_point() and scores.is_floating_point()):
        raise TypeError("nms takes floating-point boxes and scores")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores lie on different devices")


def _library():
    from instancesegmentation_tpu_torch.ops import _build

    lib = _build.library("nms.cu")
    fn, words = lib.nms_launch, lib.nms_scratch_words
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
        words.argtypes = [i, i, i]
        words.restype = ctypes.c_longlong
    return fn, words


def _sorted(boxes: torch.Tensor, scores: torch.Tensor):
    """The wrapper's torch sort above ``SORT_LIMIT``: ``(sboxes [B,N,4],
    sscores [B,N], order [B,N])`` by descending score, stable."""
    order = torch.argsort(-scores.float(), dim=1, stable=True)
    sboxes = torch.take_along_dim(boxes.float(), order[..., None], dim=1).contiguous()
    sscores = torch.take_along_dim(scores.float(), order, dim=1).contiguous()
    return sboxes, sscores, order


def _launch(boxes, scores, iou_threshold: float, k: int, score_threshold: float,
            window: int = 0):
    """One launch of the kernel on ``boxes [B,N,4]``, ``scores [B,N]`` (one
    cluster per image; B, N, k >= 1): in input order up to ``SORT_LIMIT``
    boxes, the kernel sorting them, else sorted by ``_sorted`` with their
    permutation -> ``([B,k] int64, [B,k] bool)``; raises on a failure.
    ``window > 0`` forces the global mask and a walk in column windows of
    at most that many 32-box words (else the plan takes the widest that
    fits).  Counted in ``nms.launches``."""
    order = None
    if scores.shape[1] <= SORT_LIMIT:
        boxes, scores = boxes.float().contiguous(), scores.float().contiguous()
    else:
        boxes, scores, order = _sorted(boxes, scores)
    fn, words = _library()
    b, n = scores.shape
    dev = scores.device
    need = words(n, int(order is None), window)
    if need < 0:
        raise RuntimeError(f"nms kernel cannot take N={n}: CUDA error {-need}")
    scratch = None
    if need:
        try:
            scratch = torch.empty((b, need), dtype=torch.int32, device=dev)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(
                f"nms: the suppression mask of {b} x {n} boxes needs {4 * b * need:,} bytes "
                "of device memory, which cannot be allocated") from e
    indices = torch.empty((b, k), dtype=torch.int64, device=dev)
    valid = torch.empty((b, k), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(boxes.data_ptr(), scores.data_ptr(), None if order is None else order.data_ptr(),
                indices.data_ptr(), valid.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b, n, k, iou_threshold,
                score_threshold, window, stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {rc}")
    nms.launches += 1
    return indices, valid


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{what} has no kernel for device {t.device}")
    return True


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_outputs: Optional[int] = None, score_threshold: float = _NEG_INF):
    """Single-image NMS: ``boxes [N,4]``, ``scores [N]`` -> ``(indices [K],
    valid [K])`` (see the module docstring for the contract).

    A CPU tensor runs ``nms_reference``; a CUDA tensor launches the kernel
    once (counted in ``nms.launches``) or raises.
    """
    _check(boxes, scores)
    if boxes.dim() != 2:
        raise ValueError(f"nms takes one image's boxes [N, 4], got {tuple(boxes.shape)}")
    n = boxes.shape[0]
    k = n if max_outputs is None else max_outputs
    if not _on_card(boxes, "nms"):
        return nms_reference(boxes, scores, iou_threshold, k, score_threshold)
    if n == 0 or k == 0:
        return _pad_keep(torch.empty(0, dtype=torch.int64, device=boxes.device), k)
    indices, valid = _launch(boxes[None], scores[None], iou_threshold, k, score_threshold)
    return indices[0], valid[0]


nms.launches = 0


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, class_ids: torch.Tensor,
                iou_threshold: float = 0.5, max_outputs: Optional[int] = None):
    """Class-aware NMS by the coordinate-offset trick
    (``torchvision.ops.batched_nms``): boxes of different classes never
    suppress each other."""
    max_coord = boxes.float().max() + 1.0
    offsets = class_ids.float()[:, None] * max_coord
    return nms(boxes.float() + offsets, scores, iou_threshold, max_outputs)


def nms_batch(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
              max_outputs: Optional[int] = None):
    """NMS per image over a leading batch axis: ``[B,N,4] x [B,N]`` ->
    ``([B,K], [B,K])``.  On the card: one launch, one block per image
    (counted in ``nms.launches``)."""
    _check(boxes, scores)
    if boxes.dim() != 3:
        raise ValueError(f"nms_batch takes boxes [B, N, 4], got {tuple(boxes.shape)}")
    bsz, n = scores.shape
    k = n if max_outputs is None else max_outputs
    on_card = _on_card(boxes, "nms_batch")
    if bsz == 0 or n == 0 or k == 0:
        return (torch.full((bsz, k), -1, dtype=torch.int64, device=boxes.device),
                torch.zeros((bsz, k), dtype=torch.bool, device=boxes.device))
    if not on_card:
        outs = [nms_reference(boxes[i], scores[i], iou_threshold, k) for i in range(bsz)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    return _launch(boxes, scores, iou_threshold, k, _NEG_INF)
