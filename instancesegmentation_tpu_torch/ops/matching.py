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

NaN follows the JAX function (``jnp.max``, ``jnp.argmax``): a row that holds
a NaN has best IoU NaN, its match is the first NaN's index and its label
IGNORE; a column that holds a NaN has a NaN maximum and rescues nobody.

A CPU tensor runs ``match_proposals_reference``; a CUDA tensor runs a kernel
of ``csrc/matching.cu`` (counted in ``match_proposals.launches`` and, by
form, in ``match_proposals.launches_by_form``): with the low-quality rescue the cluster form, one launch of one
thread-block cluster, where ``plan_cluster`` has a plan, else the two-pass
form (a column-max pass through a global scratch, then the rows; without
the rescue, its row pass alone).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

POSITIVE = 1
NEGATIVE = 0
IGNORE = -1


def match_proposals_reference(iou: torch.Tensor, high_threshold: float = 0.5,
                              low_threshold: float = 0.3, allow_low_quality: bool = True):
    """The plain version: ``iou [P, G]`` -> ``(matched [P] int64, labels [P]
    int32)``.  JAX's ``matched`` is int32; the values are the same.

    NaN is handled explicitly, so the rule does not hang on which NaN
    ``torch.max(dim=...)`` reports on a device: a row with a NaN has best
    NaN and matches its first NaN's index (else the first index of its
    max); a column with a NaN has gt_best NaN.
    """
    nan = iou.isnan()
    best, matched = iou.masked_fill(nan, float("-inf")).max(dim=1)
    row_nan = nan.any(dim=1)
    best = torch.where(row_nan, float("nan"), best)
    matched = torch.where(row_nan, nan.to(torch.int32).argmax(dim=1), matched)
    labels = torch.where(
        best >= high_threshold,
        POSITIVE,
        torch.where(best < low_threshold, NEGATIVE, IGNORE),
    ).to(torch.int32)
    if allow_low_quality:
        gt_best = iou.masked_fill(nan, float("-inf")).max(dim=0).values  # [G]
        gt_best = torch.where(nan.any(dim=0), float("nan"), gt_best)
        is_best = ((iou == gt_best[None, :]) & (gt_best[None, :] > 0)).any(dim=1)
        labels = torch.where(is_best, POSITIVE, labels).to(torch.int32)
    return matched, labels


# -- the cluster form's plan (mirrors csrc/matching.cu) -----------------------

CLUSTER_THREADS = 512     # threads of a cluster CTA
MAX_CLUSTER = 16          # non-portable; 8 where 16 cannot be resident
ROWS_PER_CTA = 128        # rows a CTA takes before the planner adds CTAs
SMEM_LIMIT = 232_448
ROWS_SMEM_BUDGET = 200 * 1024  # a CTA's rows staged in shared memory up to this


class ClusterPlan(NamedTuple):
    cluster: int
    rows_per_cta: int
    rows_in_smem: bool
    smem: int  # bytes per CTA


def row_lanes(g: int) -> int:
    """Lanes that share a staged row in the cluster form: a power of two, at
    least 4, about G / 16, at most 32 (rows read from L2 take a warp)."""
    lanes = 4
    while lanes < 32 and 16 * lanes < g:
        lanes *= 2
    return lanes


def staged_stride(g: int) -> int:
    """Row stride of the staged rows, in floats (16-byte rows where G % 4
    == 0; padded so that the rows a warp reads fall in other banks)."""
    return g + 4 if g % 4 == 0 else g + 1


def cluster_smem(g: int, rows_per_cta: int, rows_in_smem: bool) -> int:
    """Bytes of a cluster CTA's shared memory: partial column max and gt_best
    [G], the column pass's partials [CLUSTER_THREADS], the base labels, and
    the staged rows."""
    fixed = 2 * g + CLUSTER_THREADS + ((rows_per_cta + 3) & ~3)
    return 4 * (fixed + (rows_per_cta * staged_stride(g) if rows_in_smem else 0))


@functools.lru_cache(maxsize=256)
def plan_cluster(p: int, g: int, max_cluster: int = MAX_CLUSTER, cluster=None):
    """The cluster form's plan for ``[p, g]`` (with the rescue), or None
    where the two-pass form runs (partials of G columns that do not fit in
    shared memory).  Cached per shape: the entry point plans on every call.

    One CTA up to ``2 * ROWS_PER_CTA`` rows, else the power of two of CTAs
    that gives each at most ``ROWS_PER_CTA`` rows, capped at
    ``max_cluster``; ``cluster`` forces a size (1-16).  A CTA's rows are
    staged in shared memory where they fit ``ROWS_SMEM_BUDGET``.
    """
    if cluster is None:
        cluster = 1
        if p > 2 * ROWS_PER_CTA:
            cluster = min(max_cluster, 1 << math.ceil(math.log2(math.ceil(p / ROWS_PER_CTA))))
    rows = math.ceil(p / cluster)
    if cluster_smem(g, rows, False) > SMEM_LIMIT or not 1 <= cluster <= MAX_CLUSTER:
        return None
    in_smem = cluster_smem(g, rows, True) <= ROWS_SMEM_BUDGET
    return ClusterPlan(cluster, rows, in_smem, cluster_smem(g, rows, in_smem))


def _library():
    from instancesegmentation_tpu_torch.ops import _build

    lib = _build.library("matching.cu")
    if lib.match_proposals_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.match_proposals_launch.argtypes = [p, p, p, p, i, i, f, f, i, p]
        lib.match_proposals_launch.restype = ctypes.c_int
        lib.match_proposals_cluster_launch.argtypes = [p, p, p, i, i, f, f, i, i, i, p]
        lib.match_proposals_cluster_launch.restype = ctypes.c_int
        lib.match_proposals_max_cluster.argtypes = [i]
        lib.match_proposals_max_cluster.restype = ctypes.c_int
    return lib


_max_cluster: list = []  # the card's largest resident cluster, asked once


def max_cluster() -> int:
    """The largest cluster (16, else 8) the card can hold at the planner's
    largest shared memory."""
    if not _max_cluster:
        _max_cluster.append(_library().match_proposals_max_cluster(ROWS_SMEM_BUDGET))
    return _max_cluster[0]


def _launch(iou, high_threshold, low_threshold, allow_low_quality, form=None, plan=None):
    """Launch one form: ``form=None`` is the cluster form with the rescue
    where a plan exists, else "two_pass" (without the rescue its one row
    pass); "cluster" takes ``plan`` (a ``ClusterPlan``) or the planner's.
    Counts ``match_proposals.launches_by_form``."""
    lib = _library()
    p, g = iou.shape
    dev = iou.device
    if form in (None, "cluster") and plan is None and allow_low_quality:
        plan = plan_cluster(p, g, max_cluster())
    if form is None:
        form = "two_pass" if plan is None else "cluster"
    if form == "cluster" and (plan is None or not allow_low_quality):
        raise ValueError(f"match_proposals: no cluster plan for [{p}, {g}] "
                         f"allow_low_quality={allow_low_quality}")
    if dev.index not in (None, torch.cuda.current_device()):
        with torch.cuda.device(dev):
            return _launch(iou, high_threshold, low_threshold, allow_low_quality, form, plan)
    # one allocation for both outputs: matched int64 [P], then labels int32 [P]
    buf = torch.empty(3 * p, dtype=torch.int32, device=dev)
    matched, labels = buf[:2 * p].view(torch.int64), buf[2 * p:]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if form == "cluster":
        rc = lib.match_proposals_cluster_launch(
            iou.data_ptr(), matched.data_ptr(), labels.data_ptr(), p, g, high_threshold,
            low_threshold, plan.cluster, plan.rows_per_cta, int(plan.rows_in_smem), stream)
    elif form == "two_pass":
        # the first pass's scratch, with the rescue
        gt_best = torch.empty(g, dtype=torch.float32, device=dev) if allow_low_quality else None
        rc = lib.match_proposals_launch(
            iou.data_ptr(), None if gt_best is None else gt_best.data_ptr(), matched.data_ptr(),
            labels.data_ptr(), p, g, high_threshold, low_threshold, int(allow_low_quality),
            stream)
    else:
        raise ValueError(f"match_proposals: unknown form {form!r}")
    if rc != 0:
        raise RuntimeError(f"match_proposals {form} kernel launch failed: CUDA error {rc}")
    match_proposals.launches_by_form[form] += 1
    return matched, labels


def match_proposals(iou: torch.Tensor, high_threshold: float = 0.5,
                    low_threshold: float = 0.3, allow_low_quality: bool = True):
    """``iou [P, G]`` proposal-by-ground-truth IoU (G >= 1) -> ``(matched [P]
    int64, labels [P] int32)``.  The matrix is taken in float32.

    A CPU tensor runs ``match_proposals_reference``; a CUDA tensor launches
    a kernel (counted in ``match_proposals.launches`` and, by form, in
    ``match_proposals.launches_by_form``) or raises.
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
match_proposals.launches_by_form = {"cluster": 0, "two_pass": 0}


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
