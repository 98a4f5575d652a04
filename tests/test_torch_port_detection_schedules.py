"""The schedules of the redesigned detection kernels, emulated on the CPU.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against their
plain versions on the card.  What runs here:

- an emulator of ``roi_align``'s kernels (``csrc/roi_align.cu``): the
  locality order's keys and counting sort (``roi_order_kernel``), then the
  gather (``roi_align_kernel``) block by block, one block per (ROI in that
  order, output row), with the tap rule in float32 in the kernel's
  operation order and the four taps of each counted sample; every bin is
  written exactly once; held against the plain version within 1e-5 and
  against JAX's ``roi_align``;
- an emulator of the matching kernel's cluster schedule
  (``csrc/matching.cu:match_cluster_kernel``): each CTA's rows by segments
  of 4-32 lanes (lanes over columns, then the shuffle tree) under the NaN
  rule, the
  grouped partial column max, the merge of the partials in rank order and
  the rescue from the CTA's own rows; bit-equal to the plain version and to
  JAX's ``match_proposals``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.ops import matching as jmatch
from instancesegmentation_tpu.ops import roi_align as jroi
from instancesegmentation_tpu_torch.ops import matching as tmatch
from instancesegmentation_tpu_torch.ops import roi_align as troi

torch.set_num_threads(1)
F32 = np.float32


# ---------------------------------------------------------------------------
# roi_align: the locality order and the gather
# ---------------------------------------------------------------------------


def _tap(start, bin_, size, o, k, ratio):
    """make_tap: (i0, i1, w0, w1), w0 == 0 for a sample that does not count."""
    s = F32(F32(k) + F32(0.5)) / F32(ratio)
    with np.errstate(invalid="ignore"):  # -inf + inf: a NaN centre
        ctr = F32(start + F32(F32(o) + s) * bin_)
    if not (ctr >= -1.0 and ctr <= size):
        return 0, 0, F32(0), F32(0)
    cc = F32(min(max(ctr, F32(0)), F32(size - 1)))
    i0 = int(math.floor(cc))
    w1 = F32(cc - F32(i0))
    return i0, min(i0 + 1, size - 1), F32(1) - w1, w1


def _geometry(box, scale, aligned, oh, ow):
    off = F32(0.5 if aligned else 0.0)
    x0, y0, x1, y1 = (F32(F32(v) * F32(scale)) - off for v in box)
    roi_w, roi_h = F32(x1 - x0), F32(y1 - y0)
    if not aligned:
        roi_w, roi_h = max(roi_w, F32(1)), max(roi_h, F32(1))
    return x0, y0, F32(roi_w / F32(ow)), F32(roi_h / F32(oh))


def _order(boxes, idx, n, h, scale, bands):
    """The locality order's keys and a counting sort by them (the kernel's
    order inside a bucket is its atomics'; any order there is right)."""
    buckets = min(n * bands, 4096)
    keys = []
    for b, i in zip(boxes, idx):
        cy = F32(F32(F32(b[1]) + F32(b[3])) * F32(0.5)) * F32(scale)
        fb = F32(cy * F32(bands)) / F32(h)
        band = 0 if not fb >= 0 else (bands - 1 if fb >= bands - 1 else int(fb))
        img = min(max(int(i) + n if i < 0 else int(i), 0), n - 1)
        keys.append((img * bands + band) % buckets)
    order = sorted(range(len(keys)), key=lambda q: keys[q])
    return order, keys


def emulate_gather(feats, boxes, idx, output_size, scale, ratio, aligned, order, stats=None):
    """The kernels, block by block: with ``order``, the blocks take the ROIs
    in the counting sort's order (a permutation, sorted by key); each block
    (ROI, output row) builds its taps and sums the four taps of each counted
    sample.  ``stats["bytes"]`` counts the tap bytes read."""
    n, h, w, c = feats.shape
    oh, ow = output_size
    r = boxes.shape[0]
    seq = list(range(r))
    if order:
        seq, keys = _order(boxes, idx, n, h, scale, troi.ORDER_BANDS)
        assert sorted(seq) == list(range(r))
        assert [keys[q] for q in seq] == sorted(keys)
    f32 = feats.astype(np.float32)
    out = np.full((r, oh, ow, c), np.nan, np.float32)
    inv = F32(1) / F32(ratio * ratio)
    for block in range(r * oh):
        q, oy = divmod(block, oh)
        roi = seq[q]
        x0, y0, bw, bh = _geometry(boxes[roi], scale, aligned, oh, ow)
        ty = [_tap(y0, bh, h, oy, k, ratio) for k in range(ratio)]
        f = f32[troi.gather_index(torch.tensor([int(idx[roi])]), n).item()]
        for ox in range(ow):
            acc = np.zeros(c, np.float32)
            for ya in ty:
                if ya[2] == 0:
                    continue
                for sx in range(ratio):
                    xa = _tap(x0, bw, w, ox, sx, ratio)
                    if xa[2] == 0:
                        continue
                    top = xa[2] * f[ya[0], xa[0]] + xa[3] * f[ya[0], xa[1]]
                    bot = xa[2] * f[ya[1], xa[0]] + xa[3] * f[ya[1], xa[1]]
                    acc += ya[2] * top + ya[3] * bot
                    if stats is not None:
                        stats["bytes"] += 4 * c * feats.itemsize
            assert np.isnan(out[roi, oy, ox]).all(), "a bin written twice"
            out[roi, oy, ox] = acc * inv
    assert not np.isnan(out).any(), "an output bin no block wrote"
    return out


def _roi_inputs(seed, n=2, h=20, w=26, c=8, r=9):
    """Boxes of every kind: large, sub-pixel, crossing the map's edges,
    reversed (aligned allows a negative size), on random images."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, h, w, c)).astype(np.float32)
    x0 = rng.uniform(-3, w, size=r)
    y0 = rng.uniform(-3, h, size=r)
    bw = np.exp(rng.uniform(np.log(0.3), np.log(2 * w), size=r))
    bh = np.exp(rng.uniform(np.log(0.3), np.log(2 * h), size=r))
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32)
    boxes[0] = [-8.0, -6.0, 2 * w + 5.0, 2 * h + 3.0]   # beyond every edge (scale 0.5)
    boxes[1] = [10.2, 7.1, 10.6, 7.3]                   # under a pixel
    boxes[2, 2:] = boxes[2, :2] - 1.5                   # reversed
    idx = rng.integers(0, n, size=r).astype(np.int32)
    return feats, boxes, idx


def _reference(feats, boxes, idx, out_hw, scale, ratio, aligned):
    return troi.roi_align_reference(torch.from_numpy(feats), torch.from_numpy(boxes),
                                    torch.from_numpy(idx), out_hw, scale, ratio,
                                    aligned).numpy()


def test_order_bands_mirror_the_kernel_source():
    """ORDER_BANDS is the kernel's RA_ORDER_BANDS; a ratio below 1 raises."""
    import pathlib

    src = (pathlib.Path(troi.__file__).parent.parent / "csrc" / "roi_align.cu").read_text()
    assert f"#define RA_ORDER_BANDS {troi.ORDER_BANDS} " in src
    assert troi.ORDER_MIN_ROIS >= 1
    with pytest.raises(ValueError):
        troi.roi_align(torch.zeros(1, 4, 4, 4), torch.zeros(1, 4), torch.zeros(1),
                       sampling_ratio=0)


def test_order_keys_of_nonfinite_and_edge_boxes():
    """A NaN or negative centre falls in band 0, one past the map in the
    last band; a negative index wraps before the key is formed; above
    4,096 (image, band) pairs the keys wrap and the sort stays a
    permutation."""
    boxes = np.array([[0, np.nan, 4, 4], [0, -9, 4, -3], [0, 30, 4, 90], [0, 8, 4, 8],
                      [0, 8, 4, 8]], np.float32)
    idx = np.array([0, 0, 1, -1, 1], np.int32)
    order, keys = _order(boxes, idx, 2, 20, 0.5, troi.ORDER_BANDS)
    last = troi.ORDER_BANDS - 1
    assert keys == [0, 0, troi.ORDER_BANDS + last, troi.ORDER_BANDS + 3, troi.ORDER_BANDS + 3]
    assert order == [0, 1, 3, 4, 2]
    many = np.tile(boxes[3:4], (600, 1))
    order, keys = _order(many, np.arange(600, dtype=np.int32), 600, 20, 0.5, troi.ORDER_BANDS)
    assert max(keys) < 4096 and sorted(order) == list(range(600))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("ratio", [1, 2, 3])
def test_gather_emulator_matches_plain_version(ratio, aligned):
    feats, boxes, idx = _roi_inputs(seed=10 * ratio + aligned)
    args = (feats, boxes, idx, (5, 4), 0.5, ratio, aligned)
    stats = {"bytes": 0}
    got = emulate_gather(*args, True, stats)
    want = _reference(*args)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jroi.roi_align(*(jnp.asarray(a) for a in (feats, boxes, idx)), (5, 4),
                                       0.5, ratio, aligned)), atol=1e-4)
    # four taps per counted sample, at most
    assert 0 < stats["bytes"] <= boxes.shape[0] * 5 * 4 * ratio * ratio * 4 * 8 * 4


@pytest.mark.parametrize("order,n,c,out_hw", [
    (False, 2, 16, (5, 3)), (True, 2, 6, (1, 1)), (True, 3, 3, (2, 7)),
    (True, 300, 2, (3, 2))])
def test_gather_emulator_orders_and_shapes(order, n, c, out_hw):
    """With and without the order, channels that are not a multiple of 4
    (the kernel's scalar loads), one-bin and wide poolers, and 300 images,
    where (image, band) keys wrap at 4,096 buckets; the order changes no
    value."""
    feats, boxes, idx = _roi_inputs(seed=n + c, n=n, c=c, r=7)
    args = (feats, boxes, idx, out_hw, 0.5, 2, True)
    np.testing.assert_allclose(emulate_gather(*args, order), _reference(*args),
                               rtol=0, atol=1e-5)


def test_gather_emulator_nonfinite_boxes_and_indices():
    """NaN and infinite centres weigh nothing (zeros, bit for bit); indices
    -1, N and -N-1 take JAX's gather rule."""
    feats, boxes, idx = _roi_inputs(seed=3, r=8)
    boxes[1] = [np.nan, 1.0, 5.0, 5.0]
    boxes[2] = [-np.inf, 1.0, np.inf, 5.0]
    boxes[3] = [0.0, 1.0, np.inf, 5.0]
    idx[4:7] = [-1, 2, -3]
    args = (feats, boxes, idx, (4, 4), 0.5, 2, False)
    got = emulate_gather(*args, True)
    np.testing.assert_array_equal(got[1:4], np.zeros_like(got[1:4]))
    np.testing.assert_allclose(got, _reference(*args), rtol=0, atol=1e-5)


def test_gather_emulator_bf16_features():
    feats, boxes, idx = _roi_inputs(seed=4, c=16, r=5)
    f16 = torch.from_numpy(feats).bfloat16()
    got = emulate_gather(f16.float().numpy(), boxes, idx, (3, 3), 0.5, 2, True, False)
    want = troi.roi_align_reference(f16, torch.from_numpy(boxes), torch.from_numpy(idx), (3, 3),
                                    0.5, 2, True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# match_proposals: the cluster form
# ---------------------------------------------------------------------------


def _better(v, i, best, arg, none):
    if arg == none:
        return i != none
    if i == none:
        return False
    vn, bn = v != v, best != best
    if vn != bn:
        return vn
    if vn or v == best:
        return i < arg
    return v > best


def _nan_max(a, b):
    if a != a:
        return a
    if b != b:
        return b
    return a if a > b else b


def _segment_row_best(x, g, lanes):
    """segment_best: the row's L lanes over the columns (lane l takes l,
    l + L, ...), then the shuffle-down tree within the segment."""
    best = [F32(-np.inf)] * lanes
    arg = [g] * lanes
    for lane in range(lanes):
        for col in range(lane, g, lanes):
            if _better(x[col], col, best[lane], arg[lane], g):
                best[lane], arg[lane] = x[col], col
    off = lanes // 2
    while off:
        ob = [best[lane + off] if lane + off < lanes else best[lane] for lane in range(lanes)]
        oa = [arg[lane + off] if lane + off < lanes else arg[lane] for lane in range(lanes)]
        for lane in range(lanes):
            if _better(ob[lane], oa[lane], best[lane], arg[lane], g):
                best[lane], arg[lane] = ob[lane], oa[lane]
        off //= 2
    return best[0], arg[0]


def _label(best, high, low):
    return 1 if best >= high else (0 if best < low else -1)


def emulate_cluster(iou, high, low, plan):
    """The cluster form (with the rescue), CTA by CTA."""
    p, g = iou.shape
    threads = tmatch.CLUSTER_THREADS
    assert plan.smem == tmatch.cluster_smem(g, plan.rows_per_cta, plan.rows_in_smem)
    assert plan.smem <= tmatch.SMEM_LIMIT and plan.cluster * plan.rows_per_cta >= p
    lanes = tmatch.row_lanes(g) if plan.rows_in_smem else 32
    matched = np.full(p, -7, np.int64)
    labels = np.full(p, -7, np.int32)
    base, colpart = {}, []
    for rank in range(plan.cluster):
        r0 = rank * plan.rows_per_cta
        nr = max(0, min(p - r0, plan.rows_per_cta))
        for row in range(nr):
            best, arg = _segment_row_best(iou[r0 + row], g, lanes)
            matched[r0 + row] = arg
            base[r0 + row] = _label(best, high, low)
        stride = min((g + 31) & ~31, threads)
        groups = threads // stride
        part = np.full(g, -np.inf, np.float32)
        for col in range(g):
            ms = []
            for grp in range(groups):
                m = F32(-np.inf)
                for row in range(grp, nr, groups):
                    m = _nan_max(m, iou[r0 + row, col])
                ms.append(m)
            m = ms[0]
            for k in range(1, groups):
                m = _nan_max(m, ms[k])
            part[col] = m
        colpart.append(part)
    gt_best = []
    for col in range(g):
        m = F32(-np.inf)
        for rank in range(plan.cluster):
            m = _nan_max(m, colpart[rank][col])
        gt_best.append(m)
    for row in range(p):
        hit = any(iou[row, col] == gt_best[col] and gt_best[col] > 0 for col in range(g))
        labels[row] = 1 if hit else base[row]
    assert (matched != -7).all() and (labels != -7).all()
    return matched, labels


def emulate_row_pass(iou, high, low):
    """The two-pass form without the rescue: its one row pass, a warp per
    row (what the entry point runs then)."""
    rows = [_segment_row_best(x, iou.shape[1], 32) for x in iou]
    return (np.array([a for _, a in rows], np.int64),
            np.array([_label(b, high, low) for b, _ in rows], np.int32))


def _match_case(p, g, seed):
    rng = np.random.default_rng(seed)
    iou = (rng.integers(0, 12, size=(p, g)) / 12).astype(np.float32)  # many ties
    iou[rng.integers(0, p, size=max(1, p // 7)), rng.integers(0, g, size=max(1, p // 7))] = np.nan
    if p > 3:
        iou[3] = np.nan          # a whole NaN row
    iou[:, g - 1] = np.where(np.arange(p) % 2, iou[:, g - 1], 0.0)
    return iou


@pytest.mark.parametrize("p,g,cluster", [
    (37, 40, 4),    # P not divisible by the cluster, G not a multiple of 32
    (5, 9, 16),     # P below the cluster size: CTAs without rows
    (64, 1, 8),     # G = 1
    (300, 5, None),  # the planner's cluster (4), groups of threads over rows
    (20, 300, 2),   # G above the CTA's threads: one group, columns strided
])
@pytest.mark.parametrize("lq", [True, False])
def test_cluster_emulator_bit_equal(p, g, cluster, lq):
    """With the rescue the cluster form; without it the two-pass form's row
    pass, which the entry point then takes."""
    iou = _match_case(p, g, seed=p + g)
    if lq:
        got_m, got_l = emulate_cluster(iou, 0.5, 0.3, tmatch.plan_cluster(p, g, cluster=cluster))
    else:
        got_m, got_l = emulate_row_pass(iou, 0.5, 0.3)
    ref_m, ref_l = tmatch.match_proposals_reference(torch.from_numpy(iou), 0.5, 0.3, lq)
    np.testing.assert_array_equal(got_m, ref_m.numpy())
    np.testing.assert_array_equal(got_l, ref_l.numpy())
    jm, jl = jmatch.match_proposals(jnp.asarray(iou), 0.5, 0.3, allow_low_quality=lq)
    np.testing.assert_array_equal(got_m, np.asarray(jm))
    np.testing.assert_array_equal(got_l, np.asarray(jl))


def test_cluster_plans():
    assert [tmatch.row_lanes(g) for g in (1, 64, 65, 300, 10_000)] == [4, 4, 8, 32, 32]
    assert (tmatch.staged_stride(64), tmatch.staged_stride(37)) == (68, 38)
    big = tmatch.plan_cluster(2000, 64)
    assert (big.cluster, big.rows_per_cta, big.rows_in_smem) == (16, 125, True)
    assert big.smem <= 40 * 1024
    assert tmatch.plan_cluster(2000, 64, max_cluster=8).cluster == 8
    assert tmatch.plan_cluster(256, 8).cluster == 1
    huge = tmatch.plan_cluster(60000, 64)
    assert huge.cluster == 16 and not huge.rows_in_smem
    assert tmatch.plan_cluster(10, 100_000) is None  # partials too wide: the two-pass form
