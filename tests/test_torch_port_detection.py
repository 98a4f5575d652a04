"""The port's detection ops against the JAX package (f32, CPU): NMS, RoI-Align,
proposal matching and label subsampling.

The CUDA kernels cannot run here; their checks against the plain versions
are phases of ``chip_smoke.py``.  What does run here: the plain versions and
the CPU route of the wrappers against the JAX functions, their Pallas
kernels in interpret mode and the numpy oracles, and an emulator of the NMS
kernel (``csrc/nms.cu``) that runs its bitonic sort stage by stage with its
comparator, builds its suppression words with its item mapping, walks them
32 boxes at a time as its one warp does (the diagonal word resolved by its
shuffle loop) and compacts by its prefix count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.ops import matching as jmatch
from instancesegmentation_tpu.ops import nms as jnms
from instancesegmentation_tpu.ops import roi_align as jroi
from instancesegmentation_tpu_torch.ops import matching as tmatch
from instancesegmentation_tpu_torch.ops import nms as tnms
from instancesegmentation_tpu_torch.ops import roi_align as troi

torch.set_num_threads(1)


def _np(*ts):
    return [np.asarray(t) for t in ts]


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------


def _nms_case(seed=0, n=64):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, 80, size=n)
    y0 = rng.uniform(0, 80, size=n)
    boxes = np.stack(
        [x0, y0, x0 + rng.uniform(5, 30, n), y0 + rng.uniform(5, 30, n)], -1
    ).astype(np.float32)
    scores = rng.uniform(0, 1, size=n).astype(np.float32)
    return boxes, scores


def _hard_case(seed=0, n=64):
    """Exact score ties, duplicated boxes (IoU 1) and zero-area boxes."""
    boxes, scores = _nms_case(seed, n)
    scores = np.round(scores, 1)        # ~10 distinct scores: many ties
    boxes[3::9] = boxes[2::9][: len(boxes[3::9])]
    boxes[5::11, 2] = boxes[5::11, 0]   # zero width
    boxes[7::13, 3] = boxes[7::13, 1]   # zero height
    return boxes, scores


def _port_nms(boxes, scores, *args, **kw):
    before = tnms.nms.launches
    idx, valid = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), *args, **kw)
    assert tnms.nms.launches == before  # CPU: the plain version
    assert idx.dtype == torch.int64 and valid.dtype == torch.bool
    return idx.numpy(), valid.numpy()


def test_box_iou_matches_jax():
    a, _ = _hard_case(1, 40)
    got = tnms.box_iou(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    want = np.asarray(jnms.box_iou_jnp(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
def test_nms_matches_jax_kernel_and_oracle(seed, threshold):
    boxes, scores = _nms_case(seed, n=96)
    idx, valid = _port_nms(boxes, scores, threshold)
    ref_idx, ref_valid = _np(*jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), threshold))
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(valid, ref_valid)
    p_idx, p_valid = _np(*jnms.nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), threshold,
                                          interpret=True))
    np.testing.assert_array_equal(idx, p_idx)
    np.testing.assert_array_equal(valid, p_valid)
    np.testing.assert_array_equal(idx[valid], jnms.nms_numpy(boxes, scores, threshold))


@pytest.mark.parametrize("k", [5, 80, 0])
def test_nms_max_outputs(k):
    """K < N truncates in score order, K > N pads with -1, K = 0 is empty."""
    boxes, scores = _nms_case(7, n=40)
    idx, valid = _port_nms(boxes, scores, 0.5, max_outputs=k)
    assert idx.shape == valid.shape == (k,)
    ref_idx, ref_valid = _np(*jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                       max_outputs=k))
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(valid, ref_valid)
    assert (idx[~valid] == -1).all()


def test_nms_score_threshold():
    boxes, scores = _nms_case(8, n=48)
    idx, valid = _port_nms(boxes, scores, 0.5, score_threshold=0.5)
    for fn, kw in ((jnms.nms, {}), (jnms.nms_pallas, {"interpret": True})):
        ref_idx, ref_valid = _np(*fn(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                     score_threshold=0.5, **kw))
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_array_equal(valid, ref_valid)
    assert (scores[idx[valid]] > 0.5).all()


@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_nms_ties_duplicates_zero_area(threshold):
    boxes, scores = _hard_case(4, n=90)
    idx, valid = _port_nms(boxes, scores, threshold, max_outputs=100)
    ref_idx, ref_valid = _np(*jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), threshold,
                                       max_outputs=100))
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_array_equal(idx[valid], jnms.nms_numpy(boxes, scores, threshold))
    # a duplicate (IoU 1) never survives beside its twin, where both have area
    kept = set(idx[valid].tolist())
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in range(3, 90, 9):
        if area[i] > 0 and (boxes[i] == boxes[i - 1]).all():
            assert not {i, i - 1} <= kept


def test_batched_nms_matches_jax():
    boxes, scores = _nms_case(9, n=50)
    classes = np.random.default_rng(9).integers(0, 3, 50).astype(np.int32)
    idx, valid = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  torch.from_numpy(classes), 0.4, max_outputs=30)
    ref_idx, ref_valid = _np(*jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                               jnp.asarray(classes), 0.4, max_outputs=30))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    # two overlapping boxes of different classes both stay
    two = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11]], dtype=torch.float32)
    sc = torch.tensor([0.9, 0.8])
    assert int(tnms.batched_nms(two, sc, torch.tensor([0, 0]), 0.5)[1].sum()) == 1
    assert int(tnms.batched_nms(two, sc, torch.tensor([0, 1]), 0.5)[1].sum()) == 2


def test_nms_batch_matches_jax():
    cases = [_nms_case(s, n=32) for s in (10, 11)] + [_hard_case(12, n=32)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    idx, valid = tnms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                                max_outputs=20)
    assert idx.shape == valid.shape == (3, 20)
    ref_idx, ref_valid = _np(*jnms.nms_batch(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                             max_outputs=20))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)


def test_nms_wrappers_reject_bad_inputs():
    boxes, scores = _nms_case(0, n=8)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    with pytest.raises(ValueError):
        tnms.nms(b[:, :3], s)
    with pytest.raises(ValueError):
        tnms.nms(b, s[:5])
    with pytest.raises(ValueError):
        tnms.nms(b[None], s[None])
    with pytest.raises(ValueError):
        tnms.nms_batch(b, s)
    with pytest.raises(TypeError):
        tnms.nms(b.int(), s)


# -- the CUDA kernel, emulated ------------------------------------------------

_LANES = np.arange(32)


def _ballot(pred: np.ndarray) -> int:
    return int((pred.astype(np.uint64) << _LANES.astype(np.uint64)).sum())


def _popc(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1")


def _kernel_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """csrc/nms.cu:box_iou in float32, box a against the boxes b [32, 4]."""
    f = np.float32
    w = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), f(0))
    h = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), f(0))
    inter = w * h
    area_a = np.maximum(a[2] - a[0], f(0)) * np.maximum(a[3] - a[1], f(0))
    area_b = np.maximum(b[:, 2] - b[:, 0], f(0)) * np.maximum(b[:, 3] - b[:, 1], f(0))
    union = (area_a + area_b) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / np.maximum(union, f(1e-12)), f(0)).astype(f)


def _ranks_before(sa, ia, sb, ib):
    """csrc/nms.cu:ranks_before, elementwise: a number before a NaN, then
    descending score by value (-0.0 == +0.0), then ascending index."""
    na, nb = np.isnan(sa), np.isnan(sb)
    with np.errstate(invalid="ignore"):
        by_value = np.where(sa != sb, sa > sb, ia < ib)
    return np.where(na != nb, nb, np.where(na, ia < ib, by_value))


def _bitonic_sort(scores: np.ndarray):
    """Phase A: the bitonic network over (score, index), padded to a power
    of two with NaN sentinels of index >= N, stage by stage as the block runs
    it (comparator t swaps lo and lo + stride; at strides <= 32 a warp's
    comparators touch only its own 64 elements, so those stages meet at a
    warp barrier) -> (keys, indices)."""
    n = len(scores)
    p = 1
    while p < n:
        p <<= 1
    key = np.full(p, np.nan, np.float32)
    key[:n] = scores
    idx = np.arange(p)
    t = np.arange(p // 2)
    size = 2
    while size <= p:
        stride = size >> 1
        while stride:
            s = stride.bit_length() - 1
            lo = ((t >> s) << (s + 1)) | (t & (stride - 1))
            hi = lo + stride
            if stride <= 32:  # a warp's comparators stay in its 64 elements: __syncwarp
                assert (lo >> 6 == t >> 5).all() and (hi >> 6 == t >> 5).all()
            swap = _ranks_before(key[hi], idx[hi], key[lo], idx[lo]) == ((lo & size) == 0)
            kl, kh, il, ih = key[lo], key[hi], idx[lo], idx[hi]
            key[lo], key[hi] = np.where(swap, kh, kl), np.where(swap, kl, kh)
            idx[lo], idx[hi] = np.where(swap, ih, il), np.where(swap, il, ih)
            stride >>= 1
        size <<= 1
    return key, idx


def _emulate_nms_kernel(boxes, scores, thr, k, score_thr=-np.inf, window=0,
                        log_split=0):
    """Run csrc/nms.cu:nms_kernel for one image: the sort (A); the mask
    words as the cluster's items e = (w * 32 nwords + i) * split + s, w >= i /
    32, part s a loop over its 32 / split boxes of word w, the parts ORed (B),
    over a mask poisoned with all ones, so a read of a word no item wrote
    kills every box; the walk of each word c by one warp (C): the 32 boxes'
    diagonal words resolve word c in registers, then the kept rows are ORed
    into the later words lane by lane, from the mask or (``window`` > 0: the
    global mask) from a copy of the word's 32 rows in column windows of
    ``window`` words, the first holding the diagonal word, every read
    checked to lie in the staged window; the warp-0 prefix scan of the alive
    words' popcounts and the compaction (D).  Returns (indices, valid,
    sorted order)."""
    n = boxes.shape[0]
    key, order = _bitonic_sort(scores.astype(np.float32))
    assert (order[:n] < n).all()  # the sentinels sort last
    order = order[:n]
    sb, ss = boxes[order].astype(np.float32), key[:n]
    thr, score_thr = np.float32(thr), np.float32(score_thr)
    nwords = (n + 31) >> 5
    npad = nwords << 5
    split, part = 1 << log_split, 32 >> log_split
    items = (nwords * npad) << log_split
    assert items % 32 == 0  # whole warps: every lane takes the same trips
    mask = np.full((n, nwords), 0xFFFFFFFF, np.int64)
    written = np.zeros((n, nwords), bool)
    for e0 in range(0, items, split):  # the split lanes of one item
        w, i = divmod(e0 >> log_split, npad)
        if i >= n or w < (i >> 5):
            continue
        word = 0
        for s in range(split):
            j = (w << 5) + s * part + np.arange(part)
            bits = (j > i) & (j < n) & (_kernel_iou(sb[i], sb[np.minimum(j, n - 1)]) > thr)
            word |= _ballot(np.pad(bits, (s * part, 32 - (s + 1) * part)))
        assert not written[i, w]
        written[i, w] = True
        mask[i, w] = word
    removed = [0] * nwords
    for w in range(nwords):
        j = (w << 5) + _LANES
        with np.errstate(invalid="ignore"):
            alive = (j < n) & (ss[np.minimum(j, n - 1)] > score_thr)
        removed[w] = ~_ballot(alive) & 0xFFFFFFFF
    span_max = window or nwords
    for c in range(nwords):
        nrow = min(32, n - (c << 5))
        for w0 in range(c, nwords, span_max):
            span = min(span_max, nwords - w0)
            rows = mask[c << 5:(c << 5) + 32]  # row r of word c's boxes
            if window:  # the stage holds columns w0 .. w0 + span - 1 only
                rows = np.full((32, nwords), -1, np.int64)
                rows[:nrow, w0:w0 + span] = mask[c << 5:(c << 5) + nrow, w0:w0 + span]
                rows[nrow:, w0:w0 + span] = 0
            if w0 == c:
                dead = removed[c]
                for r in range(32):  # the diagonal words, broadcast to every lane
                    if not (dead >> r) & 1:
                        assert r < nrow  # boxes past n are seeded dead: no read past the mask
                        dead |= int(rows[r, c])
                        assert rows[r, c] >= 0
            kept = ~dead & 0xFFFFFFFF
            for w in range(max(w0, c + 1), w0 + span):  # lane (w - ...) mod 32
                acc = removed[w]
                for r in range(32):
                    if (kept >> r) & 1:
                        assert rows[r, w] >= 0, "a read outside the staged window"
                        acc |= int(rows[r, w])
                removed[w] = acc
            if w0 == c:
                removed[c] = dead
    alive_words = [~x & 0xFFFFFFFF for x in removed]
    # warp 0: exclusive prefix of the popcounts, 32 words at a time
    prefix = np.zeros(nwords + 1, np.int64)
    carry = 0
    for base in range(0, nwords, 32):
        w = base + _LANES
        cnt = np.array([_popc(alive_words[x]) if x < nwords else 0 for x in w])
        incl = cnt.copy()
        off = 1
        while off < 32:  # __shfl_up_sync inclusive scan
            incl = np.where(_LANES >= off, incl + np.roll(incl, off), incl)
            off <<= 1
        for lane in range(32):
            if w[lane] < nwords:
                prefix[w[lane]] = carry + incl[lane] - cnt[lane]
        carry += int(incl[31])
    prefix[nwords] = carry
    indices = np.full(k, -1, np.int64)
    valid = np.zeros(k, bool)
    for j in range(n):
        word, bit = alive_words[j >> 5], 1 << (j & 31)
        if word & bit:
            pos = prefix[j >> 5] + _popc(word & (bit - 1))
            if pos < k:
                indices[pos], valid[pos] = order[j], True
    return indices, valid, order


def _oracle_keep(boxes, scores, thr, score_thr=-np.inf):
    """jnms.nms_numpy on the boxes whose score passes ``score_thr`` (NaN
    never does), mapped back to input indices."""
    with np.errstate(invalid="ignore"):
        sub = np.flatnonzero(scores > np.float32(score_thr))
    if sub.size == 0:
        return sub
    return sub[jnms.nms_numpy(boxes[sub], scores[sub], thr)]


def _check_emulator(boxes, scores, threshold, k, score_thr=-np.inf, window=0,
                    log_split=0):
    idx, valid, order = _emulate_nms_kernel(boxes, scores, threshold, k, score_thr, window,
                                            log_split)
    want_order = torch.argsort(-torch.from_numpy(scores), stable=True).numpy()
    np.testing.assert_array_equal(order, want_order)  # the plain version's sort
    ref_idx, ref_valid = _port_nms(boxes, scores, threshold, max_outputs=k,
                                   score_threshold=score_thr)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(valid, ref_valid)
    j_idx, j_valid = _np(*jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), threshold,
                                   max_outputs=k, score_threshold=score_thr))
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(valid, j_valid)
    np.testing.assert_array_equal(idx[valid], _oracle_keep(boxes, scores, threshold,
                                                           score_thr)[:k])
    return idx, valid


@pytest.mark.parametrize("n,k,threshold,hard", [
    (1, 3, 0.5, False), (37, 37, 0.5, True), (100, 20, 0.7, True), (1100, 1200, 0.3, False),
])
def test_nms_kernel_scan_emulator(n, k, threshold, hard):
    boxes, scores = (_hard_case if hard else _nms_case)(n, n)
    if n > 200:  # spread the boxes so that many survive and the scan spans >32 words
        boxes[:, [0, 2]] *= 8.0
    _check_emulator(boxes, scores, threshold, k, window=(n > 1000) * 35, log_split=int(n < 200))
    # the score threshold seeds the alive words
    _check_emulator(boxes, scores, threshold, k, score_thr=0.5, log_split=3 * int(n < 50))


@pytest.mark.parametrize("window", [1, 3, 32])
def test_nms_kernel_emulator_column_windows(window):
    """The walk from a global mask in forced small column windows: bit-equal
    to the plain version, JAX and the oracle (and to the unwindowed walk)."""
    boxes, scores = _nms_case(31, 300)
    boxes[:, [0, 2]] *= 4.0
    for threshold, k in ((0.5, 300), (0.3, 40)):
        idx, valid = _check_emulator(boxes, scores, threshold, k, window=window)
        whole = _emulate_nms_kernel(boxes, scores, threshold, k)
        np.testing.assert_array_equal(idx, whole[0])
        np.testing.assert_array_equal(valid, whole[1])


@pytest.mark.parametrize("block_rows", [1, 7, 64])
def test_nms_reference_blocked_equals_reference(block_rows):
    """The row-blocked plain NMS (the card's check above the plain version's
    reach) keeps what ``nms_reference`` keeps, ties and score thresholds
    included."""
    for boxes, scores in (_nms_case(32, 150), _hard_case(33, 90), _edge_scores("nan_and_inf")):
        b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
        for thr, k, score_thr in ((0.5, None, -np.inf), (0.7, 17, 0.3)):
            got = tnms.nms_reference_blocked(b, s, thr, k, score_thr, block_rows=block_rows)
            want = tnms.nms_reference(b, s, thr, k, score_thr)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _edge_scores(case: str):
    """Inputs of the kernel's sort and walk edges."""
    boxes, scores = _hard_case(21, 90)
    if case == "exact_ties":
        scores[:] = np.float32(0.5)
        scores[10:30] = np.float32(0.75)
    elif case == "signed_zeros":
        scores[0::3] = np.float32(0.0)
        scores[1::3] = np.float32(-0.0)
        scores[2::9] = -scores[2::9]
    elif case == "nan_and_inf":
        scores[0::5] = np.nan
        scores[2::7] = -np.inf
        scores[3::11] = np.inf
    elif case == "n_not_pow2":
        boxes, scores = _hard_case(22, 97)
        scores[40:] = scores[:57]  # ties across words
    return boxes, scores


@pytest.mark.parametrize("score_thr", [-np.inf, 0.25], ids=["no_score_thr", "score_thr"])
@pytest.mark.parametrize("case", ["exact_ties", "signed_zeros", "nan_and_inf", "n_not_pow2"])
def test_nms_kernel_emulator_score_edges(case, score_thr):
    boxes, scores = _edge_scores(case)
    n = len(scores)
    for threshold, k, log_split in ((0.5, n // 4, 1), (0.7, n + 7, 2)):
        idx, valid = _check_emulator(boxes, scores, threshold, k, score_thr, log_split=log_split)
        kept = scores[idx[valid]]
        with np.errstate(invalid="ignore"):
            assert (kept > np.float32(score_thr)).all()  # NaN and -inf never survive
        if case == "signed_zeros" and score_thr < 0:
            # -0.0 and +0.0 tie: their boxes keep input order among themselves
            zeros = idx[valid][kept == 0]
            assert (np.diff(zeros) > 0).all()


# ---------------------------------------------------------------------------
# RoI-Align
# ---------------------------------------------------------------------------


def _roi_case(seed=0, n=2, h=24, w=32, c=5, r=6):
    """Boxes partly outside the map (x0, y0 from -2)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, h, w, c)).astype(np.float32)
    x0 = rng.uniform(-2, w - 4, size=r)
    y0 = rng.uniform(-2, h - 4, size=r)
    bw = rng.uniform(2, w / 2, size=r)
    bh = rng.uniform(2, h / 2, size=r)
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], axis=-1).astype(np.float32)
    boxes[0] = [-6.0, -5.0, w + 3.0, h + 4.0]  # beyond the map on every side
    idx = rng.integers(0, n, size=r).astype(np.int32)
    return feats, boxes, idx


def _port_roi(feats, boxes, idx, *args, **kw):
    before = troi.roi_align.launches
    out = troi.roi_align(torch.from_numpy(feats), torch.from_numpy(boxes),
                         torch.from_numpy(idx), *args, **kw)
    assert troi.roi_align.launches == before  # CPU: the plain version
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("ratio", [1, 2])
def test_roi_align_matches_jax_kernel_and_oracle(aligned, ratio):
    feats, boxes, idx = _roi_case(seed=ratio + 2 * aligned, c=8)
    kw = dict(spatial_scale=0.5, sampling_ratio=ratio, aligned=aligned)
    got = _port_roi(feats, boxes, idx, (7, 7), **kw)
    assert got.shape == (6, 7, 7, 8)
    j = [jnp.asarray(a) for a in (feats, boxes, idx)]
    np.testing.assert_allclose(got, np.asarray(jroi.roi_align(*j, (7, 7), **kw)), atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jroi.roi_align_pallas(*j, (7, 7), interpret=True, **kw)), atol=1e-4)
    np.testing.assert_allclose(got, jroi.roi_align_numpy(feats, boxes, idx, (7, 7), **kw),
                               atol=1e-4)


def test_roi_align_chunks_equal_one_pass():
    feats, boxes, idx = _roi_case(seed=5, r=37)
    args = [torch.from_numpy(a) for a in (feats, boxes, idx)]
    whole = troi.roi_align_reference(*args, (5, 6), 0.5, 2, False, chunk=37)
    for chunk in (1, 16):
        np.testing.assert_allclose(
            troi.roi_align_reference(*args, (5, 6), 0.5, 2, False, chunk=chunk).numpy(),
            whole.numpy(), rtol=0, atol=1e-6)
    assert troi.REFERENCE_CHUNK == 16


def test_roi_align_bf16_features():
    feats, boxes, idx = _roi_case(seed=6, c=8)
    f16 = torch.from_numpy(feats).bfloat16()
    got = troi.roi_align(f16, torch.from_numpy(boxes), torch.from_numpy(idx), (4, 4))
    want = jroi.roi_align(jnp.asarray(f16.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(boxes), jnp.asarray(idx), (4, 4))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_roi_align_rejects_bad_inputs():
    feats, boxes, idx = _roi_case(seed=7)
    f, b, i = (torch.from_numpy(a) for a in (feats, boxes, idx))
    with pytest.raises(ValueError):
        troi.roi_align(f, b, i, sampling_ratio=0)
    with pytest.raises(ValueError):
        troi.roi_align(f[0], b, i)
    with pytest.raises(ValueError):
        troi.roi_align(f, b[:, :3], i)
    with pytest.raises(TypeError):
        troi.roi_align(f.double(), b, i)


def _nonfinite_case():
    """Boxes whose sample centres are NaN (a NaN coordinate, or -inf + inf)
    or infinite, beside finite ones."""
    feats, boxes, idx = _roi_case(seed=8, c=8, r=8)
    boxes[1] = [np.nan, 1.0, 5.0, 5.0]
    boxes[2] = [-np.inf, 1.0, np.inf, 5.0]
    boxes[3] = [1.0, np.nan, 5.0, np.nan]
    boxes[4] = [0.0, 1.0, np.inf, 5.0]
    boxes[5] = [1.0, -np.inf, 6.0, 4.0]
    return feats, boxes, idx


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_nonfinite_boxes_give_zeros_as_jax(aligned):
    """A box whose samples fall on NaN or infinite centres weighs nothing:
    its bins are zeros, bit for bit, in the port and in JAX."""
    feats, boxes, idx = _nonfinite_case()
    kw = dict(spatial_scale=0.5, sampling_ratio=2, aligned=aligned)
    got = _port_roi(feats, boxes, idx, (4, 5), **kw)
    want = np.asarray(jroi.roi_align(*(jnp.asarray(a) for a in (feats, boxes, idx)), (4, 5),
                                     **kw))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1:6], np.zeros_like(got[1:6]))
    np.testing.assert_array_equal(want[1:6], np.zeros_like(want[1:6]))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the numpy oracle casts a NaN centre to an index and raises: it sees the
    # finite boxes and those with infinite (not NaN) centres
    keep = [0, 4, 6, 7]
    np.testing.assert_allclose(
        got[keep], jroi.roi_align_numpy(feats, boxes[keep], idx[keep], (4, 5), **kw), atol=1e-4)


def test_roi_align_box_indices_follow_jax_gather():
    """i < 0 wraps once to i + N, then indices clamp to [0, N - 1]: -1 -> N-1,
    N -> N-1, -N-1 -> 0, as JAX's gather does."""
    feats, boxes, idx = _roi_case(seed=9, n=3, c=4, r=6)
    idx = np.array([-1, 3, -4, 7, -3, 1], np.int32)
    ruled = np.array([2, 2, 0, 2, 0, 1], np.int32)
    np.testing.assert_array_equal(troi.gather_index(torch.from_numpy(idx), 3).numpy(), ruled)
    got = _port_roi(feats, boxes, idx, (3, 3), 0.5, 2, True)
    want = np.asarray(jroi.roi_align(*(jnp.asarray(a) for a in (feats, boxes, idx)), (3, 3),
                                     0.5, 2, True))
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, _port_roi(feats, boxes, ruled, (3, 3), 0.5, 2, True),
                               rtol=0, atol=0)
    np.testing.assert_allclose(
        got, jroi.roi_align_numpy(feats, boxes, ruled, (3, 3), 0.5, 2, True), atol=1e-4)


# ---------------------------------------------------------------------------
# proposal matching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("allow_lq", [True, False])
@pytest.mark.parametrize("seed", [0, 4, 9])
def test_match_proposals_bit_equal_to_jax(seed, allow_lq):
    rng = np.random.default_rng(seed)
    iou = rng.uniform(0, 1, size=(48, 12)).astype(np.float32)
    iou[5] = iou[3]              # tied rows
    iou[7, [2, 9]] = iou[7].max()  # a tie inside a row: the first index wins
    iou[:, 7] = 0.0              # a ground truth nobody overlaps
    iou[11] = 0.0                # a proposal that overlaps nothing
    before = tmatch.match_proposals.launches
    m, lab = tmatch.match_proposals(torch.from_numpy(iou), allow_low_quality=allow_lq)
    assert tmatch.match_proposals.launches == before
    assert m.dtype == torch.int64 and lab.dtype == torch.int32
    for fn, kw in ((jmatch.match_proposals, {}),
                   (jmatch.match_proposals_pallas, {"interpret": True})):
        ref_m, ref_l = _np(*fn(jnp.asarray(iou), allow_low_quality=allow_lq, **kw))
        np.testing.assert_array_equal(m.numpy(), ref_m)
        np.testing.assert_array_equal(lab.numpy(), ref_l)


def test_match_thresholds_and_low_quality_rescue():
    iou = torch.tensor([[0.9, 0.1], [0.4, 0.35], [0.1, 0.05]])
    m, lab = tmatch.match_proposals(iou, 0.5, 0.3, allow_low_quality=False)
    assert lab.tolist() == [tmatch.POSITIVE, tmatch.IGNORE, tmatch.NEGATIVE]
    assert m.tolist() == [0, 0, 0]
    # gt 1's best proposal reaches only 0.2: rescued as positive
    iou = torch.tensor([[0.9, 0.05], [0.1, 0.2]])
    assert tmatch.match_proposals(iou, 0.5, 0.3, False)[1].tolist() == [1, 0]
    m, lab = tmatch.match_proposals(iou, 0.5, 0.3, True)
    assert lab.tolist() == [1, 1] and m.tolist() == [0, 1]
    with pytest.raises(ValueError):
        tmatch.match_proposals(torch.zeros((4, 0)))


def test_subsample_labels_quota():
    """Random bits differ from jax.random: quotas and membership only."""
    g = torch.Generator().manual_seed(0)
    for n_pos, want_pos, want_neg in ((10, 8, 24), (2, 2, 30)):
        labels = torch.tensor([1] * n_pos + [-1] * 5 + [0] * (95 - n_pos), dtype=torch.int32)
        out = tmatch.subsample_labels(labels, g, batch_size=32, positive_fraction=0.25)
        jout = np.asarray(jmatch.subsample_labels(jnp.asarray(labels.numpy()),
                                                  jax.random.PRNGKey(0), 32, 0.25))
        assert out.dtype == labels.dtype
        assert int((out == 1).sum()) == int((jout == 1).sum()) == want_pos
        assert int((out == 0).sum()) == int((jout == 0).sum()) == want_neg
        assert (labels[out == 1] == 1).all() and (labels[out == 0] == 0).all()
        assert (out[labels == -1] == -1).all()


def _nan_matrices():
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 1, size=(24, 9)).astype(np.float32)
    base[4, [1, 6]] = base[4].max()          # a tie: the first index wins
    rows = base.copy()
    rows[0, [1, 3]] = np.nan                 # a row's first NaN is its match
    rows[0, 2] = 0.95
    rows[7, 8] = np.nan
    cols = base.copy()
    cols[[2, 15], 5] = np.nan                # a column with a NaN rescues nobody
    cols[3, 5] = 1.0
    whole = base.copy()
    whole[9] = np.nan                        # a whole NaN row
    whole[10, 0] = np.nan
    return {"rows": rows, "cols": cols, "whole_row": whole}


@pytest.mark.parametrize("allow_lq", [True, False])
@pytest.mark.parametrize("case", ["rows", "cols", "whole_row"])
def test_match_proposals_nan_follows_jax(case, allow_lq):
    """NaN in the matrix: JAX's max and argmax propagate it, and so does the
    port.  The JAX Pallas kernel is left out here: on a row with a NaN its
    matched index is G, out of range (ROADMAP.md section C)."""
    iou = _nan_matrices()[case]
    m, lab = tmatch.match_proposals(torch.from_numpy(iou), allow_low_quality=allow_lq)
    ref_m, ref_l = _np(*jmatch.match_proposals(jnp.asarray(iou), allow_low_quality=allow_lq))
    np.testing.assert_array_equal(m.numpy(), ref_m)
    np.testing.assert_array_equal(lab.numpy(), ref_l)
    nan_rows = np.isnan(iou).any(1)
    first_nan = np.argmax(np.isnan(iou), 1)
    np.testing.assert_array_equal(m.numpy()[nan_rows], first_nan[nan_rows])
    assert (lab.numpy()[nan_rows] == tmatch.IGNORE).all() or allow_lq
