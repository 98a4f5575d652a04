"""The sweep form of the two-level warp kernel (``warp_2level_fused``): its
plan and its schedule, emulated in numpy step by step in the kernel's order
(``csrc/warp_2level.cu:warp_2level_sweep_kernel``), against the plain
version and the JAX package (f32, CPU).

The emulator follows one CTA (a sample and a strip of output columns) at a
time: the steps of ``chunk_u`` output rows (halved while the band outgrows
the ring), the canvas rows each step adds to the ring, staged in pieces of
``stage_rows`` rows as byte windows, and pass 2 from the ring.  It asserts
that pass 2 finds every tmp row it loads in the ring, that pass 1 reads no
canvas pixel outside its row's staged window (and the bulk copies no byte
outside the tensor), and that each tmp value is computed once per strip.
"""
import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.ops import warp as jw
from instancesegmentation_tpu_torch.data import pipeline as tpipe
from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch
from instancesegmentation_tpu_torch.ops import warp as tw
from instancesegmentation_tpu_torch.ops import warp_2level as w2
from test_torch_port_rotation import (
    F32,
    H,
    OUT,
    W,
    _canvas,
    _centre,
    _params,
    _pass1,
    _pass2,
    _residual,
    _row_span,
    _upos,
)

torch.set_num_threads(1)
TRAIN_SCALE_X_MAX = (640 + 2 * tw.SRC_PAD) / 480
#: the H100's shared memory per SM and what each resident CTA reserves
SM_SMEM, CTA_RESERVED = 228 * 1024, 1024


def _span(k, h, block, d2, ua, ub, va, vb):
    """``_row_span`` with the kernel's fminf / fmaxf over a NaN corner:
    NaN corners are passed over, all NaN gives the whole canvas."""
    p = np.array([_upos(k, block, u, v) for u in (ua, ub - 1) for v in (va, vb)], F32)
    if np.isfinite(p).all():
        return _row_span(k, h, block, d2, ua, ub, va, vb)
    lo = np.nanmin(p) if not np.isnan(p).all() else F32(np.nan)
    hi = np.nanmax(p) if not np.isnan(p).all() else F32(np.nan)
    flo = np.fmax(np.floor(lo) - F32(d2), F32(0))
    fhi = np.fmin(np.floor(hi) + F32(2 + d2), F32(h - 1))
    return int(np.fmin(flo, F32(h))), int(np.fmax(fhi, F32(-1)))


Phase = collections.namedtuple("Phase", "ia ib lo hi p0 p1 direct")


def _phases(k, h, oh, block, d2, plan, v0, vb, stats):
    """The kernel's steps for one strip (``next_phase``), in its order."""
    up = k[5] < 0
    r = plan.ring_rows
    front = lo_valid = 0

    def span(ia, ib):
        return _span(k, h, block, d2, oh - ib, oh - ia, v0, vb) if up else \
            _span(k, h, block, d2, ia, ib, v0, vb)

    ia = 0
    while ia < oh:
        su = min(plan.chunk_u, oh - ia)
        lo, hi = span(ia, ia + su)
        while su > 1 and hi - lo + 1 > r:
            su = (su + 1) >> 1
            lo, hi = span(ia, ia + su)
            stats["halvings"] += 1
        if hi < lo or hi - lo + 1 > r:
            yield Phase(ia, ia + su, lo, hi, front, front, hi >= lo)
        else:
            if lo < lo_valid or lo > front:
                stats["resets" if lo < lo_valid else "skips"] += 1
                front = lo_valid = lo
            p0, front = front, max(front, hi + 1)
            lo_valid = max(lo_valid, front - r)
            yield Phase(ia, ia + su, lo, hi, p0, front, False)
        ia += su


def _windows(k, h, w, block, d1, nb, b, ys, v0, vb, plan, base, stats):
    """The stage of canvas rows ``ys`` of sample ``b`` of ``nb`` (the kernel's
    ``stage``): each row's window [xa, xb] (xa = -1: unstaged, read from
    device memory; an empty window reads nothing), with its 16-byte copies
    checked against the tensors' bounds (one bulk copy of 16-byte chunks
    each for RGB and mask where they lie inside the tensor, else byte by
    byte), ``base`` the image's and the mask's first addresses."""
    k0, _, _ = _residual(k[1], ys, block, d1)
    bxc = k[1] * _centre(ys, block)
    pa, pb = (k[0] * F32(v0) + bxc) + k[2], (k[0] * F32(vb) + bxc) + k[2]
    xa_f = np.floor(np.fmin(pa, pb)) + k0.astype(F32)
    xb_f = np.floor(np.fmax(pa, pb)) + (k0 + 2).astype(F32)
    xa = np.fmin(np.fmax(xa_f, F32(0)), F32(w)).astype(np.int64)
    xb = np.fmax(np.fmin(xb_f, F32(w - 1)), F32(-1)).astype(np.int64)
    in_cut = (ys.astype(F32) >= np.where(k[8] < 0, F32(0), k[8])) & \
        (ys.astype(F32) < np.minimum(k[9], F32(h)))
    img_base, msk_base = base
    img_end, msk_end = img_base + 3 * nb * h * w, msk_base + nb * h * w
    win_a, win_b = np.zeros_like(xa), np.zeros_like(xb)
    for i, y in enumerate(ys):
        win_a[i], win_b[i] = 0, -1
        if not in_cut[i] or xa[i] > xb[i]:
            continue
        px, n = (b * h + y) * w + xa[i], xb[i] - xa[i] + 1
        a_lo, m_lo = img_base + 3 * px, msk_base + px
        a0, a1 = a_lo // 16 * 16, -(-(a_lo + 3 * n) // 16) * 16
        m0, m1 = m_lo // 16 * 16, -(-(m_lo + n) // 16) * 16
        if a1 - a0 > plan.stage_rgb or m1 - m0 > plan.stage_mask:
            win_a[i] = -1
            stats["unstaged_rows"] += 1
            continue
        win_a[i], win_b[i] = xa[i], xb[i]
        stats["staged_rows"] += 1
        for c0, c1, t0, t1 in ((a0, a1, img_base, img_end), (m0, m1, msk_base, msk_end)):
            assert c0 % 16 == 0 and c1 % 16 == 0
            if t0 <= c0 and c1 <= t1:
                stats["bulk_copies"] += 1
            else:  # byte by byte, only the bytes inside the tensor
                stats["byte_rows"] += 1
                assert c0 < t0 or c1 > t1
    return win_a, win_b


def _check_reads(k, h, w, block, d1, ys, vs, win_a, win_b):
    """Every canvas pixel pass 1 of rows ``ys`` and columns ``vs`` reads
    (a used tap, inside the image and the translation cut) lies in its
    row's staged window."""
    k0, _, _ = _residual(k[1], ys, block, d1)
    vpos = (k[0] * vs.astype(F32))[None, :] + (k[1] * _centre(ys, block))[:, None]
    vpos = vpos + k[2]
    x0 = np.where(np.isnan(vpos), 0, np.floor(np.nan_to_num(vpos, posinf=2 ** 40,
                                                              neginf=-2 ** 40))).astype(np.int64)
    hix = np.minimum(k[4], F32(w))
    lox = np.where(k[3] < 0, F32(0), k[3])
    use = []
    for t in range(2):
        hw = np.maximum(F32(0), F32(1) - np.abs(vpos - (x0 + t).astype(F32)))
        use.append((x0 + t >= 0) & (x0 + t < w) & (hw > 0))
    row_in = (ys.astype(F32) >= np.where(k[8] < 0, F32(0), k[8])) & \
        (ys.astype(F32) < np.minimum(k[9], F32(h)))
    for j, read in ((0, use[0]), (1, use[0] | use[1]), (2, use[1])):
        x = x0 + k0[:, None] + j
        touched = read & (x >= 0) & (x < w) & (x.astype(F32) >= lox) & (x.astype(F32) < hix)
        touched &= row_in[:, None] & (win_a >= 0)[:, None]
        assert ((x >= win_a[:, None]) & (x <= win_b[:, None]))[touched].all(), \
            "pass 1 reads a pixel outside its row's staged window"


def _emulate_sweep(img, mask, params, out_hw, theta_max_deg, block, plan, base=(0, 0)):
    """Run the sweep CTA by CTA, step by step; ``base`` gives the image's
    and the mask's addresses mod 16.  Returns (out [B, oh, ow, 4], counts
    of the paths taken)."""
    b, h, w, _ = img.shape
    oh, ow = out_hw
    d1, d2 = tw.two_level_bands(theta_max_deg, block, (w + 2 * tw.SRC_PAD) / ow)
    coefs = w2.coefficients(params).numpy()
    content = np.concatenate([img, mask[..., None]], -1).astype(F32)
    out = np.zeros((b, oh, ow, 4), F32)
    stats = collections.Counter()
    r, q = plan.ring_rows, plan.stage_rows
    for s in range(b):
        k = coefs[s]
        for v0 in range(0, ow, plan.strip):
            nv = min(plan.strip, ow - v0)
            vs = np.arange(v0, v0 + nv)
            ring = np.zeros((r, nv, 4), F32)
            ring_row = np.full(r, -1)
            computed = np.zeros(h, np.int64)
            for ph in _phases(k, h, oh, block, d2, plan, v0, v0 + nv - 1, stats):
                stats["steps"] += 1
                for y0 in range(ph.p0, ph.p1, q):
                    stats["extra_pieces"] += y0 != ph.p0
                    ys = np.arange(y0, min(ph.p1, y0 + q))
                    win_a, win_b = _windows(k, h, w, block, d1, b, s, ys, v0, v0 + nv - 1, plan,
                                            base, stats)
                    _check_reads(k, h, w, block, d1, ys, vs, win_a, win_b)
                    # the staged bytes alone: pixels off a staged window are NaN
                    staged = content[s].copy()
                    for y, xa, xb in zip(ys, win_a, win_b):
                        if xa >= 0:
                            staged[y, :xa] = staged[y, xb + 1:] = np.nan
                    ring[ys % r] = _pass1(staged, k, block, d1, ys, vs)
                    ring_row[ys % r] = ys
                    computed[ys] += 1
                us = np.arange(ph.ia, ph.ib)
                us = oh - 1 - us if k[5] < 0 else us
                if ph.direct:
                    stats["direct_px"] += nv
                    full = _pass1(content[s], k, block, d1, np.arange(h), vs)

                    def rows(y, need, full=full):
                        return np.where(need[..., None], full[np.clip(y, 0, h - 1),
                                                              np.arange(nv)[None, :]], F32(0))
                else:
                    def rows(y, need):
                        slot = np.clip(y, 0, h - 1) % r
                        assert (ring_row[slot][need] == y[need]).all(), "a tmp row off the ring"
                        assert ((y[need] >= ph.lo) & (y[need] <= ph.hi)).all()
                        return np.where(need[..., None], ring[slot, np.arange(nv)[None, :]],
                                        F32(0))

                out[s, us, v0:v0 + nv] = _pass2(rows, k, h, block, d2, us, vs)
            stats["max_computed"] = max(stats["max_computed"], int(computed.max()))
    return out, stats


def _training_params(n, seed):
    cfg = tpipe.AugmentConfig(out_size=(480, 480), rotate=25.0, rotate_prob=1.0,
                              flip_prob=0.5, jitter=0.1)
    batch = synthetic_host_batch(n, 640, seed=seed)
    draws = tpipe.draw_augment(n, cfg, torch.Generator().manual_seed(seed))
    params, _ = tpipe.rotated_warp_params(tpipe.batch_to(batch, "cpu"), draws, cfg)
    return params


@pytest.mark.parametrize("seed", [9, 10])
def test_sweep_plan_at_the_training_config(seed):
    """At 640 -> 480, rotate 25, block 16: ring and stage within the CTA's
    budget (two CTAs per SM, so every CTA of a batch of 32 is resident at
    once), the strips cover the output columns once and each strip's steps
    its rows once, and the training path's own params (8 samples drawn from
    ``seed``) need no fallback: no halved step, no direct row, every window
    staged, each tmp value computed once, only the first step beyond one
    stage buffer."""
    plan = w2.plan_sweep(25.0, 16, TRAIN_SCALE_X_MAX, (480, 480))
    strip = plan.strip
    assert strip == w2.SWEEP_STRIP and plan.smem_bytes <= w2.SWEEP_SMEM_BYTES
    assert 2 * (plan.smem_bytes + CTA_RESERVED) <= SM_SMEM
    assert 2 * 132 >= 32 * plan.grid[0]
    assert plan.stage_rgb % 16 == 0 and plan.stage_mask % 16 == 0
    cover = np.zeros(480, int)
    for v0 in range(0, plan.grid[0] * strip, strip):
        cover[v0:v0 + strip] += 1
    assert (cover == 1).all() and (plan.grid[0] - 1) * strip < 480
    d1, d2 = tw.two_level_bands(25.0, 16, TRAIN_SCALE_X_MAX)
    stats = collections.Counter()
    for s, k in enumerate(w2.coefficients(_training_params(8, seed)).numpy()):
        for v0 in range(0, 480, strip):
            vb = min(v0 + strip, 480) - 1
            rows = np.zeros(640, int)
            steps = list(_phases(k, 640, 480, 16, d2, plan, v0, vb, stats))
            assert [p.ia for p in steps] == [0] + [p.ib for p in steps[:-1]]
            assert steps[-1].ib == 480 and not any(p.direct for p in steps)
            assert all(p.p1 - p.p0 <= plan.stage_rows for p in steps[1:])
            for p in steps:
                rows[p.p0:p.p1] += 1
                _windows(k, 640, 640, 16, d1, 8, s, np.arange(p.p0, p.p1), v0, vb, plan, (0, 0),
                         stats)
            assert rows.max() == 1
    assert stats["halvings"] == stats["resets"] == stats["unstaged_rows"] == 0
    assert stats["staged_rows"] > 0


@pytest.mark.parametrize("scale_x_max", [12.0, 40.0])
def test_sweep_plan_beyond_one_step_stays_within_a_cta(scale_x_max):
    """Bounds so loose that not even a one-row step fits the budget: one-row
    steps, narrowed stage rows and the largest ring beside them, within the
    227 KB a CTA can take (the kernel handles what outgrows them)."""
    plan = w2.plan_sweep(25.0, 16, scale_x_max, (480, 480))
    assert plan.chunk_u == 1 and 1 <= plan.ring_rows
    assert plan.stage_rgb % 16 == 0 and plan.stage_mask % 16 == 0
    assert w2.SWEEP_SMEM_BYTES < plan.smem_bytes <= w2.MAX_SMEM_BYTES


def _want(img, mask, tp):
    return w2.warp_2level_reference(torch.from_numpy(img), torch.from_numpy(mask), tp,
                                    (OUT, OUT), 25.0).numpy()


def _plan():
    return w2.plan_sweep(25.0, 16, (W + 2 * tw.SRC_PAD) / OUT, (OUT, OUT))


@pytest.mark.parametrize("cut", [False, True], ids=["no_cut", "cut"])
@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
@pytest.mark.parametrize("deg", [0.0, 13.0, -25.0])
def test_sweep_schedule_matches_the_plain_version(deg, flip, cut):
    img, mask = _canvas(1, seed=21)
    _, tp = _params(deg, cut, flip, b=1)
    got, stats = _emulate_sweep(img, mask, tp, (OUT, OUT), 25.0, 16, _plan())
    assert stats["halvings"] == stats["direct_px"] == stats["unstaged_rows"] == 0
    assert stats["max_computed"] == 1 and stats["staged_rows"] > 0
    np.testing.assert_allclose(got, _want(img, mask, tp), atol=1e-4, rtol=0)


def test_sweep_schedule_matches_jax():
    """One case straight against the JAX package's
    ``ops/warp.py:warp_image_rotated_2level``."""
    img, mask = _canvas(1, seed=22)
    jp, tp = _params(-25.0, cut=True, flip=True, b=1)
    got, stats = _emulate_sweep(img, mask, tp, (OUT, OUT), 25.0, 16, _plan())
    assert stats["max_computed"] == 1
    x = np.concatenate([img, mask[..., None]], -1).astype(np.float32)
    want = np.asarray(jw.warp_image_rotated_2level(jnp.asarray(x[0]), jp, (OUT, OUT),
                                                   theta_max_deg=25.0))[None]
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=5e-3)


def _scaled(tp, mul):
    return tp._replace(scale=tp.scale * mul)


BEYOND = {
    # ring below a step's band: steps halved, then one-row steps direct
    "small_ring_split": (lambda p: p._replace(ring_rows=p.ring_rows // 3), None, "halvings"),
    "small_ring_direct": (lambda p: p._replace(ring_rows=8), None, "direct_px"),
    # a NaN term: every band is the whole canvas, wider than the ring
    "nan_sample": (None, "nan", "direct_px"),
    # 2.5 x scale_x_max: bands past the ring, steps halved
    "scale_beyond": (None, 2.5, "halvings"),
    # stage buffers of 3 rows: each step's rows in several pieces
    "small_stage": (lambda p: p._replace(stage_rows=3), None, "extra_pieces"),
    # stage rows of 16 bytes: windows wider than their slot, read from memory
    "narrow_stage": (lambda p: p._replace(stage_rgb=16, stage_mask=16), None, "unstaged_rows"),
    # cos(theta) < 0, so m00 < 0: swept from the last output row up
    "m00_negative": (None, "turn", "steps"),
}


@pytest.mark.parametrize("case", list(BEYOND))
def test_sweep_schedule_beyond_the_plan(case):
    """Each in-kernel fallback, reached by a case beyond the plan, stays
    equal to the plain version (a NaN sample to the kernels' rule: no tap of
    a NaN position is used, so its pixels are 0)."""
    modify, sample, path = BEYOND[case]
    img, mask = _canvas(2, seed=23)
    pairs = [_params(deg, cut=True, flip=deg < 0, b=1)[1] for deg in (13.0, -25.0)]
    tp = tw.RotWarpParams(*(torch.cat(f) for f in zip(*pairs)))
    if sample == "nan":
        cs = tp.cos_sin.clone()
        cs[0, 0] = float("nan")
        tp = tp._replace(cos_sin=cs)
    elif sample == "turn":
        th = math.radians(160.0)
        tp = tp._replace(cos_sin=torch.tensor([[math.cos(th), math.sin(th)]] * 2,
                                              dtype=torch.float32))
    elif sample is not None:
        tp = _scaled(tp, sample)
    plan = _plan()
    if modify is not None:
        plan = modify(plan)
    with np.errstate(invalid="ignore"):  # NaN positions cast to int in the helpers
        got, stats = _emulate_sweep(img, mask, tp, (OUT, OUT), 25.0, 16, plan)
    assert stats[path] > 0, stats
    want = _want(img, mask, tp)
    if sample == "nan":
        assert (got[0] == 0).all()
        got, want = got[1:], want[1:]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("base", [(0, 0), (5, 11)], ids=["aligned", "unaligned"])
def test_sweep_stages_rows_of_any_stride(base):
    """A canvas 100 pixels wide (rows of 300 bytes, not a multiple of 16),
    an output width that is not a multiple of the strip (two strips, the
    second of 36 columns), and tensors whose
    first byte is not 16-byte aligned: the bulk copies stay inside the
    tensors (rows at their ends byte by byte) and the output equals the
    plain version."""
    rng = np.random.default_rng(24)
    img = rng.integers(0, 256, (2, H, 100, 3), dtype=np.uint8)
    mask = (rng.random((2, H, 100)) > 0.5).astype(np.uint8) * 255
    pairs = [_params(deg, cut=True, flip=deg < 0, b=1)[1] for deg in (13.0, -25.0)]
    tp = tw.RotWarpParams(*(torch.cat(f) for f in zip(*pairs)))
    out_hw = (OUT, 100)
    plan = w2.plan_sweep(25.0, 16, (100 + 2 * tw.SRC_PAD) / 50, out_hw)
    got, stats = _emulate_sweep(img, mask, tp, out_hw, 25.0, 16, plan, base)
    assert stats["bulk_copies"] > 0 and (stats["byte_rows"] > 0) == (base != (0, 0))
    want = w2.warp_2level_reference(torch.from_numpy(img), torch.from_numpy(mask), tp,
                                    out_hw, 25.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
