"""The banded bf16 form of the chain kernel, on the CPU.

The cluster kernel (``csrc/fused_chain.cu:fused_chain_banded_kernel``)
cannot run here; ``chip_smoke.py`` holds it against its plain version on the
card.  What runs here:

* the band plan (``plan_banded``) at every serving shape: bands, shared
  memory, cluster size, the owner of every row a depthwise tap reads;
* an emulator of the banded schedule that walks the plan's table and packed
  parameters CTA by CTA over NaN-poisoned shared-memory buffers, reads other
  bands only through the plan's row -> rank table, and checks each such read
  against the cluster barriers (after the barrier that follows the write,
  never overwritten before the next one); it must equal the rounding plain
  version;
* the bf16 weight fragments against the ``mma.m16n8k16`` B-fragment layout;
* the rounding plain version (``fused_chain_reference(...,
  act_dtype=torch.bfloat16)``) against the JAX kernel in interpret mode, the
  flax spans and the float32 plain version;
* the wrapper's dispatch on the CPU.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.ops import fused_chain as jchain
from instancesegmentation_tpu_torch.models.export import fold_batchnorm
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.ops import fused_chain as tchain
from test_torch_port_chain import _span

torch.set_num_threads(1)

BF16 = torch.bfloat16


@functools.lru_cache(maxsize=None)
def _folded():
    model = Segment(20)
    init_weights_(model, torch.Generator().manual_seed(0))
    return fold_batchnorm(model.state_dict())


def _serving_spec(kind: str, s: int) -> tchain.ChainSpec:
    extract = tchain.extract_s1_chain if kind == "s1" else tchain.extract_s23_chain
    return extract(_folded(), s, s)


# -- the band plan ------------------------------------------------------------

# s1 at /8 and s23 at /16 of the 480, 512 and 640 px programs
SERVING = [("s1", 60), ("s1", 64), ("s1", 80), ("s23", 30), ("s23", 32), ("s23", 40)]


@pytest.mark.parametrize("kind,s", SERVING)
def test_band_plan_at_serving_shapes(kind, s):
    spec = _serving_spec(kind, s)
    plan = tchain.plan_banded(spec)
    assert plan is not None
    h, w, cl = spec.h, spec.w, plan.cluster
    # the smallest cluster that fits; above 8 only with the non-portable attribute
    assert cl in tchain.CLUSTER_SIZES and plan.nonportable == (cl > 8)
    assert all(tchain.plan_banded(spec, (c,)) is None for c in tchain.CLUSTER_SIZES if c < cl)
    # bands of whole rows cover the image once, at most band_px pixels each
    lo = plan.row_lo
    assert lo[0] == 0 and lo[-1] == h and len(lo) == cl + 1
    assert all(lo[r] < lo[r + 1] for r in range(cl))
    assert max(lo[r + 1] - lo[r] for r in range(cl)) * w == plan.band_px
    assert list(plan.row_rank) == [r for r in range(cl) for _ in range(lo[r], lo[r + 1])]
    # per-CTA shared memory: table copy, row addresses, buffers, two slots,
    # in that order without overlap, within 227 KB
    tab = plan.table
    assert plan.smem_bytes <= tchain.SMEM_LIMIT
    regions = [(0, 4 * int(tab[9])), (int(tab[12]), int(tab[12]) + 4 * h)]
    regions += [(o, o + 2 * plan.band_px * s_) for o, s_ in zip(plan.buf_offsets, plan.strides)]
    regions += list(zip(plan.slot_offsets, (o + b for o, b in zip(plan.slot_offsets,
                                                                 plan.slot_bytes))))
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
    assert regions[-1][1] <= plan.smem_bytes
    assert all(o % 128 == 0 for o, _ in regions)
    # buffer rows: an odd number of 16-byte units, at least the widest value
    assert all(s_ >= c and s_ % 8 == 0 and (s_ // 8) % 2 == 1
               for s_, c in zip(plan.strides, plan.widths))
    # every row a depthwise tap reads has an owner inside the cluster
    dw = [row for row in plan.ops() if row[0] == tchain.B_DW]
    assert dw
    for row in dw:
        taps = plan.op_params(row)[row[5]:row[5] + 8 * row[4]].view(np.int32).reshape(-1, 2)
        for dy in set(taps[:, 0].tolist()):
            for y in range(h):
                if 0 <= y + dy < h:
                    assert 0 <= plan.row_rank[y + dy] < cl


def test_band_plan_sizes_of_the_programs():
    """The cluster sizes the serving programs launch with."""
    got = {(k, s): tchain.plan_banded(_serving_spec(k, s)).cluster for k, s in SERVING}
    assert got == {("s1", 60): 4, ("s1", 64): 4, ("s1", 80): 8,
                   ("s23", 30): 8, ("s23", 32): 8, ("s23", 40): 16}


# -- the banded schedule, emulated ----------------------------------------------


def _act(v, kind, alpha):
    if kind == tchain.ACT_PRELU:
        return torch.where(v >= 0, v, alpha * v)
    return torch.clamp_min(v, 0.0) if kind == tchain.ACT_RELU else v


def _f32(blk, at, n):
    return torch.from_numpy(blk[at:at + 4 * n].view(np.float32).copy())


def _emulate_banded(x: torch.Tensor, plan: tchain.BandPlan) -> torch.Tensor:
    """Run ``plan`` the way the banded kernel does: per CTA (rank), bf16
    buffers of ``band_px`` rows poisoned with NaN; 1x1 convs over K-segments
    with packed fragments; depthwise taps reading the owner's rows through
    the plan's row tables.  Phases are the stretches between the cluster
    barriers, one before each depthwise op; every read of another CTA's rows
    is checked against them."""
    tab = plan.table
    n_ops, h, w, cl, in_buf, out_buf, c_in, c_out, n_bufs = (int(v) for v in tab[:9])
    rows_off = int(tab[10])
    strides = tab[tchain.HDR:tchain.HDR + 2 * n_bufs].reshape(n_bufs, 2)[:, 1]
    row_lo = tab[rows_off:rows_off + cl + 1].tolist()
    row_rank = tab[rows_off + cl + 1:rows_off + cl + 1 + h]
    assert row_lo == list(plan.row_lo) and row_rank.tolist() == list(plan.row_rank)
    n = x.shape[0]
    px = [(row_lo[r + 1] - row_lo[r]) * w for r in range(cl)]
    smem = [[torch.full((n, plan.band_px, int(s)), float("nan")) for s in strides]
            for _ in range(cl)]
    for r in range(cl):
        smem[r][in_buf][:, :px[r], :c_in] = x[:, row_lo[r]:row_lo[r + 1]].reshape(
            n, px[r], c_in).float()
    remote_reads: dict = {}  # phase -> {(owner rank, buffer)} read from other CTAs
    written_in: dict = {}    # (rank, buffer) -> phase of its last write

    def write(r, b, v, phase):
        assert (r, b) not in remote_reads.get(phase, set()), (
            f"buffer {b} of rank {r} is overwritten in phase {phase}, while another "
            "CTA may still read it")
        assert v.shape[-1] <= strides[b]
        smem[r][b][:, :px[r], :v.shape[-1]] = v.to(BF16).float()
        written_in[(r, b)] = phase

    phase = 0
    for k, row in enumerate(plan.ops().tolist()):
        blk = plan.op_params(row)
        assert row[13] == k % 2 and blk.size == 16 * row[12] <= plan.slot_bytes[row[13]]
        if row[0] == tchain.B_MM:
            assert row[18] == phase
            nseg, n_out, dst, add, kind = row[1], row[8], row[9], row[10], row[15]
            segs = [(row[2 + 2 * s], row[3 + 2 * s]) for s in range(nseg)]
            assert row[19] in tchain.MMA_N_TILES and (n_out // 8) % row[19] == 0
            # a residual may be written in place, a K-segment never
            assert dst not in {b for b, _ in segs}
            k_all = sum(c for _, c in segs)
            wt = tchain.unpack_fragments(blk[:2 * k_all * n_out].view(np.uint16), k_all, n_out)
            wt = torch.from_numpy(wt).double()
            bias = _f32(blk, row[14], n_out)
            alpha = _f32(blk, row[16], n_out) if kind == tchain.ACT_PRELU else None
            outs = []
            for r in range(cl):
                a = torch.cat([smem[r][b][:, :px[r], :c] for b, c in segs], -1)
                v = (a.double() @ wt).float() + bias
                if add >= 0:
                    v = v + smem[r][add][:, :px[r], :n_out]
                outs.append(_act(v, kind, alpha))
            for r in range(cl):
                write(r, dst, outs[r], phase)
        else:
            phase += 1  # the cluster barrier before a depthwise op
            assert row[10] == phase
            src, dst, c, ntaps, kind = row[1], row[2], row[3], row[4], row[8]
            assert dst != src
            taps = blk[row[5]:row[5] + 8 * ntaps].view(np.int32).reshape(ntaps, 2).tolist()
            wdw = _f32(blk, row[6], ntaps * c).view(ntaps, c)
            bias = _f32(blk, row[7], c)
            alpha = _f32(blk, row[9], c) if kind == tchain.ACT_PRELU else None
            outs = []
            for r in range(cl):
                p = torch.arange(px[r])
                y, xx = row_lo[r] + p // w, p % w
                acc = bias.expand(n, px[r], c)
                for t, (dy, dx) in enumerate(taps):
                    ys, xs = y + dy, xx + dx
                    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
                    yc, xc = ys.clamp(0, h - 1), xs.clamp(0, w - 1)
                    owner = torch.from_numpy(row_rank)[yc]
                    v = torch.zeros((n, px[r], c))
                    for o in owner[ok].unique().tolist():
                        sel = ok & (owner == o)
                        assert written_in[(o, src)] < phase  # behind the barrier
                        if o != r:
                            remote_reads.setdefault(phase, set()).add((o, src))
                        local = (yc[sel] - row_lo[o]) * w + xc[sel]
                        v[:, sel] = smem[o][src][:, local, :c]
                    acc = acc + v * wdw[t]
                outs.append(_act(acc, kind, alpha))
            for r in range(cl):
                write(r, dst, outs[r], phase)
    assert phase == plan.n_phases and out_buf == plan.out_buf
    out = torch.cat([smem[r][out_buf][:, :px[r], :c_out] for r in range(cl)], 1)
    return out.reshape(n, h, w, c_out).to(x.dtype)


# (kind, n, h, w, cluster sizes tried): the planner's own choice, and forced
# clusters whose bands are 1-4 rows, so that dilation-4 taps reach 2-4 bands
# away, with uneven bands
EMULATED = [
    ("s23", 2, 8, 8, tchain.CLUSTER_SIZES),
    ("s23", 2, 16, 16, (8,)),
    ("s23", 1, 16, 12, (16,)),
    ("s23", 1, 14, 12, (4,)),
    ("s1", 2, 8, 8, tchain.CLUSTER_SIZES),
    ("s1", 1, 12, 12, (8,)),
    ("dil4", 2, 8, 8, (8,)),
]


@pytest.mark.parametrize("kind,n,h,w,clusters", EMULATED)
def test_banded_schedule_matches_rounding_reference(kind, n, h, w, clusters):
    x, _, _, tspec = _span(kind, n, h, w, seed=20 + h)
    plan = tchain.plan_banded(tspec, clusters)
    assert plan is not None and plan.cluster in clusters
    if clusters != tchain.CLUSTER_SIZES:
        assert plan.cluster == clusters[0]
    xb = torch.from_numpy(x).to(BF16)
    got = _emulate_banded(xb, plan)
    want = tchain.fused_chain_reference(xb, tspec, act_dtype=BF16)
    assert not torch.isnan(got.float()).any()
    # the same arithmetic in the same order: equal
    assert torch.equal(got, want)


def test_banded_plan_rejects_a_write_over_rows_still_read():
    """The emulator's barrier check fires on a plan whose depthwise output
    lands on its own source."""
    x, _, _, tspec = _span("s1", 1, 8, 8, seed=5)
    plan = tchain.plan_banded(tspec, (4,))
    ops = plan.ops().copy()
    dw = next(i for i, row in enumerate(ops) if row[0] == tchain.B_DW)
    nxt = dw + 1  # the 1x1 conv after it writes the depthwise op's source
    assert ops[nxt][0] == tchain.B_MM
    ops[nxt][9] = ops[dw][1]
    off = int(plan.table[11])
    table = plan.table.copy()
    table[off:off + ops.size] = ops.ravel()
    bad = dataclasses.replace(plan, table=table)
    with pytest.raises(AssertionError, match="overwritten"):
        _emulate_banded(torch.from_numpy(x).to(BF16), bad)


# -- packed weights -----------------------------------------------------------


@pytest.mark.parametrize("k,n", [(16, 8), (48, 16), (304, 128)])
def test_fragments_follow_the_mma_layout(k, n):
    w = np.random.default_rng(k + n).normal(0, 1, (k, n)).astype(np.float32)
    bits = tchain.pack_fragments(w)
    rounded = torch.from_numpy(w).to(BF16).float().numpy()
    np.testing.assert_array_equal(tchain.unpack_fragments(bits, k, n), rounded)
    # m16n8k16 B fragment (col-major): lane 4g + q holds B[2q + i, g],
    # B[2q + i + 8, g] for i in {0, 1}; tiles (k16, n8) k-major, 4 values a lane
    want = tchain.bf16_bits(w)
    tiles = bits.reshape(k // 16, n // 8, 32, 4)
    for kt in range(k // 16):
        for nt in range(n // 8):
            for lane in range(32):
                g, q = lane // 4, lane % 4
                ks = [2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9]
                np.testing.assert_array_equal(
                    tiles[kt, nt, lane], want[[16 * kt + kk for kk in ks], 8 * nt + g])


def test_plan_packs_the_spec_weights():
    """The first 1x1 conv and bottle3_1's merged product over [y | cur | xin]."""
    spec = _serving_spec("s23", 30)
    plan = tchain.plan_banded(spec)
    mm = [row for row in plan.ops() if row[0] == tchain.B_MM]

    def weights(row):
        k = int(sum(row[3 + 2 * s] for s in range(row[1])))
        return tchain.unpack_fragments(plan.op_params(row)[:2 * k * row[8]].view(np.uint16),
                                       k, int(row[8]))

    def rounded(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()

    np.testing.assert_array_equal(weights(mm[0]), rounded(spec.ops[1].w))
    merged = [row for row in mm if row[1] == 3]
    assert len(merged) == 1 and int(merged[0][8]) == 128
    i = next(i for i, op in enumerate(spec.ops)
             if isinstance(op, tchain.ResidualAdd) and op.proj is not None)
    res = spec.ops[i]
    np.testing.assert_array_equal(
        weights(merged[0]), rounded(np.concatenate([spec.ops[i - 1].w, res.proj.w])))
    bias = plan.op_params(merged[0])[merged[0][14]:merged[0][14] + 512].view(np.float32)
    np.testing.assert_array_equal(bias, np.float32(spec.ops[i - 1].b) + np.float32(res.proj.b))


# -- the rounding plain version against JAX and the float32 program -----------

CASES = [("s23", 2, 8, 8), ("s23", 1, 16, 16), ("s1", 2, 8, 8), ("dil4", 2, 8, 8)]


def _scaled_err(got, want) -> float:
    """max |got - want| over the limit atol 0.1 + rtol 0.1 of the reference's
    largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (0.1 + 0.1 * np.abs(want).max()))


@pytest.mark.parametrize("kind,n,h,w", CASES)
def test_rounding_reference_matches_jax_kernel_and_flax(kind, n, h, w):
    """Rounding every op's output to bf16 moves values near zero by more than
    10 % of themselves (a 1-ulp flip at |x| ~ 100 is 0.5), so the bf16 I/O
    limit (atol 0.1, rtol 0.1) is held against the output's largest
    magnitude."""
    x, want, jspec, _ = _span(kind, n, h, w, seed=n + h)
    _, _, _, tspec = _span(kind, n, h, w, seed=n + h)
    xb = torch.from_numpy(x).to(BF16)
    got = tchain.fused_chain_reference(xb, tspec, act_dtype=BF16)
    assert got.dtype == BF16 and got.shape == want.shape
    kernel = jchain.fused_chain(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jspec,
                                block_batch=2, interpret=True)
    got = got.float().numpy()
    assert _scaled_err(got, np.asarray(kernel, np.float32)) <= 1.0
    assert _scaled_err(got, want) <= 1.0


@pytest.mark.parametrize("kind,n,h,w", CASES)
def test_rounding_reference_against_float32_program(kind, n, h, w):
    """Against the float32 plain version on the same bf16 input: within 5 %
    of the output's largest magnitude and 2 % in root mean square (measured:
    at most 1.4 % and 1.04 %, at s23)."""
    x, _, _, tspec = _span(kind, n, h, w, seed=n + h)
    xb = torch.from_numpy(x).to(BF16)
    got = tchain.fused_chain_reference(xb, tspec, act_dtype=BF16).float()
    want = tchain.fused_chain_reference(xb.float(), tspec)
    err = got - want
    assert err.abs().max() <= 0.05 * want.abs().max()
    assert err.pow(2).mean().sqrt() <= 0.02 * want.pow(2).mean().sqrt()


@pytest.mark.parametrize("kind,n,h,w", CASES)
def test_rounding_spread_float32_against_float64(kind, n, h, w):
    """The spread ``chip_smoke.py`` sets its limit from: the rounding plain
    version with its sums in float32 and in float64, rounded at the same
    points.  A 1-ulp difference in a sum can flip a bf16 rounding, which the
    later ops carry on: at s23 on 16 x 16 most values differ, and the spread
    reaches 2.1 % of the output's largest magnitude (1 % in root mean
    square)."""
    x, _, _, tspec = _span(kind, n, h, w, seed=n + h)
    xb = torch.from_numpy(x).to(BF16)
    r32 = tchain.fused_chain_reference(xb, tspec, act_dtype=BF16).float()
    r64 = tchain.fused_chain_reference(xb, tspec, act_dtype=BF16,
                                       compute_dtype=torch.float64).float()
    diff = r32 - r64
    assert diff.abs().max() <= 0.05 * r64.abs().max()
    assert diff.pow(2).mean().sqrt() <= 0.02 * r64.pow(2).mean().sqrt()


# -- the wrapper's dispatch -----------------------------------------------------


def test_chain_form_by_dtype_and_shape():
    s1, s23 = _serving_spec("s1", 60), _serving_spec("s23", 30)
    assert tchain.chain_form(s1, BF16) == "banded"
    assert tchain.chain_form(s23, BF16) == "banded"
    assert tchain.chain_form(s1, torch.float32) == "simt"
    assert tchain.chain_form(s23, torch.float32) == "simt"
    # no cluster of <= 16 CTAs holds s23 at 120 x 120: the SIMT form, by shape
    big = _serving_spec("s23", 120)
    assert tchain.plan_banded(big) is None
    assert tchain.chain_form(big, BF16) == "simt"


def test_cpu_tensor_runs_the_plain_version_without_launches():
    x, _, _, tspec = _span("s1", 1, 8, 8, seed=7)
    xb = torch.from_numpy(x).to(BF16)
    before = (tchain.fused_chain.launches, dict(tchain.fused_chain.launches_by_form))
    got = tchain.fused_chain(xb, tspec)
    assert (tchain.fused_chain.launches, tchain.fused_chain.launches_by_form) == before
    assert set(before[1]) == {"banded", "simt"}
    assert got.dtype == BF16
    assert torch.equal(got, tchain.fused_chain_reference(xb, tspec))
