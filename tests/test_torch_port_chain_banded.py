"""The banded forms of the chain kernel (bf16 and float32), on the CPU.

The cluster kernels (``csrc/fused_chain.cu:fused_chain_banded_kernel`` and
``fused_chain_banded_f32_kernel``) cannot run here; ``chip_smoke.py`` holds
them against their plain versions on the card.  What runs here:

* the band plans (``plan_banded``) at every serving shape, in both element
  types: bands, shared memory, cluster size, the owner of every row a
  depthwise tap reads;
* an emulator of the banded schedule that walks the plan's table and packed
  parameters CTA by CTA over NaN-poisoned shared-memory buffers, reads other
  bands only through the plan's row -> rank table, and checks each such read
  against the cluster barriers (after the barrier that follows the write,
  never overwritten before the next one); in bf16 it must equal the rounding
  plain version, in float32 (products in K-chunks, partial sums in the
  output buffer) the float32 plain version within float32 rounding;
* the bf16 weight fragments against the ``mma.m16n8k16`` B-fragment layout;
* the rounding plain version (``fused_chain_reference(...,
  act_dtype=torch.bfloat16)``) against the JAX kernel in interpret mode, the
  flax spans and the float32 plain version;
* the wrapper's dispatch on the CPU, and ``bottleneck3x3_fused``'s route.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.ops import fused_chain as jchain
from instancesegmentation_tpu.ops.fused_block import (
    bottleneck3x3_reference as jax_block_reference,
)
from instancesegmentation_tpu_torch.models.export import fold_batchnorm
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.ops import fused_block as tblock
from instancesegmentation_tpu_torch.ops import fused_chain as tchain
from test_torch_port_chain import _span

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32


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


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,s", SERVING)
def test_band_plan_at_serving_shapes(kind, s, dtype):
    spec = _serving_spec(kind, s)
    plan = tchain.plan_banded(spec, dtype=dtype)
    if plan is None:  # float32 s23 at 40 x 40: no cluster of <= 16 holds it
        assert (dtype, kind, s) == (F32, "s23", 40)
        return
    assert plan.elt == (2 if dtype == BF16 else 4)
    h, w, cl = spec.h, spec.w, plan.cluster
    # the smallest cluster that fits; above 8 only with the non-portable attribute
    assert cl in tchain.CLUSTER_SIZES and plan.nonportable == (cl > 8)
    assert all(tchain.plan_banded(spec, (c,), dtype) is None
               for c in tchain.CLUSTER_SIZES if c < cl)
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
    regions += [(o, o + plan.elt * plan.band_px * s_)
                for o, s_ in zip(plan.buf_offsets, plan.strides)]
    regions += list(zip(plan.slot_offsets, (o + b for o, b in zip(plan.slot_offsets,
                                                                 plan.slot_bytes))))
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
    assert regions[-1][1] <= plan.smem_bytes
    assert all(o % 128 == 0 for o, _ in regions)
    # buffer rows: an odd number of 16-byte units, at least the widest value
    per = 16 // plan.elt
    assert all(s_ >= c and s_ % per == 0 and (s_ // per) % 2 == 1
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
    """The cluster sizes the serving programs launch with, in bf16 and in
    float32 (float32 rows take twice the bytes: twice the CTAs)."""
    got = {(k, s): tchain.plan_banded(_serving_spec(k, s)).cluster for k, s in SERVING}
    assert got == {("s1", 60): 4, ("s1", 64): 4, ("s1", 80): 8,
                   ("s23", 30): 8, ("s23", 32): 8, ("s23", 40): 16}
    plans = {(k, s): tchain.plan_banded(_serving_spec(k, s), dtype=F32) for k, s in SERVING}
    got = {key: p and p.cluster for key, p in plans.items()}
    assert got == {("s1", 60): 8, ("s1", 64): 8, ("s1", 80): 16,
                   ("s23", 30): 16, ("s23", 32): 16, ("s23", 40): None}
    # the 480 px program's: shared memory within 227 KB, the products of s23
    # over 256 and 304 channels in K-chunks of at most CHUNK_BYTES of weights
    for key in (("s1", 60), ("s23", 30)):
        assert plans[key].smem_bytes <= tchain.SMEM_LIMIT
        assert max(plans[key].slot_bytes) <= tchain.CHUNK_BYTES + 1024
    mm = [row for row in plans[("s23", 30)].ops() if row[0] == tchain.B_MM]
    assert sum(row[20] != tchain.MM_FIRST | tchain.MM_LAST for row in mm) == 7
    # rows x columns a thread takes: large tiles on s1's 480 px bands and
    # s23's 128-wide products, more warps on s23's 48-wide ones (60 px bands)
    tiles = {(k, int(row[8])): (int(row[19]), int(row[21]))
             for k in (("s1", 60), ("s23", 30)) for row in plans[k].ops() if row[0] == tchain.B_MM}
    assert tiles == {(("s1", 60), 16): (4, 8), (("s1", 60), 48): (4, 8),
                     (("s23", 30), 48): (2, 4), (("s23", 30), 128): (4, 8)}


# -- the banded schedule, emulated ----------------------------------------------


def _act(v, kind, alpha):
    if kind == tchain.ACT_PRELU:
        return torch.where(v >= 0, v, alpha * v)
    return torch.clamp_min(v, 0.0) if kind == tchain.ACT_RELU else v


def _f32(blk, at, n):
    return torch.from_numpy(blk[at:at + 4 * n].view(np.float32).copy())


def _emulate_banded(x: torch.Tensor, plan: tchain.BandPlan) -> torch.Tensor:
    """Run ``plan`` the way the banded kernel does: per CTA (rank), buffers
    of ``band_px`` rows poisoned with NaN, holding bf16 or float32 values
    (``plan.elt``); in bf16, 1x1 convs over K-segments with packed
    fragments; in float32, one K-chunk per row, from zero or from the
    partial sums in the output buffer, the last adding bias and residual
    and applying the activation; depthwise taps reading the owner's rows
    through the plan's row tables.  Phases are the stretches between the
    cluster barriers, one before each depthwise op; every read of another
    CTA's rows is checked against them."""
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

    f32 = plan.elt == 4

    def write(r, b, v, phase):
        assert (r, b) not in remote_reads.get(phase, set()), (
            f"buffer {b} of rank {r} is overwritten in phase {phase}, while another "
            "CTA may still read it")
        assert v.shape[-1] <= strides[b]
        smem[r][b][:, :px[r], :v.shape[-1]] = v if f32 else v.to(BF16).float()
        written_in[(r, b)] = phase

    phase = 0
    for k, row in enumerate(plan.ops().tolist()):
        blk = plan.op_params(row)
        assert row[13] == k % 2 and blk.size == 16 * row[12] <= plan.slot_bytes[row[13]]
        if row[0] == tchain.B_MM and f32:
            assert row[18] == phase and row[1] == 1 and (row[19], row[21]) in tchain.F32_TILES
            src, kc, k_off, n_out, dst, add, kind = (row[2], row[3], row[17], row[8],
                                                     row[9], row[10], row[15])
            first, last = row[20] & tchain.MM_FIRST, row[20] & tchain.MM_LAST
            assert dst != src and k_off % 4 == 0 and kc % 4 == 0
            assert blk.size >= 4 * kc * n_out
            wt = torch.from_numpy(blk[:4 * kc * n_out].view(np.float32).reshape(kc, n_out).copy())
            bias = _f32(blk, row[14], n_out) if last else None
            alpha = _f32(blk, row[16], n_out) if last and kind == tchain.ACT_PRELU else None
            assert last or (add < 0 and kind == tchain.ACT_NONE)
            outs = []
            for r in range(cl):
                a = smem[r][src][:, :px[r], k_off:k_off + kc]
                acc = a @ wt
                if not first:
                    acc = smem[r][dst][:, :px[r], :n_out] + acc
                if last:
                    acc = acc + bias
                    if add >= 0:
                        acc = acc + smem[r][add][:, :px[r], :n_out]
                    acc = _act(acc, kind, alpha)
                outs.append(acc)
            for r in range(cl):
                write(r, dst, outs[r], phase)
        elif row[0] == tchain.B_MM:
            assert row[18] == phase and row[20] == tchain.MM_FIRST | tchain.MM_LAST
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


# float32: the planner's own choice, forced clusters of 1-4 row bands, and
# weight chunks forced down to 4-16 rows of K, so that in-place residuals
# give way to chunked products into other buffers
EMULATED_F32 = [
    ("s23", 2, 8, 8, tchain.CLUSTER_SIZES, tchain.CHUNK_BYTES),
    ("s23", 1, 16, 12, (16,), tchain.CHUNK_BYTES),
    ("s23", 1, 14, 12, (4,), 2048),
    ("s1", 2, 8, 8, tchain.CLUSTER_SIZES, 256),
    ("s1", 1, 12, 12, (8,), tchain.CHUNK_BYTES),
    ("dil4", 2, 8, 8, (8,), 1024),
]


@pytest.mark.parametrize("kind,n,h,w,clusters,chunk", EMULATED_F32)
def test_banded_f32_schedule_matches_float32_reference(kind, n, h, w, clusters, chunk):
    """The float32 schedule against the float32 plain version (which the
    chain tests hold to the JAX kernel in interpret mode): the same float32
    program, summed in another order (K in chunks), within 1e-5 of the
    output's largest magnitude."""
    x, _, _, tspec = _span(kind, n, h, w, seed=40 + h)
    plan = tchain.plan_banded(tspec, clusters, F32, chunk)
    assert plan is not None and plan.elt == 4 and plan.cluster in clusters
    if clusters != tchain.CLUSTER_SIZES:
        assert plan.cluster == clusters[0]
    mm = [row for row in plan.ops() if row[0] == tchain.B_MM]
    if chunk < tchain.CHUNK_BYTES:
        assert any(row[20] != tchain.MM_FIRST | tchain.MM_LAST for row in mm)
    xf = torch.from_numpy(x)
    got = _emulate_banded(xf, plan)
    want = tchain.fused_chain_reference(xf, tspec)
    assert got.dtype == F32 and not torch.isnan(got).any()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


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
    assert tchain.chain_form(s1, F32) == "banded_f32"
    assert tchain.chain_form(s23, F32) == "banded_f32"
    # no cluster of <= 16 CTAs holds s23 at 120 x 120 (nor at 40 x 40 in
    # float32): the SIMT form, by shape
    big = _serving_spec("s23", 120)
    assert tchain.plan_banded(big) is None
    assert tchain.chain_form(big, BF16) == "simt"
    assert tchain.chain_form(big, F32) == "simt"
    assert tchain.chain_form(_serving_spec("s23", 40), F32) == "simt"


def test_cpu_tensor_runs_the_plain_version_without_launches():
    x, _, _, tspec = _span("s1", 1, 8, 8, seed=7)
    xb = torch.from_numpy(x).to(BF16)
    before = (tchain.fused_chain.launches, dict(tchain.fused_chain.launches_by_form))
    got = tchain.fused_chain(xb, tspec)
    assert (tchain.fused_chain.launches, tchain.fused_chain.launches_by_form) == before
    assert set(before[1]) == {"banded", "banded_f32", "simt"}
    assert got.dtype == BF16
    assert torch.equal(got, tchain.fused_chain_reference(xb, tspec))


# -- bottleneck3x3_fused through the float32 banded form ------------------------


def _block_args(seed, c=48, p=16):
    rng = np.random.default_rng(seed)
    arrs = dict(
        w1=rng.normal(0, 0.2, (c, p)), b1=rng.normal(0, 0.1, p),
        a1=rng.uniform(0.05, 0.45, p), dw=rng.normal(0, 0.3, (3, 3, p)),
        b_dw=rng.normal(0, 0.1, p), a2=rng.uniform(0.05, 0.45, p),
        w2=rng.normal(0, 0.2, (p, c)), b2=rng.normal(0, 0.1, c),
        a_out=rng.uniform(0.05, 0.45, c))
    return rng, {k: v.astype(np.float32) for k, v in arrs.items()}


@pytest.mark.parametrize("h,w,clusters", [(60, 60, tchain.CLUSTER_SIZES), (9, 8, (4,))])
def test_bottleneck3x3_fused_route(h, w, clusters):
    """Its spec is built once per set of weight tensors and runs on the
    float32 banded form (cluster 8 at the serving [*, 60, 60, 48]); that
    form's schedule, emulated, agrees with the JAX reference."""
    rng, arrs = _block_args(h)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    x = torch.from_numpy(rng.normal(0, 1, (1, h, w, 48)).astype(np.float32))
    weights = tuple(t[k] for k in ("w1", "b1", "a1", "dw", "b_dw", "a2", "w2", "b2", "a_out"))
    spec = tblock._cached_spec(x, weights)
    assert tblock._cached_spec(x, weights) is spec  # the same tensors: cached
    assert tblock._cached_spec(x, tuple(v.clone() for v in weights)) is not spec
    assert tchain.chain_form(spec, F32) == "banded_f32"
    if h == 60:
        assert tchain.plan_banded(spec, dtype=F32).cluster == 8
        return
    before = (tblock.bottleneck3x3_fused.launches,
              dict(tblock.bottleneck3x3_fused.launches_by_form))
    got = tblock.bottleneck3x3_fused(x, **t)  # CPU: the plain version
    assert (tblock.bottleneck3x3_fused.launches,
            tblock.bottleneck3x3_fused.launches_by_form) == before
    want = np.asarray(jax_block_reference(jnp.asarray(x.numpy()),
                                          **{k: jnp.asarray(v) for k, v in arrs.items()}))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    emulated = _emulate_banded(x, tchain.plan_banded(spec, clusters, F32, 512))
    np.testing.assert_allclose(emulated.numpy(), want, atol=2e-4)
