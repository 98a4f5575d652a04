"""The port's bottleneck-chain op against the JAX Pallas kernel (interpret
mode) and the flax spans (f32, CPU).

The CUDA kernel cannot run here; its check against the plain version is a
phase of ``chip_smoke.py``.  What does run here: the plain version
(``fused_chain_reference``) against JAX, the CPU route of the wrappers, and
the instruction table the kernel walks (``compile_chain``), executed by an
emulator below that follows the kernel's indexing (slot bases, weight and
tap offsets, float32 scratch poisoned with NaN).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from instancesegmentation_tpu.models.export import fold_batchnorm as jax_fold
from instancesegmentation_tpu.models.layers import (
    Bottleneck3x3,
    Bottleneck5x5,
    BottleneckDimRes,
)
from instancesegmentation_tpu.ops.fused_block import (
    bottleneck3x3_reference as jax_block_reference,
)
from instancesegmentation_tpu.ops import fused_chain as jchain
from instancesegmentation_tpu_torch.models.export import fold_batchnorm
from instancesegmentation_tpu_torch.ops import fused_chain as tchain
from instancesegmentation_tpu_torch.ops.fused_block import (
    bottleneck3x3_fused,
    bottleneck3x3_reference,
)
from instancesegmentation_tpu_torch.utils.weights import jax_variables_to_torch

torch.set_num_threads(1)


class _S23Span(nn.Module):
    """Sections 2+3 of Segment after bottle2_1."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        y = Bottleneck3x3(48, name="bottle2_x_0")(x, train)
        y = Bottleneck3x3(48, dilation=2, name="bottle2_x_1")(y, train)
        y = Bottleneck3x3(48, name="bottle2_x_2")(y, train)
        y = Bottleneck3x3(48, dilation=4, name="bottle2_x_3")(y, train)
        b2_8 = Bottleneck5x5(48, name="bottle2_x_4")(y, train)
        y = BottleneckDimRes(48, 128, use_prelu=True, name="bottle3_1")(
            jnp.concatenate([b2_8, x], axis=-1), train)
        y = Bottleneck3x3(48, name="bottle3_x_0")(y, train)
        y = Bottleneck3x3(48, dilation=2, name="bottle3_x_1")(y, train)
        y = Bottleneck3x3(48, name="bottle3_x_2")(y, train)
        y = Bottleneck3x3(48, dilation=4, name="bottle3_x_3")(y, train)
        return Bottleneck5x5(48, name="bottle3_x_4")(y, train)


class _S1Span(nn.Module):
    """Section 1 body after bottle1_1."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        for i in range(4):
            x = Bottleneck3x3(16, name=f"bottle1_x_{i}")(x, train)
        return x


class _Dil4(nn.Module):
    """One dilation-4 Bottleneck3x3 named as Segment's bottle1_x_0."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        return Bottleneck3x3(16, dilation=4, name="bottle1_x_0")(x, train)


def _randomize(variables, rng):
    def f(path, v):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("mean"):
            return jnp.asarray(rng.normal(0, 0.3, v.shape), jnp.float32)
        if name.endswith("var"):
            return jnp.asarray(rng.uniform(0.5, 2.0, v.shape), jnp.float32)
        if name.endswith("alpha"):
            return jnp.asarray(rng.uniform(0.05, 0.45, v.shape), jnp.float32)
        return v

    return jax.tree_util.tree_map_with_path(f, variables)


def _span(kind, n, h, w, seed):
    """(x, flax span output, JAX chain spec, port chain spec) from one set
    of flax variables, BN-folded on each side."""
    model, c = {"s23": (_S23Span(), 128), "s1": (_S1Span(), 48),
                "dil4": (_Dil4(), 48)}[kind]
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(0, 1, (n, h, w, c)), jnp.float32)
    variables = _randomize(model.init(jax.random.PRNGKey(seed), x), rng)
    want = np.asarray(model.apply(variables, x, train=False))
    jfolded = jax_fold(variables)["params"]
    sd = fold_batchnorm(jax_variables_to_torch(
        jax.tree_util.tree_map(np.asarray, variables)))
    if kind == "s23":
        jspec = jchain.extract_s23_chain(jfolded, h, w)
        tspec = tchain.extract_s23_chain(sd, h, w)
    elif kind == "s1":
        jspec = jchain.extract_s1_chain(jfolded, h, w)
        tspec = tchain.extract_s1_chain(sd, h, w)
    else:
        ops = jchain.extract_bottleneck3x3(jfolded["bottle1_x_0"], dilation=4)
        jspec = jchain.ChainSpec(h=h, w=w, c_in=48, c_out=48, ops=ops)
        ops = tchain.extract_bottleneck3x3(sd, "bottle1_x.0", dilation=4)
        tspec = tchain.ChainSpec(h=h, w=w, c_in=48, c_out=48, ops=ops)
    return np.array(x), want, jspec, tspec


CASES = [("s23", 2, 8, 8), ("s23", 3, 4, 4), ("s1", 2, 8, 8), ("dil4", 2, 8, 8)]


@pytest.mark.parametrize("kind,n,h,w", CASES)
def test_chain_reference_matches_jax_kernel_and_flax(kind, n, h, w):
    x, want, jspec, tspec = _span(kind, n, h, w, seed=n + h)
    kernel = np.asarray(jchain.fused_chain(jnp.asarray(x), jspec, block_batch=2,
                                           interpret=True))
    before = tchain.fused_chain.launches
    got = tchain.fused_chain(torch.from_numpy(x), tspec).numpy()
    assert tchain.fused_chain.launches == before  # CPU: plain version
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, kernel, atol=2e-4)


def test_chain_bf16_io():
    x, want, _, tspec = _span("s1", 1, 8, 8, seed=3)
    got = tchain.fused_chain(torch.from_numpy(x).bfloat16(), tspec)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.1, rtol=0.1)


def test_chain_wrapper_rejects_bad_inputs():
    x, _, _, tspec = _span("s1", 1, 8, 8, seed=4)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError):
        tchain.fused_chain(t[:, :4], tspec)
    with pytest.raises(TypeError):
        tchain.fused_chain(t.half(), tspec)
    with pytest.raises(ValueError):
        tchain.fused_chain(t.transpose(1, 2), tspec)


def test_bottleneck3x3_fused_matches_jax_reference():
    rng = np.random.default_rng(6)
    c, p = 48, 16
    arrs = dict(
        x=rng.normal(0, 1, (2, 8, 8, c)), w1=rng.normal(0, 0.2, (c, p)),
        b1=rng.normal(0, 0.1, p), a1=rng.uniform(0.05, 0.45, p),
        dw=rng.normal(0, 0.3, (3, 3, p)), b_dw=rng.normal(0, 0.1, p),
        a2=rng.uniform(0.05, 0.45, p), w2=rng.normal(0, 0.2, (p, c)),
        b2=rng.normal(0, 0.1, c), a_out=rng.uniform(0.05, 0.45, c))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    want = np.asarray(jax_block_reference(**{k: jnp.asarray(v) for k, v in arrs.items()}))
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    before = bottleneck3x3_fused.launches
    got = bottleneck3x3_fused(**t)
    assert bottleneck3x3_fused.launches == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    np.testing.assert_allclose(bottleneck3x3_reference(**t).numpy(), want, atol=2e-4)


# -- the instruction table the CUDA kernel walks ------------------------------


def _emulate(x: torch.Tensor, prog: tchain.ChainProgram, h: int, w: int):
    """Execute ``prog`` the way csrc/fused_chain.cu does: per image, NaN-
    poisoned float32 scratch slots at ``base * H*W``, [pixel, channel] rows."""
    n, hw = x.shape[0], h * w
    tab = prog.table
    wts = torch.from_numpy(prog.weights)
    rows = tab[:prog.n_instr * tchain.ROW].reshape(prog.n_instr, tchain.ROW)
    slot_ids = {int(r[i]) for r in rows for i in (1, 2, 9) if r[i] >= 0}
    bases = [int(b) for b in tab[prog.slots_off:prog.slots_off + max(slot_ids) + 1]]
    ends = bases[1:] + [prog.per_pixel]
    scratch = torch.full((n, prog.per_pixel * hw), float("nan"))

    def slot(s, c):
        assert c <= ends[s] - bases[s], "value wider than its slot"
        return scratch[:, bases[s] * hw:bases[s] * hw + hw * c].view(n, hw, c)

    def act(v, kind, a_off):
        if kind == tchain.ACT_PRELU:
            a = wts[a_off:a_off + v.shape[-1]]
            return torch.where(v >= 0, v, a * v)
        return torch.clamp_min(v, 0.0) if kind == tchain.ACT_RELU else v

    out = None
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    for r in rows.tolist():
        op, src, dst, ci, co, w_off, b_off, kind, a_off, add, ntaps, t_off = r
        if op == tchain.OP_LOAD:
            slot(dst, co)[:] = x.reshape(n, hw, co).float()
        elif op == tchain.OP_STORE:
            out = slot(src, ci).reshape(n, h, w, ci).to(x.dtype)
        elif op == tchain.OP_MATMUL:
            assert dst not in (src, add)
            v = slot(src, ci) @ wts[w_off:w_off + ci * co].view(ci, co)
            v = v + wts[b_off:b_off + co]
            if add >= 0:
                v = v + slot(add, co)
            slot(dst, co)[:] = act(v, kind, a_off)
        elif op == tchain.OP_DW:
            assert dst != src
            src_img = slot(src, ci).view(n, h, w, ci)
            acc = wts[b_off:b_off + ci].expand(n, h, w, ci).clone()
            taps = tab[t_off:t_off + 2 * ntaps].reshape(ntaps, 2)
            for t, (dy, dx) in enumerate(taps.tolist()):
                ys, xs = yy + dy, xx + dx
                ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
                v = src_img[:, ys.clamp(0, h - 1), xs.clamp(0, w - 1)]
                acc = acc + torch.where(ok[None, :, :, None], v, 0.0) * wts[
                    w_off + t * ci:w_off + (t + 1) * ci]
            slot(dst, ci)[:] = act(acc, kind, a_off).view(n, hw, ci)
        elif op == tchain.OP_CONCAT:
            assert dst not in (src, add)
            slot(dst, co)[:] = torch.cat([slot(src, ci), slot(add, co - ci)], dim=-1)
        else:
            raise AssertionError(op)
    return out


@pytest.mark.parametrize("kind,n,h,w", CASES)
def test_compiled_program_matches_reference(kind, n, h, w):
    x, _, _, tspec = _span(kind, n, h, w, seed=10 + n)
    prog = tchain.compile_chain(tspec)
    assert prog.weights.size % 4 == 0 and prog.per_pixel % 4 == 0
    got = _emulate(torch.from_numpy(x), prog, h, w)
    want = tchain.fused_chain_reference(torch.from_numpy(x), tspec)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
