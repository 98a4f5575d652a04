"""The port's Segment, weight carrying, BN fold and folded head against the
JAX package (f32, CPU).

Weights are flax-initialised, given random running stats and PReLU slopes
(so folding and per-channel indexing matter), and carried into the port
with ``utils/weights.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.models.export import fold_batchnorm as jax_fold
from instancesegmentation_tpu.models.fused_head import fold_head as jax_fold_head
from instancesegmentation_tpu.models.fused_head import head_apply as jax_head_apply
from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu_torch.models.export import fold_batchnorm
from instancesegmentation_tpu_torch.models.fused_head import fold_head, head_apply
from instancesegmentation_tpu_torch.models.segment import Segment, count_params
from instancesegmentation_tpu_torch.utils.weights import (
    jax_variables_to_torch,
    torch_to_jax_variables,
)

torch.set_num_threads(1)
SIZE = 64


def _randomize(variables, rng):
    """Random BN running stats and PReLU slopes."""

    def f(path, v):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("mean"):
            return jnp.asarray(rng.normal(0, 0.3, v.shape), jnp.float32)
        if name.endswith("var"):
            return jnp.asarray(rng.uniform(0.5, 2.0, v.shape), jnp.float32)
        if name.endswith("alpha"):
            return jnp.asarray(rng.uniform(0.05, 0.45, v.shape), jnp.float32)
        return v

    out = jax.tree_util.tree_map_with_path(f, variables)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=[3, 20])
def carried(request):
    c = request.param
    model = JaxSegment(in_channels=c)
    args = [jnp.zeros((1, SIZE, SIZE, 3))]
    if c > 3:
        args.append(jnp.zeros((1, SIZE, SIZE, c - 3)))
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(c), *args, train=False)
    variables = _randomize(dict(variables), np.random.default_rng(c))
    port = Segment(c).eval()
    port.load_state_dict(jax_variables_to_torch(variables))
    return c, model, variables, port


def _inputs(c, n=2, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
    hm = rng.random((n, SIZE, SIZE, c - 3)).astype(np.float32) if c > 3 else None
    return img, hm


def _jax_apply(model, variables, img, hm, **kw):
    args = (img,) if hm is None else (img, hm)
    return np.asarray(model.apply(variables, *args, train=False, **kw))


def _port_apply(port, img, hm, **kw):
    with torch.no_grad():
        t_hm = None if hm is None else torch.from_numpy(hm)
        return port(torch.from_numpy(img), t_hm, **kw).numpy()


def test_weight_carry_round_trip_bit_equal(carried):
    c, _, variables, port = carried
    assert count_params(port) == {3: 257_145, 20: 266_121}[c]
    back = torch_to_jax_variables(port.state_dict(), variables)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], leaf)


def test_segment_eval_forward_matches_jax(carried):
    c, model, variables, port = carried
    img, hm = _inputs(c)
    want = _jax_apply(model, variables, img, hm)
    got = _port_apply(port, img, hm)
    assert got.shape == want.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=5e-3)


def test_fold_batchnorm_matches_jax(carried):
    c, model, variables, port = carried
    sd = {k: v for k, v in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    folded = fold_batchnorm(sd)
    want = jax.tree_util.tree_map(np.asarray, jax_fold(variables))
    got = torch_to_jax_variables(folded, variables)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(
            dict(jax.tree_util.tree_leaves_with_path(got))[path], leaf,
            rtol=1e-5, atol=1e-5, err_msg=str(path))

    img, hm = _inputs(c, seed=1)
    unfolded = _port_apply(port, img, hm)
    port_f = Segment(c).eval()
    port_f.load_state_dict(folded)
    np.testing.assert_allclose(_port_apply(port_f, img, hm), unfolded,
                               atol=2e-3, rtol=5e-3)


def test_fold_head_and_head_apply_match_jax(carried):
    c, _, variables, port = carried
    sd = port.state_dict()
    head = fold_head(sd)
    jhead = jax_fold_head(variables["params"])
    np.testing.assert_allclose(
        head.phase_kernel.permute(2, 3, 1, 0).numpy(),
        np.asarray(jhead.phase_kernel), atol=1e-5)
    np.testing.assert_allclose(float(head.bias), float(jhead.bias), atol=1e-5)

    rng = np.random.default_rng(5)
    feats = rng.normal(0, 1, (2, 6, 5, 16)).astype(np.float32)
    want = np.asarray(jax_head_apply(jnp.asarray(feats), jhead))
    got = head_apply(torch.from_numpy(feats), head.to("cpu")).numpy()
    assert got.shape == want.shape == (2, 24, 20, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the ring: the unfused head on the same features
    with torch.no_grad():
        x = torch.from_numpy(feats).permute(0, 3, 1, 2)
        exact = port.bottle6_2(port.bottle6_1(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, exact, atol=1e-4)


def test_truncated_features_match_jax(carried):
    c, model, variables, port = carried
    img, hm = _inputs(c, n=1, seed=2)
    want = _jax_apply(model, variables, img, hm, truncate_head=True)
    got = _port_apply(port, img, hm, truncate_head=True)
    assert got.shape == want.shape == (1, SIZE // 4, SIZE // 4, 16)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=5e-3)
