"""The port's training slice against the JAX package (f32, CPU): Segment in
train mode (batch-statistics BN and its running-statistics update), one
``make_train_step`` with the rotated 2level sampler from the same weights,
batch and draws, and ``make_eval_step``.

Weights are flax-initialised with random running statistics and PReLU
slopes and carried both ways with ``utils/weights.py``; the draws are
the ones the JAX pipeline makes from its key
(``test_torch_port_rotation._jax_draws``).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu.train import config as jconfig
from instancesegmentation_tpu.train import steps as jsteps
from instancesegmentation_tpu.train.state import TrainState as JaxTrainState
from instancesegmentation_tpu_torch.data import pipeline as tpipe
from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch
from instancesegmentation_tpu_torch.models import layers as tlayers
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.train import config as tconfig
from instancesegmentation_tpu_torch.train import steps as tsteps
from instancesegmentation_tpu_torch.train.state import TrainState
from instancesegmentation_tpu_torch.utils.weights import (
    jax_variables_to_torch,
    torch_to_jax_variables,
)
from test_torch_port_layers import _randomize
from test_torch_port_rotation import _jax_draws, _pipeline_batch

torch.set_num_threads(1)
SIZE = 64
#: BN running statistics after one train-mode forward.  The JAX package's
#: own eager and jitted forwards disagree on them by up to 2.8e-5 here (its
#: f32 reductions), and the port in f32 stays within 9.3e-6 of itself in
#: float64 (port_numerics.py), so 5e-5 holds the port to the reference's own
#: spread.
STATS_ATOL = 5e-5


@pytest.fixture(scope="module")
def carried():
    model = JaxSegment(in_channels=20)
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(20), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, 17)), train=False)
    return model, _randomize(dict(variables), np.random.default_rng(20))


def _port(variables) -> Segment:
    port = Segment(20)
    port.load_state_dict(jax_variables_to_torch(variables))
    return port


def _flat(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_tree_close(got, want, atol, rtol=0.0, where=None):
    """Leaf-by-leaf comparison of two flax-layout trees; ``where`` optionally
    maps a leaf path to the boolean mask of entries to compare."""
    g = _flat(got)
    assert set(g) == set(_flat(want))
    for path, leaf in _flat(want).items():
        a, e = np.asarray(g[path]), np.asarray(leaf)
        sel = np.ones(e.shape, bool) if where is None else where[path]
        np.testing.assert_allclose(a[sel], e[sel], atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("truncate_head", [False, True], ids=["logits", "features"])
def test_segment_train_mode_matches_jax(carried, truncate_head):
    model, variables = carried
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    hm = rng.random((2, SIZE, SIZE, 17)).astype(np.float32)
    want, upd = jax.jit(lambda v, a, b: model.apply(
        v, a, b, train=True, truncate_head=truncate_head, mutable=["batch_stats"]))(
            variables, img, hm)
    port = _port(variables)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(hm), train=True,
                   truncate_head=truncate_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=5e-3)
    stats = torch_to_jax_variables(port.state_dict(), variables)["batch_stats"]
    _assert_tree_close(stats, upd["batch_stats"], atol=STATS_ATOL)
    # the stats moved (momentum 0.9 towards the batch's biased statistics)
    moved = [np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree_util.tree_leaves(upd["batch_stats"]),
        jax.tree_util.tree_leaves(variables["batch_stats"]))]
    assert min(moved) > 1e-4


def _cfg(**kw):
    base = dict(canvas=96, out_size=SIZE, in_channels=20, bfloat16=False, batch_size=4,
                learning_rate=1e-3, rotate=25.0, flip_prob=0.5, jitter=0.1,
                brightness=0.2, contrast=0.2, noise_std=5.0)
    base.update(kw)
    return jconfig.TrainConfig(**base), tconfig.TrainConfig(**base)


def test_train_config_matches_jax():
    j, t = jconfig.TrainConfig(), tconfig.TrainConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    argv = ["--rotate", "25", "--bfloat16", "false", "--rotate-impl", "2pass"]
    assert dataclasses.asdict(jconfig.parse_args(argv)) == \
        dataclasses.asdict(tconfig.parse_args(argv))
    assert t.rotate_impl == "2level" and t.fused_head and t.out_hw == (480, 480)
    aug = tsteps.augment_config(t, train=False)
    assert aug.rotate == 0 and aug.flip_prob == 0 and aug.out_dtype == torch.bfloat16


def test_train_step_matches_jax(carried):
    """One f32 Adam step with the rotated 2level sampler, flips, jitter and
    photometric draws: loss, gradients, updated parameters and BN
    statistics leaf by leaf."""
    model, variables = carried
    jcfg, tcfg = _cfg()
    batch = {k: v[:2] for k, v in _pipeline_batch().items()}
    rng = jax.random.PRNGKey(3)
    aug = jsteps.augment_config(jcfg, train=True)
    draws = _jax_draws(rng, 2, aug)
    assert (draws["theta"] != 0).any() and draws["flip"].any()

    # the JAX package's train step; after one step from zero moments Adam's
    # first moment is (1 - b1) * g, which gives back its gradients
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = optax.adam(jcfg.learning_rate)
    jstate, jm = jsteps.make_train_step(model, tx, jcfg)(
        JaxTrainState.create(copy.deepcopy(variables), tx), jbatch, rng)
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1),
                                   jstate.opt_state[0].mu)

    # the port
    state = TrainState.create(_port(variables), tcfg.learning_rate)
    tpipe.warp_2level.launches = 0
    state, tm = tsteps.make_train_step(tcfg)(state, batch, draws)
    assert tpipe.warp_2level.launches == 0 and state.step == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    # the IoU binarises at 0.5: a pixel on the threshold may flip (one pixel
    # moves this batch's IoU by ~2e-5)
    np.testing.assert_allclose(float(tm["train_iou"]), float(jm["train_iou"]), atol=1e-4)

    # a dead PReLU (kept for the state-dict bijection) gets no gradient in
    # torch and zeros in JAX; Adam leaves it unchanged in both
    tgrads = {n: torch.zeros_like(p) if p.grad is None else p.grad
              for n, p in state.model.named_parameters()}
    tgrads = torch_to_jax_variables(tgrads, {"params": grads})["params"]
    # atol 1e-4 * max|g| (port_numerics.py measures the spreads): on
    # identical inputs the port is 1.7e-5 * max|g| from JAX's jitted
    # gradients and JAX's jitted and eager gradients are 1.3e-5 apart; the
    # step adds JAX's jitted preprocessing, which moves the mask targets by
    # 1.5e-5 from its eager program (the one the port repeats bit for bit)
    gmax = max(np.abs(g).max() for g in _flat(grads).values())
    for path, g in _flat(grads).items():
        np.testing.assert_allclose(_flat(tgrads)[path], g, rtol=1e-3, atol=1e-4 * gmax,
                                   err_msg=jax.tree_util.keystr(path))

    new = torch_to_jax_variables(state.model.state_dict(), variables)
    # Adam's first step is -lr * g / (|g| + eps), about -lr * sign(g): a
    # gradient within the spread above (1e-4 * max|g|) may flip its sign, so
    # only entries with |g| above twice that are held
    sel = {p: np.abs(np.asarray(g)) > 2e-4 * gmax for p, g in _flat(grads).items()}
    _assert_tree_close(new["params"], jstate.params, atol=1e-6, where=sel)
    _assert_tree_close(new["batch_stats"], jstate.batch_stats, atol=STATS_ATOL)


def _step_result(variables, tcfg, batch, draws):
    """One port train step: (loss, {name: gradient}, state dict after it)."""
    state = TrainState.create(_port(variables), tcfg.learning_rate)
    state, m = tsteps.make_train_step(tcfg)(state, batch, draws)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return float(m["loss"]), grads, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("bfloat16", [False, True], ids=["f32", "bf16"])
def test_remat_step_bit_identical(carried, bfloat16):
    """``remat`` (the forward under ``torch.utils.checkpoint``) does not
    change the math, as JAX's ``tests/test_train.py:276``: one step with and
    without it gives the same loss, gradients, updated parameters and BN
    running statistics bit for bit (the recompute updates no running
    statistic); the recompute does run (the forward's BN count doubles)."""
    _, variables = carried
    _, plain_cfg = _cfg(bfloat16=bfloat16, batch_size=2)
    _, remat_cfg = _cfg(bfloat16=bfloat16, batch_size=2, remat=True)
    batch = {k: v[:2] for k, v in _pipeline_batch().items()}
    draws = tpipe.draw_augment(2, tsteps.augment_config(plain_cfg, True),
                               torch.Generator().manual_seed(3))
    calls = []
    bn_train = tlayers._bn_train
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlayers, "_bn_train", lambda *a: calls.append(1) or bn_train(*a))
        l0, g0, s0 = _step_result(variables, plain_cfg, batch, draws)
        assert len(calls) == 74
        l1, g1, s1 = _step_result(variables, remat_cfg, batch, draws)
        assert len(calls) == 74 + 2 * 74
    assert l0 == l1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert not torch.equal(s0["bottle1_1.convs.0.bn.running_mean"],
                           jax_variables_to_torch(variables)["bottle1_1.convs.0.bn.running_mean"])


def test_eval_step_matches_jax(carried):
    model, variables = carried
    jcfg, tcfg = _cfg()
    batch = synthetic_host_batch(4, 96, seed=9)
    _, _, jmasks, jious = jsteps.make_eval_step(model, jcfg)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    images, probs, masks, ious = tsteps.make_eval_step(tcfg)(_port(variables), batch)
    assert images.shape == (4, SIZE, SIZE, 3) and probs.shape == (4, SIZE, SIZE, 1)
    np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks), atol=1e-5)
    assert ious.shape == (4,)
    np.testing.assert_allclose(ious.numpy(), np.asarray(jious), atol=1e-6)


def test_mask_iou_and_bce():
    rng = np.random.default_rng(4)
    probs = rng.random((3, 8, 8, 1)).astype(np.float32)
    targets = (rng.random((3, 8, 8, 1)) > 0.5).astype(np.float32)
    probs[2], targets[2] = 0.1, 0.0              # empty vs empty counts as 1
    got = tsteps.per_sample_mask_iou(torch.from_numpy(probs), torch.from_numpy(targets))
    want = jsteps.per_sample_mask_iou(jnp.asarray(probs), jnp.asarray(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    assert float(got[2]) == 1.0
    logits = rng.normal(0, 3, (3, 8, 8, 1)).astype(np.float32)
    np.testing.assert_allclose(
        float(tsteps.bce_loss(torch.from_numpy(logits), torch.from_numpy(targets))),
        float(jsteps.bce_loss(jnp.asarray(logits), jnp.asarray(targets))), rtol=1e-6)
