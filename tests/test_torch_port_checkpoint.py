"""The port's checkpoints against the JAX package's (CPU): the msgpack codec
against flax's, ISEG files written by either package and read by the other
(step, params, BN statistics, Adam ``count`` / ``mu`` / ``nu`` and the meta
bit-equal, the payload byte-equal), one Adam step from a state reloaded on
each side, and ``load_any_checkpoint`` on every layout it accepts.
"""
import copy

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch

from instancesegmentation_tpu.infer.pipeline import load_any_checkpoint as jax_load_any
from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu.train import checkpoint as jckpt
from instancesegmentation_tpu.train import config as jconfig
from instancesegmentation_tpu.train import steps as jsteps
from instancesegmentation_tpu.train.state import TrainState as JaxTrainState
from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch
from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine, load_any_checkpoint
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.train import checkpoint as tckpt
from instancesegmentation_tpu_torch.train import config as tconfig
from instancesegmentation_tpu_torch.train import steps as tsteps
from instancesegmentation_tpu_torch.train.state import TrainState, from_state_tree, to_state_tree
from instancesegmentation_tpu_torch.utils import msgpack as mp
from instancesegmentation_tpu_torch.utils.weights import jax_variables_to_torch
from test_torch_port_layers import _randomize

torch.set_num_threads(1)
SIZE = 64
META = {"branch_name": "feature/x", "best": 0.8125, "epoch": 3}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_bit_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for k, v in w.items():
        assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
        np.testing.assert_array_equal(g[k], v, err_msg=k)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainState at step 7 with random weights, BN statistics and
    PReLU slopes and random Adam moments (count 7)."""
    model = JaxSegment(in_channels=20)
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(8), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, 17)), train=False)
    variables = _randomize(dict(variables), np.random.default_rng(8))
    tx = optax.adam(1e-3)
    state = JaxTrainState.create(variables, tx)
    rng = np.random.default_rng(9)
    adam = state.opt_state[0]
    adam = adam._replace(
        count=jnp.asarray(7, jnp.int32),
        mu=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.normal(0, 1e-3, p.shape), jnp.float32), adam.mu),
        nu=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.uniform(1e-8, 1e-6, p.shape), jnp.float32), adam.nu))
    return model, tx, state.replace(step=jnp.asarray(7, jnp.int32),
                                    opt_state=(adam,) + tuple(state.opt_state[1:]))


def _port_state(lr=1e-3) -> TrainState:
    return TrainState.create(Segment(20), lr)


# ---------------------------------------------------------------------------
# the msgpack codec
# ---------------------------------------------------------------------------

CODEC_VALUES = {
    "scalars": {"n": None, "t": True, "f": False, "ints": [0, 127, 128, 255, 256, 65536,
                2 ** 32, 2 ** 63 - 1, -1, -32, -33, -128, -129, -2 ** 31, -2 ** 63],
                "floats": [0.0, -1.5, 1e300], "s": "x" * 31, "s2": "y" * 300,
                "bin": b"\x00" * 70000},
    "nested": {"a": {"b": {"c": {}}, "d": list(range(20))}, "e": {str(i): i for i in range(20)}},
    "arrays": {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
               "i32_0d": np.asarray(7, np.int32), "f64_0d": np.asarray(2.5),
               "u8": np.arange(256, dtype=np.uint8).reshape(16, 16),
               "empty": np.zeros((0, 3), np.int64), "bool": np.array([True, False]),
               "one_byte": np.zeros((1,), np.int8)},
}


@pytest.mark.parametrize("name", list(CODEC_VALUES))
def test_msgpack_codec_matches_flax(name):
    value = CODEC_VALUES[name]
    ref = fs.msgpack_serialize(copy.deepcopy(value), in_place=True)
    assert mp.packb(value) == ref
    back = mp.unpackb(ref)
    assert back.keys() == value.keys()
    if name == "arrays":
        _assert_bit_equal(back, value)
    else:
        assert back == msgpack.unpackb(ref, raw=False, strict_map_key=False)


def test_msgpack_bfloat16():
    arr = jnp.asarray(np.random.default_rng(1).normal(size=(3, 5)), jnp.bfloat16)
    ref = fs.msgpack_serialize({"w": np.asarray(arr), "z": np.asarray(arr[0, 0])}, in_place=True)
    t = torch.from_numpy(np.asarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    assert mp.packb({"w": t, "z": t[0, 0]}) == ref
    back = mp.unpackb(ref)
    assert back["w"].dtype == torch.bfloat16 and tuple(back["z"].shape) == ()
    assert torch.equal(back["w"].view(torch.int16), t.view(torch.int16))
    restored = fs.msgpack_restore(mp.packb({"w": t}))["w"]
    np.testing.assert_array_equal(restored.view(np.uint16), np.asarray(arr).view(np.uint16))


def test_msgpack_refuses(monkeypatch):
    with pytest.raises(TypeError, match="keys must be str"):
        mp.packb({1: 2})
    with pytest.raises(TypeError, match="cannot pack"):
        mp.packb({"x": object()})
    with pytest.raises(ValueError, match="trailing"):
        mp.unpackb(mp.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        mp.unpackb(mp.packb("abcdef")[:-2])
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 16)
    with pytest.raises(ValueError, match="chunked"):
        mp.packb(np.zeros(5, np.float32))


# ---------------------------------------------------------------------------
# ISEG files in both directions
# ---------------------------------------------------------------------------

def test_jax_checkpoint_loads_in_the_port(jax_state, tmp_path):
    _, _, state = jax_state
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, state, META)
    tree, meta = tckpt.load_checkpoint(path)
    assert meta == META and tckpt.read_meta(path) == META
    port = from_state_tree(tree, _port_state())
    assert port.step == 7
    assert {float(s["step"]) for s in port.optimizer.state.values()} == {7.0}
    back = to_state_tree(port)
    _assert_bit_equal(back, fs.to_state_dict(state))
    # the port writes the same payload, byte for byte
    assert mp.packb(back) == fs.to_bytes(state)


def test_port_checkpoint_loads_in_jax(jax_state, tmp_path):
    model, tx, template = jax_state
    # a port state after one Adam step from random weights: moments and
    # statistics of its own
    port = _port_state()
    init_weights_(port.model, torch.Generator().manual_seed(3))
    cfg = tconfig.TrainConfig(canvas=96, out_size=SIZE, bfloat16=False, batch_size=2)
    batch = synthetic_host_batch(2, 96, seed=4)
    port, _ = tsteps.make_train_step(cfg)(port, batch, tsteps.draw_augment(
        2, tsteps.augment_config(cfg, True)))
    tree = to_state_tree(port)
    assert int(tree["opt_state"]["0"]["count"]) == 1 and int(tree["step"]) == 1
    path = str(tmp_path / "port.ckpt")
    ckpt = tckpt.BranchBestCheckpoint(str(tmp_path), branch_name="feature/x")
    ckpt.save(tree, best=0.8125, epoch=3)
    assert ckpt.best() == 0.8125 and ckpt.exists()
    loaded, meta = jckpt.load_checkpoint(ckpt.path, template)
    assert meta == META
    _assert_bit_equal(fs.to_state_dict(loaded), tree)
    # JAX writes back the same file
    jckpt.save_checkpoint(path, loaded, META)
    assert open(path, "rb").read() == open(ckpt.path, "rb").read()
    # a torn or foreign file: no meta, and a load error
    with open(path, "wb") as f:
        f.write(b"garbage")
    assert tckpt.read_meta(path) is None
    with pytest.raises(ValueError, match="not an ISEG"):
        tckpt.load_checkpoint(path)


def test_adam_step_after_reload_matches_jax(jax_state, tmp_path):
    """Both packages reload one JAX-written state (non-zero moments, count
    7) and take one f32 Adam step on the same batch; the train step's tolerances
    (tests/test_torch_port_train.py, port_numerics.py) hold."""
    model, tx, state = jax_state
    path = str(tmp_path / "s.ckpt")
    jckpt.save_checkpoint(path, state, META)
    base = dict(canvas=96, out_size=SIZE, in_channels=20, bfloat16=False, batch_size=2,
                learning_rate=1e-3)
    jcfg, tcfg = jconfig.TrainConfig(**base), tconfig.TrainConfig(**base)
    batch = synthetic_host_batch(2, 96, seed=6)

    jstate, _ = jckpt.load_checkpoint(path, state)
    jstate, jm = jsteps.make_train_step(model, tx, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    port = from_state_tree(tckpt.load_checkpoint(path)[0], _port_state())
    port, tm = tsteps.make_train_step(tcfg)(port, batch, tsteps.draw_augment(
        2, tsteps.augment_config(tcfg, True)))

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    got, want = to_state_tree(port), fs.to_state_dict(jstate)
    assert int(got["step"]) == int(want["step"]) == 8
    assert int(got["opt_state"]["0"]["count"]) == int(want["opt_state"]["0"]["count"]) == 8
    # the first moment moved by (1 - b1) * g: the gradients' spread (1e-4 of
    # max|g|, port_numerics.py) times 0.1
    g = {k: (np.asarray(v) - 0.9 * np.asarray(m0)) / 0.1 for (k, v), m0 in zip(
        _leaves(want["opt_state"]["0"]["mu"]).items(),
        _leaves(fs.to_state_dict(state)["opt_state"]["0"]["mu"]).values())}
    gmax = max(np.abs(v).max() for v in g.values())
    mu = _leaves(got["opt_state"]["0"]["mu"])
    for k, v in _leaves(want["opt_state"]["0"]["mu"]).items():
        np.testing.assert_allclose(mu[k], v, rtol=1e-3, atol=0.1 * 1e-4 * gmax, err_msg=k)
    # the step: -lr * mhat / (sqrt(vhat) + eps), with loaded moments that
    # outweigh one gradient's spread
    p = _leaves(got["params"])
    for k, v in _leaves(want["params"]).items():
        np.testing.assert_allclose(p[k], v, atol=1e-6, err_msg=k)
    stats = _leaves(got["batch_stats"])
    for k, v in _leaves(want["batch_stats"]).items():
        np.testing.assert_allclose(stats[k], v, atol=5e-5, err_msg=k)


# ---------------------------------------------------------------------------
# load_any_checkpoint
# ---------------------------------------------------------------------------

def test_load_any_checkpoint_layouts(jax_state, tmp_path):
    model, _, state = jax_state
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want_sd = jax_variables_to_torch(variables)
    full, var_only = str(tmp_path / "full.ckpt"), str(tmp_path / "vars.ckpt")
    jckpt.save_checkpoint(full, state, META)
    jckpt.save_checkpoint(var_only, {"step": np.zeros((), np.int32), **variables}, META)
    for path in (full, var_only):
        got = load_any_checkpoint(path)
        _assert_bit_equal(got, variables)
        _assert_bit_equal(got, jax_load_any(path, variables))
    sd = Segment(20).state_dict()
    sd.update(want_sd)
    for name, obj in (("ref.pth", {"state_dict": sd, "best": 0.5, "epoch": 2}),
                      ("bare.pt", sd)):
        torch.save(obj, str(tmp_path / name))
        got = load_any_checkpoint(str(tmp_path / name))
        assert set(got) == set(sd)
        for k, v in sd.items():
            assert torch.equal(got[k], v), k

    # the engine serves each layout alike
    batch = synthetic_host_batch(2, 96, seed=2)
    outs = []
    for path in (full, var_only, str(tmp_path / "ref.pth")):
        eng = InferenceEngine(load_any_checkpoint(path), in_channels=20, size=SIZE,
                              dtype=torch.float32, device="cpu")
        outs.append(eng.predict_instances(batch))
    for probs, masks in outs[1:]:
        np.testing.assert_array_equal(probs, outs[0][0])
        np.testing.assert_array_equal(masks, outs[0][1])
    assert outs[0][0].shape == (2, SIZE, SIZE, 1) and np.isfinite(outs[0][0]).all()
