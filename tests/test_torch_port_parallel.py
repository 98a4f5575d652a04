"""The port's parallel modules (``instancesegmentation_tpu_torch/parallel``)
against one process and against the JAX package's (CPU, f32).

- in this process: ``make_mesh``, ``multihost``'s contracts, the loader's
  ``local_slice``, ``make_parallel_steps``' checks and its world-1 step, and
  ``ParallelInferenceEngine`` over 2 and 8 CPU replicas;
- in two gloo processes (two launches): synchronised BatchNorm, the
  data-parallel train step (also with BN sync or the gradient all-reduce
  broken, to show that the bound catches them) and the eval step in one
  worker; the two-process trainer in the other.

The workers compute the torch side, rank 0 also the single-process
reference, and write numpy files; the JAX side and the comparisons run here.
"""
import hashlib
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instancesegmentation_tpu.data.dataset import InstanceCommonDataset as JaxDataset
from instancesegmentation_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu.parallel.data_parallel import (
    make_parallel_steps as jax_make_parallel_steps,
)
from instancesegmentation_tpu.parallel.inference import (
    ParallelInferenceEngine as JaxParallelEngine,
)
from instancesegmentation_tpu.train import config as jconfig
from instancesegmentation_tpu.train.state import TrainState as JaxTrainState
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.pipeline import (
    batch_iterator,
    draw_augment,
    host_batch,
)
from instancesegmentation_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
    synthetic_host_batch,
)
from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
from instancesegmentation_tpu_torch.infer.server import ServingFrontend
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.quantize import calibrate
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.parallel import multihost
from instancesegmentation_tpu_torch.parallel.data_parallel import (
    collectives_per_step,
    make_parallel_steps,
)
from instancesegmentation_tpu_torch.parallel.inference import ParallelInferenceEngine
from instancesegmentation_tpu_torch.parallel.mesh import Mesh, make_mesh
from instancesegmentation_tpu_torch.train import checkpoint as tckpt
from instancesegmentation_tpu_torch.train import config as tconfig
from instancesegmentation_tpu_torch.train import loop as tloop
from instancesegmentation_tpu_torch.train.state import TrainState
from instancesegmentation_tpu_torch.train.steps import augment_config, make_train_step
from instancesegmentation_tpu_torch.utils.weights import (
    jax_variables_to_torch,
    torch_to_jax_variables,
)
from test_torch_port_layers import _randomize

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIZE, CANVAS, BATCH = 64, 192, 8
#: a subprocess's time limit, seconds
WORKER_TIMEOUT = 120
#: global relative error of a data-parallel step's gradient vector against
#: one process's (tests/test_parallel.py:44): float reassociation through
#: ~30 BN'd layers and kinks it flips stay at ~1e-3; a sync bug gives O(0.3-1)
GRAD_REL = 5e-2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_two(script: str, *args, cwd) -> list:
    """Start ``script`` as ranks 0 and 1 (argv: port, rank, *args)."""
    path = os.path.join(cwd, "worker.py")
    with open(path, "w") as f:
        f.write(script)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, path, port, str(r), *args], cwd=cwd, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in (0, 1)]


def _wait_two(procs) -> list:
    """The ranks' outputs, failing on a non-zero exit or a time-out; no
    process outlives the call."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, "\n".join(outs)
    return outs


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# mesh and multihost, in this process
# ---------------------------------------------------------------------------

def test_make_mesh_sizes():
    mesh = make_mesh(devices=[CPU] * 8)
    assert (mesh.size, mesh.rank, mesh.world_size) == (8, 0, 1)
    assert make_mesh(4, devices=[CPU] * 8).devices == (CPU,) * 4
    with pytest.raises(ValueError, match="requested 9 devices, only 8 visible"):
        make_mesh(9, devices=[CPU] * 8)


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


@pytest.mark.parametrize("given", [dict(coordinator="127.0.0.1:1"),
                                   dict(num_processes=2, process_id=0),
                                   dict(coordinator="127.0.0.1:1", process_id=0)])
def test_initialize_all_or_nothing(given):
    with pytest.raises(ValueError, match="needs either no topology flags"):
        multihost.initialize(**given)


def test_initialize_without_torchrun_environment_raises(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK"):
        multihost.initialize()


def test_single_process_helpers_are_identities():
    assert multihost.process_info() == (0, 1)
    assert multihost.local_rank() == 0
    np.testing.assert_array_equal(multihost.sum_across_processes([1.5, 2]), [1.5, 2.0])
    np.testing.assert_array_equal(multihost.broadcast_from_main([3, 4]), [3.0, 4.0])
    rows = torch.arange(6.0)
    np.testing.assert_array_equal(multihost.host_local_rows(rows, 6), np.arange(6.0))
    with pytest.raises(AssertionError, match="contiguous block"):
        multihost.host_local_rows(rows[:3], 6)


def test_local_batch_slice(monkeypatch):
    assert multihost.local_batch_slice(8) == slice(0, 8)
    monkeypatch.setattr(multihost, "process_info", lambda: (1, 4))
    assert multihost.local_batch_slice(8) == slice(2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_batch_slice(7)
    np.testing.assert_array_equal(multihost.host_local_rows(np.zeros((2, 3)), 8), 0.0)


# ---------------------------------------------------------------------------
# the loader's local slice
# ---------------------------------------------------------------------------

def test_batch_iterator_local_slice(tmp_path):
    """With the same seed, the ``local_slice`` view of every global batch is
    that row range of the full batch, the padded tail included, and equal
    to the JAX loader's with the same slice."""
    make_synthetic_dataset(str(tmp_path / "d"), num_images=6, objects_per_image=1, seed=1)
    ds = InstanceCommonDataset(str(tmp_path / "d"), 96)
    jds = JaxDataset(str(tmp_path / "d"), 96)
    kw = dict(shuffle=True, seed=7, epochs=1, drop_last=False, num_threads=2)
    full = list(batch_iterator(ds, 4, **kw))
    part = list(batch_iterator(ds, 4, local_slice=slice(2, 4), **kw))
    jpart = list(jax_batch_iterator(jds, 4, local_slice=slice(2, 4), **kw))
    assert len(full) == len(part) == len(jpart) == 2
    for fb, pb, jb in zip(full, part, jpart):
        assert set(fb) == set(pb) == set(jb)
        for k in fb:
            np.testing.assert_array_equal(fb[k][2:4], pb[k])
            np.testing.assert_array_equal(np.asarray(jb[k]), pb[k])


# ---------------------------------------------------------------------------
# make_parallel_steps in one process
# ---------------------------------------------------------------------------

def _tcfg(**kw):
    base = dict(canvas=CANVAS, out_size=SIZE, in_channels=20, bfloat16=False,
                batch_size=BATCH, learning_rate=1e-3, data_parallel=True)
    base.update(kw)
    return tconfig.TrainConfig(**base)


def test_make_parallel_steps_checks():
    with pytest.raises(ValueError, match="not divisible"):
        make_parallel_steps(_tcfg(batch_size=6), Mesh((CPU,), 0, 4))
    with pytest.raises(ValueError, match="one process per GPU"):
        make_parallel_steps(_tcfg(), make_mesh(devices=[CPU] * 2))
    # remat, once refused, builds (its bit-equality: test_dp_remat_step_bit_identical)
    assert callable(make_parallel_steps(_tcfg(remat=True), make_mesh(devices=[CPU]))[1])
    _, _, _, shard_batch = make_parallel_steps(_tcfg(), Mesh((CPU,), 1, 2))
    batch = {"image": np.arange(8)}
    np.testing.assert_array_equal(shard_batch(batch)["image"], np.arange(4, 8))
    assert shard_batch({"image": np.arange(4)})["image"].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="neither the global"):
        shard_batch({"image": np.arange(3)})
    assert collectives_per_step(Segment(20)) == 2 * 74 + 1
    assert collectives_per_step(Segment(20), remat=True) == 3 * 74 + 1


def test_world_one_step_is_the_single_process_step():
    """Without a process group the data-parallel step is the single-process step, bit
    for bit: loss, metrics and the updated state."""
    cfg = _tcfg(rotate=25.0, flip_prob=0.5, batch_size=2)
    batch = synthetic_host_batch(2, CANVAS, seed=4)
    draws = draw_augment(2, augment_config(cfg, True), torch.Generator().manual_seed(2))
    states, metrics = [], []
    for step in (make_train_step(cfg), make_parallel_steps(cfg, make_mesh(devices=[CPU]))[1]):
        model = Segment(20)
        init_weights_(model, torch.Generator().manual_seed(0))
        state, m = step(TrainState.create(model, cfg.learning_rate), batch, draws)
        states.append(state.model.state_dict())
        metrics.append(m)
    assert float(metrics[0]["loss"]) == float(metrics[1]["loss"])
    assert float(metrics[0]["train_iou"]) == float(metrics[1]["train_iou"])
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


# ---------------------------------------------------------------------------
# two gloo ranks: sync BN, the train step and the eval step
# ---------------------------------------------------------------------------

STEP_WORKER = textwrap.dedent("""
    import sys, types
    sys.path.insert(0, %(repo)r)
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch import nn
    from instancesegmentation_tpu_torch.models import layers
    from instancesegmentation_tpu_torch.models.layers import (
        BottleneckUpRes, ConvBN, conv, init_weights_, sync_batchnorm)
    from instancesegmentation_tpu_torch.models.segment import Segment
    from instancesegmentation_tpu_torch.parallel import data_parallel, multihost
    from instancesegmentation_tpu_torch.parallel.mesh import make_mesh
    from instancesegmentation_tpu_torch.train.config import TrainConfig
    from instancesegmentation_tpu_torch.train.state import TrainState
    from instancesegmentation_tpu_torch.train.steps import make_eval_step, make_train_step

    port, rank = sys.argv[1], int(sys.argv[2])
    inp = dict(np.load("inputs.npz"))
    batch = {k[6:]: v for k, v in inp.items() if k.startswith("batch/")}
    sd = {k[3:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("sd/")}
    out = {}
    rows = slice(4 * rank, 4 * rank + 4)

    class Tiny(nn.Module):
        # both BN sites: ConvBN and BottleneckUpRes
        def __init__(self):
            super().__init__()
            self.a = ConvBN(3, 8, 3, act="prelu")
            self.b = ConvBN(8, 8, 3, groups=8, act="prelu")
            self.up = BottleneckUpRes(8, 4, 8, skip_channels=3)

        def forward(self, x):
            return self.up(self.b(self.a(x, True), True), x, True)

    def bn_run(x, w, group):
        tiny = Tiny()
        init_weights_(tiny, torch.Generator().manual_seed(1))
        x = x.clone().requires_grad_(True)
        with sync_batchnorm(tiny, group):
            y = tiny(x)
            (y * w).sum().backward()
        return {"out": y.detach(), "xgrad": x.grad,
                **{"grad/" + n: p.grad for n, p in tiny.named_parameters()},
                **{"buf/" + n: b for n, b in tiny.named_buffers()},
                "conv_a": conv(tiny.a.conv, x.detach()).detach()}

    def cfg_of(variant, **kw):
        aug = dict(rotate=25.0, flip_prob=0.5) if variant == "rotate_flip" else {}
        return TrainConfig(canvas=192, out_size=64, in_channels=20, bfloat16=False,
                           batch_size=8, learning_rate=1e-3, data_parallel=True, **aug, **kw)

    def draws_of(variant):
        d = {k: None for k in ("jitter", "brightness", "contrast", "noise")}
        if variant == "rotate_flip":
            return dict(d, theta=torch.from_numpy(inp["theta"]), flip=torch.from_numpy(inp["flip"]))
        return dict(d, theta=torch.zeros(8), flip=torch.zeros(8, dtype=torch.bool))

    def fresh():
        model = Segment(20)
        model.load_state_dict(sd)
        return TrainState.create(model, 1e-3)

    def step_out(state, m):
        return {"loss": m["loss"], "iou": m["train_iou"],
                **{"grad/" + n: p.grad for n, p in state.model.named_parameters()},
                **{"state/" + n: v for n, v in state.model.state_dict().items()}}

    def save(prefix, d):
        out.update({prefix + "/" + k: np.asarray(v.detach()) if isinstance(v, torch.Tensor)
                    else np.asarray(v) for k, v in d.items()})

    x, w = torch.from_numpy(inp["bn_x"]), torch.from_numpy(inp["bn_w"])
    if rank == 0:  # one process on the full batch
        save("ref_bn", bn_run(x, w, None))
        for variant in ("augs_off", "rotate_flip"):
            cfg = cfg_of(variant)
            save("ref_" + variant, step_out(*make_train_step(cfg)(fresh(), batch, draws_of(variant))))
        save("ref_eval", {"ious": make_eval_step(cfg_of("augs_off"))(fresh().model, batch)[3]})

    multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        save("bn", bn_run(x[rows], w[rows], dist.group.WORLD))

        def dp_step(variant, **kw):
            cfg = cfg_of(variant, **kw)
            mesh, step, eval_step, shard = data_parallel.make_parallel_steps(
                cfg, make_mesh(devices=["cpu"]))
            state, m = step(fresh(), shard(batch), draws_of(variant))
            return step_out(state, m), eval_step, shard

        for variant in ("augs_off", "rotate_flip"):
            res, eval_step, shard = dp_step(variant)
            save(variant, res)
        save("eval", {"ious": eval_step(fresh().model, shard(batch))[3]})
        # the step with remat, its all-reduces counted
        all_reduce, calls = dist.all_reduce, []
        dist.all_reduce = lambda *a, **k: calls.append(1) or all_reduce(*a, **k)
        save("remat_rotate_flip", dp_step("rotate_flip", remat=True)[0])
        dist.all_reduce = all_reduce
        save("remat_calls", {"all_reduces": len(calls), "expected":
                             data_parallel.collectives_per_step(Segment(20), remat=True)})
        # the same step with a sync bug: BN's backward without its
        # all-reduce, then no all-reduce of the gradients
        backward = layers._AllReduceSum.backward
        layers._AllReduceSum.backward = staticmethod(lambda ctx, g: (g, None))
        save("detached_bn_backward", dp_step("augs_off")[0])
        layers._AllReduceSum.backward = backward
        data_parallel.dist = types.SimpleNamespace(
            group=dist.group, is_initialized=dist.is_initialized,
            all_reduce=lambda *a, **k: None)
        save("no_grad_all_reduce", dp_step("augs_off")[0])
        data_parallel.dist = dist
    finally:
        multihost.shutdown()
    np.savez(f"rank{rank}.npz", **out)
    print(f"rank{rank} DONE", flush=True)
""")


@pytest.fixture(scope="module")
def carried():
    """Segment(20) variables in flax's layout (numpy) with random running
    statistics and PReLU slopes, and the port's state dict of them.  The
    weights are the port's seeded initialisation, carried into the tree of
    ``jax.eval_shape(init)``: compiling flax's init costs ~14 s here."""
    model = JaxSegment(in_channels=20)
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(10), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((1, SIZE, SIZE, 17)), train=False))
    port = Segment(20)
    init_weights_(port, torch.Generator().manual_seed(10))
    variables = torch_to_jax_variables(port.state_dict(), template)
    variables = _randomize(variables, np.random.default_rng(10))
    return variables, jax_variables_to_torch(variables)


@pytest.fixture(scope="module")
def batch8(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_par")
    make_synthetic_dataset(str(root), num_images=BATCH, objects_per_image=1, seed=11)
    ds = InstanceCommonDataset(str(root), canvas=CANVAS)
    return host_batch([ds.fetch(i) for i in range(BATCH)])


def _jax_dp_step(variables, batch8) -> dict:
    """One step of JAX's ``make_parallel_steps`` on a 2-device mesh (augs
    off) with ``optax.sgd(1.0)``, so that its update is its gradient: the
    loss, the gradients and the batch statistics."""
    cfg = jconfig.TrainConfig(canvas=CANVAS, out_size=SIZE, in_channels=20, bfloat16=False,
                              batch_size=BATCH, data_parallel=True)
    model = JaxSegment(in_channels=20, dtype=jnp.float32, bn_axis_name="data")
    tx = optax.sgd(1.0)
    _, step, _, shard_batch = jax_make_parallel_steps(model, tx, cfg, num_devices=2)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    new, m = step(state, shard_batch(batch8), jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   variables["params"], new.params)
    return {"loss": float(m["loss"]), "grads": grads,
            "batch_stats": jax.tree_util.tree_map(np.asarray, new.batch_stats)}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, carried, batch8):
    """Both ranks' results of STEP_WORKER, {"rank0": {...}, "rank1": {...}},
    and JAX's data-parallel step ("jax"), computed while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("dp_step"))
    rng = np.random.default_rng(12)
    inputs = {"bn_x": rng.normal(0, 1, (BATCH, 3, 16, 16)).astype(np.float32),
              "bn_w": rng.normal(0, 1, (BATCH, 8, 32, 32)).astype(np.float32),
              "theta": rng.uniform(-0.4, 0.4, BATCH).astype(np.float32),
              "flip": rng.random(BATCH) < 0.5,
              **{"batch/" + k: v for k, v in batch8.items()},
              **{"sd/" + k: v.numpy() for k, v in carried[1].items()}}
    inputs["theta"][:2] = 0.0  # a sample without rotation beside rotated ones
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    procs = _start_two(STEP_WORKER % {"repo": REPO}, cwd=tmp)
    try:
        jax_step = _jax_dp_step(carried[0], batch8)
    finally:
        outs = _wait_two(procs)
    assert "rank0 DONE" in outs[0] and "rank1 DONE" in outs[1]
    return {"jax": jax_step,
            **{f"rank{r}": dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in (0, 1)}}


def _group(res: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def test_sync_bn_matches_one_process(dp_run):
    """2 ranks of 4 rows against one process on the 8: outputs and running
    statistics within 1e-5, input and parameter gradients of a scalar loss
    within 1e-4 relative (the ranks' parameter gradients summed)."""
    ref = _group(dp_run["rank0"], "ref_bn")
    got = [_group(dp_run[f"rank{r}"], "bn") for r in (0, 1)]
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got]), ref["out"], atol=1e-5)
    xgrad = np.concatenate([g["xgrad"] for g in got])
    assert _rel(xgrad, ref["xgrad"]) < 1e-4
    # one vector: a conv bias before a BN has a zero gradient, so its own
    # relative error is float noise over float noise
    names = [k for k in ref if k.startswith("grad/")]
    assert _rel(np.concatenate([(got[0][k] + got[1][k]).ravel() for k in names]),
                np.concatenate([ref[k].ravel() for k in names])) < 1e-4
    for name in [k for k in ref if k.startswith("buf/") and "num_batches" not in k]:
        for g in got:
            np.testing.assert_allclose(g[name], ref[name], atol=1e-5, err_msg=name)


def test_sync_bn_running_var_is_biased(dp_run):
    """The first BN's running variance moved by 0.1 of the full batch's
    BIASED variance (from 1), on both ranks; the unbiased one is off by
    more than the tolerance."""
    conv_a = dp_run["rank0"]["ref_bn/conv_a"]
    biased = conv_a.var(axis=(0, 2, 3))
    unbiased = conv_a.var(axis=(0, 2, 3), ddof=1)
    for r in (0, 1):
        rv = dp_run[f"rank{r}"]["bn/buf/a.bn.running_var"]
        np.testing.assert_allclose(rv, 0.9 + 0.1 * biased, atol=1e-5)
        assert np.abs(rv - (0.9 + 0.1 * unbiased)).max() > 1e-4


def test_dp_remat_step_bit_identical(dp_run):
    """On 2 gloo ranks the data-parallel step with ``remat`` equals the step
    without it bit for bit on each rank: loss, IoU, gradients, parameters and
    BN running statistics.  The recompute takes each BN's batch statistics
    again over the ranks: 3 x 74 + 1 all-reduces per step."""
    for r in (0, 1):
        res = dp_run[f"rank{r}"]
        plain, remat = _group(res, "rotate_flip"), _group(res, "remat_rotate_flip")
        assert plain.keys() == remat.keys()
        for k in plain:
            np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)
        assert int(res["remat_calls/all_reduces"]) == int(res["remat_calls/expected"]) == 223


def _flat_grads(res: dict, names) -> np.ndarray:
    return np.concatenate([res["grad/" + n].ravel() for n in names])


@pytest.mark.parametrize("variant", ["augs_off", "rotate_flip"])
def test_dp_train_step_matches_one_process(dp_run, variant):
    """The 2-rank step against the single-process port step on the global
    batch with the same draws: loss within 2e-5, the averaged gradient
    vector within the global relative bound, batch statistics within 1e-3;
    both ranks hold the same metrics, gradients and updated state."""
    ref = _group(dp_run["rank0"], "ref_" + variant)
    got = [_group(dp_run[f"rank{r}"], variant) for r in (0, 1)]
    names = sorted(k[5:] for k in ref if k.startswith("grad/"))
    for g in got:
        assert abs(float(g["loss"]) - float(ref["loss"])) < 2e-5
        assert _rel(_flat_grads(g, names), _flat_grads(ref, names)) < GRAD_REL
        for k in [k for k in ref if k.startswith("state/") and "running" in k]:
            np.testing.assert_allclose(g[k], ref[k], atol=1e-3, err_msg=k)
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def test_dp_train_step_matches_jax(dp_run, carried):
    """Against JAX's ``make_parallel_steps`` on a 2-device mesh (augs off):
    loss within 2e-5, the gradient vector within the global relative
    bound, batch statistics within 1e-3."""
    variables, _ = carried
    jax_step = dp_run["jax"]
    res = _group(dp_run["rank0"], "augs_off")
    assert abs(float(res["loss"]) - jax_step["loss"]) < 2e-5
    tgrads = torch_to_jax_variables(
        {k[5:]: torch.from_numpy(v) for k, v in res.items() if k.startswith("grad/")},
        {"params": variables["params"]})["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(jax_step["grads"]))
    got = dict(jax.tree_util.tree_leaves_with_path(tgrads))
    assert set(got) == set(want)
    assert _rel(np.concatenate([np.ravel(got[k]) for k in want]),
                np.concatenate([np.ravel(want[k]) for k in want])) < GRAD_REL
    stats = torch_to_jax_variables(
        {k[6:]: torch.from_numpy(v) for k, v in res.items() if k.startswith("state/")},
        variables)["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(jax_step["batch_stats"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)


@pytest.mark.parametrize("variant", ["detached_bn_backward", "no_grad_all_reduce"])
def test_gradient_bound_catches_a_sync_bug(dp_run, variant):
    """A BN reduction whose backward skips its all-reduce, or a step without
    the gradient all-reduce, puts a rank's gradient above the bound."""
    ref = _group(dp_run["rank0"], "ref_augs_off")
    names = sorted(k[5:] for k in ref if k.startswith("grad/"))
    for r in (0, 1):
        bad = _group(dp_run[f"rank{r}"], variant)
        assert _rel(_flat_grads(bad, names), _flat_grads(ref, names)) > GRAD_REL


def test_dp_eval_step_matches_one_process(dp_run):
    ious = np.concatenate([dp_run[f"rank{r}"]["eval/ious"] for r in (0, 1)])
    np.testing.assert_array_equal(ious, dp_run["rank0"]["ref_eval/ious"])


# ---------------------------------------------------------------------------
# two gloo ranks: the trainer
# ---------------------------------------------------------------------------

TRAINER_WORKER = textwrap.dedent("""
    import hashlib, json, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np, torch
    torch.set_num_threads(1)
    from instancesegmentation_tpu_torch.parallel import multihost
    from instancesegmentation_tpu_torch.train.config import TrainConfig
    from instancesegmentation_tpu_torch.train.loop import Trainer
    from instancesegmentation_tpu_torch.train.state import to_state_tree

    def tree_hash(tree):
        h = hashlib.sha256()
        def walk(t, prefix):
            for k in sorted(t):
                if isinstance(t[k], dict):
                    walk(t[k], prefix + "/" + k)
                else:
                    a = np.asarray(t[k])
                    h.update((prefix + "/" + k + str(a.dtype)).encode())
                    h.update(a.tobytes())
        walk(tree, "")
        return h.hexdigest()

    port, rank, cfg = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        t = Trainer(TrainConfig(**cfg), device="cpu")
        last = t.train()
        trained = tree_hash(to_state_tree(t.state))
        resumed = Trainer(TrainConfig(**cfg), device="cpu")
        resumed.logger.close()
        print("RESULT " + json.dumps({
            "rank": rank, "val": last, "trained": trained,
            "resumed": tree_hash(to_state_tree(resumed.state)),
            "start_epoch": resumed.start_epoch, "step": resumed.state.step}), flush=True)
    finally:
        multihost.shutdown()
""")


def _tree_hash(tree) -> str:
    h = hashlib.sha256()

    def walk(t, prefix):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], prefix + "/" + k)
            else:
                a = np.asarray(t[k])
                h.update((prefix + "/" + k + str(a.dtype)).encode())
                h.update(a.tobytes())

    walk(tree, "")
    return h.hexdigest()


def _rows(out_dir, key):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if key in r]


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    """Two ranks of the trainer (6 images, global batch 4, 2 epochs, save
    gate 0, lr 1e-4 as in test_torch_port_trainer.py) and the
    single-process trainer on the same configuration."""
    tmp = str(tmp_path_factory.mktemp("dp_trainer"))
    data = os.path.join(tmp, "data")
    make_synthetic_dataset(data, num_images=6, objects_per_image=1, seed=3)

    def cfg(run, **kw):
        return dict(train_dataset_dir=data, val_dataset_dir=data,
                    checkpoint_dir=os.path.join(tmp, run, "ckpt"),
                    out_dir=os.path.join(tmp, run, "out"), canvas=96, out_size=32,
                    in_channels=20, bfloat16=False, batch_size=4, epochs=2,
                    learning_rate=1e-4, save_iou_gate=0.0, show_iter=1, num_threads=2, **kw)

    dp_cfg = cfg("dp", data_parallel=True)
    single_cfg = tconfig.TrainConfig(**cfg("single"))
    procs = _start_two(TRAINER_WORKER % {"repo": REPO}, json.dumps(dp_cfg), cwd=tmp)
    try:
        tloop.Trainer(single_cfg, device="cpu").train()
    finally:
        outs = _wait_two(procs)
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[7:])
                results[r["rank"]] = r
    assert set(results) == {0, 1}, "\n".join(outs)
    return {"results": results, "outs": outs, "dp": tconfig.TrainConfig(**dp_cfg),
            "single": single_cfg}


def test_two_process_trainer_ranks_agree(trainer_run):
    """Bit-identical parameters, BN statistics and Adam state, and the same
    global val IoU, on both ranks."""
    r = trainer_run["results"]
    assert r[0]["trained"] == r[1]["trained"]
    assert r[0]["val"] == r[1]["val"]


def test_two_process_trainer_single_writer(trainer_run):
    """Rank 0 alone writes metrics, image grids and the checkpoint."""
    cfg = trainer_run["dp"]
    assert len(_rows(cfg.out_dir, "loss")) == 2 and len(_rows(cfg.out_dir, "val_iou")) == 2
    assert sorted(os.listdir(os.path.join(cfg.out_dir, "viz"))) == ["val_e000.png",
                                                                    "val_e001.png"]
    assert os.listdir(cfg.checkpoint_dir) == ["main_best.ckpt"]
    saves = [out.count("save branch best checkpoint") for out in trainer_run["outs"]]
    assert saves[0] >= 1 and saves[1] == 0


def test_two_process_trainer_resume(trainer_run):
    """A fresh trainer on each rank resumes the state that rank 0 read from
    the checkpoint (rank 1 never reads the file)."""
    cfg = trainer_run["dp"]
    path = tckpt.BranchBestCheckpoint(cfg.checkpoint_dir).path
    tree, meta = tckpt.load_checkpoint(path)
    for r in trainer_run["results"].values():
        assert r["resumed"] == _tree_hash(tree)
        assert r["start_epoch"] == meta["epoch"] and r["step"] == int(tree["step"])


def test_two_process_trainer_matches_one_process(trainer_run):
    """Losses within rel 1e-4 and val IoUs within 1e-3 of the single-process
    trainer at the same global batch (the tolerances of
    test_torch_port_trainer.py)."""
    dp, single = trainer_run["dp"], trainer_run["single"]
    dl, sl = _rows(dp.out_dir, "loss"), _rows(single.out_dir, "loss")
    assert [r["step"] for r in dl] == [r["step"] for r in sl] == [1, 2]
    np.testing.assert_allclose([r["loss"] for r in dl], [r["loss"] for r in sl], rtol=1e-4)
    np.testing.assert_allclose([r["val_iou"] for r in _rows(dp.out_dir, "val_iou")],
                               [r["val_iou"] for r in _rows(single.out_dir, "val_iou")],
                               atol=1e-3)


# ---------------------------------------------------------------------------
# ParallelInferenceEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_engine(carried):
    return InferenceEngine(carried[0], in_channels=20, size=SIZE, dtype=torch.float32,
                           device="cpu")


@pytest.mark.parametrize("n", [2, 8])
def test_parallel_engine_matches_single(carried, single_engine, n):
    """Whole-image and instance mode over n CPU replicas equal the one
    engine's within 1e-5; a batch of 5 gives 5 rows."""
    par = ParallelInferenceEngine(carried[0], in_channels=20, size=SIZE, dtype=torch.float32,
                                  devices=[CPU] * n)
    assert par.n == n and len(par.replicas) == n
    images = np.random.default_rng(0).integers(0, 255, (8, SIZE, SIZE, 3), dtype=np.uint8)
    with torch.inference_mode():
        ref = single_engine._forward_whole(torch.from_numpy(images))
    probs = par(images)
    assert probs.shape == (8, SIZE, SIZE, 1)
    np.testing.assert_allclose(probs.numpy(), ref.numpy(), atol=1e-5)
    probs5 = par(images[:5])
    assert probs5.shape == (5, SIZE, SIZE, 1)
    np.testing.assert_allclose(probs5.numpy(), ref[:5].numpy(), atol=1e-5)

    batch = synthetic_host_batch(5, 128, seed=7)
    p, m = par.predict_instances(batch)
    rp, rm = single_engine.predict_instances(batch)
    assert p.shape == (5, SIZE, SIZE, 1) and m.shape == (5, 128, 128)
    np.testing.assert_allclose(p, rp, atol=1e-5)
    assert (m == rm).mean() > 0.999


def test_parallel_engine_matches_jax(carried):
    """Against JAX's ParallelInferenceEngine on its 8-device mesh, at the
    serving tolerance of test_torch_port_serving.py."""
    variables = carried[0]
    par = ParallelInferenceEngine(variables, in_channels=20, size=SIZE, dtype=torch.float32,
                                  devices=[CPU] * 8)
    jpar = JaxParallelEngine(variables, in_channels=20, size=SIZE, dtype=jnp.float32)
    assert jpar.n == 8
    batch = synthetic_host_batch(8, 128, seed=8)
    p, m = par.predict_instances(batch)
    jp, jm = jpar.predict_instances(batch)
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-4)
    assert (m == np.asarray(jm)).mean() >= 0.999


def test_parallel_engine_serving_frontend(carried):
    """The engine's predict_images and predict_instances drive the
    dynamic-batching ServingFrontend unchanged (mixed request sizes)."""
    par = ParallelInferenceEngine(carried[0], in_channels=20, size=SIZE, dtype=torch.float32,
                                  devices=[CPU] * 2)
    rng = np.random.default_rng(2)
    with ServingFrontend(par, max_batch=8, max_delay_ms=20.0, canvas=128) as srv:
        futs = [srv.submit(rng.integers(0, 255, (40 + i, 56, 3), dtype=np.uint8))
                for i in range(5)]
        inst = srv.submit_instance(rng.integers(0, 255, (100, 90, 3), dtype=np.uint8),
                                   [20, 10, 70, 90])
        masks = [f.result(timeout=60) for f in futs]
        one = inst.result(timeout=60)
    for i, m in enumerate(masks):
        assert m.shape == (40 + i, 56) and m.dtype == np.uint8
        assert set(np.unique(m)) <= {0, 255}
    assert one["mask"].shape == (100, 90)
    assert srv.served == 6


def test_parallel_engine_variables_refold(carried):
    """Assigning weights refolds every replica."""
    par = ParallelInferenceEngine(carried[0], in_channels=20, size=SIZE, dtype=torch.float32,
                                  devices=[CPU] * 2)
    model = Segment(20)
    init_weights_(model, torch.Generator().manual_seed(5))
    par.variables = model.state_dict()
    ref = InferenceEngine(model.state_dict(), in_channels=20, size=SIZE, dtype=torch.float32,
                          device="cpu")
    for r in par.replicas:
        for k, v in ref.variables.items():
            assert torch.equal(r.variables[k], v), k


@pytest.mark.parametrize("option,where", [({"fused_stem": True}, "A7"),
                                          ({"quant_mode": "int8"}, "A6")])
def test_parallel_engine_unported_options_raise(carried, option, where):
    """Both options, once refused, are ported.  ``fused_stem`` (A7): two
    replicas serve the keypoint-patch stem, equal to
    ``InferenceEngine(fused_stem=True)`` within 1e-5 (each replica's rows are
    a batch of their own).  ``quant`` (A6): each replica serves int8, equal
    to the int8 ``InferenceEngine``."""
    if where == "A7":
        par = ParallelInferenceEngine(carried[0], in_channels=20, size=SIZE, dtype=torch.float32,
                                      devices=[CPU] * 2, **option)
        single = InferenceEngine(carried[0], in_channels=20, size=SIZE, dtype=torch.float32,
                                 device="cpu", **option)
        assert all(r._fused_stem for r in par.replicas)
        batch = synthetic_host_batch(4, 128, seed=9)
        p, m = par.predict_instances(batch)
        rp, rm = single.predict_instances(batch)
        np.testing.assert_allclose(p, rp, rtol=0, atol=1e-5)
        assert (m == rm).mean() >= 0.999
        return
    rng = np.random.default_rng(12)
    quant = calibrate(Segment(20).eval(), carried[1],
                      [(rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
                        rng.uniform(0, 1, (2, SIZE, SIZE, 17)).astype(np.float32))])
    par = ParallelInferenceEngine(carried[0], in_channels=20, size=SIZE, dtype=torch.float32,
                                  devices=[CPU], quant=quant, **option)
    single = InferenceEngine(carried[0], in_channels=20, size=SIZE, dtype=torch.float32,
                             quant=quant, device="cpu", **option)
    assert par.replicas[0].model.quant_mode == "int8"
    batch = synthetic_host_batch(2, 128, seed=9)
    p, m = par.predict_instances(batch)
    rp, rm = single.predict_instances(batch)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(m, rm)
