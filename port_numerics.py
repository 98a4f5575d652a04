"""How closely the JAX package agrees with itself, and the port with both, on
the CPU: the spreads behind the tolerances of the training slice's tests.

    python port_numerics.py      # from the repository root; CPU only, ~3 min

It runs the data of ``tests/test_torch_port_rotation.py`` and
``tests/test_torch_port_train.py`` (their helpers are imported) and prints
one JSON object:

- ``probe_kernels``: the port's plain 2level version against both TPU probe
  kernels of ``tools/rot_pallas_probe.py`` (interpret mode) without and with
  a translation cut, per sample: the largest difference and the count of
  values that differ by more than 1 (0-255 scale);
- ``staged_preprocess``: JAX's ``rotate_chunk`` program (a compiled
  ``lax.map``) against its own eager unstaged program, and the port against
  the latter;
- ``bn_stats``: the BN running statistics after one train-mode forward:
  JAX eager vs jitted, the port (f32) vs JAX, the port f32 vs float64;
- ``grads_b2`` / ``grads_b4_cut``: parameter gradients of one train step's
  loss, as a fraction of max|g|: JAX jitted vs eager on identical inputs,
  the port (f32) vs JAX, and both against the port in float64 (at batch 4
  with large cut regions for the latter).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import test_torch_port_rotation as R  # noqa: E402
import test_torch_port_train as T  # noqa: E402
from instancesegmentation_tpu_torch.models.fused_head import (  # noqa: E402
    fold_head_live,
    head_apply,
)
from instancesegmentation_tpu_torch.train import steps as tsteps  # noqa: E402
from instancesegmentation_tpu_torch.utils.weights import torch_to_jax_variables  # noqa: E402


def probe_kernels() -> dict:
    probe = R._probe()
    out = {}
    for cut in (False, True):
        img, mask = R._canvas(2, seed=2)
        x = np.concatenate([img, mask[..., None]], -1).astype(np.float32)
        pairs = [R._params(deg, cut, flip=False, b=1) for deg in (13.0, -25.0)]
        tp = R.tw.RotWarpParams(*(torch.cat(f) for f in zip(*(p[1] for p in pairs))))
        got = R.w2.warp_2level(torch.from_numpy(img), torch.from_numpy(mask), tp,
                               (R.OUT, R.OUT), 25.0).numpy()
        coefs = jnp.stack([probe._coeffs(p[0]) for p in pairs])
        cm = jnp.transpose(jnp.asarray(x), (0, 3, 1, 2))
        for kernel in (probe.warp_2level_pallas, probe.warp_2level_pallas_fused):
            pk = np.transpose(np.asarray(kernel(cm, coefs, (R.OUT, R.OUT), 25.0,
                                                interpret=True)), (0, 2, 3, 1))
            d = np.abs(got - pk)
            out[f"{'cut' if cut else 'no_cut'}/{kernel.__name__}"] = [
                {"deg": deg, "max_abs_diff": float(d[i].max()),
                 "values_over_1": int((d[i] > 1).sum()), "values": int(d[i].size)}
                for i, deg in enumerate((13.0, -25.0))]
    return out


def staged_preprocess() -> dict:
    kw = R.PIPELINE_CASES["rot_2level_all_rotated_chunk1"]
    jcfg = R.jpipe.AugmentConfig(**kw)
    batch = R._pipeline_batch()
    rng = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    staged = R.jpipe.preprocess_batch(jb, rng, jcfg)
    eager = R.jpipe.preprocess_batch(jb, rng, dataclasses.replace(jcfg, rotate_chunk=0))
    port = R.tpipe.preprocess_batch(R.tpipe.batch_to(batch, "cpu"), R._jax_draws(rng, 4, jcfg),
                                    R.tpipe.AugmentConfig(**kw))
    names = ("images", "heatmaps", "masks")
    return {
        "jax_staged_vs_eager": {n: float(np.abs(np.asarray(a) - np.asarray(b)).max())
                                for n, a, b in zip(names, staged, eager)},
        "port_vs_jax_eager": {n: float(np.abs(a.numpy() - np.asarray(b)).max())
                              for n, a, b in zip(names, port, eager)},
    }


def _variables(model):
    v = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(20), jnp.zeros((1, T.SIZE, T.SIZE, 3)),
        jnp.zeros((1, T.SIZE, T.SIZE, 17)), train=False)
    return T._randomize(dict(v), np.random.default_rng(20))


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[p], np.float64) - np.asarray(b[p], np.float64)).max())
               for p in b)


def bn_stats(model, variables) -> dict:
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (2, T.SIZE, T.SIZE, 3)).astype(np.float32)
    hm = rng.random((2, T.SIZE, T.SIZE, 17)).astype(np.float32)

    def apply(v, a, b):
        return model.apply(v, a, b, train=True, mutable=["batch_stats"])[1]["batch_stats"]

    eager = T._flat(apply(variables, img, hm))
    jitted = T._flat(jax.jit(apply)(variables, img, hm))

    def port(dt):
        m = T._port(variables).to(dt)
        with torch.no_grad():
            m(torch.from_numpy(img).to(dt), torch.from_numpy(hm).to(dt), train=True, dtype=dt)
        sd = {k: v.float() for k, v in m.state_dict().items()}
        return T._flat(torch_to_jax_variables(sd, variables)["batch_stats"])

    p32, p64 = port(torch.float32), port(torch.float64)
    return {"jax_eager_vs_jit": _max_diff(eager, jitted), "port_f32_vs_jax_eager":
            _max_diff(p32, eager), "port_f32_vs_jax_jit": _max_diff(p32, jitted),
            "port_f32_vs_f64": _max_diff(p32, p64)}


def grads(model, variables, b: int) -> dict:
    """Loss gradients on one preprocessed batch (JAX's jitted preprocessing
    of the tests' batch), as fractions of max|g|."""
    jcfg, tcfg = T._cfg()
    batch = {k: v[:b] for k, v in R._pipeline_batch().items()}
    aug = T.jsteps.augment_config(jcfg, train=True)
    rng = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    images, heatmaps, masks = (np.asarray(a) for a in jax.jit(
        lambda x, r: T.jsteps.preprocess_batch(x, r, aug))(jb, rng))
    fwd = T.jsteps.make_fwd(model, jcfg, variables["batch_stats"], train=True)

    def loss(p):
        return T.jsteps.bce_loss(fwd(p, images, heatmaps)[0], masks)

    g_jit = T._flat(jax.jit(jax.grad(loss))(variables["params"]))
    g_eager = T._flat(jax.grad(loss)(variables["params"]))

    def port(dt):
        m = T._port(variables).to(dt)
        feats = m(torch.from_numpy(images).to(dt), torch.from_numpy(heatmaps).to(dt),
                  truncate_head=True, train=True, dtype=dt)
        logits = head_apply(feats, fold_head_live(m), dtype=dt)
        tsteps.bce_loss(logits, torch.from_numpy(masks).to(dt)).backward()
        g = {n: (torch.zeros_like(p) if p.grad is None else p.grad).double()
             for n, p in m.named_parameters()}
        tmpl = {"params": jax.tree_util.tree_map(np.asarray, variables["params"])}
        return T._flat(torch_to_jax_variables(g, tmpl)["params"])

    p32, p64 = port(torch.float32), port(torch.float64)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in p64.values())
    return {"max_abs_g": gmax,
            "jax_jit_vs_eager": _max_diff(g_jit, g_eager) / gmax,
            "port_f32_vs_jax_jit": _max_diff(p32, g_jit) / gmax,
            "jax_jit_vs_port_f64": _max_diff(g_jit, p64) / gmax,
            "port_f32_vs_f64": _max_diff(p32, p64) / gmax}


def main() -> int:
    torch.set_num_threads(1)
    model = T.JaxSegment(in_channels=20)
    variables = _variables(model)
    out = {"probe_kernels": probe_kernels(), "staged_preprocess": staged_preprocess(),
           "bn_stats": bn_stats(model, variables), "grads_b2": grads(model, variables, 2),
           "grads_b4_cut": grads(model, variables, 4)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
