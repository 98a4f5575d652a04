"""The slice end to end: the port's InferenceEngine and ServingFrontend
against the JAX engine and frontend on the same carried-over weights (f32,
CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.infer.pipeline import InferenceEngine as JaxEngine
from instancesegmentation_tpu.infer.server import ServingFrontend as JaxFrontend
from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch
from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine, to_u8
from instancesegmentation_tpu_torch.infer.server import ServingFrontend
from instancesegmentation_tpu.data.synthetic import (
    synthetic_host_batch as jax_synthetic_host_batch,
)

torch.set_num_threads(1)
SIZE = 64
CANVAS = 128


def _variables(c, seed):
    """Flax-initialised Segment variables with random running stats and
    PReLU slopes, as numpy."""
    model = JaxSegment(in_channels=c)
    args = [jnp.zeros((1, SIZE, SIZE, 3))]
    if c > 3:
        args.append(jnp.zeros((1, SIZE, SIZE, c - 3)))
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(seed), *args, train=False)
    rng = np.random.default_rng(seed)

    def f(path, v):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("mean"):
            return rng.normal(0, 0.3, v.shape).astype(np.float32)
        if name.endswith("var"):
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        if name.endswith("alpha"):
            return rng.uniform(0.05, 0.45, v.shape).astype(np.float32)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(f, dict(variables))


@pytest.fixture(scope="module")
def engines20():
    v = _variables(20, 0)
    return (InferenceEngine(v, in_channels=20, size=SIZE, dtype=torch.float32,
                            device="cpu"),
            JaxEngine(v, in_channels=20, size=SIZE, dtype=jnp.float32))


@pytest.fixture(scope="module")
def engines3():
    v = _variables(3, 1)
    return (InferenceEngine(v, in_channels=3, size=SIZE, dtype=torch.float32,
                            device="cpu"),
            JaxEngine(v, in_channels=3, size=SIZE, dtype=jnp.float32))


def test_synthetic_host_batch_is_the_jax_one():
    a, b = synthetic_host_batch(2, 64, seed=4), jax_synthetic_host_batch(2, 64, seed=4)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_predict_instances_matches_jax(engines20):
    port, ref = engines20
    batch = synthetic_host_batch(3, CANVAS)
    probs, masks = port.predict_instances(batch)
    jprobs, jmasks = ref.predict_instances(batch)
    assert probs.shape == jprobs.shape == (3, SIZE, SIZE, 1)
    assert masks.shape == jmasks.shape == (3, CANVAS, CANVAS)
    assert masks.dtype == np.uint8
    np.testing.assert_allclose(probs, jprobs, atol=1e-4)
    assert (masks == jmasks).mean() >= 0.999


def test_predict_images_matches_jax(engines3):
    port, ref = engines3
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 255, (40 + 9 * i, 70 - 7 * i, 3), dtype=np.uint8)
              for i in range(3)]
    # the programs on one resized batch: probabilities before the resize back
    batch = np.stack([to_u8(torch.nn.functional.interpolate(
        torch.from_numpy(im).permute(2, 0, 1)[None].float(), size=(SIZE, SIZE),
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0)).numpy()
        for im in images])
    with torch.inference_mode():
        probs = port._forward_whole(torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(probs, np.asarray(ref._forward_whole(jnp.asarray(batch))),
                               atol=1e-4)
    # end to end: the JAX engine resizes with cv2, whose uint8 bilinear
    # rounds its fixed-point blend (inputs differ by up to 1) and whose
    # float resize of the maps differs by float rounding, so a few
    # pixels near the threshold may flip
    masks, jmasks = port.predict_images(images), ref.predict_images(images)
    for m, jm, im in zip(masks, jmasks, images):
        assert m.shape == jm.shape == im.shape[:2] and m.dtype == np.uint8
        assert (m == jm).mean() >= 0.99


def test_serving_frontend_matches_jax(engines20):
    port, ref = engines20
    rng = np.random.default_rng(6)
    requests = []
    for h, w in [(100, 120), (90, 128), (160, 200)]:  # the last exceeds the canvas
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        box = [w * 0.2, h * 0.15, w * 0.8, h * 0.9]
        kps = np.concatenate([rng.uniform(0.2, 0.8, (17, 2)) * [w, h],
                              np.ones((17, 1))], 1)
        requests.append((img, box, kps))
    images = [rng.integers(0, 255, (50, 60, 3), dtype=np.uint8) for _ in range(2)]
    results = {}
    for name, engine, frontend in (("port", port, ServingFrontend),
                                   ("jax", ref, JaxFrontend)):
        with frontend(engine, max_batch=8, max_delay_ms=50.0, canvas=CANVAS) as fe:
            inst = [fe.submit_instance(*r) for r in requests]
            whole = [fe.submit(im) for im in images]
            results[name] = ([f.result(timeout=120) for f in inst],
                             [f.result(timeout=120) for f in whole])
    (p_inst, p_whole), (j_inst, j_whole) = results["port"], results["jax"]
    for i, (p, j) in enumerate(zip(p_inst, j_inst)):
        assert p["mask"].shape == j["mask"].shape == requests[i][0].shape[:2]
        # requests that fit the canvas see identical inputs; the one placed
        # through the uint8 bilinear resize differs from cv2 by up to 1
        agree = 0.999 if i < 2 else 0.99
        assert (p["mask"] == j["mask"]).mean() >= agree
        assert abs(p["mask_score"] - j["mask_score"]) <= (1e-4 if i < 2 else 1e-2)
    for p, j in zip(p_whole, j_whole):
        assert p.shape == j.shape and (p == j).mean() >= 0.99


def test_engine_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("the rule concerns hosts without CUDA")
    with pytest.raises(RuntimeError):
        InferenceEngine({}, in_channels=3, size=SIZE)
