"""The proposal-serving path end to end: the port's ``segment_proposals`` and
``iter_segment_proposals`` against the JAX ones on the same carried-over
weights (f32, CPU), and the packing of crops across images."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.infer import proposals as jprop
from instancesegmentation_tpu.infer.pipeline import InferenceEngine as JaxEngine
from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu_torch.infer import proposals as tprop
from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
from instancesegmentation_tpu_torch.ops import nms as tnms

torch.set_num_threads(1)
SIZE = 64
CANVAS = 128


@functools.lru_cache(maxsize=None)
def _variables(c, seed):
    """Flax-initialised Segment variables with random running stats and
    PReLU slopes, as numpy (read-only: shared between the fixtures)."""
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


@pytest.fixture(scope="module", params=[3, 20], ids=["c3", "c20"])
def engines(request):
    c = request.param
    v = _variables(c, c)
    return (InferenceEngine(v, in_channels=c, size=SIZE, dtype=torch.float32, device="cpu"),
            JaxEngine(v, in_channels=c, size=SIZE, dtype=jnp.float32))


def _request(rng, h, w, persons=2, copies=3):
    """An image with ``persons`` boxes, each proposed ``copies`` times with
    jitter, random scores and 17 keypoints inside each box."""
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    boxes, kps = [], []
    for _ in range(persons):
        x0, y0 = rng.uniform(0, 0.5 * w), rng.uniform(0, 0.5 * h)
        base = np.array([x0, y0, x0 + rng.uniform(0.3, 0.5) * w,
                         y0 + rng.uniform(0.3, 0.5) * h])
        for _ in range(copies):
            b = base + rng.normal(0, 0.02 * min(h, w), 4)
            boxes.append(b)
            pts = rng.uniform(b[:2], b[2:], (17, 2))
            kps.append(np.concatenate([pts, (rng.uniform(size=(17, 1)) > 0.2)], 1))
    return {"image": img, "boxes": np.asarray(boxes, np.float32),
            "scores": rng.uniform(0.1, 1.0, len(boxes)).astype(np.float32),
            "keypoints": np.asarray(kps, np.float32)}


def _assert_same(port, ref, hw):
    """Same boxes in the same order; masks and scores within the same limits
    whether the image fits the canvas or is placed through the uint8
    bilinear resize (cv2's arithmetic on both sides)."""
    assert [r["box"] for r in port] == [r["box"] for r in ref]
    assert [r["score"] for r in port] == pytest.approx([r["score"] for r in ref])
    for p, j in zip(port, ref):
        assert p["mask"].shape == j["mask"].shape == hw and p["mask"].dtype == np.uint8
        assert set(np.unique(p["mask"])) <= {0, 255}
        assert (p["mask"] == j["mask"]).mean() >= 0.999
        assert abs(p["mask_score"] - j["mask_score"]) <= 1e-4


@pytest.mark.parametrize("hw", [(100, 120), (160, 200)], ids=["fits", "larger"])
def test_segment_proposals_matches_jax(engines, hw):
    port, ref = engines
    req = _request(np.random.default_rng(hw[0]), *hw)
    kw = dict(nms_threshold=0.5, max_instances=4, canvas=CANVAS)
    before = tnms.nms.launches
    got = tprop.segment_proposals(port, req["image"], req["boxes"], req["scores"],
                                  req["keypoints"], **kw)
    assert tnms.nms.launches == before  # CPU engine: the plain NMS
    want = jprop.segment_proposals(ref, req["image"], req["boxes"], req["scores"],
                                   req["keypoints"], **kw)
    assert len(got) >= 1
    _assert_same(got, want, hw)


def test_iter_segment_proposals_matches_jax(engines):
    port, ref = engines
    rng = np.random.default_rng(11)
    reqs = [_request(rng, 90 + 7 * i, 110 - 5 * i) for i in range(3)]
    reqs.insert(1, {"image": np.zeros((50, 60, 3), np.uint8), "boxes": [], "scores": []})
    kw = dict(nms_threshold=0.6, max_instances=3, canvas=CANVAS, batch_cap=4)
    got = list(tprop.iter_segment_proposals(port, reqs, **kw))
    want = list(jprop.iter_segment_proposals(ref, reqs, **kw))
    assert len(got) == len(want) == 4 and got[1] == want[1] == []
    for g, w, r in zip(got, want, reqs):
        _assert_same(g, w, np.asarray(r["image"]).shape[:2])


@pytest.fixture(scope="module")
def port3():
    """A port engine on the CPU alone, for the tests of the packing rules."""
    return InferenceEngine(_variables(3, 3), in_channels=3, size=SIZE, dtype=torch.float32,
                           device="cpu")


def test_segment_proposals_suppresses_near_duplicate(port3):
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, size=(120, 160, 3), dtype=np.uint8)
    boxes = [[10, 10, 70, 90], [12, 12, 72, 92], [90, 20, 150, 100]]  # A, A', B
    results = tprop.segment_proposals(port3, image, boxes, [0.9, 0.8, 0.7],
                                      nms_threshold=0.5, canvas=192)
    assert [r["box"] for r in results] == [boxes[0], boxes[2]]
    for r in results:
        assert r["mask"].shape == (120, 160) and r["mask"].dtype == np.uint8
        assert set(np.unique(r["mask"])) <= {0, 255}
        assert 0.0 <= r["mask_score"] <= 1.0
    assert tprop.segment_proposals(port3, np.zeros((50, 50, 3), np.uint8), [], []) == []


def test_iter_segment_proposals_packs_across_images(port3, monkeypatch):
    """12 crops at batch_cap 8 go out in 2 dispatches, not 6, and each
    image's results equal the single-image API's."""
    calls = []
    orig = InferenceEngine.predict_instances

    def spy(self, batch):
        calls.append(batch["image"].shape[0])
        return orig(self, batch)

    rng = np.random.default_rng(5)
    reqs = [{"image": rng.integers(0, 255, size=(60, 70, 3), dtype=np.uint8),
             "boxes": [[5, 5, 40, 50], [20, 8, 60, 55]], "scores": [0.9, 0.8]}
            for _ in range(6)]
    monkeypatch.setattr(InferenceEngine, "predict_instances", spy)
    batched = list(tprop.iter_segment_proposals(port3, reqs, nms_threshold=0.95,
                                                canvas=96, batch_cap=8))
    monkeypatch.setattr(InferenceEngine, "predict_instances", orig)
    assert len(batched) == 6
    assert calls == [8, 4], calls
    solo = tprop.segment_proposals(port3, reqs[3]["image"], reqs[3]["boxes"],
                                   reqs[3]["scores"], nms_threshold=0.95, canvas=96)
    assert len(solo) == len(batched[3]) == 2
    for a, b in zip(solo, batched[3]):
        assert a["box"] == b["box"]
        np.testing.assert_array_equal(a["mask"], b["mask"])
        assert a["mask_score"] == pytest.approx(b["mask_score"])


def test_ground_truth_boxes_are_not_suppressed(port3, capsys):
    """``"nms": False``: identical boxes are distinct instances, taken in
    input order up to max_instances, with the cap reported."""
    image = np.random.default_rng(3).integers(0, 255, (80, 90, 3), dtype=np.uint8)
    box = [10.0, 12.0, 60.0, 70.0]
    req = {"image": image, "boxes": [box] * 3 + [[1.0, 2.0, 30.0, 40.0]],
           "scores": [0.1, 0.9, 0.5, 0.7], "nms": False}
    (out,) = tprop.iter_segment_proposals(port3, [req], max_instances=3, canvas=96)
    assert [r["box"] for r in out] == [box] * 3
    assert [r["score"] for r in out] == pytest.approx([0.1, 0.9, 0.5])
    assert "max_instances=3 cap hit (4 GT boxes in)" in capsys.readouterr().out
    (out,) = tprop.iter_segment_proposals(port3, [dict(req, nms=True)], max_instances=3,
                                          canvas=96)
    assert len(out) == 2  # with NMS the three copies are one instance


def test_nms_cap_is_reported(port3, capsys):
    rng = np.random.default_rng(4)
    boxes = [[i * 10.0, 0.0, i * 10.0 + 8.0, 8.0] for i in range(6)]  # disjoint
    keep = tprop._nms_keep(np.asarray(boxes, np.float32),
                           rng.uniform(size=6).astype(np.float32), 0.5, 4, port3.device)
    assert len(keep) == 4
    assert "max_instances=4 cap hit (6 proposals in)" in capsys.readouterr().out
    keep = tprop._nms_keep(np.asarray(boxes, np.float32)[:3], np.ones(3, np.float32), 0.5, 4,
                           port3.device)
    assert keep.tolist() == [0, 1, 2]
    assert capsys.readouterr().out == ""
