"""The port's record augmentation, debug and profiling helpers against the
JAX package (CPU): ``core/augment.py`` (``Affine``, ``common_aug``, the
warp bit-equal to ``cv2.warpAffine``), ``utils/debug.py`` (``check``,
``model_summary``) and ``utils/profiling.py`` (``trace``, ``StepTimer``,
``time_fn``).  Mirrors ``tests/test_augment_debug_proposals.py``."""
import copy
import json
import os
import time
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.core import augment as jaug
from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu.utils import debug as jdebug
from instancesegmentation_tpu_torch.core import augment as taug
from instancesegmentation_tpu_torch.core.keys import key_combine
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.utils import debug as tdebug
from instancesegmentation_tpu_torch.utils import profiling
from instancesegmentation_tpu_torch.utils.weights import flax_to_torch_key

torch.set_num_threads(1)


def _cv2(image, matrix, out_hw):
    return cv2.warpAffine(image, np.asarray(matrix, np.float32), (out_hw[1], out_hw[0]),
                          flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT, borderValue=0)


def _transforms(rng, hw):
    """(name, port Affine, JAX Affine) over translations (whole and
    sub-pixel), crops and resizes (in and out of the canvas), flips,
    rotations, sub-pixel scales and compositions."""
    h, w = hw
    specs = [
        ("identity", "identity", (hw,)),
        ("translate", "translate", (int(rng.integers(-9, 9)), int(rng.integers(-9, 9)), hw)),
        ("translate_subpixel", "translate", (float(rng.uniform(-5, 5)),
                                             float(rng.uniform(-5, 5)), hw)),
        ("crop_resize_up", "crop_resize", ([w * 0.1, h * 0.2, w * 0.7, h * 0.9],
                                           (int(h * 1.5), int(w * 1.3)))),
        ("crop_resize_down", "crop_resize", ([0, 0, w, h], (h // 2 + 3, w // 3 + 1))),
        ("crop_pad", "crop_resize", ([-w * 0.3, -h * 0.1, w * 1.2, h * 1.4], (h, w))),
        ("hflip", "hflip", (hw,)),
        ("rotate", "rotate", (float(rng.uniform(-30, 30)), hw)),
        ("rotate_subdegree", "rotate", (float(rng.uniform(-0.9, 0.9)), hw)),
        ("scale_subpixel", "crop_resize", ([0.37, 0.61, w - 0.29, h - 0.83], hw)),
    ]
    out = [(name, getattr(taug.Affine, ctor)(*args), getattr(jaug.Affine, ctor)(*args))
           for name, ctor, args in specs]
    rot = float(rng.uniform(-25, 25))
    window = [float(rng.uniform(-20, 10)), float(rng.uniform(-20, 10)), w + 7.5, h - 3.25]
    out.append(("rotate_flip_crop",
                taug.Affine.rotate(rot, hw).then(taug.Affine.hflip(hw))
                .then(taug.Affine.crop_resize(window, (61, 47))),
                jaug.Affine.rotate(rot, hw).then(jaug.Affine.hflip(hw))
                .then(jaug.Affine.crop_resize(window, (61, 47)))))
    return out


def _images(rng, hw):
    h, w = hw
    return {"u8_rgb": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "u8_gray": rng.integers(0, 256, (h, w), dtype=np.uint8),
            "u8_hw1": rng.integers(0, 256, (h, w, 1), dtype=np.uint8),
            "mask": (rng.random((h, w)) > 0.6).astype(np.uint8) * 255,
            "f32_rgb": rng.uniform(-3, 300, (h, w, 3)).astype(np.float32),
            "u16_gray": rng.integers(0, 65536, (h, w), dtype=np.uint16)}


@pytest.mark.parametrize("seed,hw", [(0, (37, 53)), (1, (64, 48)), (2, (120, 161))])
def test_apply_image_bit_equal_to_cv2(seed, hw):
    """Every transform, every image form: the port's warp equals
    ``cv2.warpAffine`` (what JAX's ``apply_image`` calls) bit for bit, and
    JAX's ``apply_image``; the matrices equal JAX's."""
    rng = np.random.default_rng(seed)
    images = _images(rng, hw)
    for name, t, j in _transforms(rng, hw):
        np.testing.assert_array_equal(t.matrix, j.matrix, err_msg=name)
        assert t.out_hw == j.out_hw
        for kind, img in images.items():
            got = t.apply_image(img)
            want = _cv2(img, t.matrix, t.out_hw)
            assert got.shape == want.shape and got.dtype == want.dtype, (name, kind)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {kind}")
            if kind in ("u8_rgb", "mask"):
                np.testing.assert_array_equal(got, j.apply_image(img), err_msg=f"{name} {kind}")


def test_warp_affine_random_matrices_bit_equal_to_cv2():
    """Seeded random rotations, scales and shears at odd sizes, both sides
    of the 16-pixel blocks the cv2 kernel runs in SIMD."""
    rng = np.random.default_rng(7)
    for i in range(60):
        h, w = (int(v) for v in rng.integers(3, 70, 2))
        out_hw = tuple(int(v) for v in rng.integers(1, 90, 2))
        th, s = rng.uniform(-3.2, 3.2), rng.uniform(0.3, 3.0)
        m = np.array([[np.cos(th) * s, -np.sin(th) * s + rng.uniform(-0.2, 0.2),
                       rng.uniform(-30, 30)],
                      [np.sin(th) * s, np.cos(th) * s, rng.uniform(-30, 30)]])
        img = rng.integers(0, 256, (h, w, 3) if i % 2 else (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(taug.warp_affine(img, m, out_hw), _cv2(img, m, out_hw))
        flt = rng.uniform(0, 1, (h, w)).astype(np.float32)
        np.testing.assert_array_equal(taug.warp_affine(flt, m, out_hw), _cv2(flt, m, out_hw))


def test_warp_affine_refuses_other_forms():
    """The forms cv2 sends through another path: 2 channels, float64."""
    m = np.eye(2, 3)
    with pytest.raises(ValueError, match="1\\|3\\|4"):
        taug.warp_affine(np.zeros((4, 4, 2), np.uint8), m, (4, 4))
    with pytest.raises(ValueError, match="float64"):
        taug.warp_affine(np.zeros((4, 4)), m, (4, 4))


def test_points_boxes_and_composition_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-10, 60, (17, 2))
    box = [3.5, 4.25, 40.0, 51.5]
    for name, t, j in _transforms(rng, (50, 60)):
        np.testing.assert_array_equal(t.apply_points(pts), j.apply_points(pts), err_msg=name)
        assert t.apply_box(box) == j.apply_box(box), name
    # the JAX package's hand cases
    t = taug.Affine.translate(2, 1, (10, 12))
    np.testing.assert_allclose(t.apply_points([[3, 2]]), [[5, 3]])
    assert t.apply_box([3, 2, 5, 4]) == [5.0, 3.0, 7.0, 5.0]
    a = taug.Affine.crop_resize([2, 2, 8, 8], (12, 12))
    np.testing.assert_allclose(a.apply_points([[2, 2], [8, 8]]), [[0, 0], [12, 12]])
    np.testing.assert_allclose(taug.Affine.translate(1, 0, (10, 10)).then(a)
                               .apply_points([[1, 2]]), [[0, 0]])
    f = taug.Affine.hflip((4, 6))
    assert f.apply_box([1, 0, 3, 2]) == [3.0, 0.0, 5.0, 2.0]


def _record(rng):
    img = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
    objs = []
    for k in range(2):
        mask = np.zeros((40, 52), np.uint8)
        mask[5 + k * 10:20 + k * 10, 6:30] = 255
        kps = {key_combine(part, "sub_dict"): {
            key_combine("point", "point_xy"): [float(v) for v in rng.uniform(0, 50, 2)],
            key_combine("status", "keypoint_status"): "vis"} for part in ("nose", "left_eye")}
        objs.append({key_combine("instance_mask", "mask"): mask,
                     key_combine("instance_mask", "mask_path"): f"m/{k}.png",
                     key_combine("box", "box_xyxy"): [6.0, 5.0 + k * 10, 30.0, 20.0 + k * 10],
                     key_combine("body_keypoint", "sub_dict"): kps})
    return {key_combine("image", "image"): img, key_combine("object", "sub_list"): objs,
            key_combine("image", "image_path"): "img/a.png"}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list) and a and isinstance(a[0], dict):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_common_aug_matches_jax():
    """The whole record (image, masks, boxes, keypoints in sub-dicts, path
    entries untouched) equal to JAX's ``common_aug`` after each transform."""
    rng = np.random.default_rng(4)
    rec = _record(rng)
    for name, t, j in _transforms(rng, (40, 52)):
        port, ref = copy.deepcopy(rec), copy.deepcopy(rec)
        taug.common_aug(port, t)
        jaug.common_aug(ref, j)
        _assert_same(port, ref)
    port = copy.deepcopy(rec)
    taug.common_aug(port, taug.Affine.translate(3, 2, (40, 52)))
    obj = port[key_combine("object", "sub_list")][0]
    assert obj[key_combine("box", "box_xyxy")] == [9.0, 7.0, 33.0, 22.0]
    assert obj[key_combine("instance_mask", "mask_path")] == "m/0.png"


# -- utils/debug.py -----------------------------------------------------------------------

def test_check_matches_jax(capsys):
    """The same line as JAX's ``check`` for a numpy array and for a float32
    tensor of it (JAX's ``tests/test_augment_debug_proposals.py:77``)."""
    arr = np.asarray([1.0, 2.0, np.nan])
    line = tdebug.check(arr, "x")
    assert line == jdebug.check(arr, "x")
    assert "nonfinite=1" in line and "shape=(3,)" in line
    rng = np.random.default_rng(5)
    a32 = rng.normal(0, 3, (4, 5, 6)).astype(np.float32)
    assert tdebug.check(torch.from_numpy(a32), "t") == jdebug.check(jnp.asarray(a32), "t")
    line = tdebug.check(torch.from_numpy(a32).bfloat16(), "b")
    assert "dtype=bfloat16" in line and "shape=(4, 5, 6)" in line
    assert capsys.readouterr().out.count("\n") == 5


def _table(text: str) -> dict:
    rows = [line.rsplit(None, 1) for line in text.splitlines()[1:]]
    return {name.strip(): int(n.replace(",", "")) for name, n in rows}


def test_model_summary_matches_jax():
    """JAX's hand case, and ``Segment(20)`` by module, by state dict and by
    JAX's parameter tree: the groups (JAX's names mapped through
    ``flax_to_torch_key``) and the total equal JAX's; buffers not counted."""
    assert _table(tdebug.model_summary({"layer1.kernel": np.zeros((3, 4)),
                                        "layer2.b": np.zeros(5)})) == \
        _table(jdebug.model_summary({"layer1": {"kernel": np.zeros((3, 4))},
                                     "layer2": {"b": np.zeros(5)}}))
    params = jax.eval_shape(lambda: JaxSegment(in_channels=20).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 17)),
        train=False))["params"]
    want = _table(jdebug.model_summary(params))
    mapped: dict = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key, _ = flax_to_torch_key(tuple(k.key for k in path), "params")
        group = key.split(".")[0]
        mapped[group] = mapped.get(group, 0) + int(np.prod(leaf.shape))
    model = Segment(20)
    for source in (model, model.state_dict()):
        got = _table(tdebug.model_summary(source))
        assert got.pop("TOTAL") == want["TOTAL"] == sum(p.numel() for p in model.parameters())
        assert got == mapped
    deep = _table(tdebug.model_summary(model, max_depth=2))
    assert deep["init_conv.layer1"] == 20 * 16 * 25 + 16 + 2 * 16 + 16


# -- utils/profiling.py -------------------------------------------------------------------

def test_step_timer_and_time_fn(monkeypatch):
    """``StepTimer`` as JAX's on a fake clock; ``time_fn`` runs warm-up and
    timed calls through results nested in a dict, a tuple and a list."""
    clock = iter([10.0, 10.5, 11.5, 11.75])
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    timer = profiling.StepTimer(ema=0.5)
    assert timer.tick() is None and timer.images_per_sec(8) is None
    assert timer.tick() == 0.5 and timer.images_per_sec(8) == 16.0
    assert timer.tick() == 0.5 * 0.5 + 0.5 * 1.0
    assert timer.tick() == 0.5 * 0.75 + 0.5 * 0.25
    monkeypatch.undo()
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.002)
        return {"y": (x * 2, [x])}

    t = profiling.time_fn(fn, torch.ones(3), iters=5, warmup=2)
    assert len(calls) == 7 and 0.002 <= t < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` on the CPU: a Chrome trace of the block, numbered."""
    for _ in range(2):
        with profiling.trace(str(tmp_path)):
            torch.nn.functional.conv2d(torch.ones(1, 3, 16, 16), torch.ones(4, 3, 3, 3))
    files = sorted(os.listdir(tmp_path))
    assert files == ["trace0000.pt.trace.json", "trace0001.pt.trace.json"]
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
