"""The port's evaluation against the JAX package's (CPU): mask AP
(``core/evaluation.py``) exactly, ``make_hard_dataset``'s files bit for bit,
and ``eval.py``'s two protocols on the same datasets and checkpoints."""
import functools
import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu import eval as jeval
from instancesegmentation_tpu.core import evaluation as JE
from instancesegmentation_tpu.core.rasterize import rle_decode as jax_rle_decode
from instancesegmentation_tpu.data.synthetic import make_hard_dataset as jax_make_hard
from instancesegmentation_tpu_torch import eval as teval
from instancesegmentation_tpu_torch.core import evaluation as TE
from instancesegmentation_tpu_torch.core.keys import ORDER_PART_NAMES, key_combine
from instancesegmentation_tpu_torch.core.png import read_png
from instancesegmentation_tpu_torch.core.rasterize import fill_ellipse, rle_decode, rle_encode
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.synthetic import make_hard_dataset, make_synthetic_dataset

torch.set_num_threads(1)
CROSSED_CKPT = os.path.join(os.path.dirname(__file__), "..", "examples", "crossed_demo.ckpt")


def _m(y0, y1, x0, x1, h=40, w=40):
    m = np.zeros((h, w), dtype=np.uint8)
    m[y0:y1, x0:x1] = 255
    return m


# -- mask AP: the hand cases of tests/test_evaluation.py -------------------


def test_iou_matrix():
    gt = [_m(0, 20, 0, 20)]
    pred = [_m(0, 20, 0, 20), _m(0, 20, 10, 30), _m(30, 40, 30, 40)]
    iou = TE.mask_iou_matrix(pred, gt)
    assert iou[0, 0] == pytest.approx(1.0)
    assert iou[1, 0] == pytest.approx(200 / 600)
    assert iou[2, 0] == pytest.approx(0.0)


def test_match_greedy_by_score():
    gt = [_m(0, 20, 0, 20)]
    preds = [_m(0, 20, 0, 20), _m(0, 20, 0, 18)]
    iou = TE.mask_iou_matrix(preds, gt)
    assert TE.match_image(iou, np.asarray([0.3, 0.9]), 0.5).tolist() == [False, True]
    assert TE.match_image(iou, np.asarray([0.9, 0.3]), 0.5).tolist() == [True, False]


def test_average_precision_hand_case():
    # 2 GT; in score order TP, FP, TP: 101-pt envelope 1.0 (51 pts), 2/3 (50)
    ap = TE.average_precision(np.asarray([True, False, True]), np.asarray([0.9, 0.8, 0.7]), 2)
    assert ap == pytest.approx((51 * 1.0 + 50 * (2 / 3)) / 101, abs=1e-9)


def test_perfect_predictions_ap_1():
    gts = [[_m(0, 20, 0, 20)], [_m(5, 25, 5, 25)]]
    preds = [{"masks": [_m(0, 20, 0, 20)], "scores": [0.9]},
             {"masks": [_m(5, 25, 5, 25)], "scores": [0.8]}]
    res = TE.mask_ap(preds, gts)
    assert res["AP"] == res["AP50"] == res["AP75"] == pytest.approx(1.0)


def test_partial_overlap_ap_threshold_behavior():
    gt = [[_m(0, 20, 0, 20)]]
    pred = [{"masks": [_m(0, 20, 0, 13)], "scores": [0.9]}]  # IoU 0.65
    assert 0.5 < TE.mask_iou_matrix(pred[0]["masks"], gt[0])[0, 0] < 0.75
    res = TE.mask_ap(pred, gt)
    assert res["AP50"] == pytest.approx(1.0) and res["AP75"] == pytest.approx(0.0)


def test_no_predictions_and_no_gt():
    assert TE.mask_ap([{"masks": [], "scores": []}], [[_m(0, 10, 0, 10)]])["AP50"] == 0.0
    assert TE.mean_mask_iou([_m(0, 10, 0, 10)], [_m(0, 10, 0, 10)]) == 1.0
    assert np.isnan(TE.average_precision(np.zeros(0, bool), np.zeros(0), 0))


def test_mask_ap_rle_matches_bitmap_ap():
    gts = [[_m(0, 20, 0, 20)], [_m(5, 25, 5, 25), _m(30, 40, 30, 40)]]
    preds = [{"masks": [_m(0, 20, 0, 20), _m(0, 20, 0, 13)], "scores": [0.9, 0.8]},
             {"masks": [_m(5, 25, 5, 25)], "scores": [0.7]}]
    rle = TE.mask_ap_rle(
        [{"masks": [rle_encode(m) for m in p["masks"]], "scores": p["scores"]} for p in preds],
        [[rle_encode(m) for m in g] for g in gts])
    assert rle == TE.mask_ap(preds, gts)


# -- mask AP: seeded random sets, exactly JAX's ----------------------------


def _random_set(seed: int):
    """3-6 images of 0-5 GT ellipses; predictions are GTs moved and resized
    by a few pixels (IoUs across every threshold), dropped GTs, spurious
    masks and empty ones, with scores that tie."""
    rng = np.random.default_rng(seed)
    preds, gts, shapes = [], [], []
    for _ in range(int(rng.integers(3, 7))):
        h, w = (int(v) for v in rng.integers(30, 70, 2))
        shapes.append((h, w))
        g_masks, p_masks = [], []
        for _ in range(int(rng.integers(0, 6))):
            c = (int(rng.integers(5, w - 5)), int(rng.integers(5, h - 5)))
            ax = (int(rng.integers(3, 15)), int(rng.integers(3, 15)))
            g_masks.append(fill_ellipse(np.zeros((h, w), np.uint8), c, ax, rng.uniform(0, 180)))
            if rng.random() < 0.85:
                c2 = (c[0] + int(rng.integers(-3, 4)), c[1] + int(rng.integers(-3, 4)))
                ax2 = (max(1, ax[0] + int(rng.integers(-2, 3))), ax[1])
                p_masks.append(fill_ellipse(np.zeros((h, w), np.uint8), c2, ax2, 0))
        for _ in range(int(rng.integers(0, 3))):
            p_masks.append((rng.random((h, w)) > 0.97).astype(np.uint8) * 255
                           if rng.random() < 0.7 else np.zeros((h, w), np.uint8))
        order = rng.permutation(len(p_masks))
        preds.append({"masks": [p_masks[i] for i in order],
                      "scores": np.round(rng.uniform(0, 1, len(p_masks)), 1).tolist()})
        gts.append(g_masks)
    if not any(gts):  # AP needs at least one GT
        gts[0].append(_m(0, 10, 0, 10, *shapes[0]))
    return preds, gts


@pytest.mark.parametrize("seed", range(6))
def test_mask_ap_equals_jax_on_random_sets(seed, monkeypatch):
    """``mask_ap`` and ``mask_ap_rle`` (native path and numpy path) return
    JAX's dicts exactly; the path counters count one image each; paired
    ``mean_mask_iou`` is JAX's."""
    preds, gts = _random_set(seed)
    want = JE.mask_ap(preds, gts)
    assert TE.mask_ap(preds, gts) == want
    rle_preds = [{"masks": [rle_encode(m) for m in p["masks"]], "scores": p["scores"]}
                 for p in preds]
    rle_gts = [[rle_encode(m) for m in g] for g in gts]
    want_rle = JE.mask_ap_rle(rle_preds, rle_gts)
    assert want_rle == want
    native, numpy_path = TE.mask_ap_rle.native_calls, TE.mask_ap_rle.numpy_calls
    got = TE.mask_ap_rle(rle_preds, rle_gts)
    assert got == want_rle
    assert (TE.mask_ap_rle.native_calls - native) + (TE.mask_ap_rle.numpy_calls - numpy_path) \
        == len(gts)
    monkeypatch.setattr(TE, "rle_iou_matrix_native", lambda *a: None)
    numpy_path = TE.mask_ap_rle.numpy_calls
    assert TE.mask_ap_rle(rle_preds, rle_gts) == want_rle
    assert TE.mask_ap_rle.numpy_calls - numpy_path == len(gts)
    pairs = [(p, g) for pr, gt in zip(preds, gts) for p, g in zip(pr["masks"], gt)]
    assert TE.mean_mask_iou(*zip(*pairs)) == JE.mean_mask_iou(*zip(*pairs))


# -- make_hard_dataset ------------------------------------------------------


K_OBJS = key_combine("object", "sub_list")
K_MASK = key_combine("instance_mask", "mask_path")
K_BOX = key_combine("box", "box_xyxy")
K_BODY = key_combine("body_keypoint", "sub_dict")
K_STATUS = key_combine("status", "keypoint_status")


@pytest.fixture(scope="module")
def hard(tmp_path_factory):
    """The same 12-image 240 x 320 hard set written by the port and by the
    JAX package."""
    root = tmp_path_factory.mktemp("hard")
    make_hard_dataset(str(root / "port"), num_images=12, image_hw=(240, 320), seed=3)
    jax_make_hard(str(root / "jax"), num_images=12, image_hw=(240, 320), seed=3)
    return str(root / "port"), str(root / "jax")


def _anns(root):
    for p in sorted(glob.glob(os.path.join(root, "data", "*.json"))):
        with open(p) as f:
            yield json.load(f)


def test_hard_dataset_files_equal_jax(hard):
    """Same file tree; JSON byte for byte; every PNG decodes (cv2) to the
    same pixels."""
    port, ref = hard
    files = sorted(os.path.relpath(p, port) for p in glob.glob(f"{port}/**/*", recursive=True)
                   if os.path.isfile(p))
    assert files == sorted(os.path.relpath(p, ref)
                           for p in glob.glob(f"{ref}/**/*", recursive=True) if os.path.isfile(p))
    assert sum(f.endswith(".png") for f in files) > 50
    for f in files:
        a, b = os.path.join(port, f), os.path.join(ref, f)
        if f.endswith(".json"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f
        else:
            np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                          cv2.imread(b, cv2.IMREAD_UNCHANGED), err_msg=f)


def test_hard_schema_and_loadable(hard):
    port, _ = hard
    anns = list(_anns(port))
    assert len(anns) == 12
    for ann in anns:
        for obj in ann[K_OBJS]:
            assert os.path.exists(os.path.join(port, obj[K_MASK]))
            x0, y0, x1, y1 = obj[K_BOX]
            assert x1 > x0 and y1 > y0
    ds = InstanceCommonDataset(port, canvas=320)
    assert len(ds) > 0
    assert ds.fetch(0).image.shape == (320, 320, 3)


def test_hard_crowding_occlusion_and_scale_range(hard):
    port, _ = hard
    n_objs, heights, overlapping = [], [], 0
    statuses = {"vis": 0, "not_vis": 0, "missing": 0}
    for ann in _anns(port):
        objs = ann[K_OBJS]
        n_objs.append(len(objs))
        boxes = [o[K_BOX] for o in objs]
        for i in range(len(boxes)):
            for j in range(i + 1, len(boxes)):
                ix = min(boxes[i][2], boxes[j][2]) - max(boxes[i][0], boxes[j][0])
                iy = min(boxes[i][3], boxes[j][3]) - max(boxes[i][1], boxes[j][1])
                overlapping += ix > 0 and iy > 0
        for o in objs:
            heights.append(o[K_BOX][3] - o[K_BOX][1])
            for part in ORDER_PART_NAMES:
                statuses[o[K_BODY][key_combine(part, "sub_dict")][K_STATUS]] += 1
        stack = np.stack([read_png(os.path.join(port, o[K_MASK]), "gray") > 0 for o in objs])
        assert int(stack.sum(0).max()) <= 1, "visible masks must be disjoint"
    assert min(n_objs) >= 2 and max(n_objs) >= 4
    assert overlapping >= len(n_objs)
    assert statuses["vis"] > 0 and statuses["missing"] > 0 and statuses["not_vis"] > 30
    assert max(heights) / max(min(heights), 1) >= 4.0


def test_hard_non_missing_keypoints_are_on_canvas(hard):
    port, _ = hard
    n_checked = 0
    for ann in _anns(port):
        for o in ann[K_OBJS]:
            for part in ORDER_PART_NAMES:
                kp = o[K_BODY][key_combine(part, "sub_dict")]
                if kp[K_STATUS] == "missing":
                    assert key_combine("point", "point_xy") not in kp
                    continue
                x, y = kp[key_combine("point", "point_xy")]
                assert 0 <= x < 320 and 0 <= y < 240
                n_checked += 1
    assert n_checked > 100


# -- eval.py: the full-image protocol --------------------------------------


def _ellipse_from_box(shape_hw, box):
    """The synthetic generator's instance mask (the ellipse inscribed in the
    box with a 2 px margin)."""
    x0, y0, x1, y1 = (int(v) for v in box)
    bw, bh = x1 - x0, y1 - y0
    return fill_ellipse(np.zeros(shape_hw, np.uint8), (x0 + bw // 2, y0 + bh // 2),
                        (bw // 2 - 2, bh // 2 - 2), 0)


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multi"))
    make_synthetic_dataset(root, num_images=3, objects_per_image=3, seed=31)
    return root


def test_full_image_ap_perfect_and_degraded(multi):
    """``_segment_fn`` perfect: AP 1.0 over 9 instances, with each object's
    keypoints delivered beside its box; one top-scored empty mask drops AP.
    Both results equal the JAX package's for the same ``_segment_fn``."""

    def perfect(image, boxes, scores, keypoints):
        assert keypoints is not None and keypoints.shape == (len(boxes), 17, 3)
        assert (keypoints[..., 2] > 0.5).all()
        return [{"mask": _ellipse_from_box(image.shape[:2], b), "mask_score": 0.9}
                for b in boxes]

    def one_bad(image, boxes, scores, keypoints):
        out = perfect(image, boxes, scores, keypoints)
        out[0]["mask"] = np.zeros(image.shape[:2], np.uint8)
        out[0]["mask_score"] = 0.99
        return out

    res = teval.evaluate_full_image(multi, _segment_fn=perfect)
    assert (res["num_images"], res["num_gt_instances"], res["num_predictions"]) == (3, 9, 9)
    assert res["AP"] == pytest.approx(1.0)
    assert res == jeval.evaluate_full_image(multi, _segment_fn=perfect)
    bad = teval.evaluate_full_image(multi, _segment_fn=one_bad)
    assert bad["AP"] < res["AP"] - 0.05
    assert bad == jeval.evaluate_full_image(multi, _segment_fn=one_bad)


def test_full_image_with_proposals_file(multi, tmp_path):
    """``--proposals`` entries by image name or file name, with keypoints, an
    image without an entry (zero predictions, its GTs missed), and
    ``max_images``: the same dict as the JAX package's."""
    anns = list(_anns(multi))
    props = {}
    for k, ann in enumerate(anns[:2]):
        name = os.path.basename(ann[key_combine("image", "image_path")])
        boxes = [o[K_BOX] for o in ann[K_OBJS]]
        props[name if k else os.path.splitext(name)[0]] = {
            "boxes": boxes, "scores": [0.9, 0.5, 0.7][:len(boxes)],
            "keypoints": np.zeros((len(boxes), 17, 3)).tolist()}
    path = tmp_path / "props.json"
    path.write_text(json.dumps(props))
    seen = []

    def seg(image, boxes, scores, keypoints):
        seen.append(keypoints is not None)
        return [{"mask": _ellipse_from_box(image.shape[:2], b), "mask_score": float(s)}
                for b, s in zip(boxes, scores)]

    for kw in ({}, {"max_images": 2}, {"use_keypoints": False}):
        got = teval.evaluate_full_image(multi, proposals_path=str(path), _segment_fn=seg, **kw)
        assert got == jeval.evaluate_full_image(multi, proposals_path=str(path),
                                                _segment_fn=seg, **kw)
    assert got["num_predictions"] == 6 and got["num_gt_instances"] == 9
    assert seen[:2] == [True, True] and seen[-1] is False


def test_unported_options_raise(crossed, capsys):
    """Both options, once refused, run.  ``fused_stem`` (the keypoint-patch
    stem) on the crossed pairs: the full-image protocol gives the dict of
    JAX's run with the dense stem, APs included (AP 1.0; the engines'
    fused stems are held against each other in
    ``test_torch_port_fused_stem.py``), the per-crop protocol the dense
    stem's mean IoU within 1e-3, and ``main --fused-stem`` prints the
    library's dict.  ``int8`` (calibrated on the evaluated set): the
    full-image protocol gives JAX's int8 run's dict."""
    common = dict(checkpoint=CROSSED_CKPT, size=256, in_channels=20, bfloat16=False, canvas=320)
    port = teval.evaluate_full_image(crossed, fused_stem=True, device="cpu", **common)
    assert port == jeval.evaluate_full_image(crossed, **common)
    assert port["num_predictions"] == port["num_gt_instances"] == 4 and port["AP"] == 1.0
    kw = dict(checkpoint=CROSSED_CKPT, size=256, batch_size=3, in_channels=20, bfloat16=False)
    crop = teval.evaluate_dataset(crossed, fused_stem=True, device="cpu", **kw)
    ref = teval.evaluate_dataset(crossed, device="cpu", **kw)
    assert crop["num_instances"] == ref["num_instances"] == 4
    assert crop["mean_iou"] == pytest.approx(ref["mean_iou"], abs=1e-3)
    capsys.readouterr()
    assert teval.main(["--dataset", crossed, "--checkpoint", CROSSED_CKPT, "--size", "256",
                       "--canvas", "320", "--float32", "--full-image", "--fused-stem"],
                      device="cpu") == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == port
    port = teval.evaluate_full_image(crossed, device="cpu", int8=True, **common)
    assert port == jeval.evaluate_full_image(crossed, int8=True, **common)
    assert port["num_predictions"] == port["num_gt_instances"] == 4 and port["AP"] > 0.5


def test_default_device_is_the_card(multi):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval.main(["--dataset", multi, "--size", "64", "--in-channels", "3"])


def _capture(monkeypatch, module, name):
    """Wrap ``module.name`` (mask AP) to record its inputs."""
    seen = []
    fn = getattr(module, name)

    def wrapped(preds, gts, *a, **k):
        seen.append((preds, gts))
        return fn(preds, gts, *a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """2 crossed-pair images (seed 301), and the JAX package's engine built
    once per argument set for this module's evaluations."""
    d = str(tmp_path_factory.mktemp("crossed"))
    make_synthetic_dataset(d, num_images=2, seed=301, crossed_pairs=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeval, "_build_engine", functools.lru_cache(maxsize=None)(jeval._build_engine))
        yield d


def test_crossed_pairs_through_both_packages(crossed, monkeypatch):
    """``examples/crossed_demo.ckpt`` on the crossed pairs at size 256,
    float32, conditioned and not: equal counts and APs, each predicted mask
    ≥ 99.9 % equal to JAX's and its mask score within 1e-4; the two
    instances sharing one box are both kept."""
    port_seen = _capture(monkeypatch, teval, "mask_ap_rle")
    jax_seen = _capture(monkeypatch, JE, "mask_ap_rle")
    common = dict(checkpoint=CROSSED_CKPT, size=256, in_channels=20, bfloat16=False, canvas=320)
    results = {}
    for cond in (True, False):
        port = teval.evaluate_full_image(crossed, use_keypoints=cond, device="cpu", **common)
        ref = jeval.evaluate_full_image(crossed, use_keypoints=cond, **common)
        assert port == ref
        assert port["num_predictions"] == port["num_gt_instances"] == 4
        results[cond] = port
    assert results[True]["AP"] == 1.0 and results[True]["AP75"] > results[False]["AP75"] + 0.5
    assert len(port_seen) == len(jax_seen) == 2
    for (p_preds, p_gts), (j_preds, j_gts) in zip(port_seen, jax_seen):
        assert p_gts == j_gts
        for p, j in zip(p_preds, j_preds):
            assert len(p["masks"]) == len(j["masks"])
            np.testing.assert_allclose(p["scores"], j["scores"], rtol=0, atol=1e-4)
            for pm, jm in zip(p["masks"], j["masks"]):
                assert (rle_decode(pm) == jax_rle_decode(jm)).mean() >= 0.999


# -- eval.py: the per-crop protocol ----------------------------------------


def test_per_crop_evaluate_dataset_matches_jax(crossed):
    """The per-crop protocol on the same checkpoint (flax variables in an
    ISEG file) over the crossed pairs' 4 instances at batch 3 (the tail
    batch's 2 repeats dropped): the same instance count and keys, mean IoU
    within 1e-3 of JAX's."""
    kw = dict(checkpoint=CROSSED_CKPT, size=256, batch_size=3, in_channels=20, bfloat16=False)
    port = teval.evaluate_dataset(crossed, device="cpu", **kw)
    ref = jeval.evaluate_dataset(crossed, **kw)
    assert port.keys() == ref.keys()
    assert port["num_instances"] == ref["num_instances"] == 4
    assert port["mean_iou"] == pytest.approx(ref["mean_iou"], abs=1e-3)
    assert port["mean_iou"] > 0.9
    assert {k: port[k] for k in ("protocol", "confidence", "ap_note")} == \
        {k: ref[k] for k in ("protocol", "confidence", "ap_note")}
