"""The port's polygon fill, RLE codecs and native RLE library against the
JAX package's ``core/rasterize.py`` (whose polygons go through
``cv2.fillPoly``) and ``ops/native`` (CPU)."""
import numpy as np
import pytest

from instancesegmentation_tpu.core import rasterize as JR
from instancesegmentation_tpu.ops.native import build as jnative
from instancesegmentation_tpu_torch.core import rasterize as TR
from instancesegmentation_tpu_torch.ops.native import build as tnative


def _polygon(rng, kind: str, h: int, w: int) -> list:
    """One flat [x0, y0, x1, y1, ...] polygon of the given kind."""
    n = int(rng.integers(3, 24))
    if kind == "convex":
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        c, r = rng.uniform(0.3, 0.7, 2) * [w, h], rng.uniform(0.1, 0.4) * min(h, w)
        p = np.stack([c[0] + r * np.cos(ang) * rng.uniform(0.5, 1.5), c[1] + r * np.sin(ang)], 1)
    elif kind == "concave":  # a star: alternating radii around the centre
        ang = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
        r = np.where(np.arange(2 * n) % 2, 0.15, 0.4) * min(h, w)
        c = rng.uniform(0.35, 0.65, 2) * [w, h]
        p = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)
    elif kind == "self_intersecting":
        p = rng.uniform(0, 1, (n, 2)) * [w, h]
    elif kind == "outside":
        p = rng.uniform(-0.6, 1.6, (n, 2)) * [w, h]
    elif kind == "far_outside":
        p = rng.uniform(-40, 40, (n, 2)) * [w, h]
    else:  # "halves": vertices on half pixels, rounded half to even
        p = np.round(rng.uniform(0, 1, (n, 2)) * [w, h] * 2) / 2
    return p.reshape(-1).tolist()


KINDS = ("convex", "concave", "self_intersecting", "outside", "far_outside", "halves")
CASES = [(kind, seed) for kind in KINDS for seed in range(6)] + [
    ("several", seed) for seed in range(8)] + [("short", seed) for seed in range(4)]


@pytest.mark.parametrize("kind,seed", CASES, ids=[f"{k}-{s}" for k, s in CASES])
def test_polygons_to_mask_bit_equal(kind, seed):
    """``polygons_to_mask`` is ``cv2.fillPoly`` bit for bit: convex, concave,
    self-intersecting (even-odd), several polygons per mask (their overlap
    even-odd too), partly and far outside, on half pixels, and polygons of
    fewer than 6 coordinates (dropped) beside real ones."""
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(20, 120, 2))
    if kind == "several":
        polys = [_polygon(rng, KINDS[int(rng.integers(0, 4))], h, w)
                 for _ in range(int(rng.integers(2, 5)))]
    elif kind == "short":
        polys = [rng.uniform(0, w, int(rng.integers(0, 6))).tolist(),
                 _polygon(rng, "convex", h, w)][: 1 + seed % 2]
    else:
        polys = [_polygon(rng, kind, h, w)]
    got = TR.polygons_to_mask(polys, h, w)
    want = JR.polygons_to_mask(polys, h, w)
    assert got.dtype == np.uint8 and got.shape == (h, w)
    np.testing.assert_array_equal(got, want)


def _masks():
    rng = np.random.default_rng(7)
    h, w = 23, 31
    first = np.zeros((h, w), np.uint8)
    first[0, 0] = 255
    return {
        "random": (rng.random((h, w)) > 0.6).astype(np.uint8) * 255,
        "blobs": TR.polygons_to_mask([_polygon(rng, "concave", h, w)], h, w),
        "empty": np.zeros((h, w), np.uint8),
        "full": np.full((h, w), 255, np.uint8),
        "first_pixel": first,
        "ones_not_255": (rng.random((h, w)) > 0.5).astype(np.uint8),
        "one_column": (rng.random((57, 1)) > 0.5).astype(np.uint8) * 255,
    }


@pytest.mark.parametrize("name", list(_masks()))
def test_rle_codecs_equal_jax(name):
    """Encode, decode, area and the COCO string codec give JAX's values, and
    both string decoders read both packages' strings back."""
    mask = _masks()[name]
    rle = TR.rle_encode(mask)
    assert rle == JR.rle_encode(mask)
    np.testing.assert_array_equal(TR.rle_decode(rle), JR.rle_decode(rle))
    np.testing.assert_array_equal(TR.rle_decode(rle) > 0, mask > 0)
    assert TR.rle_area(rle) == JR.rle_area(rle) == int((mask > 0).sum())
    s = TR.rle_to_string(rle)
    assert s == JR.rle_to_string(rle)
    h, w = mask.shape
    assert TR.rle_from_string(JR.rle_to_string(rle), h, w) == rle
    assert JR.rle_from_string(s, h, w) == rle


def test_rle_strings_with_large_and_negative_deltas():
    """Counts whose deltas against the count two before are large, negative
    and zero (multi-group varints, the sign bit) round-trip through both
    string codecs the same way."""
    counts = [0, 5, 100000, 3, 99990, 3, 1, 4096, 4096, 31, 32, 33, 0]
    rle = {"size": [sum(counts), 1], "counts": counts}
    s = TR.rle_to_string(rle)
    assert s == JR.rle_to_string(rle)
    assert TR.rle_from_string(s, *rle["size"]) == JR.rle_from_string(s, *rle["size"])
    assert TR.rle_from_string(s, *rle["size"])["counts"] == counts


@pytest.mark.parametrize("flavour", ["polygons", "rle_list", "rle_str", "rle_bytes"])
def test_segmentation_to_mask_flavours(flavour):
    """All three COCO ``segmentation`` flavours (and bytes counts) decode as
    in the JAX package."""
    rng = np.random.default_rng(3)
    h, w = 40, 50
    polys = [_polygon(rng, "convex", h, w), _polygon(rng, "concave", h, w)]
    rle = JR.rle_encode(JR.polygons_to_mask(polys, h, w))
    segm = {
        "polygons": polys,
        "rle_list": rle,
        "rle_str": {"size": [h, w], "counts": JR.rle_to_string(rle)},
        "rle_bytes": {"size": [h, w], "counts": JR.rle_to_string(rle).encode("ascii")},
    }[flavour]
    got = TR.segmentation_to_mask(segm, h, w)
    np.testing.assert_array_equal(got, JR.segmentation_to_mask(segm, h, w))
    assert got.any()


def test_rle_iou_equal_jax():
    masks = list(_masks().values())[:6]
    for a in masks:
        for b in masks:
            ra, rb = TR.rle_encode(a), TR.rle_encode(b)
            assert TR.rle_iou(ra, rb) == JR.rle_iou(ra, rb)


# -- the native library --------------------------------------------------


@pytest.fixture(scope="module")
def native():
    """The port's native library (built into build/native/ at first use)."""
    lib = tnative.load_native()
    if lib is None:
        pytest.skip("no C++ compiler: the native RLE library cannot be built")
    return lib


def _random_masks(k=6, h=37, w=53, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w)) > rng.uniform(0.3, 0.9)).astype(np.uint8) * 255
            for _ in range(k)]


def test_native_builds_into_build_dir(native):
    path = tnative.lib_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"


def test_native_encode_decode_match_numpy(native):
    for mask in _random_masks() + [np.zeros((8, 9), np.uint8), np.full((8, 9), 255, np.uint8)]:
        rle = TR.rle_encode(mask)
        assert tnative.rle_encode_native(mask) == rle
        np.testing.assert_array_equal(tnative.rle_decode_native(rle), TR.rle_decode(rle))
    assert tnative.rle_encode_native(np.zeros((8, 9), np.uint8))["counts"] == [72]
    assert tnative.rle_encode_native(np.full((8, 9), 255, np.uint8))["counts"] == [0, 72]


def test_native_iou_matrix_matches_numpy_and_jax(native):
    """The IoU matrix of the native run-merge walk equals the decoded numpy
    IoU (to 1e-12: two divisions of the same integers) and JAX's native
    library bit for bit; both empty gives 1.0."""
    from instancesegmentation_tpu_torch.core.evaluation import mask_iou_matrix

    masks = _random_masks(k=7, seed=2) + [np.zeros((37, 53), np.uint8)] * 2
    rles = [TR.rle_encode(m) for m in masks]
    got = tnative.rle_iou_matrix_native(rles[:4], rles[4:])
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got, mask_iou_matrix(masks[:4], masks[4:]), rtol=0, atol=1e-12)
    if jnative.load_native() is not None:
        np.testing.assert_array_equal(got, jnative.rle_iou_matrix_native(rles[:4], rles[4:]))
    for i in range(4):
        for j in range(5):
            assert got[i, j] == tnative.rle_iou_native(rles[i], rles[4 + j])
    assert tnative.rle_iou_native(rles[-1], rles[-1]) == 1.0
    assert tnative.rle_iou_matrix_native([], rles).shape == (0, len(rles))
