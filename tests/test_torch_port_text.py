"""The port's text (``core/text.py``, ``core/visualize.py:draw_label``,
``draw_keypoint(labeled=True)``) against the JAX package's, which calls
``cv2.putText`` (cv2 5.0: TrueType Rubik), and the port's ``show_aug`` tool
against ``tools/show_aug.py``.  Every label case is bit-equal, and so is
the drawing of every code point in Rubik's cmap (ROADMAP C7, repaired)."""
import gzip
import math
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.core import visualize as jvis
from instancesegmentation_tpu.core.keys import key_combine
from instancesegmentation_tpu.data.synthetic import make_synthetic_dataset
from instancesegmentation_tpu_torch.core import text
from instancesegmentation_tpu_torch.core import visualize as tvis
from instancesegmentation_tpu_torch.ops.native.build import build_library
from instancesegmentation_tpu_torch.tools import show_aug as tshow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import show_aug as jshow  # noqa: E402

COCO_NAMES = ("nose", "left_eye", "right_eye", "left_ear", "right_ear", "left_shoulder",
              "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
              "left_hip", "right_hip", "left_knee", "right_knee", "left_ankle", "right_ankle")
ASCII = [chr(c) for c in range(32, 127)]


def _background(rng, h, w, channels):
    shape = (h, w) if channels == 1 else (h, w, channels)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _both(img, label, origin, color, thickness, scale):
    want = jvis.draw_label(img.copy(), label, origin, color=color, thickness=thickness, scale=scale)
    got = tvis.draw_label(img.copy(), label, origin, color=color, thickness=thickness, scale=scale)
    return got, want


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3])
@pytest.mark.parametrize("scale", [0.35, 0.6])
def test_every_ascii_character_alone(scale, thickness):
    rng = np.random.default_rng(int(scale * 100) + thickness)
    for i, c in enumerate(ASCII):
        channels = (1, 3, 4)[i % 3]
        img = _background(rng, 40, 40, channels)
        color = tuple(int(v) for v in rng.integers(0, 256, 4))
        got, want = _both(img, c, (8, 8), color, thickness, scale)
        np.testing.assert_array_equal(got, want, err_msg=repr(c))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("scale", [0.35, 0.6])
def test_keypoint_names_and_person(scale, channels):
    rng = np.random.default_rng(channels)
    for label in COCO_NAMES + ("person",):
        for thickness in (1, 2):
            img = _background(rng, 36, 150, channels)
            color = tuple(int(v) for v in rng.integers(0, 256, 3))
            got, want = _both(img, label, (3, 5), color, thickness, scale)
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {thickness}")


@pytest.mark.parametrize("seed", range(4))
def test_seeded_sweep(seed):
    """Random strings (newlines too) at random scales in [0.3, 1.5], random
    thickness, channels, colours and origins that clip at every edge."""
    rng = np.random.default_rng(100 + seed)
    pool = ASCII + ["\n"] * 4
    for _ in range(150):
        label = "".join(rng.choice(pool, int(rng.integers(0, 14))))
        scale = float(rng.uniform(0.3, 1.5))
        thickness = int(rng.choice([-1, 1, 2, 3]))
        h, w = int(rng.integers(8, 70)), int(rng.integers(8, 180))
        origin = (float(rng.uniform(-45, w + 8)), float(rng.uniform(-45, h + 20)))
        img = _background(rng, h, w, int(rng.choice([1, 3, 4])))
        color = tuple(int(v) for v in rng.integers(0, 256, 4))
        got, want = _both(img, label, origin, color, thickness, scale)
        np.testing.assert_array_equal(got, want, err_msg=f"{label!r} {scale} {origin}")


@pytest.mark.parametrize("edge", ["left", "right", "top", "bottom"])
def test_origins_that_clip(edge):
    rng = np.random.default_rng(7)
    h, w = 30, 60
    for k in range(-30, 12):
        origin = {"left": (k, 8), "right": (w - 12 + k, 8), "top": (4, k - 14),
                  "bottom": (4, h - 16 + k)}[edge]
        img = _background(rng, h, w, 3)
        for scale in (0.35, 1.0):
            got, want = _both(img, "jgWy_Q", origin, (250, 20, 90), 1, scale)
            np.testing.assert_array_equal(got, want, err_msg=f"{origin} {scale}")


@pytest.mark.parametrize("pair", ["AV", "To", "LT", "Ty"])
def test_kerning_pairs(pair):
    """cv2 reads no GPOS: a pair advances by the two advances."""
    for scale in (0.35, 0.6, 1.0, 1.5):
        for thickness in (1, 2):
            img = np.zeros((60, 90, 3), np.uint8)
            got, want = _both(img, pair, (2, 10), (255, 255, 255), thickness, scale)
            np.testing.assert_array_equal(got, want)


def test_newlines_empty_and_spaces():
    rng = np.random.default_rng(3)
    for label in ["", " ", "   ", "\n", "\n\nab", "ab\n", "ab\ncd", "ab\n\n\ncd", " \nx", "a b"]:
        for scale in (0.35, 0.6, 1.2):
            img = _background(rng, 90, 70, 3)
            got, want = _both(img, label, (2, 2), (0, 255, 0), 1, scale)
            np.testing.assert_array_equal(got, want, err_msg=repr(label))


def test_blend_every_colour_over_every_background():
    """One glyph's coverage levels blended with every (colour, background)
    value pair, as ``round(bg + (c - bg) * a / 255)``."""
    bg = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 40, axis=1)
    for c in range(0, 256, 3):
        a = bg.copy()
        for y in range(0, 256, 32):
            cv2.putText(a, "@%&", (0, y + 26), cv2.FONT_HERSHEY_SIMPLEX, 1.0, c, 1, cv2.LINE_AA)
        b = bg.copy()
        for y in range(0, 256, 32):
            text.put_text(b, "@%&", (0, y + 26), 1.0, c, 1)
        np.testing.assert_array_equal(b, a, err_msg=str(c))


def test_what_cv2_refuses_and_what_it_falls_back_on():
    img = np.zeros((20, 40, 3), np.uint8)
    for dtype in (np.uint16, np.float32, np.int8):
        with pytest.raises(ValueError, match="uint8"):
            tvis.draw_label(np.zeros((20, 40, 3), dtype), "a", (0, 0))
    with pytest.raises(ValueError, match="1, 3 or 4"):
        tvis.draw_label(np.zeros((20, 40, 2), np.uint8), "a", (0, 0))
    for label in ("中", "a\tb", "\r"):  # cv2 draws these with WenQuanYi Micro Hei
        with pytest.raises(NotImplementedError, match="WenQuanYi"):
            tvis.draw_label(img, label, (0, 0))
    assert not img.any()


def test_labeled_keypoints_match_jax():
    rng = np.random.default_rng(11)
    status_key, point_key = (key_combine("status", "keypoint_status"),
                             key_combine("point", "point_xy"))
    for _ in range(20):
        img = _background(rng, 64, 80, 3)
        body = {key_combine(name, "sub_dict"): {
            status_key: str(rng.choice(["vis", "not_vis", "missing"])),
            point_key: [float(v) for v in rng.uniform(-10, 80, 2)]} for name in COCO_NAMES}
        want = jvis.draw_keypoint(img.copy(), body, labeled=True)
        np.testing.assert_array_equal(tvis.draw_keypoint(img.copy(), body, labeled=True), want)


# Every code point in Rubik's cmap drawn alone, against cv2 (ROADMAP C7,
# repaired: 27 glyphs past ASCII had differed, by the inference of
# untouched points' deltas and by an intermediate region's scalar).
LATIN = range(0xA0, 0x180)
GLYPH_SETTINGS = ((1.0, 1), (0.6, 2), (0.35, -1), (1.5, 3))


def _glyph_differences(codes) -> dict:
    """{(code, scale, thickness): (pixels that differ, largest absolute
    difference)} of the characters in ``codes`` whose port drawing differs
    from cv2's."""
    out = {}
    for code in codes:
        for scale, thickness in GLYPH_SETTINGS:
            a = np.zeros((80, 90), np.uint8)
            cv2.putText(a, chr(code), (20, 50), cv2.FONT_HERSHEY_SIMPLEX, scale, 255, thickness,
                        cv2.LINE_AA)
            b = text.put_text(np.zeros((80, 90), np.uint8), chr(code), (20, 50), scale, 255,
                              thickness)
            diff = np.abs(a.astype(np.int16) - b)
            if diff.any():
                out[(code, scale, thickness)] = (int((diff > 0).sum()), int(diff.max()))
    return out


def test_latin_glyphs_known_faults():
    """Rubik's code points in U+00A0-U+017F: every one bit-equal (C7's
    rings, degree, registered and middle-dot glyphs among them)."""
    codes = [c for c in sorted(text.load_font().cmap) if c in LATIN]
    assert len(codes) == 222
    assert _glyph_differences(codes) == {}


def test_every_other_rubik_glyph_known_faults():
    """Every other code point in Rubik's cmap (ASCII, Latin Extended-B and
    beyond, Cyrillic, Hebrew, Arabic, punctuation, the presentation forms):
    every one bit-equal (C7's bullet, breves, Hebrew points and dagesh
    forms among them)."""
    codes = [c for c in sorted(text.load_font().cmap) if c not in LATIN]
    assert len(codes) == 885 - 222
    assert _glyph_differences(codes) == {}


def test_iup_and_region_scalar_rules():
    """The two rules C7 needed, on hand-made contours: untouched deltas are
    truncated toward zero; after the last touched point they copy its delta
    where the contour's first point is untouched, and are interpolated
    across the contour's end where it is touched; an intermediate region's
    scalar is rounded to F2Dot14."""
    coords = np.array([[0, 0], [10, 0], [20, 0], [30, 0], [40, 0]])
    # touched 1 and 3; point 0 is untouched, so point 4 copies point 3
    got = text._iup([None, (-3, 0), None, (4, 0), None], coords)
    assert got == [(-3, 0), (-3, 0), (0, 0), (4, 0), (4, 0)]
    # (-3 + 10 * 7 / 20) = 0.5 truncates to 0; 5 * (7 / 20) - 3 = -1.25 to -1
    got = text._iup([None, (-3, 0), None, (4, 0), None],
                    np.array([[0, 0], [10, 0], [15, 0], [30, 0], [40, 0]]))
    assert got[2] == (-1, 0)
    # point 0 touched: point 4 lies past both references' coordinates
    got = text._iup([(6, 0), None, (-3, 0), None, None], coords)
    assert got == [(6, 0), (1, 0), (-3, 0), (-3, 0), (-3, 0)]
    got = text._iup([(6, 0), None, (-3, 0), None, None],
                    np.array([[0, 0], [10, 0], [20, 0], [30, 0], [10, 0]]))
    assert got[4] == (1, 0)
    assert text._region_scalar(0.1875, 0.0, 0.625, 1.0) == 4915 / 16384
    assert text._region_scalar(0.1875, 0.0, 1.0, 1.0) == 0.1875


def test_font_is_the_packages_own_file():
    """The font is read from the package's ``fonts/Rubik.ttf.gz``, which
    holds the bytes of cv2's embedded blob."""
    assert str(text.FONT_PATH) == os.path.join(ROOT, "instancesegmentation_tpu_torch", "core",
                                               "fonts", "Rubik.ttf.gz")
    data = gzip.decompress(text.FONT_PATH.read_bytes())
    assert data[:4] == b"\x00\x01\x00\x00" and len(data) == 359916
    assert text.load_font().data == data
    assert (text.FONT_PATH.parent / "LICENSE").read_text().count("SIL OPEN FONT LICENSE") == 1
    assert build_library(text.SRC).exists()


def test_rasteriser_refuses_nothing_of_an_empty_outline():
    out = np.full((3, 4), 7, np.uint8)
    text._load().text_glyph(np.zeros(0, np.uint8), np.zeros((0, 4), np.float32), 0, 0.1, 0, 0,
                            0, 4, 3, out)
    assert not out.any()


# -- the show_aug tool ---------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("qa") / "data"), num_images=3,
                                  seed=3)


def _read(path):
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


def test_show_dataset_matches_jax(tree, tmp_path):
    """The grid files are the JAX tool's, byte for byte."""
    assert jshow.show_dataset(tree, str(tmp_path / "j"), 3) == 3
    assert tshow.main(["show-dataset", tree, str(tmp_path / "p"), "--limit", "3"]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) == [f"dataset_{i:04d}.png" for i in range(3)]
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    # the labels are drawn: the overlay panel differs from an unlabeled one
    from instancesegmentation_tpu_torch.core.records import common_ann_loader, common_transfer
    ann = next(common_ann_loader(tree))
    common_transfer(ann)
    obj = ann[key_combine("object", "sub_list")][0]
    kps = obj[key_combine("body_keypoint", "sub_dict")]
    image = ann[key_combine("image", "image")]
    assert (tvis.draw_keypoint(image.copy(), kps, labeled=True)
            != tvis.draw_keypoint(image.copy(), kps)).any()


@pytest.mark.parametrize("shape", [(1, 1), (9, 1, 3), (2, 3), (7, 5, 3), (33, 17, 4), (100, 100),
                                   (64, 256, 3), (240, 960, 3), (5, 3000, 3)])
def test_encode_png_is_cv2s_bytes(shape):
    """``core/png.py:encode_png`` writes ``cv2.imencode(".png")``'s bytes:
    Sub rows (None for one-pixel rows), zlib level 1 with ``Z_RLE``,
    libpng's window and header for small data, 8 KiB IDAT chunks."""
    from instancesegmentation_tpu_torch.core.png import encode_png

    rng = np.random.default_rng(len(shape) * 1000 + shape[0])
    for kind in ("random", "flat", "ramp"):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        if kind == "flat":
            img[:] = 9
        elif kind == "ramp":
            img = (np.indices(shape).sum(0) % 256).astype(np.uint8)
        bgr = img[..., [2, 1, 0, 3][:shape[2]]] if img.ndim == 3 else img
        assert encode_png(img) == cv2.imencode(".png", bgr)[1].tobytes(), kind


def _within(got, want, max_share):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= max_share, (diff > 0).mean()


def test_show_aug_defaults_match_jax(tree, tmp_path):
    """Bit-equal expected; at most 0.1 % of pixels off by 1 (the
    preprocess's 1e-4 before the uint8 cast)."""
    assert jshow.show_aug(tree, str(tmp_path / "j"), limit=2, out_size=64) == 2
    assert tshow.main(["show-aug", tree, str(tmp_path / "p"), "--limit", "2", "--out-size", "64",
                       "--device", "cpu"]) == 0
    for i in range(2):
        name = f"aug_{i:04d}.png"
        want, got = _read(str(tmp_path / "j" / name)), _read(str(tmp_path / "p" / name))
        assert got.shape == want.shape == (64, 256, 3)
        _within(got, want, 1e-3)


def _jax_rotate_draws(seed):
    """The draws the JAX tool's ``preprocess_batch`` makes from
    ``PRNGKey(seed + i)`` with ``--rotate`` (rotate_prob 1, no flip or
    jitter), as ``show_aug``'s ``draws`` hook."""
    def draws(i, cfg):
        rng = jax.random.PRNGKey(seed + i)
        gate = jax.random.bernoulli(jax.random.fold_in(rng, 101), cfg.rotate_prob, (1,))
        theta = jnp.where(gate, jax.random.uniform(jax.random.fold_in(rng, 102), (1,),
                                                   minval=-1.0, maxval=1.0)
                          * (cfg.rotate * math.pi / 180.0), 0.0)
        return {"theta": torch.from_numpy(np.array(theta)), "flip": torch.zeros(1, dtype=torch.bool),
                "jitter": None, "brightness": None, "contrast": None, "noise": None}
    return draws


def test_show_aug_rotated_matches_jax(tree, tmp_path):
    """``--rotate 25`` fed JAX's draws: the rotated sampler's 1e-3 on the
    0-255 scale moves a few pixels by 1."""
    assert jshow.show_aug(tree, str(tmp_path / "j"), limit=2, out_size=64, rotate=25.0,
                          seed=4) == 2
    assert tshow.show_aug(tree, str(tmp_path / "p"), limit=2, out_size=64, rotate=25.0, seed=4,
                          device="cpu", draws=_jax_rotate_draws(4)) == 2
    for i in range(2):
        name = f"aug_{i:04d}.png"
        want, got = _read(str(tmp_path / "j" / name)), _read(str(tmp_path / "p" / name))
        _within(got, want, 1e-2)


def test_show_aug_seeds_its_own_draws(tree, tmp_path):
    """Without the hook, sample i draws from a generator seeded seed + i:
    two runs agree, and the rotation moves the grid."""
    for out in ("a", "b"):
        tshow.show_aug(tree, str(tmp_path / out), limit=1, out_size=48, rotate=25.0, seed=9,
                       device="cpu")
    tshow.show_aug(tree, str(tmp_path / "c"), limit=1, out_size=48, device="cpu")
    a, b, c = (_read(str(tmp_path / d / "aug_0000.png")) for d in "abc")
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
