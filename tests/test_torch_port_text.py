"""The port's text (``core/text.py``, ``core/visualize.py:draw_label``,
``draw_keypoint(labeled=True)``) against the JAX package's, which calls
``cv2.putText`` (cv2 5.0: TrueType Rubik, and WenQuanYi Micro Hei for the
characters Rubik lacks), and the port's ``show_aug`` tool against
``tools/show_aug.py``.  Every label case is bit-equal, and so is the
drawing of every code point in Rubik's cmap (ROADMAP C7, repaired), of a
seeded sample of the fallback font's, of every fallback glyph with a
scaled component, and of mixed strings with controls and code points in
neither font (ROADMAP A14)."""
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
    with pytest.raises(ValueError, match="UTF-8"):  # cv2's binding cannot convert it
        tvis.draw_label(img, "a\ud800", (0, 0))
    assert not img.any()
    # WenQuanYi Micro Hei draws "中"; "\t" and "\r" are in neither font and
    # draw as Rubik's "?"; the text ends at its first NUL, as cv2's C string
    for label in ("中", "a\tb", "\r", "a\x00中", "\x00"):
        for thickness in (1, 2):
            got, want = _both(np.zeros((40, 60, 3), np.uint8), label, (2, 30), (255, 200, 100),
                              thickness, 0.8)
            np.testing.assert_array_equal(got, want, err_msg=repr(label))
            assert want.any() == (label[0] != "\x00")


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


# -- text outside Rubik: cv2's fallback font, WenQuanYi Micro Hei (ROADMAP A14) --


@pytest.fixture(scope="module")
def fallback():
    return text.load_font(text.FALLBACK)


def _fallback_only(font) -> list:
    """The fallback font's code points that Rubik lacks."""
    rubik = text.load_font().cmap
    return sorted(c for c in font.cmap if c not in rubik)


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("scale", [0.45, 1.3])
def test_fallback_code_points_alone(fallback, scale, thickness):
    """A seeded 200 of the 34,031 code points only the fallback font has
    (CJK, Hangul, kana, the six past the BMP), each alone, through
    ``draw_label`` against the JAX package's, on 1-, 3- and 4-channel
    images."""
    codes = _fallback_only(fallback)
    assert len(codes) == 34031
    rng = np.random.default_rng(int(scale * 10) + thickness)
    sample = [int(c) for c in rng.choice(codes, 200, replace=False)] + [
        c for c in codes if c > 0xFFFF]
    for i, code in enumerate(sample):
        img = _background(rng, 64, 64, (1, 3, 4)[i % 3])
        color = tuple(int(v) for v in rng.integers(0, 256, 4))
        got, want = _both(img, chr(code), (6, 44), color, thickness, scale)
        np.testing.assert_array_equal(got, want, err_msg=hex(code))


def _scaled_composites(font) -> list:
    """The code points whose glyph has a component with a scale (flag 8,
    0x40 or 0x80): 1,133 glyphs, 1,620 components, every one an x / y
    scale."""
    glyphs = set()
    for gid in range(font.num_glyphs):
        pos, length = font.glyph_range(gid)
        if length and font.simple_points(gid) is None:
            if any(flags & 0xC8 for _, flags, _, _, _ in font.components(gid)):
                glyphs.add(gid)
    return sorted(c for c, g in font.cmap.items() if g in glyphs)


@pytest.mark.parametrize("part", range(4))
def test_fallback_scaled_composites(fallback, part):
    """Every code point whose glyph places a component with a scale, where
    stb multiplies each transformed point again by the column's norm, at
    two scales: a quarter of them per part."""
    codes = _scaled_composites(fallback)
    assert len(codes) == 1133
    for code in codes[part::4]:
        for scale in (0.6, 1.7):
            a = np.zeros((80, 80), np.uint8)
            cv2.putText(a, chr(code), (8, 56), cv2.FONT_HERSHEY_SIMPLEX, scale, 255, 1)
            b = text.put_text(np.zeros((80, 80), np.uint8), chr(code), (8, 56), scale, 255, 1)
            np.testing.assert_array_equal(b, a, err_msg=f"{code:#x} {scale}")


@pytest.mark.parametrize("seed", range(4))
def test_mixed_strings(fallback, seed):
    """Seeded strings of Latin, CJK, newlines, ``'\\t'``, ``'\\r'`` and other
    controls, U+E000, code points past the BMP (in the fallback font and
    in neither) and NUL, at random scales, weights, channels, colours and
    origins, through ``draw_label`` against the JAX package's."""
    rng = np.random.default_rng(300 + seed)
    pool = ([chr(int(c)) for c in rng.choice(_fallback_only(fallback), 60)] + ASCII
            + ["\n"] * 16 + ["\t", "\r", "\x01", "\x1b", "\x7f", "\x85", "\ue000",
                             "\U0001d30c", "\U00010400", "\U0001f600", "\U0010fffd", "\x00"])
    for _ in range(120):
        label = "".join(rng.choice(pool, int(rng.integers(1, 14))))
        scale = float(rng.uniform(0.3, 2.0))
        thickness = int(rng.choice([-1, 1, 2, 3]))
        h, w = int(rng.integers(16, 120)), int(rng.integers(16, 300))
        origin = (float(rng.uniform(-30, w)), float(rng.uniform(-20, h + 10)))
        img = _background(rng, h, w, int(rng.choice([1, 3, 4])))
        color = tuple(int(v) for v in rng.integers(0, 256, 4))
        got, want = _both(img, label, origin, color, thickness, scale)
        np.testing.assert_array_equal(got, want, err_msg=f"{label!r} {scale} {origin}")


def test_line_steps_of_mixed_lines():
    """A line steps down by the largest step of the faces that drew it (the
    fallback font's ``round(2401 * size / 1918)`` is never more than
    Rubik's); an empty line steps as the line before it."""
    labels = ["中\nN", "a中\nN", "中a\nN", "中\n\nN", "a\n\n中\n\n\nN", "中\n \n\t\n人",
              "\n\n中\n中", "人人\n\na"]
    for scale in (0.35, 0.6, 1.0, 1.22, 1.5, 2.2, 3.0):
        for label in labels:
            got, want = _both(np.zeros((420, 140, 3), np.uint8), label, (4, 70), (255, 255, 255),
                              1, scale)
            np.testing.assert_array_equal(got, want, err_msg=f"{label!r} {scale}")


def test_rubik_labels_never_open_the_fallback_font(monkeypatch, tmp_path):
    """Labels Rubik draws alone (the keypoint names, "person", every
    printable ASCII character) never read the fallback font's file; the
    first character Rubik lacks does."""
    monkeypatch.setattr(text, "FALLBACK_FONT_PATH", tmp_path / "missing.ttf.gz")
    text._read_font.cache_clear()
    text.face_glyph.cache_clear()
    try:
        img = np.zeros((60, 900, 3), np.uint8)
        for label in COCO_NAMES + ("person", "".join(ASCII), "two\nlines"):
            for thickness in (1, 2):
                tvis.draw_label(img, label, (2, 30), thickness=thickness, scale=0.6)
        assert img.any()
        assert text._read_font.cache_info().currsize == 1
        with pytest.raises(FileNotFoundError):
            tvis.draw_label(img, "中", (2, 30))
    finally:
        text._read_font.cache_clear()
        text.face_glyph.cache_clear()


def test_fallback_font_is_the_packages_own_file(fallback):
    """The fallback font is read from the package's
    ``fonts/WenQuanYiMicroHei.ttf.gz``, cv2's embedded blob, which ships
    with its licence (name ID 0's copyright, name ID 13's Apache 2.0
    grant, the licence's text); a static font with a format 12 cmap."""
    assert text.FALLBACK_FONT_PATH == text.FONT_PATH.with_name("WenQuanYiMicroHei.ttf.gz")
    data = gzip.decompress(text.FALLBACK_FONT_PATH.read_bytes())
    assert len(data) == 4561944 and fallback.data == data
    assert fallback.axis is None and fallback.num_glyphs == 49531
    assert (fallback.ascent, fallback.descent, fallback.line_gap) == (1918, -483, 0)
    assert len(fallback.cmap) == 34600 and sum(c > 0xFFFF for c in fallback.cmap) == 6
    licence = text.FALLBACK_FONT_PATH.with_name("WenQuanYiMicroHei.LICENSE").read_text()
    assert "WenQuanYi Board of Trustees" in licence and "Google Corporation" in licence
    assert "Licensed under the Apache License, Version 2.0" in licence
    assert licence.count("TERMS AND CONDITIONS FOR USE, REPRODUCTION, AND DISTRIBUTION") == 1
    assert text.FALLBACK_FONT_PATH.stat().st_size == 2104595


def test_stored_label_fixtures_match_cv2_and_the_port():
    """``tests/data/text/labels.npz`` (what ``chip_smoke.py`` holds the port
    to on a machine without cv2): each stored output is the JAX package's
    live drawing and the port's, the fallback font's cases among them."""
    import json

    fixtures = np.load(os.path.join(ROOT, "tests", "data", "text", "labels.npz"))
    cases = sorted(int(k[5:]) for k in fixtures.files if k.startswith("case_"))
    rubik, fallback_labels = text.load_font().cmap, 0
    for k in cases:
        case, bg, want = (json.loads(str(fixtures[f"case_{k}"])), fixtures[f"bg_{k}"],
                          fixtures[f"out_{k}"])
        if "label" in case:
            args = (case["label"], case["origin"])
            kw = dict(color=tuple(case["color"]), thickness=case["thickness"],
                      scale=case["scale"])
            live, got = (m.draw_label(bg.copy(), *args, **kw) for m in (jvis, tvis))
            fallback_labels += any(ord(c) not in rubik for c in case["label"] if c != "\n")
        else:
            live, got = (m.draw_keypoint(bg.copy(), case["keypoints"], labeled=True,
                                         radius=case["radius"]) for m in (jvis, tvis))
        np.testing.assert_array_equal(live, want, err_msg=str(k))
        np.testing.assert_array_equal(got, want, err_msg=str(k))
    assert len(cases) == 62 and fallback_labels == 14


def test_fonts_are_cv2s_blobs():
    """``tests/data/text/extract_font.py --check``: both fonts are the gzip
    streams cv2 carries, byte for byte, found by their English names."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "extract_font", os.path.join(ROOT, "tests", "data", "text", "extract_font.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main(["--check"])


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
