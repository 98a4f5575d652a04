"""WebP through the port's reader (``core/imread.py`` -> ``core/webp.py``,
the bit streams in ``ops/native/webp.cpp``) against live ``cv2.imread``
and ``cv2.imdecode`` (the JAX package's readers) in both read modes: every
pixel equal where cv2 decodes, ``FileNotFoundError`` exactly where cv2
returns None, ``ImageSizeError`` where cv2 raises on the size.

- lossy (VP8) at many qualities, odd sides, lossless (VP8L) of every
  method, palettes of 2, 4, 16 and 256 colours, RGBA from cv2 and PIL;
- ALPH chunks of method 0 and 1 with each of the four filters;
- the container: VP8X with EXIF orientations 1-8 (both byte orders), an
  EXIF flag unset, an ``Exif\\0\\0`` prefix, EXIF entries of any type and
  count, a file the demuxer refuses (pixels kept unturned), ICCP; the
  32-byte header read; RIFF sizes; animations (the first frame at its
  offset on zeros, each blend and dispose setting, files the demuxer
  refuses, sizes cv2 raises on);
- every cut of small files, as cut and with the sizes cut to fit (which
  the bit readers' end-of-data rules decide), seeded byte flips (inside
  ALPH, the VP8 partitions and the VP8L codes among them);
- the committed fixtures of ``tests/data/webp`` (``make_fixtures.py``:
  cv2, PIL and the system libwebp's settings that neither exposes) against
  the decodes stored beside them and against live cv2;
- a COCO tree of WebP images converted by both packages' ``transfer_coco``
  (file for file equal), read by both datasets, and a few port train steps
  on it; the same under ``.webp`` names, whose mix previews the port writes
  with its WebP encoder (equal pixels, ``test_torch_port_webp_enc.py``).
"""
import glob
import importlib.util
import json
import os
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.data import converters as jconv
from instancesegmentation_tpu.data.dataset import InstanceCommonDataset as JaxDataset
from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.png import ImageSizeError
from instancesegmentation_tpu_torch.data import converters as tconv
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.pipeline import draw_augment, host_batch
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.ops.native.webp import decode_vp8
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.train.config import TrainConfig
from instancesegmentation_tpu_torch.train.state import TrainState
from instancesegmentation_tpu_torch.train.steps import augment_config, make_train_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "webp")
_spec = importlib.util.spec_from_file_location("webp_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)


def _cv2(read):
    """cv2's outcome: RGB (or gray) array, None, or "raises" (a size cv2's
    validateInputImageSize refuses)."""
    try:
        img = read()
    except cv2.error:
        return "raises"
    return None if img is None else img[..., ::-1] if img.ndim == 3 else img


def _port(read):
    try:
        return read()
    except FileNotFoundError:
        return None
    except ImageSizeError:
        return "raises"


def _same(got, want) -> bool:
    if isinstance(got, str) or isinstance(want, str) or got is None or want is None:
        return (got is None and want is None) or (isinstance(got, str) and got == want)
    return got.shape == want.shape and np.array_equal(got, want)


def _against_cv2(tmp_path, data: bytes, file: bool = True, modes=("color", "gray")) -> dict:
    """The port's reads of ``data`` (as a file and as bytes) equal cv2's;
    returns cv2's outcome per mode."""
    path = str(tmp_path / "image.webp")
    with open(path, "wb") as f:
        f.write(data)
    buf = np.frombuffer(data, np.uint8)
    out = {}
    for mode in modes:
        flag = cv2.IMREAD_COLOR if mode == "color" else cv2.IMREAD_GRAYSCALE
        want = _cv2(lambda: cv2.imdecode(buf, flag))
        assert _same(_port(lambda: imdecode(data, mode)), want), f"imdecode {mode}"
        if file:
            want_file = _cv2(lambda: cv2.imread(path, flag))
            assert _same(_port(lambda: imread(path, mode)), want_file), f"imread {mode}"
        out[mode] = want
    return out


# -- the forms, written here -------------------------------------------------

SMALL = mf.picture(29, 43, 11, noise=15)
RGBA = np.dstack([SMALL, mf.picture(29, 43, 12)[..., 2]])


def _forms() -> dict:
    out = {}
    for q in (1, 3, 15, 33, 66, 85, 99, 100, 101):
        out[f"cv2_q{q}"] = lambda q=q: mf.cv2_webp(SMALL, q)
    for q in (60, 101):
        out[f"cv2_rgba_q{q}"] = lambda q=q: mf.cv2_webp(RGBA, q)
    for m in (0, 3, 6):
        out[f"pil_lossless_m{m}"] = lambda m=m: mf.pil_webp(SMALL, lossless=True, method=m)
        out[f"pil_lossy_m{m}"] = lambda m=m: mf.pil_webp(SMALL, quality=70, method=m)
    out["pil_rgba_exact"] = lambda: mf.pil_webp(RGBA, lossless=True, exact=True)
    out["pil_rgba_alpha_q10"] = lambda: mf.pil_webp(RGBA, quality=70, alpha_quality=10)
    for h, w in ((1, 1), (1, 37), (41, 1), (2, 2), (15, 17), (16, 16), (33, 65)):
        img = mf.picture(h, w, h * w, noise=30)
        out[f"lossy_{h}x{w}"] = lambda img=img: mf.cv2_webp(img, 80)
        out[f"lossless_{h}x{w}"] = lambda img=img: mf.cv2_webp(img, 101)
    rng = np.random.default_rng(3)
    for n in (2, 3, 4, 5, 16, 17, 256):
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        idx = rng.integers(0, n, (23, 37))
        out[f"palette{n}"] = lambda pal=pal, idx=idx: mf.cv2_webp(pal[idx], 101)
    vp8 = lambda: dict(mf.chunks_of(mf.cv2_webp(SMALL, 80)))[b"VP8 "]  # noqa: E731
    for method in (0, 1):
        for filt in range(4):
            out[f"alph_m{method}_f{filt}"] = lambda method=method, filt=filt: mf.riff([
                mf.vp8x(0x10, 43, 29), (b"ALPH", mf.alph(RGBA[..., 3], method, filt)),
                (b"VP8 ", vp8())])
    out["alph_without_flag"] = lambda: mf.riff([mf.vp8x(0, 43, 29),
                                                (b"ALPH", mf.alph(RGBA[..., 3], 1, 3)),
                                                (b"VP8 ", vp8())])
    out["alph_method2"] = lambda: mf.riff([mf.vp8x(0x10, 43, 29),
                                           (b"ALPH", b"\x02" + bytes(29 * 43)), (b"VP8 ", vp8())])
    out["alph_reserved_bits"] = lambda: mf.riff([mf.vp8x(0x10, 43, 29),
                                                 (b"ALPH", b"\x40" + bytes(29 * 43)),
                                                 (b"VP8 ", vp8())])
    out["alph_raw_short"] = lambda: mf.riff([mf.vp8x(0x10, 43, 29),
                                             (b"ALPH", b"\x00" + bytes(29 * 43 - 1)),
                                             (b"VP8 ", vp8())])
    out["alph_empty"] = lambda: mf.riff([mf.vp8x(0x10, 43, 29), (b"ALPH", b""), (b"VP8 ", vp8())])
    return out


FORMS = _forms()


@pytest.mark.parametrize("name", sorted(FORMS))
def test_forms_match_cv2(tmp_path, name):
    _against_cv2(tmp_path, FORMS[name]())


def _turned(base, o):
    return {1: base, 2: base[:, ::-1], 3: base[::-1, ::-1], 4: base[::-1],
            5: base.swapaxes(0, 1), 6: base.swapaxes(0, 1)[:, ::-1],
            7: base.swapaxes(0, 1)[::-1, ::-1], 8: base.swapaxes(0, 1)[::-1]}[o]


@pytest.mark.parametrize("orientation", range(0, 10))
@pytest.mark.parametrize("kind", ["lossless_mm", "lossy_ii"])
def test_exif_orientation_matches_cv2(tmp_path, orientation, kind):
    img = mf.picture(24, 40, 6, noise=20)
    stream = mf.chunks_of(mf.cv2_webp(img, 101 if kind.startswith("lossless") else 80))[0]
    plain = imdecode(mf.riff([stream]))
    data = mf.riff([mf.vp8x(0x08, 40, 24), stream, (b"EXIF", mf.exif(orientation,
                                                                     kind.endswith("ii")))])
    got = _against_cv2(tmp_path, data)["color"]
    np.testing.assert_array_equal(got, _turned(plain, orientation if 1 <= orientation <= 8 else 1))


_exif_spec = importlib.util.spec_from_file_location(
    "exif_fixtures", os.path.join(os.path.dirname(__file__), "data", "exif", "make_fixtures.py"))
exif_fx = importlib.util.module_from_spec(_exif_spec)
_exif_spec.loader.exec_module(exif_fx)
#: C10: EXIF blocks with an entry before orientation 6 (``tests/data/exif``),
#: in both byte orders
C10_CASES = {f"c10_{name}_{'ii' if order == '<' else 'mm'}": exif_fx.exif_block(entry, order)
             for name, (entry, _) in exif_fx.CASES.items() for order in "<>"}


def _exif_entry(value: bytes, typ: int, count: int) -> bytes:
    return b"MM\0*" + struct.pack(">IHHHI", 8, 1, 0x0112, typ, count) + value + bytes(4)


@pytest.mark.parametrize("case", ["flag_unset", "exif_prefix", "second_exif_ignored",
                                  "before_image", "count_10", "count_0", "type_long",
                                  "type_undefined", "beyond_riff", "demux_refuses_trailing",
                                  "demux_refuses_reserved_flag", "demux_refuses_two_images",
                                  "simple_file", "cut_block"] + sorted(C10_CASES))
def test_exif_container_rules_match_cv2(tmp_path, case):
    """Where cv2 takes the EXIF orientation of a WebP file: the first EXIF
    chunk of a file with the VP8X EXIF flag that libwebp's demuxer accepts
    whole, its 16-bit value whatever the entry's type and count; C10's
    cases (``tests/data/exif``): an entry before the orientation whose
    string or rational data lies outside the block leaves the image
    unturned."""
    img = mf.picture(24, 40, 6, noise=20)
    stream = mf.chunks_of(mf.cv2_webp(img, 101))[0]
    head, six = mf.vp8x(0x08, 40, 24), (b"EXIF", mf.exif(6))
    data = {
        "flag_unset": lambda: mf.riff([mf.vp8x(0, 40, 24), stream, six]),
        "exif_prefix": lambda: mf.riff([head, stream, (b"EXIF", b"Exif\0\0" + mf.exif(6))]),
        "second_exif_ignored": lambda: mf.riff([head, stream, six, (b"EXIF", mf.exif(3))]),
        "before_image": lambda: mf.riff([head, six, stream]),
        "count_10": lambda: mf.riff([head, stream, (b"EXIF", _exif_entry(b"\0\x06\0\0", 3, 10))]),
        "count_0": lambda: mf.riff([head, stream, (b"EXIF", _exif_entry(b"\0\x08\0\0", 3, 0))]),
        "type_long": lambda: mf.riff([head, stream, (b"EXIF", _exif_entry(b"\0\0\0\x06", 4, 1))]),
        "type_undefined": lambda: mf.riff([head, stream,
                                           (b"EXIF", _exif_entry(b"\0\x05\0\0", 7, 1))]),
        "beyond_riff": lambda: mf.riff([head, stream]) + mf.chunk(*six),
        "demux_refuses_trailing": lambda: _grow_riff(mf.riff([head, stream, six]) + b"ABC"),
        "demux_refuses_reserved_flag": lambda: mf.riff([mf.vp8x(0x09, 40, 24), stream, six]),
        "demux_refuses_two_images": lambda: mf.riff([head, stream, stream, six]),
        "simple_file": lambda: mf.riff([stream, six]),
        "cut_block": lambda: mf.riff([head, stream, (b"EXIF", mf.exif(6)[:19])]),
        **{name: (lambda name=name: mf.riff([head, stream, (b"EXIF", C10_CASES[name])]))
           for name in C10_CASES},
    }[case]()
    _against_cv2(tmp_path, data)


def _grow_riff(data: bytes) -> bytes:
    return data[:4] + struct.pack("<I", len(data) - 8) + data[8:]


@pytest.mark.parametrize("case", ["riff_size_past_data", "riff_size_small", "vp8x_size_12",
                                  "canvas_mismatch", "no_image", "unknown_chunk_odd",
                                  "chunk_past_riff", "vp8l_declared_short", "trailing_garbage",
                                  "not_key_frame", "bad_vp8l_version", "huge_canvas_animation",
                                  "vp8x_canvas_too_large", "icc"])
def test_container_rules_match_cv2(tmp_path, case):
    img = mf.picture(24, 40, 6, noise=20)
    lossless, lossy = (mf.chunks_of(mf.cv2_webp(img, q))[0] for q in (101, 80))
    head = mf.vp8x(0, 40, 24)
    frame = mf.chunks_of(mf.pil_webp(mf.picture(16, 16, 7), lossless=True))
    data = {
        "riff_size_past_data": lambda: mf.riff([lossless])[:-2],
        "riff_size_small": lambda: mf.riff([lossless])[:4] + struct.pack("<I", 11)
        + mf.riff([lossless])[8:],
        "vp8x_size_12": lambda: mf.riff([(b"VP8X", head[1] + b"\0\0"), lossless]),
        "canvas_mismatch": lambda: mf.riff([mf.vp8x(0, 41, 24), lossless]),
        "no_image": lambda: mf.riff([head, (b"ICCP", b"x" * 40)]),
        "unknown_chunk_odd": lambda: mf.riff([head, (b"ABCD", b"xyz"), lossy]),
        "chunk_past_riff": lambda: mf.riff([head, lossy])[:-30],
        "vp8l_declared_short": lambda: mf.riff([head, (b"VP8L", lossless[1][:-9]),
                                                (b"EXIF", mf.exif(1))]),
        "trailing_garbage": lambda: mf.riff([lossy]) + b"garbage" * 9,
        "not_key_frame": lambda: mf.riff([(b"VP8 ", bytes([lossy[1][0] | 1]) + lossy[1][1:])]),
        "bad_vp8l_version": lambda: mf.riff([(b"VP8L", lossless[1][:4]
                                              + bytes([lossless[1][4] | 0x20]) + lossless[1][5:])]),
        "huge_canvas_animation": lambda: mf.riff([mf.vp8x(0x02, 40000, 40000),
                                                  (b"ANIM", bytes(6)),
                                                  mf.anmf(0, 0, 16, 16, 0, frame)]),
        "vp8x_canvas_too_large": lambda: mf.riff([mf.vp8x(0, 1 << 24, 1 << 24), lossless]),
        "icc": lambda: mf.pil_webp(img, quality=80, icc_profile=bytes(300)),
    }[case]()
    _against_cv2(tmp_path, data)


def test_short_header_reads_match_cv2(tmp_path):
    """cv2 reads 32 bytes for the features: anything shorter is None, in
    both ``imread`` and ``imdecode``, even where it starts RIFF....WEBP."""
    data = mf.cv2_webp(SMALL, 101)
    for n in list(range(1, 40)) + [len(data) - 1]:
        outcome = _against_cv2(tmp_path, data[:n], modes=("color",))
        assert outcome["color"] is None, n


@pytest.mark.parametrize("bits", range(4))
@pytest.mark.parametrize("kind", ["lossless", "lossy_alpha"])
def test_animation_first_frame_matches_cv2(tmp_path, bits, kind):
    """The first ANMF frame at its offset on a canvas of zeros; the ANIM
    background, the blend and dispose bits and later frames play no part."""
    frame = np.dstack([mf.picture(16, 18, 7, noise=25), mf.picture(16, 18, 8)[..., 1]])
    chunks = mf.chunks_of(mf.pil_webp(frame, lossless=True) if kind == "lossless" else
                          mf.pil_webp(frame, quality=80))
    chunks = [c for c in chunks if c[0] != b"VP8X"]
    data = mf.riff([mf.vp8x(0x12, 40, 30), (b"ANIM", bytes([30, 20, 10, 255, 0, 0])),
                    mf.anmf(4, 6, 18, 16, bits, chunks), mf.anmf(2, 0, 18, 16, 3 - bits, chunks)])
    got = _against_cv2(tmp_path, data)["color"]
    outside = np.ones(got.shape[:2], bool)
    outside[6:22, 4:22] = False
    assert (got[outside] == 0).all()


@pytest.mark.parametrize("case", ["frame_past_canvas", "no_anim_chunk", "no_frames",
                                  "still_chunk_in_animation", "anmf_without_image",
                                  "corrupt_first_frame", "exif_turns_animation"])
def test_animation_container_rules_match_cv2(tmp_path, case):
    frame = mf.chunks_of(mf.pil_webp(mf.picture(16, 16, 7, noise=9), lossless=True))
    anim = (b"ANIM", bytes(6))
    bad = [(b"VP8L", frame[0][1][:12] + bytes(len(frame[0][1]) - 12))]
    data = {
        "frame_past_canvas": lambda: mf.riff([mf.vp8x(0x02, 40, 30), anim,
                                              mf.anmf(30, 6, 16, 16, 0, frame)]),
        "no_anim_chunk": lambda: mf.riff([mf.vp8x(0x02, 40, 30), mf.anmf(4, 6, 16, 16, 0, frame)]),
        "no_frames": lambda: mf.riff([mf.vp8x(0x02, 40, 30), anim]),
        "still_chunk_in_animation": lambda: mf.riff([mf.vp8x(0x02, 16, 16), anim] + frame),
        "anmf_without_image": lambda: mf.riff([mf.vp8x(0x02, 40, 30), anim,
                                               mf.anmf(0, 0, 4, 4, 0, [(b"ABCD", b"")]),
                                               mf.anmf(4, 6, 16, 16, 0, frame)]),
        "corrupt_first_frame": lambda: mf.riff([mf.vp8x(0x02, 40, 30), anim,
                                                mf.anmf(4, 6, 16, 16, 0, bad)]),
        "exif_turns_animation": lambda: mf.riff([mf.vp8x(0x0A, 40, 30), anim,
                                                 mf.anmf(4, 6, 16, 16, 0, frame),
                                                 (b"EXIF", mf.exif(8))]),
    }[case]()
    _against_cv2(tmp_path, data)


ALPHA_FORMS = [n for n in sorted(FORMS)
               if n.startswith(("alph_m0", "alph_m1", "cv2_rgba_q6", "pil_rgba_alpha"))]


@pytest.mark.parametrize("name", ALPHA_FORMS)
def test_alpha_plane_matches_cv2(name):
    """The ALPH stream the reads decode and drop, with its filter undone,
    equals the alpha cv2 gives for ``IMREAD_UNCHANGED``."""
    data = FORMS[name]()
    chunks = dict(mf.chunks_of(data))
    h, w = SMALL.shape[:2]
    rgb, alpha = decode_vp8(chunks[b"VP8 "], w, h, chunks[b"ALPH"], with_alpha=True)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(alpha, want[..., 3])
    np.testing.assert_array_equal(rgb, want[..., 2::-1])


# -- cuts and corruptions ------------------------------------------------------

CUT = ("lossless_17x33", "lossy_17x33", "alph_m1_f3", "alpha_libwebp_c1_f2", "exif6_lossy_le",
       "anim_lossy_bits0", "partitions8", "palette16", "segments4", "lossy_1x1")


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name + ".webp"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", CUT)
def test_every_cut_matches_cv2(name):
    data = _fixture(name)
    decoded = 0
    for n in range(1, len(data)):
        for cut in (data[:n], mf.fit_sizes(data[:n])):
            buf = np.frombuffer(cut, np.uint8)
            want = _cv2(lambda: cv2.imdecode(buf, cv2.IMREAD_COLOR))
            assert _same(_port(lambda: imdecode(cut)), want), (n, cut is not data[:n])
            decoded += isinstance(want, np.ndarray)
    assert decoded < len(data)  # nearly every cut is refused, as by cv2


@pytest.mark.parametrize("name", CUT + ("filter0_sharp7", "near_lossless60", "alph_m0_f1",
                                        "anim_lossless_bits3", "iccp", "lossless_method6"))
def test_corrupt_bytes_match_cv2(name):
    """Seeded flips of one or three bytes past the RIFF header, in both modes."""
    data = _fixture(name)
    rng = np.random.default_rng(sum(name.encode()))
    for k in range(60):
        b = bytearray(data)
        for _ in range(1 if k < 40 else 3):
            b[int(rng.integers(12, len(b)))] ^= int(rng.integers(1, 256))
        b = bytes(b)
        buf = np.frombuffer(b, np.uint8)
        for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            want = _cv2(lambda: cv2.imdecode(buf, flag))
            assert _same(_port(lambda: imdecode(b, mode)), want), (k, mode)


def test_alpha_stream_flips_match_cv2():
    """Each byte of a VP8L-coded ALPH payload flipped in turn: libwebp
    decodes the alpha stream for a colour read too, so most flips make the
    whole read None; the port agrees with cv2 on every one."""
    alpha = (mf.picture(12, 16, 13)[..., 0] // 64 * 85).astype(np.uint8)
    payload = mf.alph(alpha, 1, 0)
    vp8 = dict(mf.chunks_of(mf.cv2_webp(mf.picture(12, 16, 14), 80)))[b"VP8 "]
    nones = 0
    for i in range(1, len(payload)):
        for x in (0xFF, 0x01):
            flipped = payload[:i] + bytes([payload[i] ^ x]) + payload[i + 1:]
            data = mf.riff([mf.vp8x(0x10, 16, 12), (b"ALPH", flipped), (b"VP8 ", vp8)])
            want = _cv2(lambda: cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
            assert _same(_port(lambda: imdecode(data)), want), (i, x)
            nones += want is None
    assert nones > len(payload) // 2, nones


# -- the committed fixtures -------------------------------------------------------

FIXTURE_NAMES = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(FIXTURES,
                                                                                "*.webp")))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixtures_equal_cv2_and_the_port(name):
    path = os.path.join(FIXTURES, name + ".webp")
    stored = np.load(path[:-5] + ".npz")
    data = _fixture(name)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        for decode, cv_read, port_read in (
                (False, lambda: cv2.imread(path, flag), lambda: imread(path, mode)),
                (True, lambda: cv2.imdecode(np.frombuffer(data, np.uint8), flag),
                 lambda: imdecode(data, mode))):
            assert mf.matches(stored, mode, decode, _cv2(cv_read)), ("stored vs cv2", mode, decode)
            assert mf.matches(stored, mode, decode, _port(port_read)), ("port", mode, decode)


def test_fixture_set_is_complete():
    names = set(FIXTURE_NAMES)
    for t in mf.TIMED:
        assert t[:-5] in names
    assert {f"coco_{i:02d}" for i in range(mf.COCO_SCENES)} <= names
    assert len(names) >= 100
    size = sum(os.path.getsize(p) for p in glob.glob(os.path.join(FIXTURES, "*")))
    assert size < 2_200_000, size


# -- a COCO tree of WebP images ----------------------------------------------------


def _webp_coco_tree(root: str, n: int, ext=".jpg") -> tuple[str, str]:
    """``n`` committed 480 x 640 WebP scenes as a COCO tree (polygon people
    from ``coco_scenes.json``, 17 visible keypoints each), the files named
    ``<id><ext>`` (``ext`` a tuple: its extensions in turn)."""
    with open(os.path.join(FIXTURES, "coco_scenes.json")) as f:
        scenes = json.load(f)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, annotations = [], []
    for i in range(n):
        name = f"{i:012d}{ext if isinstance(ext, str) else ext[i % len(ext)]}"
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(_fixture(f"coco_{i:02d}"))
        images.append({"id": i, "file_name": name, "height": scenes["height"],
                       "width": scenes["width"]})
        for j, (cx, cy, ax, ay) in enumerate(scenes["people"][i]):
            ang = 2 * np.pi * np.arange(24) / 24
            ring = np.stack([cx + ax * np.cos(ang), cy + ay * np.sin(ang)], 1).round(2)
            kang = 2 * np.pi * np.arange(17) / 17
            keypoints = np.stack([cx + 0.6 * ax * np.cos(kang), cy + 0.6 * ay * np.sin(kang),
                                  np.full(17, 2)], 1).astype(int)
            annotations.append({"id": 2 * i + j, "image_id": i, "category_id": 1,
                                "segmentation": [ring.ravel().tolist()],
                                "bbox": [round(cx - ax, 2), round(cy - ay, 2), round(2 * ax, 2),
                                         round(2 * ay, 2)],
                                "keypoints": keypoints.ravel().tolist()})
    ann = os.path.join(root, "instances.json")
    with open(ann, "w") as f:
        json.dump({"categories": [{"id": 1, "name": "person"}], "images": images,
                   "annotations": annotations}, f)
    return img_dir, ann


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_webp_coco_tree_converts_as_jax(tmp_path):
    """WebP images under ``.jpg`` names (cv2 reads by content): both
    converters copy them and write the same tree, byte for byte (the ``.jpg``
    mix previews are cv2's JPEG bytes in both)."""
    img_dir, ann = _webp_coco_tree(str(tmp_path / "src"), 4)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann, port, progress=False) == 4
    assert jconv.transfer_coco(img_dir, ann, ref, progress=False) == 4
    files = _files(ref)
    assert _files(port) == files and len(files) == 4 * 7
    for rel in files:
        with open(os.path.join(port, rel), "rb") as a, open(os.path.join(ref, rel), "rb") as b:
            assert a.read() == b.read(), rel
    for i in range(4):
        with open(os.path.join(port, "image", f"{i:012d}.jpg"), "rb") as f:
            assert f.read() == _fixture(f"coco_{i:02d}")


def test_webp_named_tree_converts_as_jax(tmp_path):
    """ROADMAP C9: under ``.webp`` names (one ``.WEBP``) the mix preview is a
    WebP, which cv2 writes lossless.  Both converters write the same files,
    byte for byte, except the previews, which decode to the same pixels in
    cv2 and in the port's reader; both datasets read the trees alike, and
    the port takes 2 train steps on its tree."""
    img_dir, ann = _webp_coco_tree(str(tmp_path / "src"), 4, ext=(".webp",) * 3 + (".WEBP",))
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann, port, progress=False) == 4
    assert jconv.transfer_coco(img_dir, ann, ref, progress=False) == 4
    files = _files(ref)
    assert _files(port) == files and len(files) == 4 * 7
    previews = 0
    for rel in files:
        with open(os.path.join(port, rel), "rb") as a, open(os.path.join(ref, rel), "rb") as b:
            ours, theirs = a.read(), b.read()
        if not rel.startswith("mix" + os.sep):
            assert ours == theirs, rel
            continue
        assert ours[8:16] == theirs[8:16] == b"WEBPVP8L", rel
        want = cv2.imdecode(np.frombuffer(theirs, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(ours, np.uint8),
                                                   cv2.IMREAD_COLOR), want)
        np.testing.assert_array_equal(imread(os.path.join(port, rel)), want[..., ::-1])
        previews += 1
    assert previews == 4
    _same_datasets_and_train(port, ref, 8, 2, tmp_path)


def _same_datasets_and_train(port_dir: str, jax_dir: str, n: int, steps: int, tmp_path) -> None:
    """Both datasets read the converted trees alike (every field of the
    first 4 of ``n`` samples), then ``steps`` port train steps on a batch of
    them with finite losses."""
    port, ref = InstanceCommonDataset(port_dir, canvas=320), JaxDataset(jax_dir, canvas=320)
    assert len(port) == len(ref) == n
    for i in range(4):
        got, want = port.fetch(i), ref.fetch(i)
        for field in ("image", "mask", "image_hw", "obj_box", "mask_box", "keypoints"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                          err_msg=f"sample {i} {field}")
    cfg = TrainConfig(train_dataset_dir=port_dir, val_dataset_dir=port_dir,
                      checkpoint_dir=str(tmp_path / "ckpt"), out_dir=str(tmp_path / "runs"),
                      canvas=320, out_size=64, in_channels=20, bfloat16=False, batch_size=4,
                      learning_rate=3e-3, save_iou_gate=0.0, log_images=False)
    batch = host_batch([port.fetch(i) for i in range(4)])
    model = Segment(20)
    init_weights_(model, torch.Generator().manual_seed(0))
    state = TrainState.create(model, cfg.learning_rate)
    train_step = make_train_step(cfg)
    draws = draw_augment(4, augment_config(cfg, True))
    losses = []
    for _ in range(steps):
        state, metrics = train_step(state, batch, draws)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all(), losses


def test_webp_coco_tree_trains(tmp_path):
    """The converted WebP tree read by both datasets (every field equal),
    then a few port train steps on it."""
    img_dir, ann = _webp_coco_tree(str(tmp_path / "src"), 2)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann, port_dir, progress=False) == 2
    assert jconv.transfer_coco(img_dir, ann, jax_dir, progress=False) == 2
    _same_datasets_and_train(port_dir, jax_dir, 4, 3, tmp_path)


def test_reading_webp_loads_no_libwebp():
    """A process that decodes WebP through the port maps no libwebp (nor
    cv2 or PIL): the decoder is the port's own C++ (``build/native/
    libwebp_<hash>.so``, built from ``ops/native/webp.cpp``)."""
    code = (
        "import sys\n"
        "from instancesegmentation_tpu_torch.core.imread import imread\n"
        f"img = imread({os.path.join(FIXTURES, 'alph_m1_f3.webp')!r})\n"
        f"img = imread({os.path.join(FIXTURES, 'anim_lossy_bits1.webp')!r})\n"
        "import os, re\n"
        "files = {l.split()[-1] for l in open('/proc/self/maps') if '/' in l}\n"
        "names = {os.path.basename(f) for f in files}\n"
        "assert not [n for n in names if re.match(r'lib(webp|webpdemux|sharpyuv)\\.so', n)]\n"
        "assert [f for f in files if re.search(r'build/native/libwebp_[0-9a-f]+\\.so$', f)]\n"
        "assert 'cv2' not in sys.modules and 'PIL' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
