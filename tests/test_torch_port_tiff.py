"""TIFF and BigTIFF through the port's reader (``core/imread.py`` ->
``core/tiff.py``, the codes in ``ops/native/image_codes.cpp`` and
``ops/native/jpeg.cpp``) against live ``cv2.imread`` and ``cv2.imdecode``
(the JAX package's readers) in both read modes: every pixel equal where cv2
decodes, ``FileNotFoundError`` exactly where cv2 returns None; no TIFF
raises ``UnsupportedImage``.

- the container: both byte orders, classic and BigTIFF, strips and tiles,
  planar configuration 1 and 2, FillOrder 2, first directory only;
- the codecs: none, PackBits, LZW (and its old LSB-first form), Deflate (8
  and 32946), the horizontal predictor on 8 and 16 bits, JPEG with and
  without JPEGTables (4:4:4, 4:2:2, 4:2:0, in strips of 8, 16 and all rows,
  in tiles, short and narrow strips), CCITT RLE and RLEW (strips at even
  and odd offsets, which ``cv2.imread`` aligns by), Group 3 1-D and 2-D,
  Group 4 (widths up to 6000; damaged EOLs, libtiff's read without EOLs),
  ThunderScan, SGILog (LogL, LogLuv32, LogLuv24); the compressions cv2's
  libtiff is built without; an unknown compression code (a black image);
- the pixels: gray and bilevel at 1, 8 and 16 bits, MinIsWhite, palettes at
  1, 4 and 8 bits (16-bit and 8-bit colormaps), RGB and RGBA at 8 and 16
  bits (associated, unassociated, unspecified alpha), CMYK, subsampled
  YCbCr (every layout, strips and tiles, libtiff's 4 x 4 tile skew),
  CIELab at 8 and 16 bits (every 8-bit L and a, with and without a
  WhitePoint), LogL and LogLuv codes swept, the orientations (cv2.imread
  refuses 5-8, cv2.imdecode turns them), the forms cv2 refuses (2-bit,
  4-bit gray, 1-bit RGB, > 4 samples, ...);
- every cut length of small files, seeded corruptions of their headers and
  data (CCITT and SGILog strips among them), and the committed fixtures of
  ``tests/data/tiff`` (written by ``make_fixtures.py``) against the decodes
  stored beside them;
- a COCO tree of the 480 x 640 scenes of ``tests/data/coco_forms`` (CIELab,
  LogLuv, JPEGs whose EXIF cv2 gives up on) converted by both packages,
  read by both datasets and trained on by the port.
"""
import glob
import importlib.util
import io
import json
import os
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from instancesegmentation_tpu.data import converters as jconv
from instancesegmentation_tpu.data.dataset import InstanceCommonDataset as JaxDataset
from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.png import ImageSizeError
from instancesegmentation_tpu_torch.data import converters as tconv
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.pipeline import draw_augment, host_batch
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.train.config import TrainConfig
from instancesegmentation_tpu_torch.train.state import TrainState
from instancesegmentation_tpu_torch.train.steps import augment_config, make_train_step

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "tiff")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(FIXTURES, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tw = _load("tiff_writer")
H, W = 37, 53


def _pic(h, w, c, hi=256, seed=0):
    """Shading, edges and noise: ``[h, w, c]`` integers below ``hi``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 5 + y * 3) % hi, (x * 2 + y * 7 + 40) % hi, (x * y) % hi,
                     (x + y * 11) % hi][:c], -1)
    return (base + rng.integers(0, max(1, hi // 16), base.shape)) % hi


def _smooth(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7 + y / 11), 128 + 90 * np.cos(x / 5 - y / 13),
                    (x * 3 + y * 2) % 256], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def _outcome(got_fn, want):
    """One read against cv2's result (None: cv2 returns None)."""
    if want is None:
        with pytest.raises(FileNotFoundError):
            got_fn()
        return "none"
    got = got_fn()
    want = want[..., ::-1] if want.ndim == 3 else want
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return "decoded"


def _against_cv2(tmp_path, data: bytes, file: bool = True) -> dict:
    """``imdecode`` (and, with ``file``, ``imread`` of the bytes written out)
    against cv2 in both modes: {(source, mode): outcome}."""
    out = {}
    buf = np.frombuffer(data, np.uint8)
    path = str(tmp_path / "image.tif")
    if file:
        with open(path, "wb") as f:
            f.write(data)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        out["decode", mode] = _outcome(lambda: imdecode(data, mode), cv2.imdecode(buf, flag))
        if file:
            out["read", mode] = _outcome(lambda: imread(path, mode), cv2.imread(path, flag))
    return out


def _decoded(outcome: dict) -> bool:
    return set(outcome.values()) == {"decoded"}


# -- the container and the uncompressed forms ----------------------------------------


CONTAINER = {
    f"rgb_{o}_{'big' if big else 'classic'}_{c}": dict(
        samples=(3,), photometric=2, compression=c, order=o, big=big, rows_per_strip=8)
    for o in "<>" for big in (False, True) for c in (1, 5, 8, 32773, 32946)}


@pytest.mark.parametrize("name", sorted(CONTAINER))
def test_byte_orders_bigtiff_and_codecs_match_cv2(tmp_path, name):
    kw = dict(CONTAINER[name])
    (c,) = kw.pop("samples")
    assert _decoded(_against_cv2(tmp_path, tw.write_tiff(_pic(H, W, c), **kw)))


FORMS = {
    "rgb_lzw_pred": (_pic(H, W, 3), dict(photometric=2, compression=5, predictor=2,
                                         rows_per_strip=8)),
    "rgb16_deflate_pred_be": (_pic(H, W, 3, 65536), dict(bps=16, photometric=2, compression=8,
                                                         predictor=2, order=">")),
    "rgb16": (_pic(H, W, 3, 65536), dict(bps=16, photometric=2)),
    "rgba_unassoc": (_pic(H, W, 4), dict(photometric=2, extra_samples=(2,))),
    "rgba_assoc": (_pic(H, W, 4), dict(photometric=2, extra_samples=(1,))),
    "rgba_unspecified": (_pic(H, W, 4), dict(photometric=2)),
    "rgba16_unassoc": (_pic(H, W, 4, 65536), dict(bps=16, photometric=2, extra_samples=(2,))),
    "gray8": (_pic(H, W, 1), dict(photometric=1)),
    "gray8_minwhite": (_pic(H, W, 1), dict(photometric=0)),
    "gray16_be": (_pic(H, W, 1, 65536), dict(bps=16, photometric=1, order=">")),
    "gray16_minwhite": (_pic(H, W, 1, 65536), dict(bps=16, photometric=0)),
    "bilevel": (_pic(H, W, 1, 2), dict(bps=1, photometric=1, rows_per_strip=5)),
    "bilevel_minwhite_fill2_lzw": (_pic(H, W, 1, 2), dict(bps=1, photometric=0, fillorder=2,
                                                          compression=5)),
    "gray_alpha": (_pic(H, W, 2), dict(photometric=1, extra_samples=(2,))),
    "gray_alpha_planar": (_pic(H, W, 2), dict(photometric=1, extra_samples=(2,), planar=2)),
    "palette8": (_pic(H, W, 1), dict(
        photometric=3, colormap=np.random.default_rng(1).integers(0, 65536, (256, 3)))),
    "palette8_8bit_map": (_pic(H, W, 1), dict(
        photometric=3, colormap=np.random.default_rng(2).integers(0, 256, (256, 3)))),
    "palette4": (_pic(H, W, 1, 16), dict(
        bps=4, photometric=3, colormap=np.random.default_rng(3).integers(0, 65536, (16, 3)))),
    "palette1": (_pic(H, W, 1, 2), dict(
        bps=1, photometric=3, colormap=np.random.default_rng(4).integers(0, 65536, (2, 3)))),
    "rgb_planar_packbits": (_pic(H, W, 3), dict(photometric=2, planar=2, compression=32773,
                                                rows_per_strip=10)),
    "rgba_planar_unassoc": (_pic(H, W, 4), dict(photometric=2, planar=2, extra_samples=(2,))),
    "rgb16_planar": (_pic(H, W, 3, 65536), dict(bps=16, photometric=2, planar=2)),
    "cmyk": (_pic(H, W, 4), dict(photometric=5)),
    "cmyk_planar": (_pic(H, W, 4), dict(photometric=5, planar=2)),
    "lzw_old": (_pic(H, W, 3), dict(photometric=2, compression=5, lzw_old=True)),
    "packbits_fill2": (_pic(H, W, 3), dict(photometric=2, compression=32773, fillorder=2)),
    "larger_lzw": (_pic(200, 300, 3), dict(photometric=2, compression=5)),
    "no_photometric": (_pic(H, W, 3), dict(photometric=2, omit=(262,))),
    "gray2_refused": (_pic(H, W, 1, 4), dict(bps=2, photometric=1)),
    "gray4_refused": (_pic(H, W, 1, 16), dict(bps=4, photometric=1)),
    "rgb1_refused": (_pic(H, W, 3, 2), dict(bps=1, photometric=2, planar=2)),
    "five_samples_refused": (_pic(H, W, 4).repeat(2, axis=2)[..., :5],
                             dict(photometric=2, extra_samples=(0, 0))),
    "unknown_compression": (_pic(H, W, 3), dict(photometric=2, extra_tags={259: ("H", [12345])})),
}
for _sub in ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (1, 2), (4, 1)):
    FORMS[f"ycbcr_{_sub[0]}{_sub[1]}"] = (_pic(H, W, 3), dict(photometric=6, subsampling=_sub,
                                                             rows_per_strip=8))
    FORMS[f"ycbcr_{_sub[0]}{_sub[1]}_tiles"] = (_pic(H, W, 3), dict(
        photometric=6, subsampling=_sub, tile=(16, 16), compression=5))
FORMS["ycbcr_planar"] = (_pic(H, W, 3), dict(photometric=6, subsampling=(1, 1), planar=2))
for _t in ((16, 16), (32, 16), (16, 32), (32, 32)):
    FORMS[f"rgb_tiles_{_t[0]}x{_t[1]}"] = (_pic(H, W, 3), dict(photometric=2, tile=_t))
    FORMS[f"gray_tiles_{_t[0]}x{_t[1]}_lzw"] = (_pic(H, W, 1), dict(photometric=1, tile=_t,
                                                                   compression=5))
FORMS.update({
    "gray_alpha_tiles": (_pic(H, W, 2), dict(photometric=1, extra_samples=(2,), tile=(16, 16),
                                             compression=5)),
    "gray16_tiles": (_pic(H, W, 1, 65536), dict(bps=16, photometric=1, tile=(16, 16),
                                                compression=5)),
    "bilevel_tiles": (_pic(H, W, 1, 2), dict(bps=1, photometric=0, tile=(16, 16),
                                             compression=32773)),
    "cmyk_tiles": (_pic(H, W, 4), dict(photometric=5, tile=(16, 16), compression=5)),
    "rgb16_tiles": (_pic(H, W, 3, 65536), dict(bps=16, photometric=2, tile=(16, 16),
                                               compression=5)),
    "rgb_planar_tiles": (_pic(H, W, 3), dict(photometric=2, planar=2, tile=(32, 16))),
})


@pytest.mark.parametrize("name", sorted(FORMS))
def test_forms_match_cv2(tmp_path, name):
    samples, kw = FORMS[name]
    outcome = _against_cv2(tmp_path, tw.write_tiff(samples, **kw))
    assert "unsupported" not in outcome.values()
    if name.endswith("_refused"):
        assert set(outcome.values()) == {"none"}
    if name in ("rgb_tiles_32x32", "unknown_compression", "ycbcr_44_tiles"):
        assert _decoded(outcome)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("layout", ["strips", "tiles_lzw", "tiles"])
def test_orientations_match_cv2(tmp_path, orientation, layout):
    """2-4 mirror, turn or flip (libtiff mirrors each tile in place); 5-8:
    ``cv2.imread`` returns None, ``cv2.imdecode`` turns the image."""
    kw = {"strips": dict(rows_per_strip=7), "tiles_lzw": dict(tile=(16, 32), compression=5),
          "tiles": dict(tile=(16, 32))}[layout]
    outcome = _against_cv2(tmp_path, tw.write_tiff(_pic(H, W, 3), photometric=2,
                                                   orientation=orientation, **kw))
    if orientation >= 5:
        assert outcome["read", "color"] == "none"
        assert layout == "tiles" or outcome["decode", "color"] == "decoded"


# -- PIL's files ---------------------------------------------------------------------

def _pil(arr, mode, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, format="TIFF", **kwargs)
    return buf.getvalue()


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                                         "packbits", "jpeg"])
def test_pil_files_match_cv2(tmp_path, compression):
    """PIL (libtiff's writer) in every mode it saves: RGB, L, RGBA, CMYK, P,
    1, YCbCr, LA, I;16 (JPEG: the modes it compresses), BigTIFF, strips,
    two pages (the first read)."""
    a = _smooth(H, W)
    modes = ("RGB", "L", "RGBA", "CMYK", "YCbCr") + (
        () if compression == "jpeg" else ("P", "1", "LA", "I;16", "I;16B"))
    for mode in modes:
        assert _decoded(_against_cv2(tmp_path, _pil(a, mode, compression=compression))), mode
    if compression == "tiff_lzw":
        for kwargs in (dict(big_tiff=True), dict(strip_size=600)):
            assert _decoded(_against_cv2(tmp_path, _pil(a, "RGB", compression=compression,
                                                        **kwargs)))
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="TIFF", save_all=True, compression=compression,
                                append_images=[Image.fromarray(a[::-1])])
        assert _decoded(_against_cv2(tmp_path, buf.getvalue()))


# -- JPEG-in-TIFF --------------------------------------------------------------------


def _jpeg(part, flag=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420):
    bgr = part[..., ::-1] if part.shape[2] == 3 else part[..., 0]
    args = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag]
    return cv2.imencode(".jpg", np.ascontiguousarray(bgr), args)[1].tobytes()


@pytest.mark.parametrize("sub", [(2, 2), (2, 1), (1, 1)])
def test_jpeg_in_tiff_matches_cv2(tmp_path, sub):
    """YCbCr strips converted to RGB each with its own edges (fancy
    upsampling per strip), with and without JPEGTables, in strips of 8, 16
    and all rows and in tiles."""
    flag = {(2, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, (2, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            (1, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[sub]
    a = _smooth(H, W, 1)
    tables = tw.split_jpeg_tables(_jpeg(a))[0]
    for rps in (8, 16, H):
        assert _decoded(_against_cv2(tmp_path, tw.write_tiff(
            a, photometric=6, subsampling=sub, compression=7, rows_per_strip=rps,
            jpeg_strip=lambda p: _jpeg(p, flag))))
        assert _decoded(_against_cv2(tmp_path, tw.write_tiff(
            a, photometric=6, subsampling=sub, compression=7, rows_per_strip=rps,
            jpeg_strip=lambda p: tw.split_jpeg_tables(_jpeg(p, flag))[1], jpeg_tables=tables)))
    assert _decoded(_against_cv2(tmp_path, tw.write_tiff(
        a, photometric=6, subsampling=sub, compression=7, tile=(16, 16),
        jpeg_strip=lambda p: _jpeg(p, flag))))


def test_jpeg_in_tiff_odd_strips_match_cv2(tmp_path):
    """No YCbCrSubsampling tag (libtiff takes the first strip's), a tag the
    stream contradicts (refused), FillOrder 2 (the JPEG codec reads its
    bytes as they are), a last strip coded taller than its rows, a middle
    one taller (refused), strips shorter and narrower than the strip (the
    rest zero), a progressive strip, gray with its tables in JPEGTables."""
    a = _smooth(H, W, 2)

    def pad(p, rows):
        return np.pad(p, ((0, rows - p.shape[0]), (0, 0), (0, 0)), mode="edge")

    cases = {
        "no_subsampling_tag": (dict(subsampling=None), lambda p: _jpeg(p), "decoded"),
        "contradicting_tag": (dict(subsampling=(2, 1)), lambda p: _jpeg(p), "none"),
        "fillorder2": (dict(subsampling=(2, 2), fillorder=2), lambda p: _jpeg(p), "none"),
        "tall_last": (dict(subsampling=(2, 2)), lambda p: _jpeg(pad(p, 16)), "decoded"),
        "tall_middle": (dict(subsampling=(2, 2)), lambda p: _jpeg(pad(p, 24)), "none"),
        "short": (dict(subsampling=(2, 2)), lambda p: _jpeg(p[:10]), "decoded"),
        "narrow": (dict(subsampling=(2, 2)), lambda p: _jpeg(p[:, :40]), "decoded"),
        "progressive": (dict(subsampling=(2, 2)),
                        lambda p: cv2.imencode(".jpg", np.ascontiguousarray(p[..., ::-1]),
                                               [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes(),
                        "decoded"),
    }
    for name, (kw, enc, expect) in cases.items():
        data = tw.write_tiff(a, photometric=6, compression=7, rows_per_strip=16, jpeg_strip=enc,
                             **kw)
        outcome = _against_cv2(tmp_path, data)
        assert set(outcome.values()) == {expect}, name
    gray = a[..., :1]
    data = tw.write_tiff(gray, photometric=1, compression=7, rows_per_strip=16,
                         jpeg_strip=lambda p: tw.split_jpeg_tables(_jpeg(p))[1],
                         jpeg_tables=tw.split_jpeg_tables(_jpeg(gray))[0])
    assert _decoded(_against_cv2(tmp_path, data))


# -- CCITT and ThunderScan -----------------------------------------------------------


@pytest.mark.parametrize("size", [(7, 1), (13, 33), (40, 3000), (9, 6000), (30, 257)])
def test_ccitt_matches_cv2(tmp_path, size):
    """PIL's (libtiff's) RLE, Group 3 1-D and 2-D (with fill bits), Group 4,
    FillOrder 2, several strips, of random and blocky 1-bit images whose
    runs reach every make-up code."""
    h, w = size
    rng = np.random.default_rng(h * w)
    for p in (0.5, 0.05, 0.95):
        rand = rng.random((h, w)) < p
        blocky = np.repeat(np.repeat(rng.random((h // 3 + 1, w // 50 + 1)) < p, 3, 0), 50,
                           1)[:h, :w]
        for a in (rand, blocky):
            a8 = a.astype(np.uint8) * 255
            for compression, info in (("tiff_ccitt", {}), ("group3", {}), ("group3", {292: 1}),
                                      ("group3", {292: 5}), ("group4", {}),
                                      ("group4", {266: 2}), ("group3", {292: 1, 266: 2}),
                                      ("group4", {278: 4})):
                data = _pil(a8, "1", compression=compression, tiffinfo=info)
                assert _decoded(_against_cv2(tmp_path, data, file=False)), (compression, info)


def test_thunderscan_matches_cv2(tmp_path):
    """4-bit palette ThunderScan strips: raw pixels, and 300 strips of
    random codes (runs that pass the row's end, deltas, short rows)."""
    rng = np.random.default_rng(9)
    pal = rng.integers(0, 65536, (16, 3))
    raw = tw.write_tiff(_pic(H, W, 1, 16), bps=4, photometric=3, colormap=pal, compression=7,
                        jpeg_strip=lambda p: bytes(0xC0 | int(v) for v in p.ravel()),
                        extra_tags={259: ("H", [32809])})
    assert _decoded(_against_cv2(tmp_path, raw))
    for _ in range(300):
        h, w = int(rng.integers(1, 9)), int(rng.integers(1, 40))
        data = tw.write_tiff(
            rng.integers(0, 16, (h, w, 1)), bps=4, photometric=3, colormap=pal, compression=7,
            jpeg_strip=lambda p: bytes(rng.integers(0, 256, int(rng.integers(0, 30))).tolist()),
            extra_tags={259: ("H", [32809])}, rows_per_strip=int(rng.integers(1, 9)))
        _against_cv2(tmp_path, data, file=False)


# -- what the port does not decode ---------------------------------------------------


def test_unported_and_unconfigured_forms(tmp_path):
    """The forms that raised ``UnsupportedImage`` until they were ported
    decode equal to cv2: CIELab (PIL's LAB), LogLuv (SGILog24) and CCITT
    RLEW; ``FileNotFoundError`` for the compressions cv2's libtiff is built
    without (old-style JPEG, PixarLog, LZMA, ZSTD, WebP, JBIG, LERC) and for
    NeXT (2-bit samples, which cv2 refuses)."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    ok, jpg = cv2.imencode(".jpg", img[..., ::-1].copy())
    unported = {
        "cielab": _pil(img, "LAB"),
        "sgilog24": tw.write_tiff(img, photometric=32845, extra_tags={259: ("H", [34677])}),
        "rlew": tw.write_tiff(np.ones((20, 64, 1), int), bps=1, photometric=0, compression=7,
                              jpeg_strip=lambda p: bytes([0xD9, 0xA8, 0, 0]) * 20,
                              extra_tags={259: ("H", [32771])}),
    }
    for name, data in unported.items():
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None, name
        assert _decoded(_against_cv2(tmp_path, data)), name
    refused = {
        "ojpeg": tw.write_tiff(img, photometric=6, subsampling=(2, 2), compression=7,
                               jpeg_strip=lambda p: jpg.tobytes(),
                               extra_tags={259: ("H", [6]), 513: ("I", [8]),
                                           514: ("I", [len(jpg)])}),
        "pixarlog": tw.write_tiff(img, photometric=2, compression=7,
                                  jpeg_strip=lambda p: zlib.compress(bytes(p.size * 2)),
                                  extra_tags={259: ("H", [32909])}),
        "next": tw.write_tiff(img[..., :1] % 4, bps=2, photometric=1, compression=7,
                              jpeg_strip=lambda p: bytes(p.size), extra_tags={259: ("H", [32766])}),
    }
    for code in (34661, 34887, 34925, 50000, 50001):
        refused[str(code)] = tw.write_tiff(img, photometric=2, extra_tags={259: ("H", [code])})
    for name, data in refused.items():
        assert set(_against_cv2(tmp_path, data).values()) == {"none"}, name


# -- cut and corrupt data ------------------------------------------------------------


CUT = {
    "rgb_lzw": dict(samples=_pic(9, 13, 3), photometric=2, compression=5, rows_per_strip=4),
    "rgb_raw_ifd_first": dict(samples=_pic(9, 13, 3), photometric=2, ifd_first=True),
    "gray16_deflate_be_big": dict(samples=_pic(9, 13, 1, 65536), bps=16, photometric=1,
                                  compression=8, order=">", big=True),
    "ycbcr_packbits_tiles": dict(samples=_pic(9, 13, 3), photometric=6, subsampling=(2, 2),
                                 tile=(16, 16), compression=32773),
    "cmyk_planar": dict(samples=_pic(9, 13, 4), photometric=5, planar=2),
}


@pytest.mark.parametrize("name", sorted(CUT))
def test_every_cut_matches_cv2(tmp_path, name):
    """Every cut length of a small file: the header, the directory, the
    values it points at and the strips cut short."""
    kw = dict(CUT[name])
    data = tw.write_tiff(kw.pop("samples"), **kw)
    outcomes = [_against_cv2(tmp_path, data[:cut], file=False) for cut in range(1, len(data))]
    assert outcomes[0] == {("decode", "color"): "none", ("decode", "gray"): "none"}
    assert _decoded(_against_cv2(tmp_path, data))


def test_corrupt_bytes_match_cv2(tmp_path):
    """400 seeded corruptions (one to three bytes, the header and directory
    the likelier) of ten small files, Group 3 1-D, Group 3 2-D, Group 4 and
    RLEW strips among them: the port reads each as cv2 does, or raises
    ``ImageSizeError`` where cv2 raises; nothing else escapes."""
    rng = np.random.default_rng(11)
    sources = [tw.write_tiff(_pic(H, W, 3), photometric=2, compression=c, rows_per_strip=8)
               for c in (1, 5, 32773)]
    sources += [tw.write_tiff(_pic(H, W, 1, 2), bps=1, photometric=1, rows_per_strip=5),
                tw.write_tiff(_pic(H, W, 3), photometric=6, subsampling=(2, 2), rows_per_strip=8),
                tw.write_tiff(_pic(H, W, 3), photometric=2, tile=(16, 16), compression=5)]
    bits = (_pic(H, W, 1, 2)[..., 0] * 255).astype(np.uint8)
    sources += [_pil(bits, "1", compression="group3", tiffinfo={278: 12}),
                _pil(bits, "1", compression="group3", tiffinfo={292: 1, 278: 12}),
                _pil(bits, "1", compression="group4", tiffinfo={278: 12}),
                _rlew(_pic(H, W, 1, 2), rows_per_strip=12, lead=1)]
    for i in range(400):
        data = bytearray(sources[i % len(sources)])
        for _ in range(int(rng.integers(1, 4))):
            at = int(rng.integers(0, min(len(data), 300) if rng.random() < 0.5 else len(data)))
            data[at] = int(rng.integers(0, 256))
        data = bytes(data)
        try:
            cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        except cv2.error:
            with pytest.raises(ImageSizeError):
                imdecode(data)
            continue
        _against_cv2(tmp_path, data, file=False)


# -- C11: CCITT strips with damaged EOLs ---------------------------------------------


def _rlew(samples, **kw):
    """CCITT RLEW (32771) strips of 1-bit ``samples`` [h, w, 1] (1 black)."""
    return tw.write_tiff(samples, bps=1, photometric=kw.pop("photometric", 0), compression=7,
                         jpeg_strip=tw.ccitt_rlew, extra_tags={259: ("H", [32771])}, **kw)


@pytest.mark.parametrize("compression", ["group3_1d", "group3_2d", "group4"])
def test_ccitt_damaged_strips_match_cv2(tmp_path, compression):
    """C11: 300 seeded damages (bytes replaced, bits flipped, runs of zeros)
    inside the strips of CCITT files of one and of several strips: libtiff's
    bad-row rules (a code that fits no table, an EOL missing or found early,
    a Group 3 strip read again without EOLs once an EOL search runs out of
    data, the run arrays kept from strip to strip and their overflow) give
    cv2's rows, and cv2's None where it returns None."""
    comp, info = {"group3_1d": ("group3", {}), "group3_2d": ("group3", {292: 1}),
                  "group4": ("group4", {})}[compression]
    rng = np.random.default_rng({"group3_1d": 21, "group3_2d": 22, "group4": 23}[compression])
    sources = []
    for h, w, rps in ((13, 33, 13), (20, 70, 4), (9, 200, 9)):
        for p in (0.5, 0.1):
            a = rng.random((h, w)) < p
            blocky = np.repeat(np.repeat(rng.random((h // 3 + 1, w // 10 + 1)) < p, 3, 0), 10,
                               1)[:h, :w]
            for arr in (a, blocky):
                sources.append(_pil(arr.astype(np.uint8) * 255, "1", compression=comp,
                                    tiffinfo={**info, 278: rps}))
    for i in range(300):
        data = bytearray(sources[i % len(sources)])
        end = int.from_bytes(data[4:8], "little")  # PIL writes the strips before the IFD
        kind = i % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 4))):
                data[int(rng.integers(8, end))] = int(rng.integers(0, 256))
        elif kind == 1:
            data[int(rng.integers(8, end))] ^= 1 << int(rng.integers(0, 8))
        else:
            at, n = int(rng.integers(8, end)), int(rng.integers(1, 4))
            data[at:at + n] = bytes(n)
        _against_cv2(tmp_path, bytes(data), file=False)


def test_rlew_matches_cv2(tmp_path):
    """CCITT RLEW: rows aligned to 16 bits from the strip's first byte,
    whose address parity is its file offset where ``cv2.imread`` maps the
    file (FillOrder 2 too: the CCITT codec reverses bits itself) and even
    where ``cv2.imdecode`` reads the strip into its buffer; strips at even
    and odd offsets, one and several strips, then 100 damaged ones."""
    rng = np.random.default_rng(31)
    for i in range(60):
        h, w = int(rng.integers(1, 20)), int(rng.integers(1, 90))
        a = (rng.random((h, w, 1)) < rng.choice([0.05, 0.5, 0.9])).astype(int)
        if i % 2:
            a = np.repeat(a[:, ::7], 7, 1)[:, :w]
        data = _rlew(a, rows_per_strip=int(rng.integers(1, h + 1)), lead=i % 4,
                     fillorder=1 + i % 3 // 2, photometric=i % 5 % 2)
        outcome = _against_cv2(tmp_path, data)
        assert _decoded(outcome), i
    for i in range(100):
        h, w = int(rng.integers(2, 14)), int(rng.integers(5, 60))
        data = bytearray(_rlew((rng.random((h, w, 1)) < 0.4).astype(int), lead=i % 2,
                               rows_per_strip=int(rng.integers(1, h + 1))))
        end = int.from_bytes(data[4:8], "little")
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(8, max(9, end)))] = int(rng.integers(0, 256))
        _against_cv2(tmp_path, bytes(data))


# -- CIELab and SGILog ----------------------------------------------------------------


lw = _load("libtiff_writer")
needs_libtiff = pytest.mark.skipif(not lw.available(),
                                   reason="no libtiff with SGILog to write the fixtures")


def _lab(h, w, bits, seed=0):
    rng = np.random.default_rng(seed)
    half = 1 << (bits - 1)
    return np.stack([rng.integers(0, 2 * half, (h, w)), rng.integers(-half, half, (h, w)),
                     rng.integers(-half, half, (h, w))], -1)


def _xyz(h, w, seed=0):
    """XYZ over nine decades, with runs and zeros (LogLuv's 0 code)."""
    rng = np.random.default_rng(seed)
    xyz = np.exp(rng.uniform(-14, 6, (h, w, 3))).astype(np.float32)
    xyz[:, : w // 3] = xyz[:, :1]
    xyz[rng.random((h, w)) < 0.1] = 0
    return xyz


LAST_FORMS = {
    "cielab8_pil": lambda: _pil(_smooth(H, W), "LAB"),
    "cielab8_strips": lambda: lw.cielab(_lab(H, W, 8, 1), rows_per_strip=5),
    "cielab8_whitepoint": lambda: lw.cielab(_lab(H, W, 8, 2), whitepoint=(0.3127, 0.329)),
    "cielab8_whitepoint_odd": lambda: lw.cielab(_lab(H, W, 8, 3), whitepoint=(0.45, 0.12)),
    "cielab8_tiles_lzw": lambda: tw.write_tiff(_lab(H, W, 8, 4) & 0xFF, photometric=8,
                                               tile=(16, 16), compression=5),
    "cielab8_deflate_pred_be": lambda: tw.write_tiff(_lab(H, W, 8, 5) & 0xFF, photometric=8,
                                                     compression=8, predictor=2, order=">"),
    "cielab16": lambda: lw.cielab(_lab(H, W, 16, 6), bps=16, rows_per_strip=8),
    "cielab16_whitepoint": lambda: lw.cielab(_lab(H, W, 16, 7), bps=16, whitepoint=(0.3, 0.35)),
    "cielab16_tiles_be": lambda: tw.write_tiff(_lab(H, W, 16, 8) & 0xFFFF, bps=16,
                                               photometric=8, tile=(32, 16), order=">"),
    "cielab16_orient3": lambda: tw.write_tiff(_lab(H, W, 16, 9) & 0xFFFF, bps=16,
                                              photometric=8, orientation=3, rows_per_strip=8),
    "logl": lambda: lw.sgilog(_xyz(H, W, 10)[..., 1], rows_per_strip=7),
    "logl_negative": lambda: lw.sgilog(-_xyz(H, W, 11)[..., 1]),
    "logl_16bit": lambda: lw.sgilog(np.random.default_rng(12).integers(-32768, 32768, (H, W)),
                                    datafmt=lw.SGILOGDATAFMT_16BIT),
    "logluv32": lambda: lw.sgilog(_xyz(H, W, 13), rows_per_strip=7),
    "logluv32_48bit": lambda: lw.sgilog(
        np.random.default_rng(14).integers(-32768, 32768, (H, W, 3)),
        datafmt=lw.SGILOGDATAFMT_16BIT),
    "logluv24": lambda: lw.sgilog(_xyz(H, W, 15), lw.SGILOG24, rows_per_strip=7),
    "logluv24_one_strip": lambda: lw.sgilog(_xyz(H, W, 16), lw.SGILOG24),
    "logluv24_tiles": lambda: tw.write_tiff(
        np.zeros((H, W, 3), int), bps=16, photometric=32845, tile=(16, 16), compression=7,
        jpeg_strip=lambda p: np.random.default_rng(p.size).integers(
            0, 256, p.shape[0] * p.shape[1] * 3).astype(np.uint8).tobytes(),
        extra_tags={259: ("H", [34677]), 339: ("H", [2] * 3)}),
    "logluv32_orient2": lambda: tw.write_tiff(
        np.zeros((H, W, 3), int), bps=16, photometric=32845, compression=7, orientation=2,
        jpeg_strip=lambda p: _luv32_literals(np.random.default_rng(18).integers(
            0, 1 << 32, p.shape[:2], dtype=np.uint64).astype(np.uint32)),
        extra_tags={259: ("H", [34676]), 339: ("H", [2] * 3)}),
    "rlew_even": lambda: _rlew(_pic(H, W, 1, 2), rows_per_strip=8),
    "rlew_odd_fill2": lambda: _rlew(_pic(H, W, 1, 2), rows_per_strip=8, lead=1, fillorder=2),
}
#: refused where TIFFRGBAImage or the SGILog codec refuses them
LAST_FORMS_REFUSED = {
    "cielab_planar": lambda: tw.write_tiff(_lab(H, W, 8) & 0xFF, photometric=8, planar=2),
    "cielab_whitepoint_y0": lambda: lw.cielab(_lab(H, W, 8), whitepoint=(0.3, 0.0)),
    "cielab_4_samples": lambda: tw.write_tiff(np.dstack([_lab(H, W, 8) & 0xFF,
                                                         np.zeros((H, W), int)]), photometric=8),
    "logl_3_samples": lambda: tw.write_tiff(np.zeros((H, W, 3), int), bps=16, photometric=32844,
                                            compression=7, jpeg_strip=lambda p: bytes(100),
                                            extra_tags={259: ("H", [34676])}),
    "logluv_lzw": lambda: tw.write_tiff(np.zeros((H, W, 3), int), bps=16, photometric=32845,
                                        compression=5),
    "sgilog_rgb": lambda: tw.write_tiff(np.zeros((H, W, 3), int), photometric=2, compression=7,
                                        jpeg_strip=lambda p: bytes(100),
                                        extra_tags={259: ("H", [34676])}),
}


def _luv32_literals(codes: np.ndarray) -> bytes:
    """LogLuv32 rows of ``codes`` [h, w] uint32: each byte plane as literal
    runs of up to 127 bytes."""
    out = bytearray()
    for row in codes:
        for shift in (24, 16, 8, 0):
            plane = ((row >> shift) & 0xFF).astype(np.uint8).tobytes()
            for i in range(0, len(plane), 127):
                out += bytes([len(plane[i:i + 127])]) + plane[i:i + 127]
    return bytes(out)


@needs_libtiff
@pytest.mark.parametrize("name", sorted(LAST_FORMS))
def test_last_forms_match_cv2(tmp_path, name):
    """CIELab (8 and 16 bits, strips and tiles, a WhitePoint or D50),
    LogL, LogLuv32 and LogLuv24 (libtiff's files from float and from
    16-bit data, raw codes, tiles) and RLEW decode bit-equal to
    ``cv2.imread`` and ``cv2.imdecode`` in both modes."""
    assert _decoded(_against_cv2(tmp_path, LAST_FORMS[name]()))


@needs_libtiff
@pytest.mark.parametrize("name", sorted(LAST_FORMS_REFUSED))
def test_last_forms_refused_as_cv2(tmp_path, name):
    """Separate CIELab, a WhitePoint y of 0, CIELab of 4 samples, LogL of 3
    samples, LogLuv without SGILog and SGILog of RGB: None in cv2,
    ``FileNotFoundError`` in the port."""
    assert set(_against_cv2(tmp_path, LAST_FORMS_REFUSED[name]()).values()) == {"none"}


@needs_libtiff
def test_cielab8_values_match_cv2(tmp_path):
    """Every 8-bit L and a, with b every 17th value, and 16-bit samples
    spread over their range under three white points."""
    L, A, B = np.meshgrid(np.arange(256), np.arange(-128, 128), np.arange(-128, 128, 17),
                          indexing="ij")
    lab = np.stack([L, A, B], -1).reshape(256, -1, 3)
    assert _decoded(_against_cv2(tmp_path, lw.cielab(lab), file=False))
    for wp in (None, (0.3127, 0.329), (0.5, 0.1)):
        assert _decoded(_against_cv2(tmp_path, lw.cielab(_lab(256, 512, 16, 40), bps=16,
                                                         whitepoint=wp), file=False))


def test_sgilog_codes_match_cv2(tmp_path):
    """Every LogL code (16 bits), every 7th LogLuv24 code (24 bits), and
    LogLuv32 codes over every L with four (u, v) and every (u, v) with five
    L, written as raw codes, against cv2 in both modes."""
    def tiff(codes, compression, photometric, spp, strip):
        return tw.write_tiff(np.zeros(codes.shape + (spp,), int), bps=16, photometric=photometric,
                             compression=7, jpeg_strip=lambda p: strip,
                             extra_tags={259: ("H", [compression]), 339: ("H", [2] * spp)})
    logl = np.arange(1 << 16, dtype=np.uint32).reshape(64, 1024)
    planes = bytearray()
    for row in logl:
        for shift in (8, 0):
            plane = ((row >> shift) & 0xFF).astype(np.uint8).tobytes()
            for i in range(0, len(plane), 127):
                planes += bytes([len(plane[i:i + 127])]) + plane[i:i + 127]
    assert _decoded(_against_cv2(tmp_path, tiff(logl, 34676, 32844, 1, bytes(planes)),
                                 file=False))
    luv24 = np.arange(0, 1 << 24, 7, dtype=np.uint32)[:(1 << 24) // 7 // 2048 * 2048]
    luv24 = luv24.reshape(-1, 2048)
    strip = np.stack([luv24 >> 16, luv24 >> 8, luv24], -1).astype(np.uint8).tobytes()
    assert _decoded(_against_cv2(tmp_path, tiff(luv24, 34677, 32845, 3, strip), file=False))
    every = np.arange(1 << 16, dtype=np.uint32)
    luv32 = np.concatenate([(every << 16) | uv for uv in (0, 0x8080, 0xFFFF, 0x5A91)] +
                           [(np.uint32(l) << 16) | every for l in (0, 0x3000, 0x4800, 0x7FFF,
                                                                   0x8123)]).reshape(-1, 1024)
    assert _decoded(_against_cv2(tmp_path, tiff(luv32, 34676, 32845, 3, _luv32_literals(luv32)),
                                 file=False))


@needs_libtiff
@pytest.mark.parametrize("name", ["logl", "logluv32", "logluv24", "cielab16_tiles_be",
                                  "rlew_odd_fill2"])
def test_every_cut_of_the_last_forms_matches_cv2(tmp_path, name):
    """Every cut length of a small file of each new form (9 x 13): its
    header, directory and strips cut short."""
    small = {
        "logl": lambda: lw.sgilog(_xyz(9, 13, 50)[..., 1], rows_per_strip=4),
        "logluv32": lambda: lw.sgilog(_xyz(9, 13, 51), rows_per_strip=4),
        "logluv24": lambda: lw.sgilog(_xyz(9, 13, 52), lw.SGILOG24, rows_per_strip=4),
        "cielab16_tiles_be": lambda: tw.write_tiff(_lab(9, 13, 16, 53) & 0xFFFF, bps=16,
                                                   photometric=8, tile=(32, 16), order=">"),
        "rlew_odd_fill2": lambda: _rlew(_pic(9, 13, 1, 2), rows_per_strip=4, lead=1,
                                        fillorder=2),
    }
    data = small[name]()
    for cut in range(1, len(data)):
        _against_cv2(tmp_path, data[:cut], file=False)
    assert _decoded(_against_cv2(tmp_path, data))


@needs_libtiff
def test_corrupt_sgilog_and_cielab_match_cv2(tmp_path):
    """300 seeded corruptions of LogL, LogLuv32, LogLuv24 and CIELab files
    (runs that overrun a row, rows the data cannot fill, bad directory
    values): the port reads each as cv2 does."""
    rng = np.random.default_rng(61)
    sources = [lw.sgilog(_xyz(7, 19, 62)[..., 1], rows_per_strip=3),
               lw.sgilog(_xyz(7, 19, 63), rows_per_strip=3),
               lw.sgilog(_xyz(7, 19, 64), lw.SGILOG24, rows_per_strip=3),
               lw.cielab(_lab(7, 19, 16, 65), bps=16, whitepoint=(0.3, 0.3))]
    for i in range(300):
        data = bytearray(sources[i % len(sources)])
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        _against_cv2(tmp_path, bytes(data), file=False)


def test_reading_tiff_loads_no_libtiff():
    """A process that decodes the new forms through the port maps no
    libtiff (nor cv2 or PIL): the codecs are the port's own C++."""
    code = (
        "import sys\n"
        "from instancesegmentation_tpu_torch.core.imread import imread\n"
        f"for n in ('logluv32', 'logluv24', 'logl', 'cielab16', 'ccitt_rlew_odd'):\n"
        f"    imread({FIXTURES!r} + '/' + n + '.tif')\n"
        "files = {l.split()[-1] for l in open('/proc/self/maps') if '/' in l}\n"
        "bad = [f for f in files if 'tiff' in f.lower() or 'cv2' in f or 'PIL' in f]\n"
        "assert not bad, bad\n"
        "assert 'cv2' not in sys.modules and 'PIL' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# -- a COCO tree of the new forms -----------------------------------------------------


SCENES = os.path.join(os.path.dirname(__file__), "data", "coco_forms")


def _scene_tree(root: str, indices) -> tuple[str, str]:
    """The committed scenes ``indices`` of ``tests/data/coco_forms`` as a
    COCO tree (each under a ``.jpg`` name: cv2 and the port read by
    content), its people as 24-point polygons with 17 visible keypoints."""
    with open(os.path.join(SCENES, "coco_scenes.json")) as f:
        scenes = json.load(f)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, annotations = [], []
    for i in indices:
        name = f"{i:012d}.jpg"
        with open(os.path.join(SCENES, scenes["files"][i]), "rb") as src, \
                open(os.path.join(img_dir, name), "wb") as dst:
            dst.write(src.read())
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


def test_last_forms_coco_tree_converts_as_jax(tmp_path):
    """Scenes of every form (8- and 16-bit CIELab, LogLuv32, JPEGs whose
    EXIF cv2 gives up on): both converters copy them and write the same
    tree, byte for byte."""
    idx = (0, 9, 17, 26)
    img_dir, ann = _scene_tree(str(tmp_path / "src"), idx)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann, port, progress=False) == len(idx)
    assert jconv.transfer_coco(img_dir, ann, ref, progress=False) == len(idx)
    files = _files(ref)
    assert _files(port) == files and len(files) == len(idx) * 7
    for rel in files:
        with open(os.path.join(port, rel), "rb") as a, open(os.path.join(ref, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_last_forms_coco_tree_trains(tmp_path):
    """The converted tree read by both datasets (every field equal; the
    EXIF scenes unturned, as cv2 reads them), then port train steps on it
    on the CPU."""
    idx = (3, 12, 20, 30)
    img_dir, ann = _scene_tree(str(tmp_path / "src"), idx)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann, port_dir, progress=False) == len(idx)
    assert jconv.transfer_coco(img_dir, ann, jax_dir, progress=False) == len(idx)
    port, ref = InstanceCommonDataset(port_dir, canvas=320), JaxDataset(jax_dir, canvas=320)
    assert len(port) == len(ref) == 2 * len(idx)
    for i in range(len(port)):
        got, want = port.fetch(i), ref.fetch(i)
        for field in ("image", "mask", "image_hw", "obj_box", "mask_box", "keypoints"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                          err_msg=f"sample {i} {field}")
        assert tuple(got.image_hw) == (240, 320)  # 480 x 640, unturned, on the 320 canvas
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
    for _ in range(2):
        state, metrics = train_step(state, batch, draws)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all(), losses


def test_tif_named_tree_converts_as_jax(tmp_path):
    """ROADMAP A15, done: under ``.tif`` names the mix preview is the TIFF
    that cv2's encoder writes (libtiff's LZW with the horizontal
    predictor); the port writes the same tree, byte for byte."""
    img_dir, ann = _scene_tree(str(tmp_path / "src"), (0, 1))
    with open(ann) as f:
        tree = json.load(f)
    for image, ext in zip(tree["images"], (".tif", ".TIFF")):
        name = image["file_name"].replace(".jpg", ext)
        os.rename(os.path.join(img_dir, image["file_name"]), os.path.join(img_dir, name))
        image["file_name"] = name
    with open(ann, "w") as f:
        json.dump(tree, f)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert jconv.transfer_coco(img_dir, ann, ref, progress=False) == 2
    assert tconv.transfer_coco(img_dir, ann, port, progress=False) == 2
    files = _files(ref)
    assert _files(port) == files and len(files) == 2 * 7
    assert "mix/000000000000.tif" in files and "mix/000000000001.TIFF" in files
    for rel in files:
        with open(os.path.join(port, rel), "rb") as a, open(os.path.join(ref, rel), "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("index", range(32))
def test_coco_scenes_equal_cv2_and_the_port(index):
    """The decodes stored beside each scene (SHA-256) are still cv2's, and
    the port reads the file and decodes its bytes to them (``chip_smoke.py``
    repeats the latter on the card's machine)."""
    with open(os.path.join(SCENES, "coco_scenes.json")) as f:
        name = json.load(f)["files"][index]
    path = os.path.join(SCENES, name)
    with open(path, "rb") as f:
        data = f.read()
    stored = np.load(os.path.join(SCENES, f"coco_{index:02d}.npz"))
    live = _fixtures.cv2_reads(path, data)
    assert sorted(live) == sorted(stored.files)
    assert tuple(stored["color_shape"]) == (480, 640, 3)
    for mode in ("color", "gray"):
        for decode, read in ((False, lambda: imread(path, mode)),
                             (True, lambda: imdecode(data, mode))):
            assert _fixtures.matches(stored, mode, decode, read()), (mode, decode)


def test_coco_scene_set_is_complete():
    with open(os.path.join(SCENES, "coco_scenes.json")) as f:
        scenes = json.load(f)
    assert len(scenes["files"]) == len(scenes["people"]) == 32
    names = set(os.listdir(SCENES))
    assert set(scenes["files"]) | {f"coco_{i:02d}.npz" for i in range(32)} <= names
    kinds = [name.rsplit(".", 1)[1] for name in scenes["files"]]
    assert kinds.count("tif") == 24 and kinds.count("jpg") == 8
    assert sum(os.path.getsize(os.path.join(SCENES, n)) for n in names
               if n.startswith("coco_")) < 800_000


# -- the committed fixtures ----------------------------------------------------------


_fixtures = _load("make_fixtures")


@pytest.mark.parametrize("name", sorted(os.path.basename(p)[:-4] for p in
                                        glob.glob(os.path.join(FIXTURES, "*.tif"))))
def test_fixtures_equal_cv2_and_the_port(name):
    """The arrays stored beside each fixture are still cv2's (``imread`` of
    the file, ``imdecode`` of its bytes), and the port reads the file and
    decodes its bytes to them (``chip_smoke.py`` repeats the latter on the
    card's machine, which has no cv2)."""
    path = os.path.join(FIXTURES, name + ".tif")
    with open(path, "rb") as f:
        data = f.read()
    stored = np.load(path[:-4] + ".npz")
    live = _fixtures.cv2_reads(path, data)
    assert sorted(live) == sorted(stored.files)
    for mode in ("color", "gray"):
        for decode, read in ((False, lambda: imread(path, mode)),
                             (True, lambda: imdecode(data, mode))):
            try:
                got = read()
            except FileNotFoundError:
                got = None
            assert _fixtures.matches(stored, mode, decode, got), (mode, decode)


def test_fixture_set_is_complete():
    names = {os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES, "*"))}
    tifs = {n for n in names if n.endswith(".tif")}
    assert set(_fixtures.TIMED) <= tifs and len(tifs) >= 30
    assert {n[:-4] + ".npz" for n in tifs} <= names
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 2 << 20
