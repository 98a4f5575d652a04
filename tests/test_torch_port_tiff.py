"""TIFF and BigTIFF through the port's reader (``core/imread.py`` ->
``core/tiff.py``, the codes in ``ops/native/image_codes.cpp`` and
``ops/native/jpeg.cpp``) against live ``cv2.imread`` and ``cv2.imdecode``
(the JAX package's readers) in both read modes: every pixel equal where cv2
decodes, ``FileNotFoundError`` exactly where cv2 returns None,
``UnsupportedImage`` only for the forms cv2 reads that the port does not
(CIELab, SGILog LogL / LogLuv, CCITT RLEW).

- the container: both byte orders, classic and BigTIFF, strips and tiles,
  planar configuration 1 and 2, FillOrder 2, first directory only;
- the codecs: none, PackBits, LZW (and its old LSB-first form), Deflate (8
  and 32946), the horizontal predictor on 8 and 16 bits, JPEG with and
  without JPEGTables (4:4:4, 4:2:2, 4:2:0, in strips of 8, 16 and all rows,
  in tiles, short and narrow strips), CCITT RLE, Group 3 1-D and 2-D,
  Group 4 (widths up to 6000), ThunderScan; the compressions cv2's libtiff
  is built without; an unknown compression code (a black image);
- the pixels: gray and bilevel at 1, 8 and 16 bits, MinIsWhite, palettes at
  1, 4 and 8 bits (16-bit and 8-bit colormaps), RGB and RGBA at 8 and 16
  bits (associated, unassociated, unspecified alpha), CMYK, subsampled
  YCbCr (every layout, strips and tiles, libtiff's 4 x 4 tile skew), the
  orientations (cv2.imread refuses 5-8, cv2.imdecode turns them), the
  forms cv2 refuses (2-bit, 4-bit gray, 1-bit RGB, > 4 samples, ...);
- every cut length of small files, seeded corruptions of their headers and
  data, and the committed fixtures of ``tests/data/tiff`` (written by
  ``make_fixtures.py``) against the decodes stored beside them.
"""
import glob
import importlib.util
import io
import os
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.png import ImageSizeError, UnsupportedImage

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
    try:
        got = got_fn()
    except UnsupportedImage:
        return "unsupported"
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
    """``UnsupportedImage`` exactly for the forms cv2 decodes that the port
    does not: CIELab (PIL's LAB), LogLuv (SGILog24) and CCITT RLEW;
    ``FileNotFoundError`` for the compressions cv2's libtiff is built
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
        with pytest.raises(UnsupportedImage, match="A10 part 3"):
            imdecode(data)
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
    """200 seeded corruptions (one to three bytes, the header and directory
    the likelier) of six small files: the port reads each as cv2 does, or
    raises ``ImageSizeError`` where cv2 raises; nothing else escapes."""
    rng = np.random.default_rng(11)
    sources = [tw.write_tiff(_pic(H, W, 3), photometric=2, compression=c, rows_per_strip=8)
               for c in (1, 5, 32773)]
    sources += [tw.write_tiff(_pic(H, W, 1, 2), bps=1, photometric=1, rows_per_strip=5),
                tw.write_tiff(_pic(H, W, 3), photometric=6, subsampling=(2, 2), rows_per_strip=8),
                tw.write_tiff(_pic(H, W, 3), photometric=2, tile=(16, 16), compression=5)]
    for i in range(200):
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
