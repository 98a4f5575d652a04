"""Every JPEG form that cv2 reads, through the port's reader
(``core/imread.py`` -> ``ops/native/jpeg.cpp``), against live
``cv2.imread`` (the JAX package's reader) in both read modes: every pixel
equal where cv2 decodes, ``FileNotFoundError`` exactly where cv2 returns
None (C5), never ``UnsupportedImage``.

- sampling: cv2's 4:1:1 and 4:4:0, baseline and progressive, with restarts,
  at 1 x 1, 17 x 9, 37 x 53 and 64 x 48, colour and gray sources; layouts no
  writer here makes (luma upsampled, h4v2, h1v4, mixed), from
  ``tests/data/jpeg/jpeg_writer.py``;
- colour: PIL's CMYK (baseline, progressive), the YCCK variant (Adobe
  transform byte 2), ``keep_rgb=True`` RGB, and the writer's RGB, CMYK and
  YCCK files;
- arithmetic coding: sequential and progressive, with and without DAC
  conditioning and restarts, files cut in their data;
- lossless: predictors 1-7, point transforms, restarts, subsampling; the
  colour conversions lossless mode refuses;
- the forms cv2 refuses: hierarchical SOF5-7 / SOF13-15, the JPG marker,
  lossless arithmetic SOF11, reserved markers, 12-bit and 16-bit samples, 2
  and 5 components, sampling ratios that are not whole numbers, more than
  10 blocks in an MCU, sides above 65500;
- a Motion-JPEG file without Huffman tables (the standard ones stand in).
"""
import functools
import importlib.util
import io
import os
import struct

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu_torch.core.imread import imread

torch.set_num_threads(1)
_spec = importlib.util.spec_from_file_location(
    "jpeg_writer", os.path.join(os.path.dirname(__file__), "data", "jpeg", "jpeg_writer.py"))
jw = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jw)

SIZES = ((1, 1), (17, 9), (37, 53), (64, 48))
DAC = bytes([0, 0x52, 1, 0x31, 16, 2, 17, 9])  # DC L 2 / U 5 and L 1 / U 3; AC Kx 2 and 9
S420 = [(1, 2, 2), (2, 1, 1), (3, 1, 1)]
S444 = [(1, 1, 1), (2, 1, 1), (3, 1, 1)]


def _picture(h, w, seed=0):
    """Four planes (BGR and a fourth) of smooth shading, edges and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7 + y / 11), 128 + 90 * np.cos(x / 5 - y / 13),
                    (x * 3 + y * 2) % 256, 200 - (x * 5 + y) % 90], axis=-1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


def _planes(img, n=3):
    return [img[..., i] for i in range(n)]


def _against_cv2(tmp_path, name, data):
    """The port's ``imread`` against ``cv2.imread`` of the file in both read
    modes; returns ``{mode: "decoded" | "none"}``."""
    path = str(tmp_path / (name + ".jpg"))
    with open(path, "wb") as f:
        f.write(data)
    outcome = {}
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        want = cv2.imread(path, flag)
        if want is None:
            with pytest.raises(FileNotFoundError):
                imread(path, mode)
            outcome[mode] = "none"
            continue
        got = imread(path, mode)
        want = want[..., ::-1] if want.ndim == 3 else want
        assert got.dtype == want.dtype and got.shape == want.shape, (name, mode)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode}")
        outcome[mode] = "decoded"
    return outcome


def _decoded(outcome):
    return outcome == {"color": "decoded", "gray": "decoded"}


# -- sampling ------------------------------------------------------------------


@pytest.mark.parametrize("rst", [0, 2], ids=["plain", "rst"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["411", "440"])
def test_cv2_sampling_forms_match_cv2(tmp_path, sampling, progressive, rst):
    """cv2's own 4:1:1 (luma h4v1: chroma replicated, int_upsample) and 4:4:0
    (h1v2 fancy) files, colour and gray sources, decode as cv2 decodes."""
    flag = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)
    for h, w in SIZES:
        img = _picture(h, w, h * w)[..., :3]
        for gray in (False, True):
            src = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img
            ok, buf = cv2.imencode(".jpg", src, [
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag, cv2.IMWRITE_JPEG_PROGRESSIVE,
                int(progressive), cv2.IMWRITE_JPEG_RST_INTERVAL, rst, cv2.IMWRITE_JPEG_QUALITY, 90])
            assert ok
            assert _decoded(_against_cv2(tmp_path, f"{h}x{w}_{int(gray)}", buf.tobytes()))


LAYOUTS = {
    "luma_up": [(1, 1, 1), (2, 2, 2), (3, 2, 2)],  # Y upsampled h2v2, also for a gray read
    "luma_h1v2": [(1, 1, 1), (2, 1, 2), (3, 1, 1)],  # Y and Cr h1v2 fancy
    "h4v2": [(1, 4, 2), (2, 1, 1), (3, 1, 1)],
    "h1v4": [(1, 1, 4), (2, 1, 1), (3, 1, 1)],
    "mixed": [(1, 2, 2), (2, 2, 1), (3, 1, 2)],  # h1v2 and h2v1 chroma
    "h4v1_h2v1": [(1, 4, 1), (2, 2, 1), (3, 1, 1)],  # h2v1 fancy of a 2-wide chroma
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_writer_layouts_match_cv2(tmp_path, layout):
    """Whole-number layouts no writer here makes, baseline (one scan, and
    one scan per component), arithmetic sequential in two scans and
    arithmetic progressive: each component brought up by jdsample.c's
    method."""
    for h, w in SIZES:
        img = _picture(h, w, h + w)
        for kw in ({}, {"scans": [(0,), (1,), (2,)]},
                   {"coding": "arith", "scans": [(0,), (1, 2)], "restart": 2},
                   {"coding": "arith", "mode": "progressive", "restart": 1}):
            data = jw.write_jpeg(_planes(img), LAYOUTS[layout], markers=jw.jfif(), **kw)
            assert _decoded(_against_cv2(tmp_path, f"{layout}_{h}x{w}_{len(kw)}", data))


# -- colour ------------------------------------------------------------------


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("form", ["cmyk", "ycck", "keep_rgb"])
def test_pil_colour_forms_match_cv2(tmp_path, form, progressive):
    """PIL's CMYK file (Adobe transform 0: cv2 turns libjpeg's CMYK into
    RGB and gray itself), the same file with its transform byte set to 2
    (YCCK: jdcolor.c's ycck_cmyk_convert first) and a ``keep_rgb`` RGB file
    (Adobe transform 0, three components: no conversion; gray by
    rgb_gray_convert)."""
    from PIL import Image

    for h, w in SIZES:
        img = _picture(h, w, 3 * h + w)
        buf = io.BytesIO()
        pil = Image.fromarray(np.ascontiguousarray(img[..., 2::-1]))
        if form == "keep_rgb":
            pil.save(buf, format="JPEG", keep_rgb=True, progressive=progressive, quality=90)
        else:
            pil.convert("CMYK").save(buf, format="JPEG", progressive=progressive, quality=90)
        data = bytearray(buf.getvalue())
        assert b"Adobe" in data
        if form == "ycck":
            data[data.index(b"Adobe") + 11] = 2
        assert _decoded(_against_cv2(tmp_path, f"{form}_{h}x{w}", bytes(data)))


@pytest.mark.parametrize("coding", ["huffman", "arith"])
@pytest.mark.parametrize("form", ["rgb_ids", "cmyk_plain", "cmyk_adobe0", "ycck", "ycck_t1",
                                  "ycbcr_ids"])
def test_writer_colour_spaces_match_cv2(tmp_path, form, coding):
    """default_decompress_parms's choices: component ids R, G, B (RGB) and
    1, 2, 3 (YCbCr) without markers; four components without an Adobe
    marker or with transform 0 (CMYK), with 2 or any other value (YCCK),
    subsampled too."""
    comps, markers = {
        "rgb_ids": ([(82, 1, 1), (71, 1, 1), (66, 2, 2)], b""),
        "cmyk_plain": ([(1, 1, 1), (2, 1, 1), (3, 1, 1), (4, 1, 1)], b""),
        "cmyk_adobe0": ([(1, 2, 1), (2, 1, 1), (3, 1, 1), (4, 2, 1)], jw.adobe(0)),
        "ycck": ([(1, 2, 2), (2, 1, 1), (3, 1, 1), (4, 2, 2)], jw.adobe(2)),
        "ycck_t1": ([(1, 1, 1), (2, 1, 1), (3, 1, 1), (4, 1, 1)], jw.adobe(1)),
        "ycbcr_ids": ([(1, 2, 2), (2, 1, 1), (3, 1, 1)], b""),
    }[form]
    for h, w in SIZES[1:]:
        img = _picture(h, w, h * 7 + w)
        data = jw.write_jpeg(_planes(img, len(comps)), comps, coding=coding, markers=markers)
        assert _decoded(_against_cv2(tmp_path, f"{form}_{h}x{w}", data))


# -- arithmetic coding ---------------------------------------------------------


@pytest.mark.parametrize("dac", [False, True], ids=["default_conditioning", "dac"])
@pytest.mark.parametrize("rst", [0, 1, 3], ids=["rst0", "rst1", "rst3"])
@pytest.mark.parametrize("mode", ["sequential", "progressive"])
def test_arithmetic_matches_cv2(tmp_path, mode, rst, dac):
    """SOF9 and SOF10 (jpeg_simple_progression's script: DC and AC, first
    and refine scans) of 4:2:0 colour and of gray, every size."""
    for h, w in SIZES:
        img = _picture(h, w, h * w + 1)
        for planes, comps in ((_planes(img), S420), (_planes(img, 1), [(1, 1, 1)])):
            data = jw.write_jpeg(planes, comps, coding="arith", mode=mode, restart=rst,
                                 dac=DAC if dac else b"", markers=jw.jfif(), quality=90)
            assert (b"\xff\xc9" if mode == "sequential" else b"\xff\xca") in data
            assert _decoded(_against_cv2(tmp_path, f"{h}x{w}_{len(comps)}", data))


@pytest.mark.parametrize("mode", ["sequential", "progressive"])
def test_arithmetic_cut_in_scan_data_matches_cv2(tmp_path, mode):
    """Files cut at 24 points after the first scan's header: behind the cut
    the data reads as zeros (cv2 decodes what that gives), as cv2 does, or
    cv2 returns None where the port raises FileNotFoundError."""
    data = jw.write_jpeg(_planes(_picture(48, 64, 2)), S420, coding="arith", mode=mode, restart=1,
                         markers=jw.jfif(), quality=90)
    first_scan = data.index(b"\xff\xda")
    for cut in np.linspace(first_scan + 12, len(data) - 1, 24).astype(int):
        _against_cv2(tmp_path, f"cut{cut}", data[:cut])


# -- lossless ------------------------------------------------------------------


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_matches_cv2(tmp_path, predictor):
    """SOF3 with each predictor: gray files with a point transform (cv2
    reads them as gray only) and RGB files (colour only; libjpeg-turbo reads
    a lossless file without markers as RGB), restarts every two rows, a
    6-bit file; equal to the source where no point transform drops bits."""
    for h, w in SIZES:
        img = _picture(h, w, predictor)
        gray = jw.write_jpeg(_planes(img, 1), [(1, 1, 1)], mode="lossless", predictor=predictor,
                             pt=predictor % 3, restart=2 * w)
        assert _against_cv2(tmp_path, f"g{h}x{w}", gray) == {"color": "none", "gray": "decoded"}
        rgb = jw.write_jpeg(_planes(img), S444, mode="lossless", predictor=predictor)
        assert _against_cv2(tmp_path, f"c{h}x{w}", rgb) == {"color": "decoded", "gray": "none"}
        np.testing.assert_array_equal(imread(str(tmp_path / f"c{h}x{w}.jpg")), img[..., :3])
        six = jw.write_jpeg([img[..., 0] >> 2], [(1, 1, 1)], mode="lossless", precision=6,
                            predictor=predictor)
        assert _against_cv2(tmp_path, f"s{h}x{w}", six) == {"color": "none", "gray": "decoded"}


def test_lossless_conversions_and_layouts_match_cv2(tmp_path):
    """Lossless CMYK (both modes), subsampled RGB (replicated: no fancy
    upsampling at one sample per unit), restarts with subsampling, one scan
    per component with restarts, and the
    conversions lossless mode refuses: YCbCr (JFIF, Adobe 1 or 2), YCCK."""
    img = _picture(37, 53, 11)
    cases = {
        "cmyk": (_planes(img, 4), [(1, 1, 1), (2, 1, 1), (3, 1, 1), (4, 1, 1)], b"", {}),
        "rgb_sub": (_planes(img), S420, b"", {"predictor": 6, "restart": 27}),
        "rgb_h2v1": (_planes(img), [(1, 2, 1), (2, 1, 1), (3, 1, 1)], b"", {"predictor": 4}),
        # one scan per component, luma v 2: a restart resets the predictor
        # for the first row of the iMCU row it falls in (jddiffct.c)
        "rgb_scans_rst": (_planes(img), [(1, 1, 2), (2, 1, 1), (3, 1, 1)], b"",
                          {"predictor": 1, "scans": [(0,), (1,), (2,)], "restart": 53 * 3}),
        "ycc_jfif": (_planes(img), S444, jw.jfif(), {}),
        "ycc_adobe1": (_planes(img), S444, jw.adobe(1), {}),
        "ycc_adobe2": (_planes(img), S444, jw.adobe(2), {}),
        "ycck": (_planes(img, 4), [(1, 1, 1), (2, 1, 1), (3, 1, 1), (4, 1, 1)], jw.adobe(2), {}),
    }
    want = {"cmyk": {"color": "decoded", "gray": "decoded"},
            "rgb_sub": {"color": "decoded", "gray": "none"},
            "rgb_h2v1": {"color": "decoded", "gray": "none"},
            "rgb_scans_rst": {"color": "decoded", "gray": "none"}}
    for name, (planes, comps, markers, kw) in cases.items():
        data = jw.write_jpeg(planes, comps, mode="lossless", markers=markers, **kw)
        got = _against_cv2(tmp_path, name, data)
        assert got == want.get(name, {"color": "none", "gray": "none"}), name


def test_lossless_cut_matches_cv2(tmp_path):
    """A lossless file cut at 12 points: the rows after the data ends
    restart their predictor from zero differences, as cv2 decodes them."""
    data = jw.write_jpeg(_planes(_picture(48, 64, 4)), S444, mode="lossless", predictor=4,
                         restart=128)
    first_scan = data.index(b"\xff\xda")
    for cut in np.linspace(first_scan + 12, len(data) - 1, 12).astype(int):
        _against_cv2(tmp_path, f"cut{cut}", data[:cut])


# -- C5: the forms cv2 refuses ---------------------------------------------------


def _swap_marker(data, old, new):
    i = data.index(bytes([0xFF, old]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


@functools.lru_cache(maxsize=None)
def _c5_cases():
    img = _picture(37, 53, 5)
    planes = _planes(img)
    base = jw.write_jpeg(planes, S420, markers=jw.jfif())
    lossless = jw.write_jpeg(_planes(img, 1), [(1, 1, 1)], mode="lossless")
    cases = {f"sof{m:02x}": _swap_marker(base, 0xC0, m)
             for m in (0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE, 0xCF)}
    cases["sof11_lossless_arith"] = _swap_marker(lossless, 0xC3, 0xCB)
    for m in (0x02, 0x4F, 0xBF, 0xDE, 0xDF, 0xF0, 0xFD):
        cases[f"marker{m:02x}"] = base[:2] + bytes([0xFF, m]) + b"\x00\x04ab" + base[2:]
    cases["bits12"] = jw.write_jpeg([img[..., 0].astype(np.uint16) * 16], [(1, 1, 1)],
                                    precision=12)
    cases["bits12_progressive_arith"] = jw.write_jpeg(
        [img[..., 0].astype(np.uint16) * 16], [(1, 1, 1)], precision=12, coding="arith",
        mode="progressive")
    cases["lossless16"] = jw.write_jpeg([img[..., 0].astype(np.uint16) * 256], [(1, 1, 1)],
                                        mode="lossless", precision=16)
    for nc in (2, 5):
        cases[f"components{nc}"] = jw.write_jpeg(_planes(np.concatenate([img, img], -1), nc),
                                                 [(i + 1, 1, 1) for i in range(nc)])
    cases["frac_chroma"] = jw.write_jpeg(planes, [(1, 3, 1), (2, 2, 1), (3, 2, 1)],
                                         markers=jw.jfif())
    cases["frac_chroma_v"] = jw.write_jpeg(planes, [(1, 1, 3), (2, 1, 2), (3, 1, 2)],
                                           markers=jw.jfif(), coding="arith")
    cases["frac_luma"] = jw.write_jpeg(planes, [(1, 2, 1), (2, 3, 1), (3, 3, 1)],
                                       markers=jw.jfif())
    cases["mcu16"] = jw.write_jpeg(planes, [(1, 4, 4), (2, 1, 1), (3, 1, 1)], markers=jw.jfif())
    cases["mcu11"] = jw.write_jpeg(planes, [(1, 3, 3), (2, 1, 1), (3, 1, 1)], markers=jw.jfif())
    for w in (65500, 65501):
        wide = bytearray(base)
        at = wide.index(b"\xff\xc0")
        wide[at + 7:at + 9] = struct.pack(">H", w)
        cases[f"width{w}"] = bytes(wide)
    return cases


# what cv2 does with each (None in both modes unless listed)
_C5_DECODED = {"frac_chroma": {"color": "none", "gray": "decoded"},
               "frac_chroma_v": {"color": "none", "gray": "decoded"},
               "width65500": {"color": "decoded", "gray": "decoded"}}


@pytest.mark.parametrize("name", sorted(_c5_cases()))
def test_c5_refusals_match_cv2(tmp_path, name):
    """C5: ``FileNotFoundError`` exactly where cv2 returns None, for every
    form libjpeg-turbo refuses; a sampling ratio that is not a whole number
    refuses only the read that needs the component (a gray read of chroma
    at h 2 of 3 decodes)."""
    got = _against_cv2(tmp_path, name, _c5_cases()[name])
    assert got == _C5_DECODED.get(name, {"color": "none", "gray": "none"})


def test_motion_jpeg_without_tables_matches_cv2(tmp_path):
    """A baseline file without DHT segments (Motion JPEG): jstdhuff.c's
    standard tables stand in for tables 0 and 1, as cv2 decodes it."""
    for h, w in ((17, 9), (64, 48)):
        ok, buf = cv2.imencode(".jpg", _picture(h, w, 6)[..., :3])
        data = bytearray(buf.tobytes())
        while b"\xff\xc4" in data:
            at = data.index(b"\xff\xc4")
            del data[at:at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]]
        assert _decoded(_against_cv2(tmp_path, f"mjpeg{h}x{w}", bytes(data)))


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_exif_orientation_on_new_forms(tmp_path, orientation):
    """An APP1 Exif segment first in the file turns a CMYK, an arithmetic
    progressive, a lossless and a 4:1:1 file as cv2 turns them."""
    from PIL import Image

    img = _picture(13, 22, orientation)
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[..., 2::-1])).convert("CMYK").save(buf, format="JPEG")
    ok, s411 = cv2.imencode(".jpg", img[..., :3], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    files = {"cmyk": buf.getvalue(), "s411": s411.tobytes(),
             "arith": jw.write_jpeg(_planes(img), S420, coding="arith", mode="progressive"),
             "lossless": jw.write_jpeg(_planes(img), S444, mode="lossless")}
    tiff = (b"MM\x00*" + struct.pack(">IH", 8, 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00" * 4)
    body = b"Exif\x00\x00" + tiff
    app1 = b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
    for name, data in files.items():
        got = _against_cv2(tmp_path, name, data[:2] + app1 + data[2:])
        assert got["color"] == "decoded", name
        assert imread(str(tmp_path / f"{name}.jpg")).shape[:2] == (
            (22, 13) if orientation in (6, 8) else (13, 22))
