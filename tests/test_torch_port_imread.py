"""The port's image reader (``core/imread.py``, ``core/png.py``'s EXIF
orientation, the JPEG decoder ``ops/native/jpeg.cpp``) against the JAX
package's readers, which are ``cv2.imread`` (CPU): every pixel equal.

- PNG ``eXIf`` orientations 1-8 (and 0, 9), both byte orders, before and
  after IDAT;
- C10: an IFD0 entry before the orientation whose data cv2 reads (string and
  rational tags) swept over tags, types, counts and offsets, in PNG and
  JPEG, and the committed EXIF fixtures of ``tests/data/exif``;
- ``imread``'s split: ``FileNotFoundError`` exactly where cv2 returns None,
  ``ValueError`` naming ROADMAP A10 for valid files it does not decode;
  the sweep over every format cv2 writes here (C3) and the AVIF and
  BigTIFF signatures (AVIF's decoder is held to cv2 in
  ``test_torch_port_avif.py``);
- JPEG: quality 50 and 95, 4:4:4, 4:2:2 and 4:2:0, progressive, optimised
  tables, restart markers, gray files, odd sizes, APP1 orientations, files
  cut in their scan data (block smoothing of a cut progressive file);
- a JPEG dataset's samples, and ``eval`` over unreadable mask files;
- the committed fixtures of ``tests/data/jpeg/`` against cv2.
"""
import glob
import importlib.util
import json
import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu import eval as jeval
from instancesegmentation_tpu.core import records as jrecords
from instancesegmentation_tpu.data.dataset import InstanceCommonDataset as JaxDataset
from instancesegmentation_tpu.data.synthetic import make_hard_dataset as jax_make_hard
from instancesegmentation_tpu.data.synthetic import make_synthetic_dataset as jax_make
from instancesegmentation_tpu_torch import eval as teval
from instancesegmentation_tpu_torch.core import records as trecords
from instancesegmentation_tpu_torch.core.exif import exif_orientation
from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.keys import key_combine
from instancesegmentation_tpu_torch.core.png import UnsupportedImage, encode_png
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.ops.native import build as native_build
from instancesegmentation_tpu_torch.ops.native import jpeg as native_jpeg

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")


def _picture(h, w, seed=0, noise=20.0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7 + y / 11), 128 + 90 * np.cos(x / 5 - y / 13),
                    (x * 3 + y * 2) % 256], axis=-1) + rng.normal(0, noise, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _tiff(orientation, order):
    if order == "II":
        return (b"II*\x00" + struct.pack("<IH", 8, 1)
                + struct.pack("<HHII", 0x0112, 3, 1, orientation) + b"\x00" * 4)
    return (b"MM\x00*" + struct.pack(">IH", 8, 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00" * 4)


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _same_as_jax(path):
    """The port's ``_load_image`` / ``_load_mask`` equal JAX's (cv2's)."""
    for port, ref in ((trecords._load_image, jrecords._load_image),
                      (trecords._load_mask, jrecords._load_mask)):
        got, want = port(path), ref(path)
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


# -- C1: PNG eXIf ------------------------------------------------------------


def _with_exif(png: bytes, tiff: bytes, after_idat: bool) -> bytes:
    chunk = struct.pack(">I", len(tiff)) + b"eXIf" + tiff + struct.pack(
        ">I", zlib.crc32(b"eXIf" + tiff))
    at = png.index(b"IEND") - 4 if after_idat else png.index(b"IDAT") - 4
    return png[:at] + chunk + png[at:]


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("after_idat", [False, True], ids=["before_idat", "after_idat"])
def test_png_exif_orientation_matches_jax(tmp_path, order, after_idat):
    """Orientations 0-9 of a 5 x 7 RGB and a gray PNG: the shapes turn
    (5-8 transpose) and every pixel equals cv2's, in both read modes."""
    rgb = _picture(5, 7)
    gray = rgb[..., 0].copy()
    for o in range(10):
        tiff = _tiff(o, order)
        assert exif_orientation(tiff) == o
        color = _write(tmp_path / f"c{o}.png", _with_exif(encode_png(rgb), tiff, after_idat))
        got = trecords._load_image(color)
        np.testing.assert_array_equal(got, jrecords._load_image(color))
        assert got.shape == ((7, 5, 3) if 5 <= o <= 8 else (5, 7, 3))
        _same_as_jax(_write(tmp_path / f"g{o}.png",
                            _with_exif(encode_png(gray), tiff, after_idat)))


# -- C10: the EXIF entries whose data cv2 reads before the orientation -------

_exif_spec = importlib.util.spec_from_file_location(
    "exif_fixtures", os.path.join(os.path.dirname(__file__), "data", "exif", "make_fixtures.py"))
exif_fx = importlib.util.module_from_spec(_exif_spec)
_exif_spec.loader.exec_module(exif_fx)
EXIF_FIXTURES = os.path.dirname(exif_fx.__file__)
#: the six string tags, the six rational tags, and tags whose data cv2 does
#: not read (or reads inline)
C10_TAGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298, 0x011A, 0x011B, 0x013E, 0x013F,
            0x0211, 0x0214, 0x013B, 0x0128, 0x0213, 0x8769, 0x0100, 0x0102, 0x0103, 0x0106,
            0x0115, 0x011C, 0x8825)


def _c10_turned(data: bytes, ext: str) -> bool:
    """Whether cv2 turns a 24 x 40 picture (the exif fixtures') whose EXIF
    block ``data`` holds orientation 6."""
    img = exif_fx.picture()
    bgr = np.ascontiguousarray(img[..., ::-1])
    if ext == "png":
        file = exif_fx.png_with_exif(cv2.imencode(".png", bgr)[1].tobytes(), data)
    else:
        file = exif_fx.jpeg_with_exif(cv2.imencode(".jpg", bgr)[1].tobytes(), data)
    return cv2.imdecode(np.frombuffer(file, np.uint8), cv2.IMREAD_COLOR).shape[0] == 40


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("tag", C10_TAGS, ids=[f"0x{t:04X}" for t in C10_TAGS])
def test_exif_entry_before_the_orientation_matches_cv2(ext, tag):
    """C10: an entry of ``tag`` before orientation 6, of every type 1-12,
    counts 0-10 and a large one, its value offset around the block's end
    and far past it, in both byte orders: the port turns the image exactly
    where cv2 does (cv2 stops at string and rational tags whose data lies
    outside the block)."""
    for order in "<>":
        for typ in range(1, 13):
            for count in list(range(11)) + [0x10000]:
                for back in (None, -78, -48, -25, -24, -17, -16, -9, -8, -7, -6, -5, -1, 0):
                    data = exif_fx.exif_block((tag, typ, count, back), order, tail=40)
                    want = _c10_turned(data, ext) if (typ + count + (back or 0)) % 7 == 0 \
                        or back is None else None
                    got = exif_orientation(data) == 6
                    if want is not None:
                        assert got == want, (order, typ, count, back)
                    elif tag in (0x013B, 0x0128, 0x0213, 0x8769):
                        assert got, (order, typ, count, back)


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_exif_probe_cases_match_cv2(tmp_path, ext):
    """The cases that found C10, read whole through ``imread`` and
    ``imdecode`` in both modes: ``Make`` ending at the block's end turned,
    one byte past it unturned; ``XResolution``'s 8 bytes fitting turned,
    7 unturned; an inline count (at most 4) turned whatever its offset;
    an entry after the orientation changes nothing."""
    cases = {"make_at_end": ((0x010F, 2, 6, -6), True),
             "make_past_end": ((0x010F, 2, 6, -5), False),
             "xres_fits": ((0x011A, 5, 1, -8), True), "xres_short": ((0x011A, 5, 1, -7), False),
             "inline_4": ((0x010F, 2, 4, 9000), True), "inline_5": ((0x010F, 2, 5, 9000), False)}
    img = exif_fx.picture()
    bgr = np.ascontiguousarray(img[..., ::-1])
    for name, (entry, turned) in cases.items():
        block = exif_fx.exif_block(entry, tail=0)
        assert _c10_turned(block, ext) == turned, name
        if ext == "png":
            data = exif_fx.png_with_exif(cv2.imencode(".png", bgr)[1].tobytes(), block)
        else:
            data = exif_fx.jpeg_with_exif(cv2.imencode(".jpg", bgr)[1].tobytes(), block)
        path = _write(tmp_path / f"{name}.{ext}", data)
        _same_as_jax(path)
        for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            want = want[..., ::-1] if want.ndim == 3 else want
            np.testing.assert_array_equal(imdecode(data, mode), want)
        # the same entry after the orientation: turned
        tag, typ, count, offset = entry
        after = struct.pack("<HHII", 0x0112, 3, 1, 6) + struct.pack("<HHII", tag, typ, count,
                                                                     len(block) + 9000)
        block2 = block[:10] + after + block[34:]
        assert exif_orientation(block2) == 6 and _c10_turned(block2, ext), name


@pytest.mark.parametrize("name", sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(EXIF_FIXTURES, "*.*")) if not p.endswith((".py", ".npz"))))
def test_exif_fixtures_equal_cv2_and_the_port(name):
    """The committed EXIF fixtures (``tests/data/exif``): the stored decodes
    are still cv2's, and the port reads the file and decodes its bytes to
    them in both modes (``chip_smoke.py`` repeats the latter)."""
    path = os.path.join(EXIF_FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    stem, ext = name.rsplit(".", 1)
    stored = np.load(os.path.join(EXIF_FIXTURES, f"{stem}_{ext}.npz"))
    tiff_fx = exif_fx._load(os.path.join(os.path.dirname(EXIF_FIXTURES), "tiff",
                                         "make_fixtures.py"), "tiff_fixtures")
    live = tiff_fx.cv2_reads(path, data)
    assert sorted(live) == sorted(stored.files)
    for key in stored.files:
        np.testing.assert_array_equal(live[key], stored[key])
    case = stem[:-3] if stem.endswith("_be") else stem
    assert (stored["color"].shape[0] == 40) == exif_fx.CASES[case][1]
    for mode in ("color", "gray"):
        for decode, read in ((False, lambda: imread(path, mode)),
                             (True, lambda: imdecode(data, mode))):
            assert tiff_fx.matches(stored, mode, decode, read()), (mode, decode)


# -- C2: what raises ---------------------------------------------------------


def test_imread_raises_where_cv2_returns_none(tmp_path):
    png = encode_png(_picture(6, 8))
    ok, jpg = cv2.imencode(".jpg", _picture(16, 16))
    ok, bmp = cv2.imencode(".bmp", _picture(6, 8))
    none_cases = {
        "missing.png": None,
        "empty.png": b"",
        "garbage.png": b"this is not an image at all",
        "no_iend.png": png[:png.index(b"IEND") - 4],
        "cut_idat.png": png[:len(png) // 2],
        "header_cut.jpg": jpg.tobytes()[:200],
        "soi_only.jpg": jpg.tobytes()[:10],
    }
    for name, data in none_cases.items():
        path = str(tmp_path / name) if data is None else _write(tmp_path / name, data)
        assert cv2.imread(path) is None, name
        for mode in ("color", "gray"):
            with pytest.raises(FileNotFoundError):
                imread(path, mode)
        with pytest.raises(FileNotFoundError):
            trecords._load_image(path)
    # BMP and 16-bit PNG are decoded since their decoders landed; a colour
    # PNG read as gray takes libpng's weights
    ok, sixteen = cv2.imencode(".png", _picture(6, 8).astype(np.uint16) * 257)
    rgb = _write(tmp_path / "rgb.png", encode_png(_picture(6, 8)))
    for name, data in {"image.bmp": bmp.tobytes(), "sixteen.png": sixteen.tobytes()}.items():
        _same_as_jax(_write(tmp_path / name, data))
    np.testing.assert_array_equal(imread(rgb, "gray"), cv2.imread(rgb, cv2.IMREAD_GRAYSCALE))
    # an RLE8 BMP is decoded since its decoder landed
    rle8 = bytearray(bmp.tobytes()[:54]) + bytes(1024) + b"\x08\x01\x00\x00" * 6 + b"\x00\x01"
    rle8[28:34] = struct.pack("<HI", 8, 1)  # 8 bits per pixel, BI_RLE8
    rle8[10:14] = struct.pack("<I", 54 + 1024)
    _same_as_jax(_write(tmp_path / "rle8.bmp", bytes(rle8)))
    # TIFF is decoded since its decoder landed
    ok, tiff = cv2.imencode(".tiff", _picture(6, 8))
    _same_as_jax(_write(tmp_path / "image.tiff", tiff.tobytes()))
    # WebP is decoded since its decoder landed, lossy and lossless
    for q in (90, 101):
        ok, webp = cv2.imencode(".webp", _picture(6, 8), [cv2.IMWRITE_WEBP_QUALITY, q])
        _same_as_jax(_write(tmp_path / f"image{q}.webp", webp.tobytes()))
    # JPEG 2000 is decoded since its decoder landed
    ok, jp2 = cv2.imencode(".jp2", _picture(64, 64))  # OpenJPEG needs 33+ pixels a side
    _same_as_jax(_write(tmp_path / "image.jp2", jp2.tobytes()))
    # AVIF is decoded since its decoder landed
    ok, avif = cv2.imencode(".avif", _picture(64, 64))
    _same_as_jax(_write(tmp_path / "image.avif", avif.tobytes()))
    # a form that stays out (ROADMAP A10 part 3, step 6b) raises, never skips
    ok, avif = cv2.imencode(".avif", _picture(64, 64).astype(np.uint16) * 257,
                            [cv2.IMWRITE_AVIF_DEPTH, 10])
    unsupported = {"image10.avif": avif.tobytes()}
    for name, data in unsupported.items():
        path = _write(tmp_path / name, data)
        assert cv2.imread(path) is not None, name
        with pytest.raises(ValueError, match="A10") as info:
            imread(path)
        assert isinstance(info.value, UnsupportedImage)
    # the extension plays no part: a JPEG named .png is a JPEG
    _same_as_jax(_write(tmp_path / "jpeg_named.png", jpg.tobytes()))


def _writers(img):
    """{name: bytes} of every format ``cv2.imencode`` writes here, of the
    BGR ``img`` and its gray, and PIL's BigTIFF and CMYK JPEG."""
    import io

    from PIL import Image

    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    f32 = img.astype(np.float32) / 255
    out = {}
    for ext, src, params in (
            (".png", img, ()), (".png", gray, ()), (".jpg", img, ()), (".jpg", gray, ()),
            (".bmp", img, ()), (".bmp", gray, ()), (".tiff", img, ()), (".tiff", gray, ()),
            (".webp", img, ()), (".webp", img, (cv2.IMWRITE_WEBP_QUALITY, 101)),
            (".jp2", img, ()), (".avif", img, ()), (".pbm", gray, ()), (".pgm", gray, ()),
            (".ppm", img, ()), (".pbm", gray, (cv2.IMWRITE_PXM_BINARY, 0)),
            (".pgm", gray, (cv2.IMWRITE_PXM_BINARY, 0)), (".ppm", img, (cv2.IMWRITE_PXM_BINARY, 0)),
            (".pam", img, ()), (".pam", gray, ()), (".pfm", f32, ()), (".pfm", f32[..., 0], ()),
            (".ras", img, ()), (".ras", gray, ()), (".hdr", f32, ()), (".gif", img, ())):
        ok, buf = cv2.imencode(ext, src, list(params))
        assert ok, ext
        out[f"{ext[1:]}_{src.ndim}d_{len(params)}"] = buf.tobytes()
    ok, buf = cv2.imencode(".avif", img.astype(np.uint16) * 257, [cv2.IMWRITE_AVIF_DEPTH, 10])
    out["avif10"] = buf.tobytes()
    rgb = Image.fromarray(img[..., ::-1].copy())
    for name, kwargs in (("bigtiff", dict(format="TIFF", big_tiff=True)),
                         ("cmyk_jpeg", dict(format="JPEG"))):
        buf = io.BytesIO()
        (rgb.convert("CMYK") if name == "cmyk_jpeg" else rgb).save(buf, **kwargs)
        out[name] = buf.getvalue()
    out["openexr_magic"] = b"\x76\x2f\x31\x01" + bytes(60)
    return out


def test_every_format_cv2_writes_decodes_or_raises_as_cv2(tmp_path):
    """C3: for every format cv2 writes here (and PIL's BigTIFF and CMYK
    JPEG), in both read modes, the port does exactly one of: decode equal
    to ``cv2.imread``; raise ``UnsupportedImage`` where cv2 decodes; raise
    ``FileNotFoundError`` where cv2 returns None.  A 10-bit AVIF raises
    ``UnsupportedImage`` (ROADMAP A10 part 3, step 6b); cv2's 8-bit AVIF is
    decoded (since the AVIF decoder landed); PIL's CMYK JPEG is decoded (since the JPEG
    decoder took every form cv2 reads), cv2's TIFF and PIL's BigTIFF (since
    the TIFF decoder landed), cv2's lossy and lossless WebP (since the WebP
    decoder landed) and cv2's JPEG 2000 (since the JPEG 2000 decoder
    landed); OpenEXR (cv2 here is built without it) ``FileNotFoundError``."""
    img = _picture(32, 48, seed=3)
    outcome = {}
    for name, data in _writers(img).items():
        path = _write(tmp_path / name, data)
        for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            want = cv2.imread(path, flag)
            try:
                got = imread(path, mode)
            except UnsupportedImage:
                assert want is not None, (name, mode)
                outcome[name, mode] = "unsupported"
                continue
            except FileNotFoundError:
                assert want is None, (name, mode)
                outcome[name, mode] = "none"
                continue
            assert want is not None, (name, mode)
            want = want[..., ::-1] if want.ndim == 3 else want
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode}")
            outcome[name, mode] = "decoded"
    assert outcome["avif10", "color"] == outcome["avif10", "gray"] == "unsupported"
    for name in ("cmyk_jpeg", "bigtiff", "tiff_3d_0", "tiff_2d_0", "webp_3d_0", "webp_3d_2",
                 "jp2_3d_0", "avif_3d_0"):
        assert outcome[name, "color"] == outcome[name, "gray"] == "decoded", name
    assert outcome["openexr_magic", "color"] == "none"
    assert outcome["pfm_3d_0", "gray"] == outcome["pfm_2d_0", "color"] == "none"
    decoded = {n for (n, m), o in outcome.items() if o == "decoded"}
    assert {"pbm_2d_0", "pgm_2d_2", "ppm_3d_2", "pam_3d_0", "pfm_3d_0", "ras_3d_0", "hdr_3d_0",
            "gif_3d_0", "bmp_3d_0"} <= decoded


def test_avif_brands_and_bigtiff_signatures():
    """The sniff of C3: an ``ftyp`` box naming ``avif`` or ``avis`` as its
    major or a compatible brand goes to the AVIF decoder, which finds no
    ``meta`` box after it (since the AVIF decoder landed; it raised
    ``UnsupportedImage`` before); other ISO-BMFF brands, OpenEXR and a bare
    BigTIFF header of either byte order (whose first directory libtiff
    cannot read, since the TIFF decoder landed): all ``FileNotFoundError``
    (cv2 returns None for them here)."""
    def ftyp(major, compatible):
        body = major + b"\x00\x00\x00\x00" + b"".join(compatible)
        return struct.pack(">I", 8 + len(body)) + b"ftyp" + body + bytes(32)

    for data in (ftyp(b"avif", [b"mif1"]), ftyp(b"avis", []), ftyp(b"mif1", [b"miaf", b"avif"]),
                 ftyp(b"heic", [b"avis"])):
        with pytest.raises(FileNotFoundError, match="AVIF: no ftyp, or the meta or moov box"):
            imdecode(data)
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    for data in (ftyp(b"heic", [b"mif1"]), ftyp(b"isom", [b"mp41"]),
                 b"\x76\x2f\x31\x01" + bytes(60), b"II+\x00" + bytes(12), b"MM\x00+" + bytes(12)):
        with pytest.raises(FileNotFoundError):
            imdecode(data)
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None


def test_undecodable_masks_skip_as_in_jax(tmp_path):
    """``evaluate_full_image`` over a hard set where one object's mask file is
    empty and another's is cut in its image data: both packages skip those
    objects and return the same AP dict, to the last bit."""
    root = str(tmp_path / "hard")
    jax_make_hard(root, num_images=3, image_hw=(120, 160), seed=4)
    k_objs, k_mask = key_combine("object", "sub_list"), key_combine("instance_mask", "mask_path")
    masks = [o[k_mask] for p in sorted(glob.glob(os.path.join(root, "data", "*.json")))
             for o in json.load(open(p)).get(k_objs, []) if k_mask in o]
    assert len(masks) >= 3
    _write(os.path.join(root, masks[0]), b"")
    with open(os.path.join(root, masks[1]), "rb") as f:
        data = f.read()
    _write(os.path.join(root, masks[1]), data[:len(data) // 2])

    def segment(image, boxes, scores, keypoints):
        out = []
        for x0, y0, x1, y1 in boxes:
            m = np.zeros(image.shape[:2], np.uint8)
            m[int(y0) + 2:int(y1) - 2, int(x0) + 2:int(x1) - 2] = 255
            out.append({"mask": m, "mask_score": float((x1 - x0) / 200.0)})
        return out

    got = teval.evaluate_full_image(root, _segment_fn=segment)
    want = jeval.evaluate_full_image(root, _segment_fn=segment)
    assert got == want
    assert got["num_gt_instances"] == len(masks) - 2


# -- JPEG --------------------------------------------------------------------

_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _jpeg(img, quality=90, sampling="420", progressive=False, optimize=False, rst=0):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling],
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive), cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("form", ["plain", "progressive", "optimize", "rst"])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_forms_match_jax(tmp_path, quality, sampling, form):
    """Colour and gray files at odd and whole-block sizes, read in both
    modes, equal cv2's decode pixel for pixel."""
    opts = {"progressive": form == "progressive", "optimize": form == "optimize",
            "rst": 2 if form == "rst" else 0}
    for h, w in ((17, 9), (37, 53), (1, 1), (64, 48)):
        img = _picture(h, w, seed=h * w)
        for gray in (False, True):
            src = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img
            _same_as_jax(_write(tmp_path / f"{h}x{w}_{int(gray)}.jpg",
                                _jpeg(src, quality, sampling, **opts)))


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_jpeg_exif_orientation_matches_jax(tmp_path, order, progressive):
    """An APP1 Exif segment with orientation 0-9, first or after JFIF's
    APP0, turns the image as cv2 does."""
    data = _jpeg(_picture(13, 22), progressive=progressive)
    app0_end = 4 + struct.unpack(">H", data[4:6])[0]
    for o in range(10):
        body = b"Exif\x00\x00" + _tiff(o, order)
        app1 = b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
        for at in (2, app0_end):
            path = _write(tmp_path / f"o{o}_{at}.jpg", data[:at] + app1 + data[at:])
            _same_as_jax(path)
            assert trecords._load_mask(path).shape == ((22, 13) if 5 <= o <= 8 else (13, 22))


@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_jpeg_cut_in_scan_data_matches_jax(tmp_path, progressive, sampling):
    """Files cut at 24 points (headers excepted): cv2 decodes what is there
    (the rest gray; a cut progressive file block-smoothed from its DC
    values), or returns None where the port raises FileNotFoundError."""
    data = _jpeg(_picture(48, 64, seed=2), 90, sampling, progressive=progressive, rst=1)
    first_scan = data.index(b"\xff\xda")
    for cut in np.linspace(first_scan + 12, len(data) - 1, 24).astype(int):
        path = _write(tmp_path / f"cut{cut}.jpg", data[:cut])
        if cv2.imread(path) is None:
            with pytest.raises(FileNotFoundError):
                imread(path)
            continue
        _same_as_jax(path)


def test_jpeg_without_a_compiler_raises(tmp_path, monkeypatch):
    """No silent path: with no library built and no compiler, reading a
    JPEG raises and names the reason."""
    path = _write(tmp_path / "a.jpg", _jpeg(_picture(8, 8)))
    monkeypatch.setattr(native_jpeg, "_lib", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        imread(path)


def test_jpeg_dataset_fetch_matches_jax(tmp_path):
    """A common-format dataset whose images are JPEGs (written by cv2, half
    of them progressive): every sample of the port's reader equals JAX's."""
    root = str(tmp_path / "jpeg_set")
    jax_make(root, num_images=4, objects_per_image=2, seed=9)
    k_img = key_combine("image", "image_path")
    for k, path in enumerate(sorted(glob.glob(os.path.join(root, "data", "*.json")))):
        with open(path) as f:
            ann = json.load(f)
        png = os.path.join(root, ann[k_img])
        rel = os.path.splitext(ann[k_img])[0] + ".jpg"
        cv2.imwrite(os.path.join(root, rel), cv2.imread(png),
                    [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, k % 2])
        os.remove(png)
        ann[k_img] = rel
        with open(path, "w") as f:
            json.dump(ann, f)
    port, ref = InstanceCommonDataset(root, 256), JaxDataset(root, 256)
    assert len(port) == len(ref) > 0
    for i in range(len(port)):
        a, b = port.fetch(i), ref.fetch(i)
        for name in ("image", "mask", "image_hw", "obj_box", "mask_box", "keypoints"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert a.mask_valid == b.mask_valid


# -- the committed fixtures ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(os.path.splitext(os.path.basename(p))[0]
                                        for p in glob.glob(os.path.join(FIXTURES, "*.jpg"))))
def test_fixtures_equal_cv2_and_the_port(name):
    """The arrays stored beside each fixture are still cv2's decode, and the
    port decodes the file to them (``chip_smoke.py`` repeats the latter on
    the card's machine, which has no cv2); a read mode with no stored array
    is one cv2 returns None for, where the port raises
    ``FileNotFoundError``."""
    path = os.path.join(FIXTURES, name + ".jpg")
    stored = np.load(os.path.join(FIXTURES, name + ".npz"))
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        if mode not in stored:
            assert cv2.imread(path, flag) is None, mode
            with pytest.raises(FileNotFoundError):
                imread(path, mode)
            continue
        ref = jrecords._load_image(path) if mode == "color" else jrecords._load_mask(path)
        np.testing.assert_array_equal(stored[mode], ref)
        np.testing.assert_array_equal(imread(path, mode), stored[mode])


def test_fixture_set_is_complete():
    names = {os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES, "*"))}
    jpgs = {n for n in names if n.endswith(".jpg")}
    assert {"base_480x640_420_q95.jpg", "prog_480x640_420_q95.jpg", "form_cmyk_480x640_q95.jpg",
            "form_arith_480x640_420.jpg"} <= jpgs
    assert {n[:-4] + ".npz" for n in jpgs} <= names
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in jpgs) < 1 << 20
    assert shutil.which("g++") is None or native_build.lib_path(native_jpeg.SRC).exists()
