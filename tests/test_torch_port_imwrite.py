"""The port's ``imencode`` / ``imwrite`` (``core/imwrite.py`` and the
encoders behind it: ``core/pnm.py``, ``core/sunras.py``, ``core/hdr.py``,
``core/gif.py``, ``core/tiff.py``, their loops in
``ops/native/image_codes.cpp``) against live ``cv2.imencode`` and
``cv2.imwrite`` (the JAX package's writers), byte for byte:

- every extension cv2 writes except the three codecs (``.jpe .dib .pbm
  .pgm .ppm .pnm .pam .pfm .sr .ras .hdr .pic .gif .tif .tiff``), gray and
  colour, at 1 x 1, odd widths, widths 7 and 8 and more (HDR's run-length
  threshold), one TIFF strip and several, in any letter case; the
  refusals, and what each leaves on disk; a seeded random sweep per
  format; HDR's conversion at every gray level; the GIF quantiser on
  random pixels and on the scenes; TIFF's LZW over rows longer than its
  ratio check's 10,000 bytes;
- ``.avif`` and extensions cv2 has no writer for raise ``ValueError``
  naming the extension (``.webp``: ``tests/test_torch_port_webp_enc.py``;
  ``.jp2``: ``tests/test_torch_port_jpeg2000_enc.py``);
- the digests ``tests/data/imwrite/make_fixtures.py`` stored (which
  ``chip_smoke.py`` holds the port to on the card) are still cv2's and the
  port's, and for WebP the port's bytes, cv2's decode of them and cv2's
  byte count;
- the encoders480 COCO tree (the 32 scenes of ``tests/data/webp`` under the
  names of every encoder) converted by both packages' ``transfer_coco``,
  file for file; the webp_named480 tree (the scenes under ``.webp``
  names) converted by the port against the stored digests of the JAX
  package's tree.

Sun raster: cv2 pads a row of odd length with the byte after it in its
buffer, which after the last row lies past the image; the port writes 0
there, and that one byte is left out of the comparison.
"""
import hashlib
import json
import os

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from instancesegmentation_tpu.data import converters as jconv
from instancesegmentation_tpu_torch.core.imread import imread
from instancesegmentation_tpu_torch.core.imwrite import EXTENSIONS, imencode, imwrite
from instancesegmentation_tpu_torch.data import converters as tconv

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "imwrite")
SCENES = os.path.join(os.path.dirname(__file__), "data", "webp")
EXTS = (".jpe", ".dib", ".pbm", ".pgm", ".ppm", ".pnm", ".pam", ".pfm", ".sr", ".ras", ".hdr",
        ".pic", ".gif", ".tif", ".tiff")
#: gray and colour shapes: 1 x 1, odd widths, 7 and 8 wide, several TIFF
#: strips (300 x 400 gray: 15; 100 x 64 colour: 3)
SHAPES = ((1, 1), (1, 2), (2, 3), (3, 7), (4, 8), (5, 9), (9, 33), (17, 128), (300, 400),
          (100, 64))


def _bgr(image):
    if image.ndim == 2:
        return image
    return np.ascontiguousarray(image[..., [2, 1, 0, 3][:image.shape[2]]])


def _cut(ext, image):
    """1 where cv2's last byte lies past the image (a Sun raster's odd rows)."""
    c = 1 if image.ndim == 2 else image.shape[2]
    return int(ext.lower() in (".sr", ".ras") and image.shape[1] * c % 2 == 1)


def _same_as_cv2(ext, image, tmp_path):
    """``imencode`` and ``imwrite`` against cv2's: the same bytes (or None
    and False where cv2 refuses), and the same file left on disk."""
    ok, want = cv2.imencode(ext, _bgr(image))
    got = imencode(ext, image)
    if not ok:
        assert got is None, (ext, image.shape)
    else:
        want = want.tobytes()
        cut = _cut(ext, image)
        assert got is not None and len(got) == len(want), (ext, image.shape)
        assert got[:len(got) - cut] == want[:len(want) - cut], (ext, image.shape)
        if cut:
            assert got[-1] == 0
    theirs, ours = tmp_path / ("cv2" + ext), tmp_path / ("port" + ext)
    for p in (theirs, ours):
        if p.exists():
            p.unlink()
    assert imwrite(str(ours), image) == cv2.imwrite(str(theirs), _bgr(image))
    assert ours.exists() == theirs.exists(), (ext, image.shape)
    if theirs.exists():
        a, b = ours.read_bytes(), theirs.read_bytes()
        cut = _cut(ext, image) if ok else 0
        assert a[:len(a) - cut] == b[:len(b) - cut], (ext, image.shape)
    return ok


def _picture(shape, seed):
    """Shading with blocks and noise: runs for RLE and LZW, and variety."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = (x // 4 * 9 + y // 3 * 5) % 256
    planes = [base, (base * 3 + 40) % 256, (x * y) % 256][:1 if len(shape) == 2 else 3]
    img = np.stack(planes, -1) + rng.integers(0, 4, (h, w, len(planes)))
    img = (img % 256).astype(np.uint8)
    return img[..., 0] if len(shape) == 2 else img


@pytest.mark.parametrize("kind", ["gray", "color"])
@pytest.mark.parametrize("ext", EXTS)
def test_shapes_match_cv2(ext, kind, tmp_path):
    for k, (h, w) in enumerate(SHAPES):
        shape = (h, w) if kind == "gray" else (h, w, 3)
        _same_as_cv2(ext, _picture(shape, k), tmp_path)
        noise = np.random.default_rng(100 + k).integers(0, 256, shape, dtype=np.uint8)
        _same_as_cv2(ext, noise, tmp_path)


@pytest.mark.parametrize("ext", EXTS)
def test_random_sweep_matches_cv2(ext, tmp_path):
    """40 seeded images per format: random sizes, gray or colour, noise,
    flat, blocky or a picture."""
    rng = np.random.default_rng(sum(map(ord, ext)))
    for k in range(40):
        h, w = int(rng.integers(1, 24)), int(rng.integers(1, 70))
        shape = (h, w) if rng.random() < 0.5 else (h, w, 3)
        style = k % 4
        if style == 0:
            img = rng.integers(0, 256, shape, dtype=np.uint8)
        elif style == 1:
            img = np.full(shape, rng.integers(0, 256), np.uint8)
        elif style == 2:
            img = rng.integers(0, 4, shape, dtype=np.uint8) * 85
        else:
            img = _picture(shape, k)
        _same_as_cv2(ext, img, tmp_path)


@pytest.mark.parametrize("ext", [".JPE", ".DIB", ".PBM", ".Pgm", ".PPM", ".PNM", ".PAM", ".PFM",
                                 ".SR", ".RAS", ".HDR", ".PIC", ".GIF", ".TIF", ".Tiff"])
def test_letter_case_is_ignored(ext, tmp_path):
    for shape in ((5, 9), (5, 9, 3)):
        _same_as_cv2(ext, _picture(shape, 1), tmp_path)


def test_refusals_and_what_they_leave(tmp_path):
    """Gray to ``.ppm`` and ``.gif``, colour to ``.pbm`` and ``.pgm``, four
    channels to the PNM forms, PFM and HDR: None and False; no file, except
    GIF's empty one and PFM's ``P``."""
    gray = _picture((6, 7), 0)
    color = _picture((6, 7, 3), 0)
    rgba = np.random.default_rng(0).integers(0, 256, (6, 7, 4), dtype=np.uint8)
    refused = [(".ppm", gray, None), (".gif", gray, b""), (".pbm", color, None),
               (".pgm", color, None)]
    refused += [(e, rgba, b"P" if e == ".pfm" else None)
                for e in (".pbm", ".pgm", ".ppm", ".pnm", ".pfm", ".hdr", ".pic")]
    for ext, image, left in refused:
        assert not _same_as_cv2(ext, image, tmp_path), ext
        path = tmp_path / ("port" + ext)
        assert (path.read_bytes() if path.exists() else None) == left, ext
    # a refusal leaves an earlier file as cv2 leaves it
    for ext, image in ((".ppm", gray), (".gif", gray), (".pfm", rgba)):
        ours, theirs = tmp_path / ("old_port" + ext), tmp_path / ("old_cv2" + ext)
        ours.write_bytes(b"old")
        theirs.write_bytes(b"old")
        assert imwrite(str(ours), image) is cv2.imwrite(str(theirs), _bgr(image)) is False
        assert ours.read_bytes() == theirs.read_bytes() == (b"old" if ext == ".ppm" else
                                                            _LEFT[ext]), ext


_LEFT = {".gif": b"", ".pfm": b"P"}


def test_rgba(tmp_path):
    """Four channels: ``.dib`` writes BMP's BITMAPV5 form as ``.bmp`` does;
    the formats cv2 writes them to and the port does not yet raise."""
    rgba = np.random.default_rng(1).integers(0, 256, (6, 7, 4), dtype=np.uint8)
    assert _same_as_cv2(".dib", rgba, tmp_path)
    assert imencode(".dib", rgba) == imencode(".bmp", rgba)
    for ext in (".pam", ".sr", ".ras", ".gif", ".tif", ".tiff"):
        assert cv2.imencode(ext, rgba)[0]
        with pytest.raises(ValueError, match=ext.replace(".", r"\.")):
            imencode(ext, rgba)


@pytest.mark.parametrize("ext", [".avif", ".xyz", ".exr", ".j2k", ".jpg2", ""])
def test_extensions_without_an_encoder_raise(ext, tmp_path):
    image = _picture((40, 40, 3), 0)
    writes = ext.lower() == ".avif"
    if writes:
        assert cv2.imencode(ext, image)[0]
    with pytest.raises(ValueError, match=repr(ext).replace(".", r"\.")) as err:
        imencode(ext, image)
    label = {".avif": "AVIF"}.get(ext.lower())
    if label:
        assert label in str(err.value)
    with pytest.raises(ValueError):
        imwrite(str(tmp_path / ("x" + ext)), image)
    assert not (tmp_path / ("x" + ext)).exists()


def test_jp2_default_is_lossless_only_within_rate_1():
    """cv2's default ``.jp2`` is OpenJPEG's 5/3 at rate 4
    (``IMWRITE_JPEG2000_COMPRESSION_X1000`` 250, not rate 1): it decodes
    bit-equal while the lossless stream fits a quarter of the raw bytes, as
    a 480 x 640 scene and its gray plane do, but not for noise, whose coding
    passes the rate allocation cuts; so the port's JPEG 2000 encoder is held
    to cv2's bytes (``tests/test_torch_port_jpeg2000_enc.py``), not to the
    pixels alone, as the WebP encoder is."""
    scene = _bgr(_input("coco_00"))
    for img in (scene, cv2.cvtColor(scene, cv2.COLOR_BGR2GRAY)):
        ok, data = cv2.imencode(".jp2", img)
        assert ok
        np.testing.assert_array_equal(cv2.imdecode(data, cv2.IMREAD_UNCHANGED), img)
        print(f"jp2 of {img.shape}: {len(data)} bytes, bit-equal")
    noise = np.random.default_rng(0).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    ok, data = cv2.imencode(".jp2", noise)
    err = np.abs(cv2.imdecode(data, cv2.IMREAD_UNCHANGED).astype(int) - noise).max()
    print(f"jp2 of seeded noise (37, 53, 3): {len(data)} bytes, largest error {err}")
    assert ok and err > 100


def test_aliases_write_their_formats_bytes():
    for shape in ((9, 13), (9, 13, 3)):
        img = _picture(shape, 2)
        assert imencode(".jpe", img) == imencode(".jpg", img) == imencode(".jpeg", img)
        assert imencode(".dib", img) == imencode(".bmp", img)
        assert imencode(".ras", img) == imencode(".sr", img)
        assert imencode(".pic", img) == imencode(".hdr", img)
        assert imencode(".tiff", img) == imencode(".tif", img)
    assert imencode(".pnm", _picture((9, 13), 0)) == imencode(".pgm", _picture((9, 13), 0))
    assert imencode(".pnm", _picture((9, 13, 3), 0)) == imencode(".ppm", _picture((9, 13, 3), 0))
    assert set(EXTS) <= set(EXTENSIONS)


def test_hdr_every_level(tmp_path):
    """Every gray level (widths 256 and 7: run-length coded and flat) and
    random triples through ``float2rgbe``; widths around the run-length
    limits 8 and 0x7fff and runs around 127 and 128."""
    levels = np.arange(256, dtype=np.uint8)
    for img in (levels.reshape(1, 256), levels.reshape(256, 1), levels[:252].reshape(36, 7),
                levels.reshape(16, 16)):
        _same_as_cv2(".hdr", img, tmp_path)
        _same_as_cv2(".hdr", np.stack([img, img[::-1], img // 3], -1), tmp_path)
    rng = np.random.default_rng(4)
    _same_as_cv2(".hdr", rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), tmp_path)
    for w in (7, 8, 9, 127, 128, 129, 255, 256, 257, 0x7FFF, 0x8000):
        img = np.repeat(rng.integers(0, 3, (2, -(-w // 130), 3), dtype=np.uint8) * 100, 130,
                        axis=1)[:, :w]
        _same_as_cv2(".hdr", np.ascontiguousarray(img), tmp_path)


def test_gif_quantiser_matches_cv2(tmp_path):
    """cv2's Floyd-Steinberg diffusion in float over 480 x 640 random
    pixels (ties to the half-step included) and a few picture rows."""
    for seed in (6, 7):
        img = np.random.default_rng(seed).integers(0, 256, (480, 640, 3), dtype=np.uint8)
        _same_as_cv2(".gif", img, tmp_path)
    _same_as_cv2(".gif", _picture((200, 300, 3), 5), tmp_path)


def test_tiff_long_rows_match_cv2(tmp_path):
    """Rows longer than 8 KiB (one row a strip) pass the LZW encoder's
    ratio check every 10,000 bytes: a run of flat rows then noise, so the
    ratio falls and the table is reset; the table also fills on noise."""
    rng = np.random.default_rng(5)
    img = np.zeros((3, 9000, 3), np.uint8)
    img[:, 4000:] = rng.integers(0, 256, (3, 5000, 3))
    _same_as_cv2(".tif", img, tmp_path)
    _same_as_cv2(".tif", rng.integers(0, 256, (2, 30000), dtype=np.uint8), tmp_path)
    _same_as_cv2(".tif", rng.integers(0, 2, (2, 70000), dtype=np.uint8) * 255, tmp_path)
    _same_as_cv2(".tif", rng.integers(0, 256, (70000, 1), dtype=np.uint8), tmp_path)


with open(os.path.join(FIXTURES, "cv2_digests.json")) as _f:
    DIGESTS = json.load(_f)
INPUTS = np.load(os.path.join(FIXTURES, "inputs.npz"))


def _input(name):
    if name.startswith("coco_"):
        return imread(os.path.join(SCENES, name + ".webp"))
    return INPUTS[name]


def _outcome(ext, image):
    data = imencode(ext, image)
    if data is None:
        return None
    cut = _cut(ext, image)
    return hashlib.sha256(data[:len(data) - cut]).hexdigest(), len(data), cut


@pytest.mark.parametrize("name", sorted(DIGESTS["encodes"]))
def test_stored_digests_are_cv2s_and_the_ports(name, tmp_path):
    """Each stored outcome is still cv2's, and the port gives it (what
    ``chip_smoke.py``'s ``encoders_phase`` checks on the card)."""
    image = _input(name)
    for ext, stored in DIGESTS["encodes"][name].items():
        ok, data = cv2.imencode(ext, _bgr(image))
        got = _outcome(ext, image)
        if stored.get("refused"):
            assert not ok and got is None, (name, ext)
            continue
        cut = stored["cut"]
        data = data.tobytes()
        assert hashlib.sha256(data[:len(data) - cut]).hexdigest() == stored["sha256"]
        assert got == (stored["sha256"], stored["bytes"], cut), (name, ext)
    webp = DIGESTS["webp"]["encodes"][name]
    ours = imencode(".webp", image)
    ok, theirs = cv2.imencode(".webp", _bgr(image))
    assert ok and len(theirs) == webp["cv2_bytes"], name
    assert (hashlib.sha256(ours).hexdigest(), len(ours)) == (webp["port_sha256"],
                                                             webp["port_bytes"]), name
    back = cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_UNCHANGED)
    back = np.ascontiguousarray(back[..., [2, 1, 0, 3][:back.shape[2]]])
    np.testing.assert_array_equal(back, chip_smoke.webp_read_back(image))
    assert hashlib.sha256(back).hexdigest() == webp["decode_sha256"], name


def test_fixture_set_is_complete():
    assert len(DIGESTS["encodes"]) == len(INPUTS.files) + 32
    for name, outcomes in DIGESTS["encodes"].items():
        assert set(outcomes) == (set(EXTS) if _input(name).ndim == 2
                                 or _input(name).shape[2] == 3 else
                                 {".dib", ".pbm", ".pgm", ".ppm", ".pnm", ".pfm", ".hdr", ".pic"})
    assert tuple(DIGESTS["encoders480"]["exts"]) == (
        ".jpe", ".dib", ".ppm", ".pnm", ".pam", ".pfm", ".sr", ".ras", ".hdr", ".pic", ".gif",
        ".tif", ".tiff", ".pgm", ".pbm", ".JPE")
    webp = DIGESTS["webp"]
    assert set(webp["encodes"]) == set(DIGESTS["encodes"])
    for outcome in webp["encodes"].values():
        assert set(outcome) == {"port_sha256", "port_bytes", "cv2_bytes", "decode_sha256"}
    named = webp["webp_named480"]
    assert tuple(named["exts"]) == (".webp",) * 15 + (".WEBP",)
    assert len(named["previews"]) == len(named["preview_cv2_bytes"]) == 32
    assert sorted(os.path.splitext(r)[1] for r in named["previews"]) == \
        [".WEBP"] * 2 + [".webp"] * 30
    assert not any(r.startswith("mix/") for r in named["files"])
    size = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert size < 300_000, size


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root).replace(os.sep, "/")] = f.read()
    return out


def test_encoders480_tree_converts_as_jax(tmp_path):
    """The 32 scenes named in turn ``.jpe .dib .ppm .pnm .pam .pfm .sr .ras
    .hdr .pic .gif .tif .tiff .pgm .pbm .JPE`` (``chip_smoke.py``'s tree):
    both converters write the same files, byte for byte, and both equal the
    stored digests; the ``.pgm`` and ``.pbm`` mix previews are absent (cv2
    refuses a colour image there and the converters go on)."""
    with open(os.path.join(SCENES, "coco_scenes.json")) as f:
        scenes = json.load(f)
    sources = [os.path.join(SCENES, f"coco_{i:02d}.webp") for i in range(32)]
    exts = tuple(DIGESTS["encoders480"]["exts"])
    img_dir, ann = chip_smoke.scene_coco_tree(str(tmp_path / "src"), sources, scenes, exts)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann, port, progress=False) == 32
    assert jconv.transfer_coco(img_dir, ann, ref, progress=False) == 32
    ours, theirs = _files(port), _files(ref)
    assert sorted(ours) == sorted(theirs)
    for rel, data in ours.items():
        assert data == theirs[rel], rel
    assert chip_smoke.tree_digests(port, img_dir) == DIGESTS["encoders480"]["files"]
    mixes = sorted(r for r in ours if r.startswith("mix/"))
    assert len(mixes) == 28
    assert not any(r.endswith((".pgm", ".pbm")) for r in mixes)


def test_webp_named480_tree_matches_the_stored_digests(tmp_path):
    """The 32 scenes under ``.webp`` names (two ``.WEBP``), ``chip_smoke.py``'s
    webp_named480 tree, converted by the port: every file but the mix
    previews has the stored digest of the JAX package's file, and each
    ``.webp`` mix preview decodes (the port's reader and cv2's) to the
    stored digest of cv2's decode of the JAX package's preview."""
    with open(os.path.join(SCENES, "coco_scenes.json")) as f:
        scenes = json.load(f)
    named = DIGESTS["webp"]["webp_named480"]
    sources = [os.path.join(SCENES, f"coco_{i:02d}.webp") for i in range(32)]
    img_dir, ann = chip_smoke.scene_coco_tree(str(tmp_path / "src"), sources, scenes,
                                              tuple(named["exts"]))
    port = str(tmp_path / "port")
    assert tconv.transfer_coco(img_dir, ann, port, progress=False) == 32
    got = chip_smoke.tree_digests(port, img_dir)
    previews = {r: got.pop(r) for r in list(got) if r.startswith("mix/")}
    assert got == named["files"]
    assert sorted(previews) == sorted(named["previews"])
    ours = theirs = 0
    for rel in previews:
        path = os.path.join(port, rel)
        rgb = imread(path)
        np.testing.assert_array_equal(rgb, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
        assert hashlib.sha256(rgb).hexdigest() == named["previews"][rel], rel
        ours += os.path.getsize(path)
        theirs += named["preview_cv2_bytes"][rel]
    print(f"webp_named480: the port's previews {ours} bytes against cv2's {theirs}: "
          f"{ours / theirs:.4f} x")
    assert ours <= 1.5 * theirs
