"""The port's WebP writer (``core/webp.py:encode_webp``, the VP8L stream of
``ops/native/webp_enc.cpp``, reached through ``core/imwrite.py``) against
live ``cv2.imencode(".webp")`` / ``cv2.imwrite``, which write a lossless
VP8L file at their default parameters.

libwebp picks its transforms and codes by heuristics, so the bytes differ;
what is held equal is what a reader gets: ``cv2.imdecode`` of the port's
bytes equals ``cv2.imdecode`` of cv2's bytes for the same image in
``IMREAD_COLOR``, ``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``, and the
port's own ``decode_webp`` gives the same colour and gray images.  One rule
is the port's: RGB under alpha 0 is written as 0, where libwebp's inexact
default writes whatever its predictors make cheapest; there the pixels
with alpha 0 are held to 0 and the rest to cv2's.

- shapes: 1 x 1, widths 1-17, odd sides, gray, 2, 3, 4, 5, 16, 17, 256 and
  257 colours (pixel bundling and colour indexing at their edges), a 480 x
  640 mask, RGBA with alpha 0, 255 and mixed, a seeded sweep of sizes and
  colour counts;
- size: at most 2 x cv2's bytes + 256 for each image, at most 1.5 x
  cv2's summed over the 32 scenes of ``tests/data/webp`` (printed);
- refusals (a side above 16,383) as cv2's, and what ``imwrite`` leaves;
- the container (``RIFF`` / ``WEBP`` / ``VP8L``, the pad byte, the alpha
  hint), letter case, and a writer process that maps no libwebp.
"""
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu_torch.core.imread import imread
from instancesegmentation_tpu_torch.core.imwrite import imencode, imwrite
from instancesegmentation_tpu_torch.core.webp import MAX_SIDE, decode_webp, encode_webp

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "tests", "data", "webp")
DIGESTS = os.path.join(ROOT, "tests", "data", "imwrite", "cv2_digests.json")
MODES = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)


def _bgr(image):
    if image.ndim == 2:
        return image
    return np.ascontiguousarray(image[..., [2, 1, 0, 3][:image.shape[2]]])


def _decode(data, mode):
    return cv2.imdecode(np.frombuffer(data, np.uint8), mode)


def _same_as_cv2(image):
    """The port's bytes against cv2's for ``image``: each read mode decodes
    alike (pixels under alpha 0 aside, which the port writes as 0), the
    port's ``decode_webp`` agrees, and the size is within 2 x + 256 bytes.
    Returns (port bytes, cv2 bytes)."""
    ours = imencode(".webp", image)
    ok, theirs = cv2.imencode(".webp", _bgr(image))
    assert ok and ours is not None, image.shape
    theirs = theirs.tobytes()
    alpha = image[..., 3] if image.ndim == 3 and image.shape[2] == 4 else None
    clear = alpha == 0 if alpha is not None else None
    for mode in MODES:
        got, want = _decode(ours, mode), _decode(theirs, mode)
        assert got is not None and got.shape == want.shape, (image.shape, mode)
        if clear is None or not clear.any():
            np.testing.assert_array_equal(got, want, err_msg=f"{image.shape} mode {mode}")
        else:
            np.testing.assert_array_equal(got[~clear], want[~clear])
            assert not got[clear].any(), (image.shape, mode)
    color = decode_webp(ours)
    np.testing.assert_array_equal(color, _decode(ours, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(decode_webp(ours, "gray"),
                                  _decode(ours, cv2.IMREAD_GRAYSCALE))
    if alpha is None or not clear.any():
        rgb = image if image.ndim == 3 else np.repeat(image.reshape(image.shape[:2] + (1,)), 3, -1)
        np.testing.assert_array_equal(color, rgb[..., :3])
    assert len(ours) <= 2 * len(theirs) + 256, (image.shape, len(ours), len(theirs))
    return len(ours), len(theirs)


def _colours(n, shape, seed, gray=False):
    """``shape`` (``[H, W]``) pixels, RGB or gray, drawn from ``n`` distinct
    colours (gray levels)."""
    rng = np.random.default_rng(seed)
    if gray:
        levels = rng.permutation(256)[:n].astype(np.uint8)
        return levels[rng.integers(0, n, shape)]
    codes = rng.choice(1 << 24, n, replace=False)
    palette = np.stack([(codes >> 16) & 255, (codes >> 8) & 255, codes & 255], -1).astype(np.uint8)
    idx = rng.integers(0, n, shape)
    idx.flat[:n] = np.arange(n)  # every colour present
    return palette[idx]


def _picture(h, w, seed):
    """Shading, blocks and a little noise (the predictors' and LZ77's
    ground)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([30 + x // 3, 40 + y // 2, 60 + (x + y) // 4], -1) + rng.integers(0, 3, (h, w, 3))
    img[h // 4:h // 2, w // 3:2 * w // 3] += 90
    return (img % 256).astype(np.uint8)


@pytest.mark.parametrize("width", range(1, 18))
def test_widths_1_to_17(width):
    """Every width that bundles 1-8 pixels to a byte, gray and colour,
    noise and pictures, 1-5 rows."""
    rng = np.random.default_rng(width)
    for h in (1, 2, 3, 5):
        _same_as_cv2(rng.integers(0, 256, (h, width, 3), dtype=np.uint8))
        _same_as_cv2(rng.integers(0, 256, (h, width), dtype=np.uint8))
        _same_as_cv2(_picture(h, width, width))


@pytest.mark.parametrize("shape", [(1, 1), (1, 1, 3), (1, 1, 4), (3, 1), (1, 3, 3), (7, 9),
                                   (9, 7, 3), (33, 65, 3), (101, 37), (255, 3, 3)])
def test_small_and_odd_shapes(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if len(shape) == 3 and shape[2] == 4:
        img[..., 3] = 200
    _same_as_cv2(img)
    _same_as_cv2(np.zeros(shape, np.uint8))
    if len(shape) == 2 or shape[2] == 3:
        h, w = shape[:2]
        pic = _picture(h, w, 1)
        _same_as_cv2(pic if len(shape) == 3 else np.ascontiguousarray(pic[..., 1]))


def test_gray_forms_write_three_equal_channels():
    """Gray ``[H, W]`` and ``[H, W, 1]`` write the same file, cv2's
    ``GRAY2BGR`` of the plane: three equal channels, no alpha."""
    img = _picture(40, 50, 2)[..., 0]
    data = imencode(".webp", img)
    assert data == imencode(".webp", img[..., None])
    assert data == imencode(".webp", np.repeat(img[..., None], 3, -1))
    _same_as_cv2(img)
    assert _decode(data, cv2.IMREAD_UNCHANGED).shape == (40, 50, 3)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 16, 17, 256, 257])
def test_colour_counts(n):
    """Colour indexing at each bundling edge (2 / 4 / 16 colours: 8, 4, 2
    pixels to a byte), at 256 (the largest palette) and 257 (none)."""
    for k, shape in enumerate(((37, 53), (64, 64), (1, 300), (300, 1))):
        _same_as_cv2(_colours(n, shape, 10 * n + k))
        _same_as_cv2(_colours(n, shape, 10 * n + k, gray=True) if n <= 256 else
                     _colours(256, shape, 10 * n + k, gray=True))


def test_mask_480x640():
    """A two-level mask, as ``infer --dataset-mode`` writes them: colour
    indexing with 8 pixels to a byte; cv2 writes such a rectangle in 64
    bytes."""
    m = np.zeros((480, 640), np.uint8)
    m[100:300, 200:500] = 255
    ours, theirs = _same_as_cv2(m)
    assert ours <= 2 * theirs, (ours, theirs)
    yy, xx = np.mgrid[:480, :640]
    _same_as_cv2((((xx - 300) / 120) ** 2 + ((yy - 200) / 150) ** 2 < 1).astype(np.uint8) * 255)


@pytest.mark.parametrize("alpha", ["zero", "opaque", "mixed", "levels"])
def test_rgba(alpha):
    """RGBA: alpha 0 everywhere (the file's RGB all 0), 255 everywhere (no
    alpha hint: read back with three channels, as cv2's file), mixed and
    many levels; random and smooth RGB under it."""
    rng = np.random.default_rng(len(alpha))
    for rgb in (rng.integers(0, 256, (30, 41, 3), dtype=np.uint8), _picture(60, 70, 3)):
        h, w = rgb.shape[:2]
        a = {"zero": np.zeros((h, w)), "opaque": np.full((h, w), 255),
             "mixed": np.where(rng.random((h, w)) < 0.4, 0, 255),
             "levels": rng.integers(0, 256, (h, w))}[alpha].astype(np.uint8)
        img = np.concatenate([rgb, a[..., None]], -1)
        _same_as_cv2(img)
        data = imencode(".webp", img)
        has_alpha = bool((data[20 + 4] >> 4) & 1)
        assert has_alpha == (alpha != "opaque")
        assert _decode(data, cv2.IMREAD_UNCHANGED).shape[2] == (3 if alpha == "opaque" else 4)
        if alpha == "opaque":
            assert data == imencode(".webp", rgb)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_sweep(seed):
    """25 images per seed: random sizes, gray or colour or RGBA, drawn from
    1 to 100,000 colours, or pictures."""
    rng = np.random.default_rng(1000 + seed)
    for k in range(25):
        h, w = int(rng.integers(1, 90)), int(rng.integers(1, 90))
        style = k % 5
        if style == 4:
            img = _picture(h, w, k)
        else:
            n = int(rng.choice([1, 2, 3, 7, 20, 200, 256, 257, 1000, 100000]))
            img = _colours(min(n, h * w), (h, w), int(rng.integers(1 << 30)))
            if style == 1:
                img = np.ascontiguousarray(img[..., 0])
            elif style == 2:
                a = rng.choice([0, 128, 255], (h, w)).astype(np.uint8)
                img = np.concatenate([img, a[..., None]], -1)
        _same_as_cv2(img)


def test_scenes_size_against_cv2():
    """The 32 480 x 640 scenes of ``tests/data/webp``: each decodes to
    itself, and the port's bytes are at most 1.5 x cv2's in sum (cv2's
    byte counts stored by ``tests/data/imwrite/make_fixtures.py``, which
    ``test_torch_port_imwrite.py`` holds to live cv2)."""
    with open(DIGESTS) as f:
        stored = json.load(f)["webp"]["encodes"]
    ours = theirs = 0
    for i in range(32):
        name = f"coco_{i:02d}"
        img = imread(os.path.join(SCENES, name + ".webp"))
        data = encode_webp(img)
        np.testing.assert_array_equal(decode_webp(data), img)
        ours += len(data)
        theirs += stored[name]["cv2_bytes"]
        assert len(data) <= 2 * stored[name]["cv2_bytes"] + 256, name
    print(f"webp: the port's bytes {ours} against cv2's {theirs} over the 32 scenes: "
          f"{ours / theirs:.4f} x")
    assert ours <= 1.5 * theirs, (ours, theirs)


@pytest.mark.parametrize("shape", [(1, MAX_SIDE + 1, 3), (MAX_SIDE + 1, 1), (MAX_SIDE + 1, 2, 4),
                                   (1, MAX_SIDE, 3), (MAX_SIDE, 1)])
def test_side_limit_and_what_imwrite_leaves(shape, tmp_path):
    """A side above 16,383: cv2's encode fails (None / False), and
    ``cv2.imwrite`` leaves no file, removing one that was there; 16,383
    writes."""
    img = np.zeros(shape, np.uint8)
    refused = max(shape[:2]) > MAX_SIDE
    ok, _ = cv2.imencode(".webp", img)
    assert ok is not refused
    assert (imencode(".webp", img) is None) is refused
    for before in (None, b"old"):
        ours, theirs = tmp_path / "port.webp", tmp_path / "cv2.webp"
        for p in (ours, theirs):
            if p.exists():
                p.unlink()
            if before is not None:
                p.write_bytes(before)
        assert imwrite(str(ours), img) is cv2.imwrite(str(theirs), img) is (not refused)
        assert ours.exists() == theirs.exists() == (not refused)
    if not refused:
        _same_as_cv2(img)


def test_container_and_letter_case(tmp_path):
    """cv2's simple container: ``RIFF`` size, ``WEBP``, one ``VP8L`` chunk
    (no ``VP8X``) whose odd size takes a pad byte; the VP8L header's sides
    and version; ``.WEBP`` and ``.Webp`` write the same bytes, and
    ``imwrite`` writes ``imencode``'s."""
    rng = np.random.default_rng(5)
    pads = set()
    for shape in ((1, 1, 3), (3, 5, 3), (17, 23, 3), (40, 61), (8, 8, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        data = imencode(".webp", img)
        size = int.from_bytes(data[16:20], "little")
        assert data[:4] == b"RIFF" and data[8:16] == b"WEBPVP8L"
        assert int.from_bytes(data[4:8], "little") == len(data) - 8
        assert len(data) == 20 + size + (size & 1)
        pads.add(size & 1)
        if size & 1:
            assert data[-1] == 0
        head = int.from_bytes(data[21:25], "little")
        assert data[20] == 0x2F and head >> 29 == 0
        assert (head & 0x3FFF) + 1 == shape[1] and ((head >> 14) & 0x3FFF) + 1 == shape[0]
        for ext in (".WEBP", ".Webp"):
            assert imencode(ext, img) == data
            assert imwrite(str(tmp_path / ("x" + ext)), img)
            assert (tmp_path / ("x" + ext)).read_bytes() == data
    assert pads == {0, 1}


def test_bad_input_raises():
    for bad in (np.zeros((2, 2), np.float32), np.zeros((2, 2, 2), np.uint8),
                np.zeros((0, 3, 3), np.uint8), np.zeros((2, 2, 3, 1), np.uint8)):
        with pytest.raises(ValueError):
            imencode(".webp", bad)


def test_writing_webp_loads_no_libwebp():
    """A process that writes WebP through the port maps no libwebp (nor cv2
    or PIL): the encoder is the port's own C++ (``build/native/
    libwebp_enc_<hash>.so``, built from ``ops/native/webp_enc.cpp``)."""
    code = (
        "import sys, os, re\n"
        "import numpy as np\n"
        "from instancesegmentation_tpu_torch.core.imwrite import imencode\n"
        "data = imencode('.webp', np.arange(600, dtype=np.uint8).reshape(20, 10, 3))\n"
        "assert data[8:16] == b'WEBPVP8L'\n"
        "files = {l.split()[-1] for l in open('/proc/self/maps') if '/' in l}\n"
        "names = {os.path.basename(f) for f in files}\n"
        "assert not [n for n in names if re.match(r'lib(webp|webpdemux|sharpyuv)\\.so', n)]\n"
        "assert [f for f in files if re.search(r'build/native/libwebp_enc_[0-9a-f]+\\.so$', f)]\n"
        "assert 'cv2' not in sys.modules and 'PIL' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
