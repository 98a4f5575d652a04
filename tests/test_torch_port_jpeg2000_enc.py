"""The port's JPEG 2000 writer (``core/jpeg2000.py:encode_jpeg2000``, the
codestream of ``ops/native/jpeg2000_enc.cpp``, reached through
``core/imwrite.py``) against live ``cv2.imencode(".jp2")`` /
``cv2.imwrite``, byte for byte.

cv2 5.0 has OpenJPEG 2.5.3 write one quality layer at rate 4
(``IMWRITE_JPEG2000_COMPRESSION_X1000`` 250), so the rate allocation cuts
photographs and noise; OpenJPEG's choices are deterministic, and the port's
file is cv2's:

- the inputs of ``tests/data/imwrite`` (the 32 scenes among them), the
  stored digests of ``make_fixtures.py``'s ``jp2`` section still cv2's;
- seeded gray, RGB and RGBA images at sides 32, 33, 63-65, 127 and odd
  widths; flat images and 0/255 masks; seeded noise (cut hard); the
  ``coco_00`` JPEG 2000 scene (which fits the rate: lossless) and the q95
  JPEG fixture (cut by the rate: largest error 1);
- the rates 1000, 500, 250 and 100 of ``IMWRITE_JPEG2000_COMPRESSION_X1000``
  through the private ``_encode_jp2`` (``imencode`` always writes cv2's
  default);
- refusals (a side under 32): ``imencode`` None, ``imwrite`` False leaving
  the JP2 boxes ``cv2.imwrite`` leaves;
- the port's reader gives cv2's decode of the port's files, letter case,
  bad input, and a writer process that maps no OpenJPEG.
"""
import hashlib
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.imwrite import imencode, imwrite
from instancesegmentation_tpu_torch.core.jpeg2000 import _encode_jp2, encode_jpeg2000

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMWRITE = os.path.join(ROOT, "tests", "data", "imwrite")
WEBP_SCENES = os.path.join(ROOT, "tests", "data", "webp")
JPEG2000 = os.path.join(ROOT, "tests", "data", "jpeg2000")
Q95 = os.path.join(ROOT, "tests", "data", "jpeg", "base_480x640_420_q95.jpg")
with open(os.path.join(IMWRITE, "cv2_digests.json")) as _f:
    STORED = json.load(_f)["jp2"]["encodes"]


def _bgr(image):
    if image.ndim == 2 or image.shape[2] == 1:
        return image
    return np.ascontiguousarray(image[..., [2, 1, 0, 3][:image.shape[2]]])


def _cv2(image, x1000=None):
    params = [] if x1000 is None else [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000]
    ok, data = cv2.imencode(".jp2", _bgr(image), params)
    return data.tobytes() if ok else None


def _same_as_cv2(image):
    """The port's ``.jp2`` of ``image`` is cv2's, byte for byte; returns it."""
    ours = imencode(".jp2", image)
    theirs = _cv2(image)
    assert theirs is not None and ours == theirs, (image.shape, None if ours is None
                                                   else (len(ours), len(theirs)))
    return ours


def _input(name):
    if name.startswith("coco_"):
        return imread(os.path.join(WEBP_SCENES, name + ".webp"))
    return np.load(os.path.join(IMWRITE, "inputs.npz"))[name]


def _picture(shape, seed):
    """Smooth gradients with seeded noise on top, ``shape`` (H, W) or (H, W, C)."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / rng.uniform(3, 20)) + 50 * np.cos(yy / rng.uniform(3, 20))
    if len(shape) == 3:
        base = base[..., None] + rng.integers(-40, 40, shape[2])
    return np.clip(base + rng.integers(-6, 7, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(STORED))
def test_stored_inputs(name):
    """Each input of ``tests/data/imwrite``: the port's bytes are live
    cv2's and the stored digest (the card holds the port to it); the port's
    reader gives cv2's stored decode; a refused input is refused by both."""
    image, stored = _input(name), STORED[name]
    ours = imencode(".jp2", image)
    if stored.get("refused"):
        assert ours is None and _cv2(image) is None
        return
    assert ours == _cv2(image)
    assert len(ours) == stored["bytes"]
    assert hashlib.sha256(ours).hexdigest() == stored["sha256"]
    assert hashlib.sha256(np.ascontiguousarray(imdecode(ours))).hexdigest() == \
        stored["decode_sha256"]


SIDES = [(32, 32), (33, 47), (63, 65), (64, 64), (65, 63), (127, 33), (41, 127), (35, 101)]


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("hw", SIDES, ids=[f"{h}x{w}" for h, w in SIDES])
def test_seeded_shapes(hw, channels):
    shape = hw if channels == 1 else hw + (channels,)
    _same_as_cv2(_picture(shape, sum(shape)))


@pytest.mark.parametrize("value", [0, 1, 2, 3, 11, 127, 128, 129, 254, 255])
def test_flat_images(value):
    """Flat images: one code-block with passes (the LL band), empty packets
    for the rest, and the threshold search stopping early (several values
    end a pass on a slope at the bisection's floor)."""
    for shape in ((40, 88), (37, 80, 3), (44, 98, 4)):
        _same_as_cv2(np.full(shape, value, np.uint8))


@pytest.mark.parametrize("kind", ["circle", "blocks", "sparse", "stripes"])
def test_masks(kind):
    """0/255 masks as ``infer --dataset-mode`` writes them, gray and three
    channels."""
    rng = np.random.default_rng(len(kind))
    h, w = 120, 161
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "circle":
        m = (yy - 60) ** 2 + (xx - 75) ** 2 < 45 ** 2
    elif kind == "blocks":
        m = np.kron(rng.random((12, 17)) < 0.5, np.ones((10, 10), bool))[:h, :w]
    elif kind == "sparse":
        m = rng.random((h, w)) < 0.01
    else:
        m = (xx // 7) % 2 == 0
    mask = m.astype(np.uint8) * 255
    data = _same_as_cv2(mask)
    _same_as_cv2(np.repeat(mask[..., None], 3, -1))
    if kind == "circle":
        np.testing.assert_array_equal(imdecode(data, "gray"), mask)  # fits the rate


@pytest.mark.parametrize("shape", [(32, 32), (53, 37, 3), (64, 80, 4), (150, 123, 3)])
def test_noise_is_cut_as_cv2_cuts_it(shape):
    noise = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    data = _same_as_cv2(noise)
    back = imdecode(data, "gray" if len(shape) == 2 else "color")
    want = noise if noise.ndim == 2 else noise[..., :3]
    assert np.abs(back.astype(int) - want).max() > 100  # far from lossless


def test_coco_00_scene_fits_the_rate():
    """The first committed JPEG 2000 scene, as the port reads it: cv2's
    bytes, and lossless (every pass fits rate 4)."""
    scene = imread(os.path.join(JPEG2000, "coco_00.jp2"))
    data = _same_as_cv2(scene)
    np.testing.assert_array_equal(imdecode(data), scene)


def test_q95_fixture_is_cut_by_the_rate():
    """The 480 x 640 q95 JPEG fixture: its lossless stream (238,380 bytes)
    passes rate 4's budget, so the allocation cuts it to cv2's 230,371
    bytes, whose largest error is 1."""
    image = imread(Q95)
    data = _same_as_cv2(image)
    assert len(data) == 230371 and len(_encode_jp2(image, 1000)) == 238380
    assert np.abs(imdecode(data).astype(int) - image).max() == 1
    _same_as_cv2(cv2.cvtColor(image, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("x1000", [1000, 500, 250, 100])
def test_private_rates(x1000):
    """``IMWRITE_JPEG2000_COMPRESSION_X1000`` through ``_encode_jp2``: 1000
    (rate 1) is lossless, lower values cut harder."""
    rng = np.random.default_rng(x1000)
    for shape in ((32, 40), (45, 33, 3), (64, 64, 4), (70, 90, 3)):
        for image in (_picture(shape, x1000), rng.integers(0, 256, shape, dtype=np.uint8)):
            ours, theirs = _encode_jp2(image, x1000), _cv2(image, x1000)
            assert ours == theirs, (shape, x1000)
            if x1000 == 1000:
                back = imdecode(ours, "gray" if len(shape) == 2 else "color")
                np.testing.assert_array_equal(back, image if image.ndim == 2 else image[..., :3])
    assert _encode_jp2(_picture((40, 40, 3), 0), 250) == encode_jpeg2000(_picture((40, 40, 3), 0))


@pytest.mark.parametrize("shape", [(16, 40), (31, 64, 3), (32, 31), (33, 31, 4), (1, 1)])
def test_refusals_and_what_imwrite_leaves(shape, tmp_path):
    """A side under 32 (too small for OpenJPEG's 6 resolutions): ``imencode``
    None where cv2's returns False; ``imwrite`` False, leaving in the file
    (an older one overwritten) the JP2 boxes ``cv2.imwrite`` leaves."""
    image = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    assert imencode(".jp2", image) is None and _cv2(image) is None
    ours, theirs = tmp_path / "port.jp2", tmp_path / "cv2.jp2"
    ours.write_bytes(b"an older file")
    assert imwrite(str(ours), image) is False
    assert cv2.imwrite(str(theirs), _bgr(image)) is False
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(ours.read_bytes()) == (111 if len(shape) == 3 and shape[2] == 4 else 77)


def test_reader_gives_cv2s_decode(tmp_path):
    """``imread`` of the port's files (gray, colour, RGBA) gives
    ``cv2.imread``'s pixels, in colour and in gray."""
    for k, shape in enumerate(((48, 50), (48, 50, 3), (48, 50, 4))):
        path = str(tmp_path / f"x{k}.jp2")
        assert imwrite(path, np.random.default_rng(k).integers(0, 256, shape, dtype=np.uint8))
        np.testing.assert_array_equal(imread(path), cv2.imread(path)[..., ::-1])
        np.testing.assert_array_equal(imread(path, "gray"),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_letter_case_and_channel_forms(tmp_path):
    image = _picture((40, 45, 3), 7)
    gray = image[..., 0]
    assert imencode(".JP2", image) == imencode(".jp2", image) == encode_jpeg2000(image)
    assert imencode(".jp2", gray[..., None]) == imencode(".jp2", gray)
    assert imwrite(str(tmp_path / "a.Jp2"), image)
    assert (tmp_path / "a.Jp2").read_bytes() == _cv2(image)


def test_bad_input_raises():
    for bad in (np.zeros((40, 40), np.float32), np.zeros((40, 40, 2), np.uint8),
                np.zeros((0, 40, 3), np.uint8), np.zeros((40, 40, 3, 1), np.uint8)):
        with pytest.raises(ValueError):
            imencode(".jp2", bad)


def test_writing_jp2_loads_no_openjpeg():
    """A process that writes JPEG 2000 through the port maps no OpenJPEG
    (nor cv2 or PIL): the encoder is the port's own C++ (``build/native/
    libjpeg2000_enc_<hash>.so``, built from ``ops/native/jpeg2000_enc.cpp``)."""
    code = (
        "import sys, os, re\n"
        "import numpy as np\n"
        "from instancesegmentation_tpu_torch.core.imwrite import imencode\n"
        "data = imencode('.jp2', np.arange(4800, dtype=np.uint8).reshape(40, 40, 3))\n"
        "assert data[4:8] == b'jP  ' and b'jp2c' in data\n"
        "files = {l.split()[-1] for l in open('/proc/self/maps') if '/' in l}\n"
        "names = {os.path.basename(f) for f in files}\n"
        "assert not [n for n in names if 'openjp' in n]\n"
        "lib = r'build/native/libjpeg2000_enc_[0-9a-f]+\\.so$'\n"
        "assert [f for f in files if re.search(lib, f)]\n"
        "assert 'cv2' not in sys.modules and 'PIL' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
