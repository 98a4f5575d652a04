"""The port's JPEG encoder (``ops/native/jpeg_enc.cpp`` through
``ops/native/jpeg.py:encode_jpeg`` and ``core/imwrite.py``) against
``cv2.imencode(".jpg")`` with its default parameters (the JAX converters'
``cv2.imwrite``; CPU): the bytes equal, for colour and gray images of
1 x 1, 17 x 9, 37 x 53, 96 x 128 and 480 x 640 pixels with random and
smooth content (odd sizes exercise the edge padding and the dummy blocks
of the 4:2:0 MCUs); and the committed encoder fixtures of
``tests/data/jpeg`` against cv2 and the port.
"""
import glob
import os

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu_torch.core.imwrite import imencode, imwrite
from instancesegmentation_tpu_torch.ops.native.jpeg import encode_jpeg

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SIZES = [(1, 1), (17, 9), (37, 53), (96, 128), (480, 640)]


def _pixels(h, w, content, seed):
    rng = np.random.default_rng(seed)
    if content == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7 + y / 11), 128 + 90 * np.cos(x / 5 - y / 13),
                    (x * 3 + y * 2) % 256], axis=-1) + rng.normal(0, 3, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2(pixels):
    ok, data = cv2.imencode(".jpg", pixels if pixels.ndim == 2 else pixels[..., ::-1])
    assert ok
    return data.tobytes()


@pytest.mark.parametrize("channels", [3, 1], ids=["color", "gray"])
@pytest.mark.parametrize("content", ["random", "smooth"])
@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_encode_jpeg_equals_cv2(h, w, content, channels):
    rgb = _pixels(h, w, content, seed=h * w)
    pixels = rgb if channels == 3 else np.ascontiguousarray(rgb[..., 1])
    want = _cv2(pixels)
    assert encode_jpeg(pixels) == want
    if channels == 1:
        assert encode_jpeg(pixels[..., None]) == want


def test_imwrite_picks_the_encoder_by_extension(tmp_path):
    rgb = _pixels(20, 30, "smooth", 1)
    want = _cv2(rgb)
    for ext in (".jpg", ".JPEG"):
        assert imencode(ext, rgb) == want
        imwrite(str(tmp_path / f"a{ext}"), rgb)
        assert (tmp_path / f"a{ext}").read_bytes() == want
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(rgb.astype(np.float32))
    with pytest.raises(ValueError, match="H, W"):
        encode_jpeg(np.zeros((4, 4, 4), np.uint8))


@pytest.mark.parametrize("name", sorted(os.path.basename(p)[:-4]
                                        for p in glob.glob(os.path.join(FIXTURES, "enc_*.jpg"))))
def test_encoder_fixtures(name):
    """Each ``enc_*`` fixture is still cv2's encoding of the pixels stored
    beside it, and the port encodes them to the same bytes
    (``chip_smoke.py`` repeats the latter on the card's machine)."""
    with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
        data = f.read()
    pixels = np.load(os.path.join(FIXTURES, name + ".npz"))["pixels"]
    assert _cv2(pixels) == data
    assert encode_jpeg(pixels) == data
