"""The port's PNG reader (``core/png.py`` behind ``core/imread.py``) against
``cv2.imread`` (the JAX package's reader, CPU) on every form of the format:
every valid pair of bit depth and colour type, with and without ``tRNS``,
without interlace and with Adam7, read as colour and as gray, bit for bit.

The files are written here chunk by chunk (rows in all five filters, drawn
from a seed), as ``tests/test_torch_port_data.py`` writes its files.  Also:
a colour file read as gray through libpng's gamma tables (``gAMA``,
``sRGB``, ``sBIT``), palette indices past the palette, and the bitmap that
Supervisely exports (1-bit palette with ``tRNS``).
"""
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.png import decode_png

torch.set_num_threads(1)

#: the bit depths the format allows per colour type
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
FORMS = [(color, depth, trns) for color, depths in DEPTHS.items() for depth in depths
         for trns in ((False, True) if color in (0, 2, 3) else (False,))]


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples, depth):
    """Rows of samples ``[h, n]`` at ``depth`` -> bytes ``[h, stride]``."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    per = 8 // depth
    padded = np.zeros((h, -(-n // per) * per), np.int64)
    padded[:, :n] = samples
    padded = padded.reshape(h, -1, per)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (padded << shifts).sum(axis=2).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows, filters, bpp):
    out = b""
    prev = np.zeros(rows.shape[1], np.int64)
    for row, f in zip(rows.astype(np.int64), filters):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[:len(row)]
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(row)]
        pred = (0, left, prev, (left + prev) // 2, _paeth(left, prev, up_left))[f]
        out += bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return out


def encode(samples, color, depth, interlace=0, before=(), after=(), seed=0):
    """A PNG of ``samples [H, W, C]`` (values at ``depth``), every row in a
    filter drawn from ``seed``; ``before`` chunks go ahead of PLTE / IDAT
    (``after``: between PLTE and IDAT)."""
    h, w, c = samples.shape
    rng = np.random.default_rng(seed)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            rows = _pack(sub.reshape(sub.shape[0], -1), depth)
            raw += _filtered(rows, rng.integers(0, 5, sub.shape[0]), max(1, c * depth // 8))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(k, v) for k, v in before)
            + b"".join(_chunk(k, v) for k, v in after)
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _cv2(data, mode):
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR if mode == "color" else cv2.IMREAD_GRAYSCALE)
    assert img is not None
    return img[..., ::-1] if img.ndim == 3 else img


def _same(data, mode, tmp_path=None):
    want = _cv2(data, mode)
    got = imdecode(data, mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if tmp_path is not None:  # and through the file reader
        path = tmp_path / "f.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(imread(str(path), mode), want)


def _form(color, depth, trns, h=13, w=19, seed=0):
    """Samples, PLTE and tRNS chunks of one form, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    n_palette = min(1 << depth, 7) if color == 3 else 0
    samples = rng.integers(0, n_palette or 1 << depth, (h, w, CHANNELS[color]))
    after = []
    if color == 3:
        after.append((b"PLTE", rng.integers(0, 256, 3 * n_palette).astype(np.uint8).tobytes()))
    if trns:
        first = [int(v) for v in samples[0, 0]]
        body = (bytes(rng.integers(0, 256, n_palette).astype(np.uint8)) if color == 3
                else struct.pack(f">{len(first)}H", *first))
        after.append((b"tRNS", body))
    return samples, after


@pytest.mark.parametrize("mode", ["color", "gray"])
@pytest.mark.parametrize("interlace", [0, 1], ids=["progressive_rows", "adam7"])
@pytest.mark.parametrize("color,depth,trns", FORMS,
                         ids=[f"type{c}_{d}bit{'_trns' if t else ''}" for c, d, t in FORMS])
def test_png_form_matches_cv2(color, depth, trns, interlace, mode, tmp_path):
    samples, after = _form(color, depth, trns, seed=depth + 7 * color)
    data = encode(samples, color, depth, interlace, after=after, seed=interlace)
    _same(data, mode, tmp_path)
    np.testing.assert_array_equal(decode_png(data), samples)  # the file's own samples


@pytest.mark.parametrize("color,depth", [(2, 8), (6, 8), (2, 16), (6, 16), (3, 8), (3, 4)])
def test_colour_read_as_gray_through_gamma(color, depth):
    """A colour file read as gray mixes in linear light where its gamma is
    further than 5 % from 1, as libpng does (``gAMA``, ``sRGB``, the sBIT of
    a 16-bit file), and ignores colour-space chunks after PLTE."""
    samples, after = _form(color, depth, False, h=9, w=33, seed=3)
    gammas = {"srgb": [(b"sRGB", b"\x00")], "g045": [(b"gAMA", struct.pack(">I", 45455))],
              "g220": [(b"gAMA", struct.pack(">I", 220000))],
              "g097": [(b"gAMA", struct.pack(">I", 97000))],
              "srgb_over_gama": [(b"gAMA", struct.pack(">I", 100000)), (b"sRGB", b"\x00")]}
    if depth == 16:
        for bits in (5, 9, 12):
            gammas[f"sbit{bits}"] = [(b"sBIT", bytes([bits] * CHANNELS[color])),
                                     (b"gAMA", struct.pack(">I", 45455))]
    for chunks in gammas.values():
        _same(encode(samples, color, depth, before=chunks, after=after), "gray")
        if color == 3:  # after PLTE the chunks do not count
            _same(encode(samples, color, depth, after=after + chunks), "gray")
        _same(encode(samples, color, depth, before=chunks, after=after), "color")


def test_palette_index_past_the_palette_is_black():
    samples = np.random.default_rng(5).integers(0, 16, (5, 9, 1))
    data = encode(samples, 3, 4, after=[(b"PLTE", bytes(range(40, 55)))])  # 5 entries
    for mode in ("color", "gray"):
        _same(data, mode)


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
def test_supervisely_bitmap(interlace):
    """The bitmaps Supervisely's library writes: 1-bit palette PNGs,
    palette ``[0, 0, 0, 255, 255, 255]`` with black transparent; read as
    gray they give cv2's {0, 255} mask."""
    rng = np.random.default_rng(11)
    bits = (rng.random((7, 13, 1)) > 0.4).astype(np.int64)
    data = encode(bits, 3, 1, interlace,
                  after=[(b"PLTE", bytes([0, 0, 0, 255, 255, 255])), (b"tRNS", b"\x00")])
    got = imdecode(data, "gray")
    np.testing.assert_array_equal(got, bits[..., 0] * 255)
    _same(data, "gray")
    _same(data, "color")


def test_corrupt_forms_raise_where_cv2_fails(tmp_path):
    samples, after = _form(3, 2, False)
    good = encode(samples, 3, 2, after=after)
    no_plte = encode(samples, 3, 2)
    bad_depth = encode(np.zeros((4, 5, 3), np.int64), 2, 4)  # RGB at 4 bits
    path = tmp_path / "g.png"
    path.write_bytes(good)
    assert imread(str(path), "gray").shape == (13, 19)
    for name, data in (("no_plte.png", no_plte), ("bad_depth.png", bad_depth)):
        path = tmp_path / name
        path.write_bytes(data)
        assert cv2.imread(str(path)) is None
        with pytest.raises(FileNotFoundError):
            imread(str(path))
