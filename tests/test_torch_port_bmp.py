"""The port's BMP codec (``core/bmp.py`` behind ``core/imread.py``) against
cv2 (the JAX package's reader and writer, CPU): files that
``cv2.imencode(".bmp")`` writes (gray, RGB, RGBA, odd widths) and files
written here field by field (1-, 4- and 8-bit colour tables, 16-bit 5-5-5
and 5-6-5, 24 and 32 bits, ``BI_BITFIELDS``, top-down rows, the OS/2 and
V5 headers) read bit for bit in both modes; ``encode_bmp``'s bytes equal
cv2's; RLE8 and RLE4 files read as cv2 reads them (the decoder's own cases
are in ``tests/test_torch_port_image_forms.py``) and cut files raise where
cv2 returns None.
"""
import struct

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu_torch.core.bmp import decode_bmp, encode_bmp
from instancesegmentation_tpu_torch.core.imread import imread
from instancesegmentation_tpu_torch.core.imwrite import imencode, imwrite

torch.set_num_threads(1)


def make_bmp(pixels, bpp, palette=None, top_down=False, compression=0, masks=None,
             header=40, clrused=None):
    """A BMP of ``pixels``: colour-table indices ``[H, W]`` (bpp <= 8), 16-bit
    words ``[H, W]`` or bytes ``[H, W, C]`` in file order (24 and 32)."""
    h, w = pixels.shape[:2]
    if bpp <= 8:
        per = 8 // bpp
        idx = np.zeros((h, -(-w // per) * per), np.int64)
        idx[:, :w] = pixels
        idx = idx.reshape(h, -1, per)
        raw = (idx << (8 - bpp * (np.arange(per) + 1))).sum(axis=2).astype(np.uint8)
    elif bpp == 16:
        raw = pixels.astype("<u2").view(np.uint8).reshape(h, 2 * w)
    else:
        raw = pixels.reshape(h, -1).astype(np.uint8)
    rows = np.zeros((h, (raw.shape[1] + 3) & -4), np.uint8)
    rows[:, :raw.shape[1]] = raw
    if not top_down:
        rows = rows[::-1]
    table = b""
    if palette is not None:
        entries = np.zeros((len(palette), 3 if header == 12 else 4), np.uint8)
        entries[:, :3] = palette
        table = entries.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        n = (len(palette) if clrused is None else clrused) if palette is not None else 0
        info = struct.pack("<IiiHHIIIIII", header, w, -h if top_down else h, 1, bpp,
                           compression, 0, 2835, 2835, n, 0)
        info += bytes(header - 40)
        if masks is not None and header >= 52:
            info = info[:40] + struct.pack("<III", *masks) + info[52:]
    extra = struct.pack("<III", *masks) if masks is not None and header == 40 else b""
    body = info + extra + table
    return (b"BM" + struct.pack("<IHHI", 14 + len(body) + rows.size, 0, 0, 14 + len(body))
            + body + rows.tobytes())


def _same(data, tmp_path=None):
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        assert want is not None
        want = want[..., ::-1] if want.ndim == 3 else want
        got = decode_bmp(data, mode)
        assert got.dtype == np.uint8 and got.shape == want.shape, mode
        np.testing.assert_array_equal(got, want, err_msg=mode)
        if tmp_path is not None:
            path = tmp_path / "f.bmp"
            path.write_bytes(data)
            np.testing.assert_array_equal(imread(str(path), mode), want)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("width", [1, 5, 13, 16])
def test_cv2_files_read_and_written_equal(channels, width, tmp_path):
    rng = np.random.default_rng(width * channels)
    shape = (7, width) if channels == 1 else (7, width, channels)
    rgb = rng.integers(0, 256, shape, dtype=np.uint8)
    bgr = rgb if channels == 1 else rgb[..., [2, 1, 0, 3][:channels]]
    ok, data = cv2.imencode(".bmp", bgr)
    assert ok
    assert encode_bmp(rgb) == data.tobytes() == imencode(".BMP", rgb)
    imwrite(str(tmp_path / "w.bmp"), rgb)
    assert (tmp_path / "w.bmp").read_bytes() == data.tobytes()
    _same(data.tobytes(), tmp_path)


@pytest.mark.parametrize("bpp", [1, 4, 8])
@pytest.mark.parametrize("width", [5, 13, 16])
def test_colour_tables(bpp, width):
    rng = np.random.default_rng(bpp + width)
    n = 1 << bpp
    palette = rng.integers(0, 256, (n, 3))
    idx = rng.integers(0, n, (7, width))
    gray_table = np.repeat(np.arange(0, 256, 256 // n)[:, None], 3, axis=1)
    for data in (make_bmp(idx, bpp, palette), make_bmp(idx, bpp, palette, top_down=True),
                 make_bmp(idx, bpp, gray_table),
                 make_bmp(idx, bpp, palette[:n // 2 + 1], clrused=n // 2 + 1),  # black past it
                 make_bmp(idx, bpp, palette, header=12)):
        _same(data)


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("width", [1, 6, 13])
def test_16_24_32_bit_forms(top_down, width):
    rng = np.random.default_rng(width + 100 * top_down)
    px3 = rng.integers(0, 256, (7, width, 3))
    px4 = rng.integers(0, 256, (7, width, 4))
    words = rng.integers(0, 1 << 16, (7, width))
    rgb_masks = (0xFF0000, 0xFF00, 0xFF)
    cases = [
        make_bmp(px3, 24, top_down=top_down),
        make_bmp(px3, 24, top_down=top_down, header=124),
        make_bmp(px4, 32, top_down=top_down),
        make_bmp(px4, 32, top_down=top_down, compression=3, masks=rgb_masks),
        make_bmp(px4, 32, top_down=top_down, compression=3, masks=(0xFF, 0xFF00, 0xFF0000)),
        # a header with an alpha mask: cv2 reads BGRA and converts in float32
        make_bmp(px4, 32, top_down=top_down, compression=3, masks=rgb_masks, header=56),
        make_bmp(px4, 32, top_down=top_down, compression=3, masks=rgb_masks, header=124),
        make_bmp(words, 16, top_down=top_down),
        make_bmp(words, 16, top_down=top_down, compression=3, masks=(0x7C00, 0x3E0, 0x1F)),
        make_bmp(words, 16, top_down=top_down, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
    ]
    if not top_down:
        cases.append(make_bmp(px3, 24, header=12))
    for data in cases:
        _same(data)


def _rle8(idx):
    """BI_RLE8 data of index rows ``[H, W]`` (bottom-up): one run per pixel."""
    out = b""
    for row in idx[::-1]:
        out += b"".join(bytes([1, int(v)]) for v in row) + b"\x00\x00"
    return out + b"\x00\x01"


def test_rle_raises_and_cut_files_fail_as_in_cv2(tmp_path):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 16, (4, 6))
    palette = rng.integers(0, 256, (16, 3))
    for bpp, compression in ((8, 1), (4, 2)):
        plain = make_bmp(idx, bpp, palette[:1 << bpp], compression=compression)
        head = plain[:struct.unpack_from("<I", plain, 10)[0]]
        if bpp == 8:
            data = _rle8(idx)
        else:  # BI_RLE4: one run of two pixels per byte pair
            data = b"".join(b"".join(bytes([2, int(a) << 4 | int(b)])
                                     for a, b in zip(row[::2], row[1::2])) + b"\x00\x00"
                            for row in idx[::-1]) + b"\x00\x01"
        rle = bytearray(head + data)
        rle[2:6] = struct.pack("<I", len(rle))
        path = tmp_path / f"rle{bpp}.bmp"
        path.write_bytes(bytes(rle))
        assert cv2.imread(str(path)) is not None
        _same(bytes(rle), tmp_path)  # decoded since the RLE decoder landed
    ok, data = cv2.imencode(".bmp", rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))
    data = data.tobytes()
    for cut in (10, 30, 54, len(data) - 1):
        path = tmp_path / f"cut{cut}.bmp"
        path.write_bytes(data[:cut])
        assert cv2.imread(str(path)) is None
        with pytest.raises(FileNotFoundError):
            imread(str(path))
    assert imencode(".jp2", np.zeros((2, 2), np.uint8)) is None  # OpenJPEG: sides of 32+
    with pytest.raises(ValueError, match="extension"):  # cv2 writes no .xyz
        imencode(".xyz", np.zeros((2, 2), np.uint8))
