"""PNG decoding and encoding with zlib and numpy: the port's counterpart of
``cv2.imread`` / ``cv2.imwrite`` for PNG files.

``read_png(path, "color")`` is ``cv2.imread(path, IMREAD_COLOR)`` followed
by ``COLOR_BGR2RGB``: RGB uint8 ``[H, W, 3]``.  ``read_png(path, "gray")``
is ``IMREAD_GRAYSCALE``: uint8 ``[H, W]``.  Every valid PNG is read, with
the transformations that cv2 asks of libpng (``grfmt_png.cpp``):

- colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6
  (RGBA) at every bit depth the format allows (1, 2, 4, 8, 16), with or
  without Adam7 interlace, rows in any of the five filters;
- 16-bit samples keep their high byte (``png_set_strip_16``), gray samples
  of 1, 2 or 4 bits are scaled to 8 (``png_set_expand_gray_1_2_4_to_8``),
  palette indices look up ``PLTE`` (entries past its end are black);
- alpha channels and ``tRNS`` are dropped (``png_set_strip_alpha``);
- a colour file read as gray goes through ``png_set_rgb_to_gray(png, 1,
  0.299, 0.587)``: libpng's fixed-point weights 9797 / 19234 / 3737 over
  2^15, truncated on 8-bit rows and rounded on 16-bit rows before the
  strip; a pixel with R = G = B keeps its value.  Where the file's gamma
  (``gAMA``, or ``sRGB``'s 1/2.2) is further than 5 % from 1, libpng
  mixes in linear light through its gamma tables, and so does the port.

An ``eXIf`` chunk's orientation (before or after IDAT; the first one
counts) turns the image as cv2 does (``core/exif.py``).  Rows in filter 0
(None) or 1 (Sub), which is all that ``cv2.imwrite`` writes, are undone for
the whole image at once with numpy; Up is a row add; Average and Paeth
(other writers' choices) are undone pixel by pixel.  A corrupt file (bad
CRC, no IEND, short data, a header the format does not allow) raises plain
``ValueError``.

``write_png(path, array)`` writes gray ``[H, W]``, RGB ``[H, W, 3]`` or RGBA
``[H, W, 4]`` uint8 rows in filter 0 or 1; in the default (Sub) the file is
``cv2.imwrite``'s, byte for byte.
"""
from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from instancesegmentation_tpu_torch.core.exif import apply_orientation, exif_orientation

SIGNATURE = b"\x89PNG\r\n\x1a\n"

#: samples per pixel, and the bit depths the format allows, per colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
#: colour type written for 1, 3 and 4 channels
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
#: Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
#: libpng's rgb-to-gray weights for cv2's 0.299 / 0.587, in 1/32768
_RC = 29900 * 32768 // 100000
_GC = 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC
_FP_1 = 100000       # libpng's fixed-point 1.0
_SRGB_GAMMA = 45455  # the file gamma an sRGB chunk implies


class UnsupportedImage(ValueError):
    """A valid image file of a form the port does not decode (ROADMAP A10
    part 3), where ``cv2.imread`` would return pixels."""


class ImageSizeError(ValueError):
    """An image file whose header gives a size that ``cv2.imread`` raises
    on (``validateInputImageSize``: a side not positive or above 2^20, more
    than 2^30 pixels), where it neither decodes nor returns None."""


def _chunks(data: bytes, path: str):
    """Yield ``(type, body)`` of each chunk (the body a view into ``data``),
    checking the CRC of critical chunks (upper-case first letter) and of
    ``eXIf``, as libpng does: a critical chunk raises, ``eXIf`` is dropped."""
    view = memoryview(data)
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        body = view[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        checked = kind[:1].isupper() or kind == b"eXIf"
        if checked and zlib.crc32(body, zlib.crc32(kind)) != crc:
            if kind[:1].isupper():
                raise ValueError(f"{path}: CRC error in {kind!r} chunk")
        else:
            yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw [H, 1 + stride]`` (filter byte
    first) -> ``[H, stride]`` uint8."""
    filters = raw[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(filters.max())}")
    h, stride = raw.shape[0], raw.shape[1] - 1
    if (filters == 1).all():  # what cv2 writes: one running sum per row
        if bpp > 1:
            rows = raw[:, 1:].reshape(h, stride // bpp, bpp)
            return np.cumsum(rows, axis=1, dtype=np.uint8).reshape(h, stride)
        # one channel: a running sum over the whole image less each row's
        # carry-in (numpy's 1-D accumulate releases the interpreter lock,
        # its accumulate along rows of one channel does not)
        run = np.cumsum(raw[:, 1:].ravel(), dtype=np.uint8).reshape(h, stride)
        run[1:] -= run[:-1, -1:].copy()
        return run
    out = raw[:, 1:].copy()
    # None and Sub rows do not read the row above: undo all of them at once
    # (Sub: a running sum along the row per channel, modulo 256)
    sub = np.flatnonzero(filters == 1)
    if sub.size:
        rows = out[sub].reshape(sub.size, stride // bpp, bpp)
        out[sub] = np.cumsum(rows, axis=1, dtype=np.uint8).reshape(sub.size, stride)
    for y in np.flatnonzero(filters >= 2):
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.uint8)
        f = filters[y]
        if f == 2:  # Up
            out[y] += prev
            continue
        row = out[y].astype(np.int32)
        up = prev.astype(np.int32)
        for x in range(stride):
            left = row[x - bpp] if x >= bpp else 0
            if f == 3:  # Average
                row[x] = (row[x] + ((left + int(up[x])) >> 1)) & 0xFF
            else:       # Paeth
                ul = int(up[x - bpp]) if x >= bpp else 0
                row[x] = (row[x] + _paeth(left, int(up[x]), ul)) & 0xFF
        out[y] = row.astype(np.uint8)
    return out


def _check_header(header: tuple, path: str) -> None:
    w, h, depth, color, compression, filter_method, interlace = header
    if depth not in _DEPTHS.get(color, ()):
        raise ValueError(f"{path}: bit depth {depth} with colour type {color} is not a PNG form")
    if not (0 < w < 2 ** 31 and 0 < h < 2 ** 31):
        raise ValueError(f"{path}: image size {w} x {h}")
    if compression != 0 or filter_method != 0 or interlace > 1:
        raise ValueError(f"{path}: unknown compression, filter or interlace method")


def _unpack(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """Unfiltered rows ``[H, stride]`` -> samples ``[H, W, C]`` (uint8, or
    uint16 at depth 16; sub-byte samples as their values, unscaled)."""
    h = rows.shape[0]
    if depth == 16:
        s = rows[:, :2 * w * c].reshape(h, w * c, 2).astype(np.uint16)
        return ((s[..., 0] << 8) | s[..., 1]).reshape(h, w, c)
    if depth == 8:
        return rows[:, :w * c].reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[..., None]


def _parse(data: bytes, path: str) -> dict:
    """The chunks that decide the pixels: header, samples ``[H, W, C]`` in
    the file's own form, palette, gamma, sBIT and the ``eXIf`` block."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    info = {"header": None, "plte": None, "gamma": None, "srgb": False, "sbit": None,
            "exif": None}
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: IHDR of {len(body)} bytes")
            info["header"] = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE" and info["plte"] is None:
            info["plte"] = bytes(body)
        elif kind == b"eXIf" and info["exif"] is None and bytes(body[:2]) in (b"II", b"MM"):
            info["exif"] = bytes(body)  # libpng drops a block with another byte order mark
        elif info["plte"] is not None or idat:
            pass  # libpng ignores colour-space chunks after PLTE or IDAT
        elif kind == b"gAMA" and info["gamma"] is None and len(body) == 4:
            info["gamma"] = struct.unpack(">I", body)[0]
        elif kind == b"sRGB" and len(body) == 1:
            info["srgb"] = True
        elif kind == b"sBIT" and info["sbit"] is None:
            info["sbit"] = bytes(body)
    header = info["header"]
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    _check_header(header, path)
    w, h, depth, color, _, _, interlace = header
    if color == 3 and not info["plte"]:
        raise ValueError(f"{path}: palette image without PLTE")
    c = _CHANNELS[color]
    bpp = max(1, c * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    shapes = [(-(-(h - y0) // dy), -(-(w - x0) // dx)) for x0, y0, dx, dy in passes]
    sizes = [ph * (1 + (pw * c * depth + 7) // 8) if ph and pw else 0 for ph, pw in shapes]
    try:
        raw = zlib.decompress(b"".join(idat), bufsize=max(1, sum(sizes)))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    if len(raw) < sum(sizes):
        raise ValueError(f"{path}: image data too short")
    raw = np.frombuffer(raw, np.uint8)
    samples = np.empty((h, w, c), np.uint16 if depth == 16 else np.uint8) if interlace else None
    pos = 0
    for (x0, y0, dx, dy), (ph, pw), size in zip(passes, shapes, sizes):
        if size:
            part = _unpack(_unfilter(raw[pos:pos + size].reshape(ph, size // ph), bpp),
                           pw, c, depth)
            if samples is None:  # not interlaced: the one pass is the image
                samples = part
            else:
                samples[y0::dy, x0::dx] = part
            pos += size
    info["samples"] = samples
    return info


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode PNG bytes to their samples ``[H, W, C]`` in the file's own
    form (C = 1, 3, 1, 2 or 4 for colour types 0, 2, 3, 4, 6; uint16 at
    depth 16, else uint8; palette indices and sub-byte values as stored),
    turned by the file's ``eXIf`` orientation."""
    info = _parse(data, path)
    return apply_orientation(info["samples"], exif_orientation(info["exif"]))


def _to_8bit(v: np.ndarray, depth: int) -> np.ndarray:
    """Gray samples as libpng hands them to cv2: 16 bits stripped to the
    high byte, 1, 2 and 4 bits scaled to 8."""
    if depth == 16:
        return (v >> 8).astype(np.uint8)
    return v * np.uint8(255 // ((1 << depth) - 1))


def _reciprocal(a: int) -> int:
    return math.floor(1e10 / a + 0.5)


def _significant(g: int) -> bool:
    return g < _FP_1 - 5000 or g > _FP_1 + 5000


def _gamma8(gamma: int) -> np.ndarray:
    """libpng's ``png_build_8bit_table``: 8-bit samples through ``gamma``."""
    x = np.arange(256, dtype=np.float64)
    if not _significant(gamma):
        return x.astype(np.int64)
    y = np.floor(255 * np.power(x / 255.0, gamma * 1e-5) + 0.5)
    y[0], y[-1] = 0, 255
    return y.astype(np.int64)


def _gamma16(n_bits: int, gamma: int) -> np.ndarray:
    """libpng's ``png_build_16bit_table``, flattened: the top ``n_bits`` of
    a 16-bit sample -> a 16-bit sample through ``gamma``."""
    top = (1 << n_bits) - 1
    x = np.arange(top + 1, dtype=np.int64)
    if _significant(gamma):
        return np.floor(65535.0 * np.power(x * (1.0 / top), gamma * 1e-5) + 0.5).astype(np.int64)
    return x if n_bits == 16 else (x * 65535 + (1 << (n_bits - 1))) // top


def _gamma_16to8(n_bits: int) -> np.ndarray:
    """libpng's ``png_build_16to8_table`` at a file gamma times screen gamma
    of 1: each top-``n_bits`` input to the 16-bit form of its 8-bit value."""
    count = 1 << n_bits
    bounds = ((np.arange(255, dtype=np.int64) * 257 + 128) * count + 32768) // 65535 + 1
    out = np.searchsorted(bounds, np.arange(count), side="right") * 257
    return np.minimum(out, 65535)


def _rgb_to_gray(rgb: np.ndarray, depth: int, info: dict) -> np.ndarray:
    """libpng's ``png_do_rgb_to_gray`` with cv2's weights, then the strip to
    8 bits: ``rgb [H, W, 3]`` uint8 (depth <= 8, palette expanded) or
    uint16 -> uint8 ``[H, W]``."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    equal = (r == g) & (r == b)
    file_gamma = _SRGB_GAMMA if info["srgb"] else (info["gamma"] or _FP_1)
    screen = _reciprocal(file_gamma)
    if depth <= 8:
        if not (_significant(file_gamma) or _significant(screen)):
            return np.where(equal, r, (_RC * r + _GC * g + _BC * b) >> 15).astype(np.uint8)
        to_1 = _gamma8(_reciprocal(file_gamma))
        from_1 = _gamma8(_reciprocal(screen))
        table = _gamma8(math.floor(1e15 / file_gamma / screen + 0.5))
        mixed = from_1[(_RC * to_1[r] + _GC * to_1[g] + _BC * to_1[b] + 16384) >> 15]
        return np.where(equal, table[r], mixed).astype(np.uint8)
    if not (_significant(file_gamma) or _significant(screen)):
        return (((_RC * r + _GC * g + _BC * b + 16384) >> 15) >> 8).astype(np.uint8)
    sbit = info["sbit"] or b""
    sig = max(sbit[:3]) if len(sbit) >= 3 else 0
    shift = min(max(16 - sig if 0 < sig < 16 else 0, 16 - 11), 8)
    n_bits = 16 - shift
    to_1 = _gamma16(n_bits, _reciprocal(file_gamma))
    from_1 = _gamma16(n_bits, _reciprocal(screen))
    gray16 = (_RC * to_1[r >> shift] + _GC * to_1[g >> shift] + _BC * to_1[b >> shift]
              + 16384) >> 15
    w = np.where(equal, _gamma_16to8(n_bits)[r >> shift], from_1[gray16 >> shift])
    return (w >> 8).astype(np.uint8)


def png_pixels(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """PNG bytes as ``read_png`` returns the file: oriented, RGB ``[H, W, 3]``
    for ``"color"``, ``[H, W]`` for ``"gray"``."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    info = _parse(data, path)
    _, _, depth, color, _, _, _ = info["header"]
    img = info["samples"]
    if color == 3:
        palette = np.zeros((256, 3), np.uint8)
        plte = np.frombuffer(info["plte"], np.uint8)[:768]
        palette[:len(plte) // 3] = plte[:len(plte) // 3 * 3].reshape(-1, 3)
        img, depth = palette[img[..., 0]], 8
    if img.shape[2] <= 2:  # gray, gray + alpha
        gray = _to_8bit(img[..., 0], depth)
        out = gray if mode == "gray" else np.repeat(gray[..., None], 3, axis=2)
    elif mode == "gray":
        out = _rgb_to_gray(img[..., :3], depth, info)
    else:
        out = img[..., :3] if depth == 8 else (img[..., :3] >> 8).astype(np.uint8)
    return apply_orientation(out, exif_orientation(info["exif"]))


def read_png(path: str, mode: str = "color") -> np.ndarray:
    """Read a PNG file as ``cv2.imread`` does: ``"color"`` -> RGB uint8
    ``[H, W, 3]`` (the BGR image converted to RGB), ``"gray"`` -> uint8
    ``[H, W]`` of a gray file, turned by its ``eXIf`` orientation.  A
    missing file raises ``FileNotFoundError``; an unsupported one
    ``UnsupportedImage``, a corrupt one ``ValueError``."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot read image: {path}")
    with open(path, "rb") as f:
        return png_pixels(f.read(), mode, path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _deflate_window_bits(size: int) -> int:
    """libpng's zlib window for ``size`` bytes of filtered rows: 15 bits,
    halved while the data and zlib's 262-byte lookahead fit in half the
    window (``png_deflate_claim``, data of at most 16 KiB)."""
    bits = 15
    if size <= 16384:
        half = 1 << (bits - 1)
        while size + 262 <= half:
            half >>= 1
            bits -= 1
    return bits


def _optimize_cmf(data: bytes, size: int) -> bytes:
    """libpng's ``optimize_cmf``: the zlib header of ``size`` bytes of rows
    (at most 16 KiB) names the smallest window that holds them."""
    cmf = data[0]
    if size > 16384 or (cmf & 0x0F) != 8 or (cmf & 0xF0) > 0x70:
        return data
    cinfo = cmf >> 4
    half = 1 << (cinfo + 7)
    if size > half:
        return data
    while True:
        half >>= 1
        cinfo -= 1
        if not (cinfo > 0 and size <= half):
            break
    cmf = (cmf & 0x0F) | (cinfo << 4)
    flg = data[1] & 0xE0
    flg += 0x1F - ((cmf << 8) + flg) % 0x1F
    return bytes((cmf, flg)) + data[2:]


def encode_png(array: np.ndarray, filter_type: int = 1) -> bytes:
    """PNG bytes of uint8 gray ``[H, W]`` (or ``[H, W, 1]``), RGB
    ``[H, W, 3]`` or RGBA ``[H, W, 4]``, every row in ``filter_type`` 0
    (None) or 1 (Sub).  With filter 1 (the default) these are the bytes of
    ``cv2.imencode(".png")`` of the BGR(A) counterpart: libpng at cv2's
    level 1 with zlib's ``Z_RLE`` strategy, the window libpng picks for the
    data's size (and names in the zlib header), IDAT chunks of 8 KiB.  The
    bytes equal cv2's where Python's ``zlib`` is the same zlib as the one
    inside cv2 (the deflate stream is zlib's); with another zlib only the
    decoded pixels are the same."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in (1, 3, 4):
        raise ValueError(f"write_png takes [H, W], [H, W, 3] or [H, W, 4], got {a.shape}")
    if filter_type not in (0, 1):
        raise ValueError(f"write_png writes filter 0 or 1, not {filter_type}")
    h, w, c = a.shape
    if w == 1:  # libpng writes a one-pixel row in filter None
        filter_type = 0
    rows = np.ascontiguousarray(a).reshape(h, w * c)
    if filter_type == 1:
        rows = rows.copy()
        rows[:, c:] -= rows[:, :-c].copy()
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = filter_type
    raw[:, 1:] = rows
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    deflate = zlib.compressobj(1, zlib.DEFLATED, _deflate_window_bits(raw.size), 8, zlib.Z_RLE)
    data = _optimize_cmf(deflate.compress(raw.tobytes()) + deflate.flush(), raw.size)
    idat = b"".join(_chunk(b"IDAT", data[i:i + 8192]) for i in range(0, len(data), 8192))
    return SIGNATURE + _chunk(b"IHDR", header) + idat + _chunk(b"IEND", b"")


def write_png(path: str, array: np.ndarray, filter_type: int = 1) -> None:
    """Write ``array`` (see ``encode_png``) to ``path`` as ``cv2.imwrite``
    of its BGR counterpart would: in filter Sub, the same bytes."""
    data = encode_png(array, filter_type)
    with open(path, "wb") as f:
        f.write(data)
