"""PNG decoding and encoding with zlib and numpy: the port's counterpart of
``cv2.imread`` / ``cv2.imwrite`` for the files of a common-format dataset.

``read_png(path, "color")`` is ``cv2.imread(path, IMREAD_COLOR)`` followed
by ``COLOR_BGR2RGB``: RGB uint8 ``[H, W, 3]``; a gray file repeats its
channel and an alpha channel is dropped.  ``read_png(path, "gray")`` is
``IMREAD_GRAYSCALE`` of a gray file (with or without alpha).

Accepted: colour types 0 (gray), 2 (RGB), 4 (gray + alpha) and 6 (RGBA) at
bit depth 8, without interlace, rows in any of the five filters.  Rows in
filter 0 (None) or 1 (Sub), which is all that ``cv2.imwrite`` writes, are
undone for the whole image at once with numpy; Up is a row add; Average and
Paeth (other writers' choices) are undone pixel by pixel.  Anything else
(16-bit samples, palettes, Adam7 interlace, a colour file read as gray,
whose libpng weights are not ported) raises ``ValueError`` naming it.

``write_png(path, array)`` writes gray ``[H, W]``, RGB ``[H, W, 3]`` or RGBA
``[H, W, 4]`` uint8 rows in filter 0 or 1 (default Sub).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

#: channels per colour type (8-bit samples)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def _chunks(data: bytes, path: str):
    """Yield ``(type, body)`` of each chunk (the body a view into ``data``),
    checking the CRC of critical chunks (upper-case first letter), as libpng
    does."""
    view = memoryview(data)
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        body = view[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if kind[:1].isupper() and zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise ValueError(f"{path}: CRC error in {kind!r} chunk")
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
    _, _, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: colour type {color} "
                         f"({_COLOR_NAMES.get(color, 'unknown')}) is not supported")
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not supported (8 only)")
    if interlace != 0:
        raise ValueError(f"{path}: interlace method {interlace} (Adam7) is not supported")


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode PNG bytes to uint8 ``[H, W, C]`` in the file's own channels
    (C = 1, 3, 2 or 4 for colour types 0, 2, 4, 6)."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    _check_header(header, path)
    w, h, _, color, _, _, _ = header
    c = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat), bufsize=h * (1 + w * c))
    if len(raw) < h * (1 + w * c):
        raise ValueError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, count=h * (1 + w * c)).reshape(h, 1 + w * c)
    return _unfilter(rows, c).reshape(h, w, c)


def read_png(path: str, mode: str = "color") -> np.ndarray:
    """Read a PNG file as ``cv2.imread`` does: ``"color"`` -> RGB uint8
    ``[H, W, 3]`` (the BGR image converted to RGB), ``"gray"`` -> uint8
    ``[H, W]`` of a gray file.  A missing file raises ``FileNotFoundError``;
    an unsupported or corrupt one ``ValueError``."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot read image: {path}")
    with open(path, "rb") as f:
        img = decode_png(f.read(), path)
    c = img.shape[2]
    if mode == "gray":
        if c > 2:
            raise ValueError(f"{path}: a colour file read as gray (libpng's "
                             "rgb-to-gray weights are not ported)")
        return np.ascontiguousarray(img[..., 0])
    if c <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(array: np.ndarray, filter_type: int = 1) -> bytes:
    """PNG bytes of uint8 gray ``[H, W]`` (or ``[H, W, 1]``), RGB
    ``[H, W, 3]`` or RGBA ``[H, W, 4]``, every row in ``filter_type`` 0
    (None) or 1 (Sub), deflated at zlib level 1 (cv2's default)."""
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
    rows = np.ascontiguousarray(a).reshape(h, w * c)
    if filter_type == 1:
        rows = rows.copy()
        rows[:, c:] -= rows[:, :-c].copy()
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = filter_type
    raw[:, 1:] = rows
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + _chunk(b"IEND", b""))


def write_png(path: str, array: np.ndarray, filter_type: int = 1) -> None:
    """Write ``array`` (see ``encode_png``) to ``path`` as ``cv2.imwrite``
    of its BGR counterpart would: the file holds the array's pixels."""
    data = encode_png(array, filter_type)
    with open(path, "wb") as f:
        f.write(data)
