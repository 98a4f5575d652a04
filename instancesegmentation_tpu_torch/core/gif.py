"""GIF decoding: ``cv2.imread``'s own GIF decoder of cv2 5.0 (not giflib),
first frame only.

``decode_gif(data, mode)`` gives RGB uint8 ``[H, W, 3]`` (``"color"``) or
``[H, W]`` (``"gray"``, through ``cvtColor``'s weights) of the logical screen,
as cv2 draws the first frame on it:

- the whole file must be well formed block by block up to its trailer
  (extensions, image descriptors, sub-blocks; bytes after the trailer are
  not read), with at least one image; the screen and each frame are
  non-empty and each frame lies inside the screen;
- the colour table is the global one (its background index must lie in
  it), a frame's local table overwriting its first entries; a file without
  either reads index ``i`` as gray ``i`` but 1 as white; an index past both
  tables refuses the file;
- the screen starts as the global table's background colour (black without
  a global table); the frame's pixels are drawn on it, except those of the
  transparent index of the graphic control extension before it, which
  keep the background;
- LZW code sizes 2-11 (``ops/native/image_codes.cpp``: clear and end codes,
  widths up to 12 bits, a full table kept until a clear code); the frame's
  rows de-interlaced in GIF's four passes; data that gives more or fewer
  pixels than the frame holds refuses the file.

A file cv2 refuses raises ``ValueError``; a screen cv2 raises on raises
``ImageSizeError``.  One difference from cv2 is known: cv2 goes on
decoding the bytes after a frame's end code within its sub-blocks, into a
table it has freed (what that gives depends on memory); the port reads
nothing after the end code.

``encode_gif(pixels)`` writes what ``cv2.imencode(".gif")`` writes at its
defaults (fast mode): ``GIF89a`` with a global table of 256 entries (8
levels of red and of green in steps of 36, 4 of blue in steps of 85), a
``NETSCAPE2.0`` block looping forever, a graphic control extension with
disposal 3 and a delay of 100, one image of the whole screen, its pixels
quantised into the table with cv2's Floyd-Steinberg diffusion and coded
as LZW at minimum code size 8 (``ops/native/image_codes.cpp``).  cv2's
quantiser refuses a gray image: ``encode_gif`` returns None for it.
"""
from __future__ import annotations

import struct

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import cvtcolor_gray
from instancesegmentation_tpu_torch.core.pnm import check_size
from instancesegmentation_tpu_torch.ops.native.image_codes import (
    gif_dither, gif_lzw, gif_lzw_encode)

SIGNATURES = (b"GIF87a", b"GIF89a")
_EXTENSION, _IMAGE, _TRAILER, _GCE = 0x21, 0x2C, 0x3B, 0xF9


def _default_table() -> np.ndarray:
    table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    table[1] = 255
    return table


def _skip_blocks(data: bytes, pos: int, path: str) -> int:
    """The position after a chain of sub-blocks and its terminator."""
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: GIF sub-blocks cut short")
        size = data[pos]
        pos += 1 + size
        if size == 0:
            return pos


def _frames(data: bytes, pos: int, path: str) -> list:
    """[(image descriptor position, the graphic control extension before
    it or None)] of every frame, after checking the file's blocks up to its
    trailer."""
    frames, gce = [], None
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: GIF without its trailer")
        kind = data[pos]
        if kind == _TRAILER:
            break
        if kind == _EXTENSION:
            if pos + 1 >= len(data):
                raise ValueError(f"{path}: GIF extension cut short")
            if data[pos + 1] == _GCE and pos + 7 <= len(data) and data[pos + 2] >= 4:
                gce = (data[pos + 3], data[pos + 6])
            pos = _skip_blocks(data, pos + 2, path)
        elif kind == _IMAGE:
            if pos + 10 > len(data):
                raise ValueError(f"{path}: GIF image descriptor cut short")
            frames.append((pos, gce))
            gce = None
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = _skip_blocks(data, pos + 1, path)  # the LZW minimum code size, then data
        else:
            raise ValueError(f"{path}: GIF block 0x{kind:02x}")
    if not frames:
        raise ValueError(f"{path}: GIF without an image")
    return frames


def decode_gif(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """GIF bytes -> the first frame on the logical screen, RGB
    ``[H, W, 3]`` (``"color"``) or ``[H, W]`` (``"gray"``) uint8, as
    ``cv2.imread``."""
    if len(data) < 13:
        raise ValueError(f"{path}: GIF header cut short")
    sw, sh, flags, bg = struct.unpack_from("<HHBB", data, 6)
    if sw == 0 or sh == 0:
        raise ValueError(f"{path}: GIF screen {sw} x {sh}")
    pos = 13
    table, size = _default_table(), 256
    canvas_colour = np.zeros(3, np.uint8)
    if flags & 0x80:
        size = 2 << (flags & 7)
        entries = np.frombuffer(data, np.uint8, count=-1, offset=min(pos, len(data)))[:3 * size]
        if len(entries) < 3 * size:
            raise ValueError(f"{path}: GIF colour table cut short")
        table[:size] = entries.reshape(size, 3)
        if bg >= size:
            raise ValueError(f"{path}: GIF background index {bg} past the colour table")
        canvas_colour = table[bg].copy()
        pos += 3 * size
    (at, gce), = _frames(data, pos, path)[:1]
    check_size(sw, sh, path)
    left, top, w, h, fflags = struct.unpack_from("<HHHHB", data, at + 1)
    if w == 0 or h == 0 or left + w > sw or top + h > sh:
        raise ValueError(f"{path}: GIF frame {w} x {h} at ({left}, {top}) outside the screen")
    pos = at + 10
    if fflags & 0x80:
        local = 2 << (fflags & 7)
        table[:local] = np.frombuffer(data, np.uint8, count=3 * local, offset=pos).reshape(local, 3)
        size = max(size, local) if flags & 0x80 else local
        pos += 3 * local
    index = gif_lzw(data, pos + 1, data[pos], h, w, path)
    if fflags & 0x40:  # interlaced: rows 0, 8, ..., then 4, 12, ..., 2, 6, ..., 1, 3, ...
        order = np.concatenate([np.arange(s, h, d) for s, d in ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = np.empty_like(index)
        rows[order] = index
        index = rows
    if int(index.max()) >= size:
        raise ValueError(f"{path}: GIF index past the colour table")
    canvas = np.empty((sh, sw, 3), np.uint8)
    canvas[:] = canvas_colour
    region = canvas[top:top + h, left:left + w]
    if gce is None or not gce[0] & 1:
        region[:] = table[index]
    else:
        drawn = index != gce[1]
        region[drawn] = table[index[drawn]]
    if mode == "gray":
        return cvtcolor_gray(canvas[..., ::-1])
    return canvas


def _encoder_table() -> bytes:
    i = np.arange(256)
    return np.stack([(i >> 5) * 36, (i >> 2 & 7) * 36, (i & 3) * 85], axis=1).astype(
        np.uint8).tobytes()


def encode_gif(pixels: np.ndarray):
    """GIF bytes of uint8 RGB ``[H, W, 3]``; None for gray ``[H, W, 1]``."""
    h, w, c = pixels.shape
    if c != 3:
        return None
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + _encoder_table()
            + b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
            + struct.pack("<BBBBHBB", _EXTENSION, _GCE, 4, 0x0C, 100, 0, 0)
            + struct.pack("<BHHHHB", _IMAGE, 0, 0, w, h, 0x07) + b"\x08"
            + gif_lzw_encode(gif_dither(pixels)) + bytes([_TRAILER]))
