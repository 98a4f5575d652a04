"""Sun raster decoding with numpy: ``cv2.imread``'s ``grfmt_sunras`` as
this container's cv2 5.0 runs it.

``decode_sunras(data, mode)`` gives RGB uint8 ``[H, W, 3]`` (``"color"``)
or ``[H, W]`` (``"gray"``).  The 32-byte big-endian header; rows padded to
16 bits:

- types 0 (old) and 1 (standard) only: cv2's header check compares the
  wrong field for types 2 (byte-encoded, RLE) and 3 (RGB format), so it
  refuses those files, and so does the port;
- 1 and 8 bits through a colour map of ``RMT_EQUAL_RGB`` (``maplength``
  bytes, at most ``3 * 2^bits``: all the reds, then the greens, then the
  blues; entries past it black) or, without one, black and white (1 bit)
  or gray ``i`` (8 bits) in colour mode; in gray mode cv2 converts only a
  colour map (fixed-point weights) and reads a file without one as 0;
- 24 bits as B, G, R and 32 bits as X, B, G, R (no colour map), gray by
  cv2's fixed-point weights.

A file cv2 refuses (another type, depth or map, data cut short) raises
``ValueError``; a size cv2 raises on raises ``ImageSizeError``.

``encode_sunras(pixels)`` writes what ``cv2.imencode(".ras")`` writes:
``RT_STANDARD`` without a colour map, gray at depth 8 and colour at depth
24 (B, G, R), the header's length the data's size.  cv2 writes each row
padded to 16 bits by taking one byte past it from its buffer: the next
row's first byte, and after the last row a byte past the image, which the
port writes as 0 (cv2's is whatever its memory holds there).
"""
from __future__ import annotations

import struct

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import _bgr_to_gray
from instancesegmentation_tpu_torch.core.pnm import check_size

SIGNATURE = b"\x59\xa6\x6a\x95"
_RMT_NONE, _RMT_EQUAL_RGB = 0, 1


def decode_sunras(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """Sun raster bytes -> RGB ``[H, W, 3]`` (``"color"``) or ``[H, W]``
    (``"gray"``) uint8, as ``cv2.imread``."""
    if len(data) < 32:
        raise ValueError(f"{path}: Sun raster header cut short")
    width, height, bpp, _, kind, maptype, maplength = struct.unpack_from(">iiiiiii", data, 4)
    pal_size = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    ok = (width > 0 and height > 0 and bpp in (1, 8, 24, 32) and kind in (0, 1)
          and ((maptype == _RMT_NONE and maplength == 0)
               or (maptype == _RMT_EQUAL_RGB and 0 < maplength <= pal_size and bpp <= 8)))
    if not ok:
        raise ValueError(f"{path}: not a Sun raster form cv2 reads")
    if len(data) < 32 + maplength:
        raise ValueError(f"{path}: Sun raster colour map cut short")
    check_size(width, height, path)
    rgb_palette = np.zeros((256, 3), np.uint8)
    gray_palette = np.zeros(256, np.uint8)
    if maplength:
        n = maplength // 3
        planes = np.frombuffer(data, np.uint8, count=3 * n, offset=32).reshape(3, n)
        rgb_palette[:n] = planes.T
        gray_palette = _bgr_to_gray(rgb_palette[:, ::-1])
    elif bpp == 1:
        rgb_palette[1] = 255
    else:
        rgb_palette[:] = np.arange(256, dtype=np.uint8)[:, None]
    pitch = ((width * bpp + 7) // 8 + 1) & -2
    offset = 32 + maplength
    if len(data) < offset + pitch * height:
        raise ValueError(f"{path}: Sun raster data cut short")
    rows = np.frombuffer(data, np.uint8, count=pitch * height, offset=offset).reshape(height, pitch)
    if bpp <= 8:
        index = np.unpackbits(rows, axis=1)[:, :width] if bpp == 1 else rows[:, :width]
        return gray_palette[index] if mode == "gray" else rgb_palette[index]
    c = bpp // 8
    bgr = rows[:, :c * width].reshape(height, width, c)[..., c - 3:]
    if mode == "gray":
        return _bgr_to_gray(bgr)
    return np.ascontiguousarray(bgr[..., ::-1])


def encode_sunras(pixels: np.ndarray) -> bytes:
    """Sun raster bytes of uint8 ``[H, W, C]`` (C 1: gray, 3: RGB)."""
    h, w, c = pixels.shape
    body = pixels if c == 1 else pixels[..., ::-1]
    step = (w * c + 1) & -2
    flat = np.concatenate([np.ascontiguousarray(body).ravel(), np.zeros(1, np.uint8)])
    rows = flat[np.arange(h)[:, None] * (w * c) + np.arange(step)[None, :]]
    header = SIGNATURE + struct.pack(">iiiiiii", w, h, 8 * c, step * h, 1, _RMT_NONE, 0)
    return header + rows.tobytes()
