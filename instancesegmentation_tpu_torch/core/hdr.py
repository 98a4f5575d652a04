"""Radiance HDR decoding: ``cv2.imread``'s ``grfmt_hdr`` / ``rgbe.cpp`` as
this container's cv2 5.0 runs them.

``decode_hdr(data, mode)`` gives RGB uint8 ``[H, W, 3]`` (``"color"``) or
``[H, W]`` (``"gray"``, ``cvtColor``'s fixed-point weights of the 8-bit
colour pixels):

- the header is read in ``fgets`` lines of at most 127 bytes: the first
  line is skipped, then lines up to an empty one, among which one must be
  exactly ``FORMAT=32-bit_rle_rgbe``; the next line is scanned as
  ``-Y %d +X %d`` (C's ``sscanf``: any other orientation refuses the file);
- scanlines RLE-encoded or flat as ``rgbe.cpp`` reads them
  (``ops/native/image_codes.cpp``);
- each channel is ``byte * 2^(e - 136)`` in float32 (no half-step offset;
  0 where ``e`` is 0), times 255 in float32, rounded half to even and
  saturated as cv2's ``convertTo`` (beyond int32: 0).

A file cv2 refuses (a header it cannot read, data cut short or malformed)
raises ``ValueError``; a size cv2 raises on raises ``ImageSizeError``.

``encode_hdr(pixels)`` writes what ``cv2.imencode(".hdr")`` writes: the
header ``#?RADIANCE``, ``FORMAT=32-bit_rle_rgbe``, an empty line and
``-Y H +X W``; each value ``v`` as the float32 ``v * float32(1 / 255)``
(gray replicated to three channels) turned into RGBE by ``rgbe.cpp``'s
``float2rgbe`` (``frexp`` of the largest channel in double, the factor
``m * 256 / max`` rounded to float32, each channel times it truncated;
all zero below 1e-32); scanlines run-length coded for widths 8-32767
(``ops/native/image_codes.cpp``) and flat otherwise.
"""
from __future__ import annotations

import re

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import cvtcolor_gray
from instancesegmentation_tpu_torch.core.pnm import check_size
from instancesegmentation_tpu_torch.ops.native.image_codes import hdr_pixels, hdr_rle_encode

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
_FGETS = 127
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
#: sscanf("-Y %d +X %d"): a space in the format takes any whitespace
_SIZE = re.compile(rb"-Y[ \t\n\v\f\r]*[ \t\n\v\f\r]*([+-]?\d+)[ \t\n\v\f\r]*\+X"
                   rb"[ \t\n\v\f\r]*([+-]?\d+)")


def _fgets(data: bytes, pos: int) -> tuple:
    """C's ``fgets`` into 128 bytes: (line, position after it), or (None,
    pos) at the end of the data."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + _FGETS)
    end = min(pos + _FGETS, len(data)) if end < 0 else end + 1
    return data[pos:end], end


def _header(data: bytes, path: str) -> tuple:
    """(width, height, offset of the pixel data)."""
    line, pos = _fgets(data, 0)
    has_format = False
    while True:
        line, pos = _fgets(data, pos)
        if line is None:
            raise ValueError(f"{path}: HDR header cut short")
        if line[:1] == b"\n":
            break
        has_format |= line == _FORMAT
    if not has_format:
        raise ValueError(f"{path}: HDR header without FORMAT=32-bit_rle_rgbe")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line or b"")
    if m is None:
        raise ValueError(f"{path}: HDR size line {line!r} is not '-Y H +X W'")
    height, width = int(m.group(1)), int(m.group(2))
    if width <= 0 or height <= 0:
        raise ValueError(f"{path}: HDR size {width} x {height}")
    return width, height, pos


_LUT = None


def _lut() -> np.ndarray:
    """uint8 ``[256 exponents, 256 bytes]``: each channel's value depends on
    its byte and the pixel's exponent alone."""
    global _LUT
    if _LUT is None:
        e = np.arange(256, dtype=np.int32)[:, None]
        f = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0).astype(np.float32)
        with np.errstate(over="ignore", invalid="ignore"):
            v = np.arange(256, dtype=np.float32)[None, :] * f * np.float32(255.0)
            r = np.rint(v)
            ok = np.abs(r) < 2.0 ** 31
            _LUT = np.where(ok, np.clip(np.where(ok, r, 0), 0, 255), 0).astype(np.uint8)
    return _LUT


def rgbe_to_uint8(rgbe: np.ndarray) -> np.ndarray:
    """RGBE bytes ``[..., 4]`` -> RGB uint8 as cv2 reads them."""
    return _lut()[rgbe[..., 3:4], rgbe[..., :3]]


def decode_hdr(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """Radiance HDR bytes -> RGB ``[H, W, 3]`` (``"color"``) or ``[H, W]``
    (``"gray"``) uint8, as ``cv2.imread``."""
    width, height, pos = _header(data, path)
    check_size(width, height, path)
    rgb = rgbe_to_uint8(hdr_pixels(data, pos, height, width, path))
    if mode == "gray":
        return cvtcolor_gray(rgb[..., ::-1])
    return rgb


def float2rgbe(rgb: np.ndarray) -> np.ndarray:
    """float32 RGB ``[..., 3]`` -> RGBE bytes ``[..., 4]`` as ``rgbe.cpp``'s
    ``float2rgbe`` computes them."""
    top = rgb.max(axis=-1).astype(np.float64)
    mantissa, exponent = np.frexp(top)
    small = top < 1e-32
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(small, 0, mantissa * 256.0 / top).astype(np.float32)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.floor(rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(small, 0, exponent + 128).astype(np.uint8)
    return out


def encode_hdr(pixels: np.ndarray) -> bytes:
    """Radiance HDR bytes of uint8 ``[H, W, C]`` (C 1: gray, 3: RGB)."""
    h, w, c = pixels.shape
    scale = np.float32(1) / np.float32(255)  # cv2's convertTo scale 1 / 255.0f
    rgb = np.broadcast_to(pixels, (h, w, 3)).astype(np.float32) * scale
    rgbe = float2rgbe(rgb)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)
    if 8 <= w <= 0x7FFF:
        return header + hdr_rle_encode(rgbe)
    return header + rgbe.tobytes()
