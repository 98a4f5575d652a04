"""BMP decoding and encoding with numpy: ``cv2.imread`` / ``cv2.imencode``'s
BMP codec (OpenCV's ``grfmt_bmp.cpp``).

``decode_bmp(data, mode)`` gives what ``cv2.imread`` gives for a BMP file,
converted as the port's readers want it: ``"color"`` RGB uint8
``[H, W, 3]``, ``"gray"`` uint8 ``[H, W]``.  Headers of 40 bytes or more
(``BITMAPINFOHEADER`` and its successors) and the 12-byte OS/2 core header;
bottom-up or top-down (negative height) rows padded to 4 bytes:

- 1, 4 and 8 bits through the colour table (entries past it are black);
- 16 bits as 5-5-5 (``BI_RGB``, or ``BI_BITFIELDS`` with those masks) or
  5-6-5 (``BI_BITFIELDS``), each field shifted up without replication;
- 24 bits BGR, 32 bits BGRX / BGRA (``BI_RGB`` or ``BI_BITFIELDS``, whose
  masks cv2 does not read), alpha dropped.

Gray is cv2's ``icvCvt_BGR2Gray_8u``: ``(1868 B + 9617 G + 4899 R + 8192)
>> 14`` of the colour pixel, except for a 32-bit ``BI_BITFIELDS`` file
whose header holds an alpha mask (56 bytes or more, as cv2 writes RGBA):
cv2 reads that one as BGRA and takes ``0.299 R + 0.587 G + 0.114 B`` in
float32, truncated.  RLE8 and RLE4 files (``BI_RLE8`` at 8 bits,
``BI_RLE4`` at 4) decode as cv2's decoder runs their codes
(``ops/native/image_codes.cpp``): the gaps that end of line, end of bitmap
and delta leave take index 0 in reading order, and a run past its row
refuses the file; cv2 reads an RLE4 end of bitmap as an end of line and an
RLE4 delta as dx pixels (dy unused), and so does the port.  A file cv2
refuses (other header sizes, bit depths or masks, data cut short) raises
plain ``ValueError``.

``encode_bmp(image)`` is ``cv2.imencode(".bmp", ...)`` byte for byte:
bottom-up rows, 24 bits for RGB ``[H, W, 3]`` (stored BGR) and 8 bits with
a gray colour table for ``[H, W]`` under a 40-byte header, 32 bits BGRA for
RGBA ``[H, W, 4]`` under a 124-byte one with its bit fields.
"""
from __future__ import annotations

import struct

import numpy as np

from instancesegmentation_tpu_torch.ops.native.image_codes import bmp_rle


SIGNATURE = b"BM"
_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
#: cv2's fixed-point BGR -> gray weights (imgcodecs utils.cpp, SCALE 14)
_CR = int(0.299 * (1 << 14) + 0.5)
_CG = int(0.587 * (1 << 14) + 0.5)
_CB = (1 << 14) - _CR - _CG


def _bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """cv2's ``icvCvt_BGR2Gray_8u_C3C1R`` of uint8 ``[..., 3]`` BGR."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * _CB + g * _CG + r * _CR + (1 << 13)) >> 14).astype(np.uint8)


def cvtcolor_gray(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(..., COLOR_BGR2GRAY)`` (and ``BGRA2GRAY``) of uint8
    ``[..., 3]`` BGR: 15-bit fixed point, unlike the codecs' own
    ``_bgr_to_gray``; the decoders that convert through ``cvtColor`` (GIF,
    HDR) use it."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def _header(data: bytes, path: str) -> tuple:
    """(offset, width, height, bpp, BGR colour table [256, 3], whether cv2
    reads the pixels as BGRA, compression)."""
    if len(data) < 18:
        raise ValueError(f"{path}: BMP header cut short")
    offset, size = struct.unpack_from("<iI", data, 10)
    palette = np.zeros((256, 3), np.uint8)
    bgra = False
    if size >= 36:
        if len(data) < 14 + size:
            raise ValueError(f"{path}: BMP header cut short")
        width, height, bpp, compression, clrused = struct.unpack_from("<iiIIxxxxxxxxxxxxI",
                                                                      data, 18)
        bpp >>= 16
        if compression > _BI_BITFIELDS:
            raise ValueError(f"{path}: BMP compression {compression}")
        ok = ((bpp in (1, 4, 8, 16, 24, 32) and compression == _BI_RGB)
              or (bpp in (16, 32) and compression == _BI_BITFIELDS)
              or (bpp == 4 and compression == _BI_RLE4)
              or (bpp == 8 and compression == _BI_RLE8))
        pos = 14 + size
        if ok and bpp <= 8:
            if clrused > 256:
                raise ValueError(f"{path}: BMP colour table of {clrused} entries")
            n = clrused or 1 << bpp
            table = np.frombuffer(data[pos:pos + 4 * n], np.uint8)
            if len(table) < 4 * n:
                raise ValueError(f"{path}: BMP colour table cut short")
            palette[:n] = table.reshape(n, 4)[:, :3]
        elif ok and bpp == 16 and compression == _BI_BITFIELDS:
            if len(data) < pos + 12:
                raise ValueError(f"{path}: BMP bit fields cut short")
            masks = struct.unpack_from("<III", data, pos)
            if masks == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif masks != (0xF800, 0x7E0, 0x1F):
                ok = False
        elif ok and bpp == 16:
            bpp = 15
        bgra = bpp == 32 and compression == _BI_BITFIELDS and size >= 56
    elif size == 12:
        width, height, bpp = struct.unpack_from("<HHxxH", data, 18)
        compression = _BI_RGB
        ok = bpp in (1, 4, 8, 24, 32)
        if ok and bpp <= 8:
            n = 1 << bpp
            table = np.frombuffer(data[26:26 + 3 * n], np.uint8)
            if len(table) < 3 * n:
                raise ValueError(f"{path}: BMP colour table cut short")
            palette[:n] = table.reshape(n, 3)
    else:
        ok = False
    if not ok or width <= 0 or height == 0:
        raise ValueError(f"{path}: not a BMP form cv2 reads")
    return offset, width, height, bpp, palette, bgra, compression


def decode_bmp(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """BMP bytes -> RGB ``[H, W, 3]`` (``"color"``) or ``[H, W]``
    (``"gray"``) uint8, as ``cv2.imread``."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    offset, width, height, bpp, palette, bgra, compression = _header(data, path)
    h = abs(height)
    if compression in (_BI_RLE4, _BI_RLE8):
        if offset < 0:
            raise ValueError(f"{path}: BMP pixel data offset {offset}")
        index = bmp_rle(data, offset, h, width, bpp, path)
        index = index[::-1] if height > 0 else index
        return _bgr_to_gray(palette)[index] if mode == "gray" else palette[index][..., ::-1]
    pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    if offset < 0 or offset + pitch * h > len(data):
        raise ValueError(f"{path}: BMP pixel data cut short")
    rows = np.frombuffer(data, np.uint8, count=pitch * h, offset=offset).reshape(h, pitch)
    if height > 0:
        rows = rows[::-1]
    if bpp <= 8:
        index = np.unpackbits(rows, axis=1) if bpp < 8 else rows
        if bpp == 4:
            index = index.reshape(h, -1, 4) @ np.array([8, 4, 2, 1], np.uint8)
        bgr = palette[index[:, :width]]
    elif bpp in (15, 16):
        t = rows[:, :2 * width].copy().view("<u2").astype(np.int32)
        if bpp == 15:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8], axis=-1)
        else:
            bgr = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8], axis=-1)
        bgr = bgr.astype(np.uint8)
    else:
        c = bpp // 8
        bgr = rows[:, :c * width].reshape(h, width, c)[..., :3]
    if mode == "gray" and bgra:
        b, g, r = (bgr[..., i].astype(np.float32) for i in range(3))
        mixed = r * np.float32(0.299) + g * np.float32(0.587) + b * np.float32(0.114)
        return mixed.astype(np.uint8)
    if mode == "gray":
        return _bgr_to_gray(bgr)
    return np.ascontiguousarray(bgr[..., ::-1])


def encode_bmp(image: np.ndarray) -> bytes:
    """``cv2.imencode(".bmp", ...)``'s bytes for uint8 gray ``[H, W]``
    (or ``[H, W, 1]``), RGB ``[H, W, 3]`` or RGBA ``[H, W, 4]``."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_bmp takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in (1, 3, 4):
        raise ValueError(f"encode_bmp takes [H, W], [H, W, 3] or [H, W, 4], got {a.shape}")
    h, w, c = a.shape
    pixels = a if c == 1 else a[..., [2, 1, 0, 3][:c]]
    step = (w * c + 3) & -4
    rows = np.zeros((h, step), np.uint8)
    rows[:, :w * c] = pixels[::-1].reshape(h, w * c)
    if c == 4:  # a BITMAPV5HEADER with the alpha mask, as cv2 writes it
        info = (struct.pack("<IiiHHIIIIII", 124, w, h, 1, 32, _BI_BITFIELDS, 0, 0, 0, 0, 0)
                + struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000) + b"BGRs")
        info += bytes(124 - len(info))
    else:
        info = struct.pack("<IiiHHIIIIII", 40, w, h, 1, 8 * c, _BI_RGB, 0, 0, 0, 0, 0)
    if c == 1:
        gray = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, axis=1)
        gray[:, 3] = 0
        info += gray.tobytes()
    header_size = 14 + len(info)
    return (SIGNATURE + struct.pack("<III", header_size + step * h, 0, header_size) + info
            + rows.tobytes())
