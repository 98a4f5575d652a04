"""The port's JPEG decoder (``jpeg.cpp``) and encoder (``jpeg_enc.cpp``),
bound with ctypes.

``decode_jpeg(data, mode)`` gives what ``cv2.imread`` gives for a JPEG
file, bit for bit, as the port's readers want it: ``"color"`` RGB uint8
``[H, W, 3]``, ``"gray"`` uint8 ``[H, W]`` (the Y plane), with the first
APP1 segment's EXIF orientation applied (``core/exif.py``).  The library is
built with g++ on first use (``build.py``); there is no other path, so
without a compiler the call raises ``RuntimeError`` with the reason.

Every JPEG form that cv2 decodes is decoded: baseline, extended and
progressive files, arithmetic-coded sequential and progressive files (with
or without DAC conditioning), lossless files of 2 to 8 bits, any whole-number
sampling layout (the luma plane upsampled too), YCbCr, RGB, gray, CMYK and
YCCK (converted as cv2 converts CMYK), restart markers, files cut in their
data (``cv2.imread`` decodes those; ``cv2.imdecode`` returns None for the
bytes, whose memory source suspends where libjpeg's file source inserts an
end marker, and so does ``decode_jpeg(..., imread=False)``).  A file that cv2 cannot decode raises ``ValueError`` (the reader's
``FileNotFoundError``): headers cut or corrupt, no image, and the forms
libjpeg-turbo refuses: hierarchical frames and the JPG marker, lossless
arithmetic coding (SOF11), 12-bit and 9-16-bit samples, 2 or 5 and more
components, sampling ratios that are not whole numbers for a component the
read mode needs (so a gray read can succeed where a colour read fails),
more than 10 blocks in an MCU, sides above 65500, and the colour
conversions lossless mode refuses (a lossless YCbCr or YCCK file, a gray
file read in colour, an RGB file read as gray).  ``jpeg.cpp``'s header
comment says where each rule lives in libjpeg-turbo.

``encode_jpeg(image)`` gives ``cv2.imencode(".jpg", ...)``'s bytes with
cv2's defaults (baseline, quality 95, 4:2:0 for colour), byte for byte, for
RGB ``[H, W, 3]`` (the BGR image cv2 is given, converted) or gray
``[H, W]`` uint8; it is built like the decoder and has no other path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.core.exif import apply_orientation, exif_orientation
from instancesegmentation_tpu_torch.ops.native.build import build_library

SRC = Path(__file__).with_name("jpeg.cpp")
ENC_SRC = Path(__file__).with_name("jpeg_enc.cpp")
SIGNATURE = b"\xff\xd8\xff"
_MSG_LEN = 256
_lib: Optional[ctypes.CDLL] = None
_enc: Optional[ctypes.CDLL] = None


def load_jpeg() -> ctypes.CDLL:
    """The bound decoder, built on first use; raises ``RuntimeError``
    (with the compiler's message) when it cannot be built."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(SRC)))
        i64 = ctypes.c_int64
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.jpeg_header.restype = ctypes.c_int
        lib.jpeg_header.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, i64p, ctypes.c_char_p,
                                    i64]
        lib.jpeg_tiff_decode.restype = ctypes.c_int
        lib.jpeg_tiff_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_char_p, i64, ctypes.c_int,
                                         i64p, ctypes.c_void_p, i64, ctypes.c_char_p, i64]
        lib.jpeg_decode_src.restype = ctypes.c_int
        lib.jpeg_decode_src.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, ctypes.c_int, u8p,
                                        i64, ctypes.c_char_p, i64]
        _lib = lib
    return _lib


def _raise(msg: ctypes.Array, path: str) -> None:
    raise ValueError(f"{path}: {msg.value.decode(errors='replace')}")


def decode_jpeg(data: bytes, mode: str = "color", path: str = "<bytes>",
                imread: bool = True) -> np.ndarray:
    """JPEG bytes -> RGB ``[H, W, 3]`` (``"color"``) or ``[H, W]``
    (``"gray"``) uint8, oriented by its EXIF tag, as ``cv2.imread`` reads
    the file; ``imread=False``: as ``cv2.imdecode`` reads the bytes, which
    raises where the data ends before the decode does (a file cut short)."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    lib = load_jpeg()
    data = bytes(data)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    info = np.zeros(6, np.int64)
    gray = int(mode == "gray")
    rc = lib.jpeg_header(data, len(data), gray, info, msg, _MSG_LEN)
    if rc:
        _raise(msg, path)
    h, w, _, _, exif_off, exif_len = (int(v) for v in info)
    out = np.empty((h, w) if mode == "gray" else (h, w, 3), np.uint8)
    rc = lib.jpeg_decode_src(data, len(data), gray, int(not imread), out, out.size, msg,
                             _MSG_LEN)
    if rc:
        _raise(msg, path)
    tiff = data[exif_off:exif_off + exif_len] if exif_off >= 0 else None
    return apply_orientation(out, exif_orientation(tiff))


def decode_tiff_jpeg(tables: bytes, data: bytes, rgb: bool) -> tuple[np.ndarray, tuple, int]:
    """One JPEG-in-TIFF strip or tile as libtiff's JPEG codec decodes it:
    ``tables`` (the JPEGTables tag, may be empty) read before the stream
    ``data``; ``rgb``: YCbCr converted to RGB (JPEGCOLORMODE_RGB), else
    each component as it is.  Returns uint8 ``[h, w, 3 or components]``,
    the first component's (h, v) sampling factors and the stream's
    components; raises ``ValueError`` where libjpeg fails."""
    lib = load_jpeg()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    info = np.zeros(5, np.int64)
    tables, data = bytes(tables), bytes(data)
    if lib.jpeg_tiff_decode(tables, len(tables), data, len(data), int(rgb), info, None, 0, msg,
                            _MSG_LEN):
        _raise(msg, "JPEG-in-TIFF")
    h, w, nc, hs, vs = (int(v) for v in info)
    out = np.empty((h, w, 3 if rgb else nc), np.uint8)
    if lib.jpeg_tiff_decode(tables, len(tables), data, len(data), int(rgb), info,
                            out.ctypes.data, out.size, msg, _MSG_LEN):
        _raise(msg, "JPEG-in-TIFF")
    return out, (hs, vs), nc


def load_jpeg_encoder() -> ctypes.CDLL:
    """The bound encoder, built on first use; raises ``RuntimeError`` (with
    the compiler's message) when it cannot be built."""
    global _enc
    if _enc is None:
        lib = ctypes.CDLL(str(build_library(ENC_SRC)))
        i64 = ctypes.c_int64
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.jpeg_encode.restype = ctypes.c_int
        lib.jpeg_encode.argtypes = [u8p, i64, i64, ctypes.c_int, u8p, i64,
                                    ctypes.POINTER(i64)]
        _enc = lib
    return _enc


def encode_jpeg(image: np.ndarray) -> bytes:
    """``cv2.imencode(".jpg", ...)``'s bytes (default parameters) for uint8
    RGB ``[H, W, 3]`` or gray ``[H, W]`` (or ``[H, W, 1]``)."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes [H, W] or [H, W, 3], got {a.shape}")
    h, w = a.shape[:2]
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise ValueError(f"a JPEG holds 1 to 65535 rows and columns, not {h} x {w}")
    lib = load_jpeg_encoder()
    pixels = np.ascontiguousarray(a)
    channels = 1 if a.ndim == 2 else 3
    n = ctypes.c_int64(0)
    cap = 1024 + pixels.size
    while True:
        out = np.empty(cap, np.uint8)
        if lib.jpeg_encode(pixels, h, w, channels, out, cap, ctypes.byref(n)) == 0:
            return out[:n.value].tobytes()
        cap = n.value
