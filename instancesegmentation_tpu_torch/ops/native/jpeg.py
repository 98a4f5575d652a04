"""The port's JPEG decoder (``jpeg.cpp``) and encoder (``jpeg_enc.cpp``),
bound with ctypes.

``decode_jpeg(data, mode)`` gives what ``cv2.imread`` gives for a JPEG
file, bit for bit, as the port's readers want it: ``"color"`` RGB uint8
``[H, W, 3]``, ``"gray"`` uint8 ``[H, W]`` (the Y plane), with the first
APP1 segment's EXIF orientation applied (``core/exif.py``).  The library is
built with g++ on first use (``build.py``); there is no other path, so
without a compiler the call raises ``RuntimeError`` with the reason.

A file that cv2 cannot decode (headers cut or corrupt, no image) raises
``ValueError``; a valid form the decoder does not take raises
``core.png.UnsupportedImage``, a ``ValueError`` too.

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
from instancesegmentation_tpu_torch.core.png import UnsupportedImage
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
        lib.jpeg_header.argtypes = [ctypes.c_char_p, i64, i64p, ctypes.c_char_p, i64]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, u8p, i64,
                                    ctypes.c_char_p, i64]
        _lib = lib
    return _lib


def _raise(rc: int, msg: ctypes.Array, path: str) -> None:
    text = f"{path}: {msg.value.decode(errors='replace')}"
    if rc == 2:
        raise UnsupportedImage(text)
    raise ValueError(text)


def decode_jpeg(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> RGB ``[H, W, 3]`` (``"color"``) or ``[H, W]``
    (``"gray"``) uint8, oriented by its EXIF tag, as ``cv2.imread``."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    lib = load_jpeg()
    data = bytes(data)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    info = np.zeros(6, np.int64)
    rc = lib.jpeg_header(data, len(data), info, msg, _MSG_LEN)
    if rc:
        _raise(rc, msg, path)
    h, w, _, _, exif_off, exif_len = (int(v) for v in info)
    out = np.empty((h, w) if mode == "gray" else (h, w, 3), np.uint8)
    rc = lib.jpeg_decode(data, len(data), int(mode == "gray"), out, out.size, msg, _MSG_LEN)
    if rc:
        _raise(rc, msg, path)
    tiff = data[exif_off:exif_off + exif_len] if exif_off >= 0 else None
    return apply_orientation(out, exif_orientation(tiff))


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
