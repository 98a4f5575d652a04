"""The port's JPEG decoder (``jpeg.cpp``), bound with ctypes.

``decode_jpeg(data, mode)`` gives what ``cv2.imread`` gives for a JPEG
file, bit for bit, as the port's readers want it: ``"color"`` RGB uint8
``[H, W, 3]``, ``"gray"`` uint8 ``[H, W]`` (the Y plane), with the first
APP1 segment's EXIF orientation applied (``core/exif.py``).  The library is
built with g++ on first use (``build.py``); there is no other path, so
without a compiler the call raises ``RuntimeError`` with the reason.

A file that cv2 cannot decode (headers cut or corrupt, no image) raises
``ValueError``; a valid form the decoder does not take raises
``core.png.UnsupportedImage``, a ``ValueError`` too.
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
SIGNATURE = b"\xff\xd8\xff"
_MSG_LEN = 256
_lib: Optional[ctypes.CDLL] = None


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
