"""The port's WebP bit-stream decoders (``webp.cpp``), bound with ctypes:
the lossless VP8L stream, the lossy VP8 key frame (fancy-upsampled to RGB
as libwebp's ``WebPDecodeBGRInto`` gives it) and the ALPH stream of a lossy
image, each bit for bit as cv2's libwebp decodes it.  ``core/webp.py``
reads the container around them.

The library is built with g++ on first use (``build.py``); there is no
other path, so without a compiler a WebP read raises ``RuntimeError`` with
the reason.  A stream that libwebp refuses raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.ops.native.build import build_library

SRC = Path(__file__).with_name("webp.cpp")
ENC_SRC = Path(__file__).with_name("webp_enc.cpp")
_MSG_LEN = 256
_lib: Optional[ctypes.CDLL] = None
_enc: Optional[ctypes.CDLL] = None


def load_webp() -> ctypes.CDLL:
    """The bound decoders, built on first use; raises ``RuntimeError``
    (with the compiler's message) when they cannot be built."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(SRC)))
        i64, c_int = ctypes.c_int64, ctypes.c_int
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.webp_vp8l.argtypes = [ctypes.c_char_p, i64, c_int, c_int, u8p, ctypes.c_char_p, i64]
        lib.webp_vp8.argtypes = [ctypes.c_char_p, i64, ctypes.c_char_p, i64, c_int, c_int, u8p,
                                 ctypes.c_void_p, ctypes.c_char_p, i64]
        lib.webp_vp8l.restype = lib.webp_vp8.restype = c_int
        _lib = lib
    return _lib


def decode_vp8l(data: bytes, width: int, height: int, path: str = "<bytes>") -> np.ndarray:
    """RGB ``[height, width, 3]`` of the VP8L stream at the start of ``data``
    (every byte to the end of the data is the reader's, as in libwebp)."""
    out = np.empty((height, width, 3), np.uint8)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    if load_webp().webp_vp8l(data, len(data), width, height, out, msg, _MSG_LEN):
        raise ValueError(f"{path}: {msg.value.decode(errors='replace')}")
    return out


def decode_vp8(data: bytes, width: int, height: int, alph: Optional[bytes] = None,
               path: str = "<bytes>", with_alpha: bool = False):
    """RGB ``[height, width, 3]`` of the VP8 key frame at the start of
    ``data``; ``alph``: the ALPH chunk's payload, decoded too (a bad one
    fails the read, as in libwebp); ``with_alpha``: also return the alpha
    plane ``[height, width]`` (255 without ``alph``)."""
    out = np.empty((height, width, 3), np.uint8)
    alpha = np.full((height, width), 255, np.uint8)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    if load_webp().webp_vp8(data, len(data), alph, -1 if alph is None else len(alph), width,
                            height, out, alpha.ctypes.data if alph is not None else None, msg,
                            _MSG_LEN):
        raise ValueError(f"{path}: {msg.value.decode(errors='replace')}")
    return (out, alpha) if with_alpha else out


def load_webp_encoder() -> ctypes.CDLL:
    """The bound encoder, built on first use; raises ``RuntimeError`` (with
    the compiler's message) when it cannot be built."""
    global _enc
    if _enc is None:
        lib = ctypes.CDLL(str(build_library(ENC_SRC)))
        lib.webp_vp8l_encode.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)]
        lib.webp_vp8l_encode.restype = ctypes.c_int
        lib.webp_enc_free.argtypes = [ctypes.c_void_p]
        lib.webp_enc_free.restype = None
        _enc = lib
    return _enc


def encode_vp8l(argb: np.ndarray, width: int, height: int, use_alpha: bool) -> bytes:
    """The VP8L stream (its header included) of ``height x width`` pixels
    ``argb`` (uint32 ``0xAARRGGBB``), the header's alpha hint ``use_alpha``;
    RGB under alpha 0 is written as 0.  Sides of 1 to 16,384."""
    argb = np.ascontiguousarray(argb, dtype=np.uint32).reshape(-1)
    if argb.size != width * height:
        raise ValueError(f"encode_vp8l: {argb.size} pixels for {width} x {height}")
    lib = load_webp_encoder()
    out, size = ctypes.c_void_p(), ctypes.c_int64()
    if lib.webp_vp8l_encode(argb, width, height, int(use_alpha), ctypes.byref(out),
                            ctypes.byref(size)):
        raise ValueError(f"encode_vp8l: cannot encode {width} x {height}")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.webp_enc_free(out)
