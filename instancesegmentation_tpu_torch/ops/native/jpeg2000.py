"""The port's JPEG 2000 codestream decoder (``jpeg2000.cpp``) and encoder
(``jpeg2000_enc.cpp``), bound with ctypes: the main header, and the whole
codestream to integer component planes as OpenJPEG 2.5.3 (cv2 5.0's) gives
them; uint8 planes to the codestream OpenJPEG 2.5.3 writes for cv2.
``core/jpeg2000.py`` reads and writes the JP2 boxes around them and
converts the planes as cv2 does.

The libraries are built with g++ on first use (``build.py``); there is no
other path, so without a compiler a JPEG 2000 read or write raises
``RuntimeError`` with the reason.  A codestream that OpenJPEG refuses
raises ``ValueError`` with its reason; a form the port does not decode
raises ``UnsupportedImage``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.core.png import UnsupportedImage
from instancesegmentation_tpu_torch.ops.native.build import build_library

SRC = Path(__file__).with_name("jpeg2000.cpp")
ENC_SRC = Path(__file__).with_name("jpeg2000_enc.cpp")
_MSG_LEN = 256
_MAX_COMPS = 16384
#: cv2's default ``IMWRITE_JPEG2000_COMPRESSION_X1000``: OpenJPEG's rate 4
DEFAULT_X1000 = 250
_lib: Optional[ctypes.CDLL] = None
_enc: Optional[ctypes.CDLL] = None


@dataclass(frozen=True)
class Component:
    prec: int
    sgnd: int
    dx: int
    dy: int
    x0: int
    y0: int
    w: int
    h: int


@dataclass(frozen=True)
class Header:
    x0: int
    y0: int
    x1: int
    y1: int
    comps: tuple


def load_jpeg2000() -> ctypes.CDLL:
    """The bound decoder, built on first use; raises ``RuntimeError`` (with
    the compiler's message) when it cannot be built."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(SRC)))
        i64, u32 = ctypes.c_int64, ctypes.c_uint32
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.j2k_header.argtypes = [ctypes.c_char_p, i64, u32, u32, i64p, i64, ctypes.c_char_p,
                                   i64]
        lib.j2k_decode.argtypes = [ctypes.c_char_p, i64, u32, u32, i32p, i64p, i64,
                                   ctypes.c_char_p, i64]
        lib.j2k_header.restype = lib.j2k_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def _raise(code: int, msg, path: str):
    text = f"{path}: JPEG 2000: {msg.value.decode(errors='replace')}"
    if code == 2:
        raise UnsupportedImage(f"{text} (ROADMAP A10 part 3, step 5)")
    raise ValueError(text)


def read_header(codestream: bytes, ihdr_wh=(0, 0), path: str = "<bytes>") -> Header:
    """The main header of ``codestream`` (SOC to the end of the data), as
    OpenJPEG's ``opj_read_header`` reads it; ``ihdr_wh``: a JP2 file's ihdr
    sides, which must equal the SIZ marker's."""
    info = np.zeros(5 + 8 * _MAX_COMPS, np.int64)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    code = load_jpeg2000().j2k_header(codestream, len(codestream), ihdr_wh[0], ihdr_wh[1], info,
                                      info.size, msg, _MSG_LEN)
    if code:
        _raise(code, msg, path)
    x0, y0, x1, y1, n = (int(v) for v in info[:5])
    comps = tuple(Component(*(int(v) for v in info[5 + 8 * i:13 + 8 * i])) for i in range(n))
    return Header(x0, y0, x1, y1, comps)


def decode_codestream(codestream: bytes, header: Header, ihdr_wh=(0, 0),
                      path: str = "<bytes>") -> list:
    """Every component of ``codestream`` decoded, int32 ``[h, w]`` each, as
    OpenJPEG's ``opj_decode`` gives them."""
    sizes = [c.w * c.h for c in header.comps]
    offsets = np.zeros(len(sizes), np.int64)
    if len(sizes) > 1:
        offsets[1:] = np.cumsum(sizes)[:-1]
    out = np.zeros(max(1, sum(sizes)), np.int32)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    code = load_jpeg2000().j2k_decode(codestream, len(codestream), ihdr_wh[0], ihdr_wh[1], out,
                                      offsets, len(sizes), msg, _MSG_LEN)
    if code:
        _raise(code, msg, path)
    return [out[o:o + s].reshape(c.h, c.w) for o, s, c in zip(offsets, sizes, header.comps)]


def load_jpeg2000_encoder() -> ctypes.CDLL:
    """The bound encoder, built on first use; raises ``RuntimeError`` (with
    the compiler's message) when it cannot be built."""
    global _enc
    if _enc is None:
        lib = ctypes.CDLL(str(build_library(ENC_SRC)))
        c_int = ctypes.c_int
        lib.j2k_encode.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), c_int, c_int, c_int, c_int,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)]
        lib.j2k_encode.restype = c_int
        lib.j2k_enc_free.argtypes = [ctypes.c_void_p]
        lib.j2k_enc_free.restype = None
        _enc = lib
    return _enc


def encode_codestream(planes: np.ndarray, before: int,
                      x1000: int = DEFAULT_X1000) -> Optional[bytes]:
    """The codestream (SOC to EOC) OpenJPEG 2.5.3 writes for cv2 from
    ``planes``, uint8 ``[C, H, W]`` (C 1 to 4) in the file's component
    order, at ``IMWRITE_JPEG2000_COMPRESSION_X1000`` = ``x1000``; ``before``:
    the bytes of the file ahead of the codestream (OpenJPEG takes them from
    the rate's byte budget).  None where OpenJPEG refuses the image (a side
    under 32, too small for its 6 resolutions)."""
    planes = np.ascontiguousarray(planes, dtype=np.uint8)
    c, h, w = planes.shape
    lib = load_jpeg2000_encoder()
    out, size = ctypes.c_void_p(), ctypes.c_int64()
    code = lib.j2k_encode(planes, c, w, h, x1000, before, ctypes.byref(out), ctypes.byref(size))
    if code == 1:
        return None
    if code:
        raise ValueError(f"encode_codestream: cannot encode {c} x {h} x {w} at {x1000}")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.j2k_enc_free(out)
