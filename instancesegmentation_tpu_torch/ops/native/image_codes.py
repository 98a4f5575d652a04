"""The per-code loops of the port's image decoders (``image_codes.cpp``),
bound with ctypes: GIF's LZW (``core/gif.py``), Radiance HDR's scanlines
(``core/hdr.py``) and BMP's RLE4 / RLE8 (``core/bmp.py``).

The library is built with g++ on first use (``build.py``); there is no
other path, so without a compiler such a read raises ``RuntimeError`` with
the reason.  Each call raises ``ValueError`` where cv2's decoder gives up.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.ops.native.build import build_library

SRC = Path(__file__).with_name("image_codes.cpp")
_lib: Optional[ctypes.CDLL] = None


def load_image_codes() -> ctypes.CDLL:
    """The bound library, built on first use; raises ``RuntimeError`` (with
    the compiler's message) when it cannot be built."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(SRC)))
        i64, c_int = ctypes.c_int64, ctypes.c_int
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.gif_lzw.argtypes = [ctypes.c_char_p, i64, i64, c_int, u8p, i64]
        lib.hdr_pixels.argtypes = [ctypes.c_char_p, i64, i64, c_int, c_int, u8p]
        lib.bmp_rle.argtypes = [ctypes.c_char_p, i64, i64, c_int, c_int, c_int, u8p]
        for fn in (lib.gif_lzw, lib.hdr_pixels, lib.bmp_rle):
            fn.restype = c_int
        _lib = lib
    return _lib


def gif_lzw(data: bytes, pos: int, min_size: int, height: int, width: int,
            path: str) -> np.ndarray:
    """One GIF frame's palette indices ``[height, width]`` (uint8) from its
    LZW sub-blocks at ``data[pos:]``."""
    out = np.zeros((height, width), np.uint8)
    if load_image_codes().gif_lzw(data, len(data), pos, min_size, out, out.size):
        raise ValueError(f"{path}: GIF image data cut short or not LZW cv2 decodes")
    return out


def hdr_pixels(data: bytes, pos: int, height: int, width: int, path: str) -> np.ndarray:
    """Radiance HDR's RGBE bytes ``[height, width, 4]`` from ``data[pos:]``."""
    out = np.zeros((height, width, 4), np.uint8)
    if load_image_codes().hdr_pixels(data, len(data), pos, width, height, out):
        raise ValueError(f"{path}: HDR pixel data cut short or malformed")
    return out


def bmp_rle(data: bytes, pos: int, height: int, width: int, bits: int, path: str) -> np.ndarray:
    """BMP RLE8 / RLE4 palette indices ``[height, width]`` in the file's row
    order, from ``data[pos:]``."""
    out = np.zeros((height, width), np.uint8)
    if load_image_codes().bmp_rle(data, len(data), pos, width, height, bits, out):
        raise ValueError(f"{path}: RLE{bits} data cut short or a run past its row")
    return out
