"""The per-code loops of the port's image decoders (``image_codes.cpp``),
bound with ctypes: GIF's LZW (``core/gif.py``), Radiance HDR's scanlines
(``core/hdr.py``), BMP's RLE4 / RLE8 (``core/bmp.py``) and TIFF's LZW,
PackBits, CCITT (RLE, RLEW, Group 3, Group 4), ThunderScan and SGILog codes
and its CIELab conversion (``core/tiff.py``); and those of the encoders:
GIF's quantiser and LZW, HDR's run-length scanlines and TIFF's LZW with
its horizontal predictor.

The library is built with g++ on first use (``build.py``); there is no
other path, so without a compiler such a read raises ``RuntimeError`` with
the reason.  Each GIF, HDR or BMP call raises ``ValueError`` where cv2's
decoder gives up; a TIFF codec returns what it decoded and whether libtiff
reports an error there (cv2 keeps the partial output).
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
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.gif_lzw.argtypes = [ctypes.c_char_p, i64, i64, c_int, u8p, i64]
        lib.hdr_pixels.argtypes = [ctypes.c_char_p, i64, i64, c_int, c_int, u8p]
        lib.bmp_rle.argtypes = [ctypes.c_char_p, i64, i64, c_int, c_int, c_int, u8p]
        for name in ("tiff_lzw", "tiff_packbits"):
            getattr(lib, name).argtypes = [ctypes.c_char_p, i64, u8p, i64]
        lib.tiff_fax.argtypes = [c_int, c_int, ctypes.c_char_p, i64, c_int, c_int, c_int,
                                 ctypes.POINTER(c_int), u32p, u8p]
        lib.fax_nruns.argtypes = [c_int, c_int]
        lib.fax_nruns.restype = i64
        lib.tiff_thunder.argtypes = [ctypes.c_char_p, i64, c_int, c_int, u8p]
        lib.tiff_cielab.argtypes = [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"), i64,
                                    c_int, ctypes.c_float, ctypes.c_float, u8p]
        lib.tiff_sgilog.argtypes = [c_int, ctypes.c_char_p, i64, c_int, c_int, u8p]
        lib.gif_dither.argtypes = [u8p, c_int, c_int, u8p]
        lib.gif_dither.restype = None
        lib.gif_lzw_encode.argtypes = [u8p, i64, u8p]
        lib.hdr_rle_encode.argtypes = [u8p, c_int, c_int, u8p]
        lib.tiff_lzw_encode.argtypes = [u8p, i64, c_int, c_int, u8p]
        for fn in (lib.gif_lzw_encode, lib.hdr_rle_encode, lib.tiff_lzw_encode):
            fn.restype = i64
        for fn in (lib.gif_lzw, lib.hdr_pixels, lib.bmp_rle, lib.tiff_lzw, lib.tiff_packbits,
                   lib.tiff_fax, lib.tiff_thunder, lib.tiff_cielab, lib.tiff_sgilog):
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


def tiff_codec(name: str, data: bytes, size: int) -> tuple[np.ndarray, bool]:
    """``size`` bytes of one strip or tile decoded by TIFF's ``"lzw"`` or
    ``"packbits"`` code (zeros where the code stops), and whether libtiff
    reports an error for it."""
    out = np.zeros(size, np.uint8)
    failed = getattr(load_image_codes(), "tiff_" + name)(data, len(data), out, size)
    return out, bool(failed)


class FaxState:
    """What libtiff's CCITT codec keeps from strip to strip of one image:
    its two run arrays (zero at first) and ``FAXMODE_NOEOL``, set once a
    Group 3 row is decoded without its EOL."""

    def __init__(self, width: int, two_d: bool):
        lib = load_image_codes()
        self.runs = np.zeros(2 * lib.fax_nruns(width, int(two_d)) + 4, np.uint32)
        self.noeol = ctypes.c_int(0)


def tiff_fax(compression: int, t4_options: int, data: bytes, rows: int, width: int,
             size: int, parity: int, state: FaxState) -> tuple[np.ndarray, bool]:
    """``size`` bytes of one CCITT-coded strip or tile (compression 2, 3, 4
    or 32771; ``t4_options`` bit 0: Group 3 rows may be 2-D) of ``rows``
    1-bit rows of ``width`` pixels, and whether libtiff reports an error
    for it.  ``parity``: the address parity of the data's first byte, which
    RLEW's 16-bit row alignment counts from; ``state``: the image's
    ``FaxState``, which the call updates."""
    out = np.zeros(max(size, rows * ((width + 7) // 8)), np.uint8)
    failed = load_image_codes().tiff_fax(compression, t4_options & 1, data, len(data), width,
                                         rows, parity & 1, ctypes.byref(state.noeol),
                                         state.runs, out)
    return out[:size], bool(failed)


def tiff_thunder(data: bytes, rows: int, width: int, size: int) -> tuple[np.ndarray, bool]:
    """``size`` bytes of one ThunderScan strip (``rows`` 4-bit rows of
    ``width`` pixels), and whether libtiff reports an error for it."""
    # a run that ends the last row writes one byte past it, as in libtiff
    out = np.zeros(max(size, rows * ((width + 1) // 2)) + 1, np.uint8)
    failed = load_image_codes().tiff_thunder(data, len(data), width, rows, out)
    return out[:size], bool(failed)


def tiff_cielab(samples: np.ndarray, bits: int, whitepoint: tuple) -> np.ndarray:
    """RGB uint8 ``[..., 3]`` of CIELab samples ``[..., 3]`` (L unsigned, a
    and b two's complement in ``bits`` 8 or 16 bits, as the file stores
    them) as TIFFRGBAImage converts them for the WhitePoint ``whitepoint``
    (two float32 values); raises ``ValueError`` where its y is 0."""
    flat = np.ascontiguousarray(samples, np.int32).reshape(-1, 3)
    out = np.zeros(flat.shape, np.uint8)
    if load_image_codes().tiff_cielab(flat, len(flat), bits, float(whitepoint[0]),
                                      float(whitepoint[1]), out):
        raise ValueError("CIELab with a WhitePoint y of 0")
    return out.reshape(samples.shape[:-1] + (3,))


def tiff_sgilog(kind: int, data: bytes, rows: int, width: int, size: int
                ) -> tuple[np.ndarray, bool]:
    """``size`` bytes of one SGILog strip or tile decoded to libtiff's 8-bit
    data format (``kind`` 0 LogL: a gray byte a pixel; 1 LogLuv32, 2
    LogLuv24: 3 RGB bytes a pixel) for ``rows`` rows of ``width`` pixels,
    and whether libtiff reports an error for it."""
    out = np.zeros(max(size, rows * width * (1 if kind == 0 else 3)), np.uint8)
    failed = load_image_codes().tiff_sgilog(kind, data, len(data), width, rows, out)
    return out[:size], bool(failed)


def gif_dither(rgb: np.ndarray) -> np.ndarray:
    """cv2 5.0's GIF quantiser: indices ``[H, W]`` (uint8) into its fixed
    3:3:2 table of the RGB uint8 pixels ``rgb`` ``[H, W, 3]``."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out = np.zeros(rgb.shape[:2], np.uint8)
    load_image_codes().gif_dither(rgb, rgb.shape[0], rgb.shape[1], out)
    return out


def gif_lzw_encode(indices: np.ndarray) -> bytes:
    """GIF's LZW image data (minimum code size 8) of 8-bit ``indices`` as
    cv2 5.0 writes it, in sub-blocks ended by the zero block."""
    flat = np.ascontiguousarray(indices, np.uint8).ravel()
    out = np.zeros(2 * flat.size + 16, np.uint8)
    n = load_image_codes().gif_lzw_encode(flat, flat.size, out)
    return out[:n].tobytes()


def hdr_rle_encode(rgbe: np.ndarray) -> bytes:
    """Radiance HDR's run-length scanlines of RGBE bytes ``[H, W, 4]`` as
    rgbe.cpp writes them (width 8 to 0x7fff)."""
    height, width = rgbe.shape[:2]
    planes = np.ascontiguousarray(np.asarray(rgbe, np.uint8).transpose(0, 2, 1))
    out = np.zeros(height * (4 + 4 * width + 4 * -(-width // 128)), np.uint8)
    n = load_image_codes().hdr_rle_encode(planes, width, height, out)
    return out[:n].tobytes()


def tiff_lzw_encode(rows: np.ndarray, stride: int) -> bytes:
    """One TIFF strip of 8-bit sample rows ``[rows, row_bytes]`` as libtiff
    4.7.1 writes it with LZW after the horizontal predictor over
    ``stride`` samples a pixel."""
    rows = np.ascontiguousarray(rows, np.uint8)
    out = np.zeros(2 * rows.size + 16, np.uint8)
    n = load_image_codes().tiff_lzw_encode(rows, rows.shape[1], rows.shape[0], stride, out)
    return out[:n].tobytes()
