"""TIFF files written by the system's libtiff through ctypes, for the forms
that neither cv2, PIL nor ``tiff_writer.py`` writes: SGILog (LogL and
LogLuv, compressions 34676 and 34677) from float XYZ or Y, 16-bit CIELab,
and CIELab with a WhitePoint tag.

Test-only code, used by ``make_fixtures.py`` and the TIFF tests, never by
the port (which loads no libtiff).  ``available()`` says whether a libtiff
with the SGILog codec can be loaded here.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import tempfile

import numpy as np

TIFFTAG = dict(width=256, height=257, bps=258, compression=259, photometric=262,
               spp=277, rps=278, planar=284, sample_format=339, whitepoint=318,
               sgilog_datafmt=65560, sgilog_encode=65561, stonits=37439)
SGILOG, SGILOG24 = 34676, 34677
SGILOGDATAFMT_FLOAT, SGILOGDATAFMT_16BIT = 0, 1

_lib = None


def _load():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("tiff")
        if name is None:
            raise OSError("no libtiff")
        lib = ctypes.CDLL(name)
        lib.TIFFOpen.restype = ctypes.c_void_p
        lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.TIFFClose.argtypes = [ctypes.c_void_p]
        lib.TIFFWriteScanline.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                                          ctypes.c_uint16]
        lib.TIFFIsCODECConfigured.argtypes = [ctypes.c_uint16]
        lib.TIFFSetErrorHandler.argtypes = [ctypes.c_void_p]
        lib.TIFFSetWarningHandler.argtypes = [ctypes.c_void_p]
        lib.TIFFSetErrorHandler(None)
        lib.TIFFSetWarningHandler(None)
        _lib = lib
    return _lib


def available() -> bool:
    try:
        lib = _load()
    except OSError:
        return False
    return bool(lib.TIFFIsCODECConfigured(SGILOG)) and bool(lib.TIFFIsCODECConfigured(SGILOG24))


def write(rows: np.ndarray, fields: dict, whitepoint: tuple | None = None) -> bytes:
    """One image of ``rows`` ``[H, row bytes]`` (uint8 view of each row's
    samples as libtiff takes them), with ``fields`` {name or tag: int}
    set in order (the SGILog data format after the compression);
    ``whitepoint``: the WhitePoint tag's two floats."""
    lib = _load()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "image.tif").encode()
        tif = lib.TIFFOpen(path, b"w")
        if not tif:
            raise OSError("TIFFOpen failed")
        try:
            for key, value in fields.items():
                tag = TIFFTAG.get(key, key)
                if tag == TIFFTAG["stonits"]:
                    ok = lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag),
                                          ctypes.c_double(value))
                else:
                    ok = lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag),
                                          ctypes.c_int(value))
                if not ok:
                    raise ValueError(f"TIFFSetField({key}, {value}) failed")
            if whitepoint is not None:
                wp = (ctypes.c_float * 2)(*whitepoint)
                if not lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(TIFFTAG["whitepoint"]),
                                        wp):
                    raise ValueError("TIFFSetField(WhitePoint) failed")
            rows = np.ascontiguousarray(rows)
            for y in range(rows.shape[0]):
                if lib.TIFFWriteScanline(tif, rows[y].ctypes.data, y, 0) != 1:
                    raise ValueError(f"TIFFWriteScanline({y}) failed")
        finally:
            lib.TIFFClose(tif)
        with open(path, "rb") as f:
            return f.read()


def sgilog(values: np.ndarray, compression: int = SGILOG, rows_per_strip: int = 0,
           datafmt: int = SGILOGDATAFMT_FLOAT) -> bytes:
    """LogL (``values`` [H, W] luminance Y) or LogLuv (``values`` [H, W, 3]
    XYZ), float32 (``datafmt`` float) or int16 (16-bit: LogL's 16-bit log
    code, LogLuv's L, u, v as ``Luv48``), no dithering."""
    values = np.asarray(values)
    h, w = values.shape[:2]
    spp = 1 if values.ndim == 2 else 3
    fields = {"width": w, "height": h, "photometric": 32844 if spp == 1 else 32845,
              "spp": spp, "compression": compression, "planar": 1,
              "sgilog_datafmt": datafmt, "sgilog_encode": 0,
              "rps": rows_per_strip or h}
    dtype = np.float32 if datafmt == SGILOGDATAFMT_FLOAT else np.int16
    rows = values.astype(dtype).reshape(h, -1).view(np.uint8)
    return write(rows, fields)


def cielab(samples: np.ndarray, bps: int = 8, whitepoint: tuple | None = None,
           rows_per_strip: int = 0) -> bytes:
    """CIELab (photometric 8) of ``samples`` [H, W, 3]: L unsigned, a and b
    signed (int8 or int16 values), uncompressed."""
    samples = np.asarray(samples)
    h, w, _ = samples.shape
    fields = {"width": w, "height": h, "photometric": 8, "spp": 3, "bps": bps,
              "compression": 1, "planar": 1, "rps": rows_per_strip or h}
    if bps == 8:
        rows = np.stack([samples[..., 0].astype(np.uint8),
                         samples[..., 1].astype(np.int8).view(np.uint8),
                         samples[..., 2].astype(np.int8).view(np.uint8)], -1)
    else:
        rows = np.stack([samples[..., 0].astype(np.uint16),
                         samples[..., 1].astype(np.int16).view(np.uint16),
                         samples[..., 2].astype(np.int16).view(np.uint16)], -1).view(np.uint8)
    return write(rows.reshape(h, -1), fields, whitepoint)
