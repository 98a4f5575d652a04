"""Build and bind the port's host C++ libraries.

Each source (``rle.cpp``, ``jpeg.cpp``, ``jpeg_enc.cpp``, ``image_codes.cpp``,
``text.cpp``, ``webp.cpp``, ``webp_enc.cpp``, ``jpeg2000.cpp``,
``jpeg2000_enc.cpp``, ``av1.cpp``) is compiled
with ``g++`` on first use into ``build/native/`` at the repository root,
named by a hash of the source (a changed source builds afresh), through a
temporary file and an atomic rename so that concurrent processes never load
a half-written library, and loaded with ctypes.  Every caller of the RLE
library has a NumPy path: ``load_native()`` returns None when no compiler
is found or the build fails.
The JPEG codecs, the image decoders' codes, the WebP codecs, the JPEG
2000 codecs, the AV1 decoder and the text rasteriser have none:
``ops/native/jpeg.py``, ``ops/native/image_codes.py``,
``ops/native/webp.py``, ``ops/native/jpeg2000.py``, ``ops/native/av1.py``
and ``core/text.py`` raise with the compiler's message
(``build_library``).  No source is built with ``-march`` or
``-ffast-math``, and ``-ffp-contract=off`` keeps g++ from fusing a product
and a sum (the JPEG 2000 9/7 wavelet and colour transform round as
OpenJPEG's do, and the encoder's rate allocation compares OpenJPEG's
slopes).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).with_name("rle.cpp")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_cached: Optional[ctypes.CDLL] = None
_failed = False


def lib_path(src: Path = SRC) -> Path:
    """Path of the library built from the current ``src`` and the headers
    beside it (``jpeg_tables.h``, ``av1_tables.h``)."""
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.h")))
    digest = hashlib.sha256(text + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_library(src: Path) -> Path:
    """The library of ``src``, compiled unless already built; raises
    ``RuntimeError`` with the reason (no compiler, or its message)."""
    path = lib_path(src)
    if path.exists():
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"cannot build {src.name}: no C++ compiler (g++ or c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"cannot build {src.name}: {cxx} failed:\n{proc.stderr}")
        os.replace(tmp, path)
    except subprocess.SubprocessError as e:
        raise RuntimeError(f"cannot build {src.name}: {e!r}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_native() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None if it cannot be built."""
    global _cached, _failed
    if _cached is not None:
        return _cached
    if _failed:
        return None
    try:
        lib = ctypes.CDLL(str(build_library(SRC)))
    except (OSError, RuntimeError):
        _failed = True
        return None

    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64

    lib.rle_encode.restype = i64
    lib.rle_encode.argtypes = [u8p, i64, i64, u32p, i64]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [u32p, i64, u8p, i64, i64]
    lib.rle_area.restype = ctypes.c_uint64
    lib.rle_area.argtypes = [u32p, i64]
    lib.rle_iou.restype = ctypes.c_double
    lib.rle_iou.argtypes = [u32p, i64, u32p, i64]
    lib.rle_iou_matrix.restype = None
    lib.rle_iou_matrix.argtypes = [u32p, i64p, i64p, i64, i64p, i64p, i64, f64p]

    _cached = lib
    return lib


def rle_encode_native(mask: np.ndarray) -> Optional[dict]:
    """``core.rasterize.rle_encode`` in C++; None without the library."""
    lib = load_native()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = mask.shape
    out = np.empty(h * w + 1, dtype=np.uint32)
    n = lib.rle_encode(mask, h, w, out, out.size)
    if n < 0:
        return None
    return {"size": [h, w], "counts": out[:n].astype(np.int64).tolist()}


def rle_decode_native(rle: dict) -> Optional[np.ndarray]:
    """``core.rasterize.rle_decode`` in C++; None without the library."""
    lib = load_native()
    if lib is None:
        return None
    h, w = rle["size"]
    counts = np.ascontiguousarray(rle["counts"], dtype=np.uint32)
    out = np.empty((h, w), dtype=np.uint8)
    lib.rle_decode(counts, len(counts), out, h, w)
    return out


def rle_iou_native(a: dict, b: dict) -> Optional[float]:
    """IoU of two RLEs by the run-merge walk; None without the library."""
    lib = load_native()
    if lib is None:
        return None
    ca = np.ascontiguousarray(a["counts"], dtype=np.uint32)
    cb = np.ascontiguousarray(b["counts"], dtype=np.uint32)
    return float(lib.rle_iou(ca, len(ca), cb, len(cb)))


def rle_iou_matrix_native(preds: list[dict], gts: list[dict]) -> Optional[np.ndarray]:
    """[P, G] float64 IoU matrix of two RLE lists in one C call (mask AP's
    matching); None without the library."""
    lib = load_native()
    if lib is None:
        return None
    all_counts = [np.asarray(r["counts"], dtype=np.uint32) for r in preds + gts]
    buf = (np.ascontiguousarray(np.concatenate(all_counts)) if all_counts
           else np.zeros(1, dtype=np.uint32))
    lens = np.asarray([len(c) for c in all_counts], dtype=np.int64)
    offsets = np.zeros(len(all_counts), dtype=np.int64)
    if len(all_counts) > 1:
        offsets[1:] = np.cumsum(lens)[:-1]
    pa, pb = len(preds), len(gts)
    out = np.zeros((pa, pb), dtype=np.float64)
    if pa and pb:
        lib.rle_iou_matrix(
            buf,
            np.ascontiguousarray(offsets[:pa]), np.ascontiguousarray(lens[:pa]), pa,
            np.ascontiguousarray(offsets[pa:]), np.ascontiguousarray(lens[pa:]), pb,
            out,
        )
    return out
