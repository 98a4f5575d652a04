"""The port's AV1 decoder (``av1.cpp``), bound with ctypes: one AV1 image
item (its OBUs) to its Y, U and V planes, as libaom 3.14.1 (cv2 5.0's,
through libavif 1.4.2) decodes a still image.  ``core/avif.py`` reads the
HEIF boxes around it and converts the planes as cv2 does.

The library is built with g++ on first use (``build.py``); there is no other
path, so without a compiler an AVIF read raises ``RuntimeError`` with the
reason.  A stream libaom refuses raises ``ValueError`` with its reason; a
form the port does not decode (ROADMAP A10 part 3, step 6b) raises
``UnsupportedImage``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.core.png import UnsupportedImage
from instancesegmentation_tpu_torch.ops.native.build import build_library

SRC = Path(__file__).with_name("av1.cpp")
_MSG_LEN = 256
_lib: Optional[ctypes.CDLL] = None
#: the decoder's path counters (``av1_test_counters``), in its order: intra
#: block copy blocks by subsampling, chroma predicted at half pixels, the
#: displacement vector's reference (a neighbour's, the default), transform
#: tree leaves at depths 1 and 2, inter transform sets read (DCT and IDTX,
#: 9 types and IDTX and the 1-D DCTs, all 16), 4:2:2 chroma blocks CDEF
#: filtered along a remapped direction and restored, 4:2:2 blocks
COUNTERS = ("intrabc_444", "intrabc_420", "intrabc_422", "intrabc_400", "half_pel_420",
            "half_pel_422", "dv_ref_neighbour", "dv_ref_default", "vartx_depth1", "vartx_depth2",
            "tx_set_dct_idtx", "tx_set_dtt9", "tx_set_all16", "cdef_422_remapped", "lr_422_chroma",
            "blocks_422")


@dataclass(frozen=True)
class Av1Image:
    """A decoded frame: its planes (``u`` and ``v`` None for 4:0:0) and the
    sequence header's colour description."""
    width: int
    height: int
    mono: bool
    ssx: int
    ssy: int
    full_range: bool
    primaries: int
    transfer: int
    matrix: int
    y: np.ndarray
    u: Optional[np.ndarray]
    v: Optional[np.ndarray]


def load_av1() -> ctypes.CDLL:
    """The bound decoder, built on first use; raises ``RuntimeError`` (with
    the compiler's message) when it cannot be built."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(SRC)))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.av1_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, i64p,
                                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int64]
        lib.av1_decode.restype = ctypes.c_int
        lib.av1_planes.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
        lib.av1_planes.restype = None
        lib.av1_free.argtypes = [ctypes.c_void_p]
        lib.av1_free.restype = None
        lib.av1_test_counters.argtypes = [i64p, ctypes.c_int]
        lib.av1_test_counters.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode_av1(data: bytes, path: str = "<bytes>", depth: int = 0) -> Av1Image:
    """The frame of the AV1 item ``data`` (its OBUs, as the item's extents
    give them); ``depth``: the bit depth its ``av1C`` gives, which the
    stream's must equal (0: any)."""
    lib = load_av1()
    info = np.zeros(9, np.int64)
    handle = ctypes.c_void_p()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    code = lib.av1_decode(data, len(data), depth, info, ctypes.byref(handle), msg, _MSG_LEN)
    if code:
        text = f"{path}: AV1: {msg.value.decode(errors='replace')}"
        if code == 2:
            raise UnsupportedImage(f"{text} (ROADMAP A10 part 3, step 6b)")
        raise ValueError(text)
    w, h, mono, ssx, ssy, full_range, cp, tc, mc = (int(v) for v in info)
    try:
        y = np.empty((h, w), np.uint8)
        u = v = None
        cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
        if not mono:
            u = np.empty((ch, cw), np.uint8)
            v = np.empty((ch, cw), np.uint8)
        lib.av1_planes(handle, y.ctypes.data, None if mono else u.ctypes.data,
                       None if mono else v.ctypes.data)
    finally:
        lib.av1_free(handle)
    return Av1Image(w, h, bool(mono), ssx, ssy, bool(full_range), cp, tc, mc, y, u, v)


def last_counters() -> dict:
    """The counters of this thread's last ``decode_av1`` (for tests: which
    of the decoder's paths the frame reached)."""
    lib = load_av1()
    out = np.zeros(len(COUNTERS), np.int64)
    assert lib.av1_test_counters(out, len(COUNTERS)) == len(COUNTERS)
    return dict(zip(COUNTERS, (int(v) for v in out)))
