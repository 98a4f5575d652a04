"""EXIF orientation as ``cv2.imread`` applies it (no
``IMREAD_IGNORE_ORIENTATION``): read tag 0x0112 from IFD0 of a TIFF block
(a PNG ``eXIf`` chunk, a JPEG's first APP1 segment from its seventh byte,
or a WebP ``EXIF`` chunk), then turn the decoded array by one of the eight
orientations.

The TIFF walk is cv2's ``ExifReader``: little-endian after ``II``, else
big-endian; the marker 42; IFD0's entries in order, where the first 0x0112
entry decides: the 16-bit value at its value field, whatever the entry's
type and count say (cv2 5.0 reads it so for PNG, JPEG and WebP alike).
Before it, the reader also reads the data of twelve tags, by tag whatever
their type (``_TAG_DATA``): the six string tags their ``count`` bytes (at
the value offset where the count is above 4, else at byte 8 of the block),
the six rational tags 1, 2, 3 or 6 rationals at the value offset.  Where
that data does not lie inside the block, cv2 stops, keeps the entries it
read before, and so never reaches a later orientation: the image stays
unturned.  A block cut short keeps what was read before the cut.  Values
outside 1-8 leave the image as it is.
``ifd_entries`` is the walk of one IFD, which ``core/tiff.py`` reads TIFF
and BigTIFF files with too.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

ORIENTATION_TAG = 0x0112
#: the tags before the orientation whose data cv2's ``ExifReader`` reads,
#: by tag: ``"string"`` (``getString``: ``count`` bytes) or the number of
#: unsigned rationals (8 bytes each) at the value offset
_TAG_DATA = {0x010E: "string", 0x010F: "string", 0x0110: "string", 0x0131: "string",
             0x0132: "string", 0x8298: "string", 0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6,
             0x0211: 3, 0x0214: 6}


def ifd_entries(block: bytes, off: int, order: str, big: bool = False):
    """Yield ``(tag, type, count, value position)`` for each entry of the IFD
    at ``off`` of the TIFF block ``block`` (``order`` ``"<"`` or ``">"``;
    ``big``: BigTIFF's 8-byte counts and offsets), in file order; raises
    ``IndexError`` where the block ends inside the count or an entry's tag,
    type and count (its value is the caller's to read)."""
    cfmt, efmt, size = ("Q", "HHQ", 20) if big else ("H", "HHI", 12)
    if off < 0 or off + struct.calcsize(cfmt) > len(block):
        raise IndexError("IFD count cut short")
    count = struct.unpack_from(order + cfmt, block, off)[0]
    pos = off + struct.calcsize(cfmt)
    value = 8 if big else 4
    for i in range(count):
        at = pos + size * i
        if at + size - value > len(block):
            raise IndexError("IFD entry cut short")
        tag, typ, n = struct.unpack_from(order + efmt, block, at)
        yield tag, typ, n, at + size - value


def exif_orientation(tiff: Optional[bytes]) -> int:
    """The orientation (1 when absent) of the TIFF block ``tiff``."""
    if not tiff:
        return 1
    end = "<" if tiff[:2] == b"II" else ">"

    def u16(off: int) -> int:
        if off + 2 > len(tiff):
            raise IndexError
        return struct.unpack_from(end + "H", tiff, off)[0]

    try:
        if u16(2) != 42:
            return 1
        if len(tiff) < 8:
            raise IndexError
        for tag, _, count, pos in ifd_entries(tiff, struct.unpack_from(end + "I", tiff, 4)[0],
                                                  end):
            if tag == ORIENTATION_TAG:
                return u16(pos)
            if tag in _TAG_DATA and not _data_fits(tiff, _TAG_DATA[tag], count,
                                                   struct.unpack_from(end + "I", tiff, pos)[0]):
                return 1
    except (IndexError, struct.error):
        pass
    return 1


def _data_fits(tiff: bytes, kind, count: int, offset: int) -> bool:
    """Whether cv2's read of one ``_TAG_DATA`` entry's data stays inside the
    block (its checks in 32-bit unsigned arithmetic, as cv2 computes
    them)."""
    if kind == "string":
        at = 8 if count <= 4 else offset
        return at <= len(tiff) and (at + count) & 0xFFFFFFFF <= len(tiff)
    return offset + 8 * kind <= len(tiff)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` ([H, W] or [H, W, C]) turned as cv2 turns orientation 1-8:
    2 mirror, 3 rotate 180, 4 flip, 5 transpose, 6 rotate 90 clockwise,
    7 transverse, 8 rotate 90 counter-clockwise."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)
