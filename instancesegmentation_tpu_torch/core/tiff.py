"""TIFF and BigTIFF decoding as ``cv2.imread`` / ``cv2.imdecode`` read them
in their 8-bit modes: libtiff 4.7 opens the file and reads the first
directory (``tif_dirread.c``), ``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``
turn each strip or tile into RGBA (``tif_getimage.c``), and cv2's
``grfmt_tiff.cpp`` flips the bottom-up rows and converts them to BGR or
gray (imgcodecs' 14-bit weights 4899 / 9617 / 1868).

``decode_tiff(data, mode)`` gives RGB uint8 ``[H, W, 3]`` (``"color"``) or
``[H, W]`` (``"gray"``):

- the container: both byte orders, classic TIFF (32-bit offsets) and
  BigTIFF (64-bit); the first directory only, tag types 1-18; strips or
  tiles, planar configuration 1 or 2, FillOrder 2 (every strip's bytes
  bit-reversed before its codec); the directory walk is ``core/exif.py``'s
  ``ifd_entries``;
- the codecs: none, PackBits, LZW (current and old-style), CCITT RLE and
  RLEW, Group 3 and Group 4 (2, 32771, 3, 4) on 1-bit images, ThunderScan on
  4-bit ones and SGILog (34676: LogL and LogLuv32, 34677: LogLuv24)
  (``ops/native/image_codes.cpp``), Deflate (8 and 32946, Python's
  ``zlib``), the horizontal predictor on 8 and 16 bits, JPEG (7; each strip
  or tile after the JPEGTables tag, YCbCr converted to RGB per strip,
  ``ops/native/jpeg.cpp``);
- the pixels as ``TIFFRGBAImage`` gives them: gray and bilevel
  (``makebwmap``: 1 and 8 bits, 16 bits by their high byte, MinIsWhite
  inverted), palettes of 1, 4 and 8 bits (a colormap whose entries all lie
  below 256 taken as 8-bit), RGB and RGBA contig or separate at 8 and 16
  bits (16 to 8 as ``(v + 128) // 257``, unassociated alpha premultiplied
  as ``(v * a + 127) // 255``), subsampled YCbCr through
  ``TIFFYCbCrToRGBInit``'s tables, CMYK (``r = (255 - k) * (255 - c) //
  255``), CIELab at 8 and 16 bits (``TIFFCIELab16ToXYZ`` and
  ``TIFFXYZToRGB`` for the sRGB display, the WhitePoint tag or D50), LogL
  and LogLuv through the SGILog codec's 8-bit data format (``L16toGry``,
  ``Luv32toRGB``, ``Luv24toRGB``), each put routine's step over a clipped
  tile's skipped pixels (libtiff's own: a gray pixel's extra samples,
  16-bit gray's second byte and a 4 x 4 YCbCr block's 18 bytes are stepped
  over short);
- orientations 2-4 mirror, turn or flip (a tile mirrored in place), 5-8 as
  ``cv2.imdecode`` turns them (``core/exif.py``); ``cv2.imread`` returns
  None for 5-8 (its check that the decoder kept the image's buffer fails
  on the turned image).

The CCITT codec is ``tif_fax3.c``'s state machine bit for bit, damaged
data included: its bit accumulator and the zeros it pads the data with, a
Group 3 row whose EOL is not found read again without EOLs from the
strip's start (``FAXMODE_NOEOL``, kept for the rest of the image), the run
arrays kept from strip to strip and their overflow, RLEW's 16-bit alignment
counted from the address of the strip's first byte (its offset in the file
for ``cv2.imread``, which maps the file; 0 for ``cv2.imdecode``, which
reads each strip into an aligned buffer).

Where cv2 returns None the decode raises ``ValueError`` (the reader's
``FileNotFoundError``): a header or directory cut or corrupt, a strip or
tile whose bytes lie past the end of the data, samples of other depths than
1, 8 and 16 (and 4 in a palette), floating-point samples, forms libtiff's
RGBA interface refuses (1-bit RGB, 16-bit palettes or CMYK, subsampled
YCbCr that is not 8-bit contig, separate CIELab, LogL or LogLuv without
SGILog compression, ...), more than 4 samples, compressions cv2's libtiff
is built without (old-style JPEG, PixarLog, LZMA, ZSTD, WebP, JBIG, LERC)
or that need 2-bit samples (NeXT), an uncompressed tile whose byte count
libtiff's buffer does not match (the count itself where ``cv2.imread``
maps the file, rounded up to 1 KiB where ``cv2.imdecode`` reads the bytes
or the file needs its bits reversed).  As in cv2, a codec that fails inside
a strip's bytes leaves that strip's decoded part and zeros after it, and a
compression code libtiff does not know gives a black image.  Every form
cv2 reads is decoded: no TIFF raises ``UnsupportedImage``.

``encode_tiff(pixels)`` writes what ``cv2.imencode(".tif")`` writes with
libtiff 4.7.1 at cv2's defaults: little-endian classic TIFF, the strips
first (from byte 8, one after another), then the directory at the next
even offset and the values that do not fit in it (BitsPerSample,
StripByteCounts, StripOffsets, SampleFormat, in that order).  The tags:
ImageWidth and ImageLength (SHORT below 65536, else LONG), BitsPerSample
8, Compression 5 (LZW), Photometric 1 (gray) or 2 (RGB), StripOffsets,
SamplesPerPixel, RowsPerStrip (cv2's ``8192 // row bytes``, at least 1 and
at most the height), StripByteCounts (LONG), PlanarConfig 1, Predictor 2
and SampleFormat 1; each strip coded by ``tif_lzw.c``'s encoder after the
horizontal predictor (``ops/native/image_codes.cpp``).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from instancesegmentation_tpu_torch.core.exif import apply_orientation, ifd_entries
from instancesegmentation_tpu_torch.core.pnm import check_size
from instancesegmentation_tpu_torch.ops.native.image_codes import (
    FaxState, tiff_cielab, tiff_codec, tiff_fax, tiff_lzw_encode, tiff_sgilog, tiff_thunder)
from instancesegmentation_tpu_torch.ops.native.jpeg import decode_tiff_jpeg

SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

#: bytes per value and struct format of the 18 tag types
_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "I"), 5: (8, "II"), 6: (1, "b"),
          7: (1, "B"), 8: (2, "h"), 9: (4, "i"), 10: (8, "ii"), 11: (4, "f"), 12: (8, "d"),
          13: (4, "I"), 16: (8, "Q"), 17: (8, "q"), 18: (8, "Q")}
_INTEGER_TYPES = (1, 3, 4, 6, 8, 9, 13, 16, 17, 18)

NONE, CCITTRLE, CCITTFAX3, CCITTFAX4, LZW, OJPEG, JPEG, DEFLATE = 1, 2, 3, 4, 5, 6, 7, 8
PACKBITS, DEFLATE_OLD = 32773, 32946
NEXT, CCITTRLEW, THUNDERSCAN, SGILOG, SGILOG24 = 32766, 32771, 32809, 34676, 34677
#: compressions libtiff knows but this cv2's build does not configure
_NOT_CONFIGURED = {OJPEG: "old-style JPEG", 32909: "PixarLog", 34661: "JBIG", 34887: "LERC",
                   34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
MINISWHITE, MINISBLACK, RGB, PALETTE, SEPARATED, YCBCR = 0, 1, 2, 3, 5, 6
CIELAB, LOGL, LOGLUV = 8, 32844, 32845
#: _TIFFGetMaxColorChannels
_COLOR_CHANNELS = {MINISWHITE: 1, MINISBLACK: 1, PALETTE: 1, RGB: 3, YCBCR: 3, 8: 3, 9: 3,
                   10: 3, SEPARATED: 4, 32844: 1, 32845: 3}
ASSOCALPHA, UNASSALPHA = 1, 2


class _Bad(ValueError):
    """What libtiff or cv2 refuses: cv2 returns None."""


# -- the directory ----------------------------------------------------------------


class _Entry:
    """One directory entry; ``values()`` reads it as libtiff's
    ``TIFFReadDirEntry*`` do (raising ``_EntryError``)."""

    def __init__(self, data: bytes, order: str, big: bool, typ: int, count: int, pos: int):
        self.data, self.order, self.big = data, order, big
        self.type, self.count, self.pos = typ, count, pos

    def values(self, limit: int | None = None) -> tuple:
        """The values (at most ``limit``; the entry holds them inline where
        all ``count`` fit)."""
        if self.type not in _TYPES:
            raise _EntryError("type")
        size, fmt = _TYPES[self.type]
        count = self.count if limit is None else min(self.count, limit)
        at = self.pos
        if size * self.count > (8 if self.big else 4):
            at = struct.unpack_from(self.order + ("Q" if self.big else "I"), self.data, self.pos)[0]
            if at + size * count > len(self.data):
                raise _EntryError("io")
        raw = struct.unpack_from(self.order + fmt * count, self.data, at)
        if self.type in (5, 10):
            return tuple(raw[i] / raw[i + 1] if raw[i + 1] else 0.0
                         for i in range(0, len(raw), 2))
        return raw

    def ints(self, lo: int = 0, hi: int = (1 << 64) - 1, limit: int | None = None) -> tuple:
        """Integer values in ``[lo, hi]`` (``TIFFReadDirEntry*Array``'s range
        checks)."""
        if self.type not in _INTEGER_TYPES:
            raise _EntryError("type")
        v = self.values(limit)
        if any(x < lo or x > hi for x in v):
            raise _EntryError("range")
        return v

    def scalar(self, hi: int) -> int:
        """``TIFFReadDirEntryShort`` / ``Long``: one integer value (a SHORT
        is not read from the IFD types 13 and 18)."""
        if self.count != 1:
            raise _EntryError("count")
        if hi == 0xFFFF and self.type in (13, 18):
            raise _EntryError("type")
        return self.ints(0, hi)[0]

    def per_sample(self, spp: int) -> int:
        """``TIFFReadDirEntryPersampleShort``: ``spp`` equal values."""
        if self.count < spp:
            raise _EntryError("count")
        v = self.ints(0, 0xFFFF)[:spp]
        if any(x != v[0] for x in v):
            raise _EntryError("per-sample values differ")
        return v[0]


class _EntryError(Exception):
    pass


class _Directory:
    """The fields of the first directory that the RGBA read uses, with
    libtiff's defaults and the fix-ups ``TIFFReadDirectory`` makes."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 8:
            raise _Bad("TIFF header cut short")
        self.order = "<" if data[:2] == b"II" else ">"
        self.big = data[2:4] in (b"+\x00", b"\x00+")
        if self.big:
            if len(data) < 16:
                raise _Bad("BigTIFF header cut short")
            bytesize, zero, off = struct.unpack_from(self.order + "HHQ", data, 4)
            if bytesize != 8 or zero != 0:
                raise _Bad("BigTIFF header with a bad offset size")
        else:
            off = struct.unpack_from(self.order + "I", data, 4)[0]
        self._read(off)

    def _read(self, off: int) -> None:
        data, order, big = self.data, self.order, self.big
        try:  # TIFFFetchDirectory: the count, then every entry in the data
            entries = list(ifd_entries(data, off, order, big))
        except IndexError as e:
            raise _Bad(f"TIFF directory cut short ({e})") from None
        if not entries or len(entries) > 4096:
            raise _Bad("TIFF directory count out of range")
        if entries[-1][3] + (8 if big else 4) > len(data):
            raise _Bad("TIFF directory cut short")
        tags: dict[int, _Entry] = {}
        self.entries = [_Entry(data, order, big, typ, n, pos) for tag, typ, n, pos in entries]
        for (tag, *_), e in zip(entries, self.entries):
            tags.setdefault(tag, e)
        self.tags = tags

        def required(tag, read, default):
            if tag not in tags:
                return default
            try:
                return read(tags[tag])
            except _EntryError as e:
                raise _Bad(f"TIFF tag {tag} unreadable ({e})") from None

        def optional(tag, read, default):
            try:
                return read(tags[tag]) if tag in tags else default
            except (_EntryError, struct.error):
                return default

        self.spp = required(277, lambda e: e.scalar(0xFFFF), 1)
        if self.spp == 0:
            raise _Bad("SamplesPerPixel 0")
        spp = self.spp

        def compression(e):
            try:
                return e.scalar(0xFFFF)
            except _EntryError as err:
                if str(err) != "count":
                    raise
                return e.per_sample(spp)

        self.compression = required(259, compression, NONE)
        self.width = required(256, lambda e: e.scalar(0xFFFFFFFF), None)
        self.height = required(257, lambda e: e.scalar(0xFFFFFFFF), None)
        tw = required(322, lambda e: e.scalar(0xFFFFFFFF), None)
        th = required(323, lambda e: e.scalar(0xFFFFFFFF), None)
        self.planar = required(284, lambda e: e.scalar(0xFFFF), 1)
        if self.planar not in (1, 2):
            raise _Bad(f"PlanarConfiguration {self.planar}")
        self.rps = required(278, lambda e: e.scalar(0xFFFFFFFF), 0xFFFFFFFF)
        if self.rps == 0:
            raise _Bad("RowsPerStrip 0")
        extra = required(338, lambda e: e.ints(0, 0xFFFF), ())
        if len(extra) > spp or any(v > UNASSALPHA for v in extra):
            raise _Bad("bad ExtraSamples")
        self.extra = list(extra)
        if self.width is None or self.height is None:
            raise _Bad("TIFF directory without ImageWidth or ImageLength")
        self.tiled = tw is not None or th is not None
        if self.tiled:
            if not tw or not th:
                raise _Bad("TIFF tile without a width or length")
            self.tile = (tw, th)
        # the second pass
        self.bps = required(258, lambda e: e.scalar(0xFFFF) if e.count == 1 else e.per_sample(spp),
                            1)
        self.bps_set = 258 in tags
        self.sample_format = required(339, lambda e: e.scalar(0xFFFF) if e.count == 1
                                      else e.per_sample(spp), 1)
        if not 1 <= self.sample_format <= 6:
            raise _Bad(f"SampleFormat {self.sample_format}")
        self.photometric = optional(262, lambda e: e.scalar(0xFFFF), None)
        orientation = optional(274, lambda e: e.scalar(0xFFFF), 1)
        self.orientation = orientation if 1 <= orientation <= 8 else 1
        fillorder = optional(266, lambda e: e.scalar(0xFFFF), 1)
        self.fillorder = fillorder if fillorder in (1, 2) else 1
        self.predictor = optional(317, lambda e: e.scalar(0xFFFF), 1)
        self.inkset = optional(332, lambda e: e.scalar(0xFFFF), 1)
        self.subsampling = optional(530, lambda e: e.ints(0, 0xFFFF)[:2]
                                    if e.count == 2 else _raise(_EntryError("count")), None)
        self.jpeg_tables = optional(347, lambda e: bytes(v & 0xFF for v in e.values())
                                    if e.type in (1, 2, 6, 7) else _raise(_EntryError("type")),
                                    b"")
        self.luma = optional(529, lambda e: e.values() if e.count == 3 else
                             _raise(_EntryError("count")), None)
        self.refbw = optional(532, lambda e: e.values() if e.count == 6 else
                              _raise(_EntryError("count")), None)
        self.colormap = None
        if 320 in tags and self.bps_set and self.bps <= 24:
            e = tags[320]
            if e.count == 3 << self.bps:
                self.colormap = optional(320, lambda e: np.array(e.ints(0, 0xFFFF), np.int64)
                                         .reshape(3, -1), None)
        self.t4 = optional(292, lambda e: e.scalar(0xFFFFFFFF), 0)
        self.whitepoint = optional(318, _floats(2), None)
        # the non-colour channels become extra samples
        cc = _COLOR_CHANNELS.get(self.photometric)
        if cc and spp - len(self.extra) > cc:
            self.extra += [0] * (spp - cc - len(self.extra))
        if self.photometric == PALETTE and self.colormap is None:
            if self.bps >= 8 and spp == 3:
                self.photometric = RGB
            elif self.bps >= 8:
                self.photometric = MINISBLACK
            else:
                raise _Bad("palette image without a colormap")
        self._striles()

    def _striles(self) -> None:
        tags = self.tags
        if self.tiled:
            tw, th = self.tile
            per_plane = -(-self.width // tw) * -(-self.height // th)
        else:
            rps = min(self.rps, self.height) if self.height else self.rps
            per_plane = -(-self.height // rps) if self.height else 0
        n = per_plane * (self.spp if self.planar == 2 else 1)
        if n == 0:
            raise _Bad("no strips or tiles")
        # TIFFReadDirectory reads StripOffsets and TileOffsets (and the two
        # byte counts) into one field, the later entry of the two winning
        off_tag = self._later(273, 324)
        cnt_tag = self._later(279, 325)
        if off_tag not in tags:
            raise _Bad("no StripOffsets or TileOffsets")
        try:  # TIFFFetchStripThing: at most n values, a short array padded with zeros
            offsets = list(tags[off_tag].ints(limit=n))
            counts = list(tags[cnt_tag].ints(limit=n)) if cnt_tag in tags else None
        except (_EntryError, struct.error) as e:
            raise _Bad(f"strip or tile array unreadable ({e})") from None
        if n > 1000000 and (tags[off_tag].count < n or
                            (cnt_tag in tags and tags[cnt_tag].count < n)):
            raise _Bad("strip or tile array too short")
        offsets = (offsets + [0] * n)[:n]
        self.offsets, self.per_plane = offsets, per_plane
        # TIFFReadDirectory's repairs of StripByteCounts
        if counts is None:
            if (self.planar == 1 and n > 1) or (self.planar == 2 and n != self.spp):
                raise _Bad("no StripByteCounts")
            counts = self._estimate(n)
        else:
            counts = (counts + [0] * n)[:n]
            if n == 1 and not self.tiled and self._count_looks_bad(offsets[0], counts[0]):
                counts = self._estimate(n)
            elif (self.planar == 1 and n > 2 and self.compression == NONE and counts[0] != counts[1]
                  and counts[0] and counts[1]):
                counts = self._estimate(n)
        self.counts = counts
        if (self.compression == JPEG and self.photometric == YCBCR and self.planar == 1
                and self.spp == 3 and self.subsampling is None and offsets[0]):
            self._jpeg_subsampling(offsets[0], counts[0])

    def _later(self, a: int, b: int) -> int:
        """Of tags ``a`` and ``b``, the one whose first entry comes later
        in the directory (``a`` where neither is there)."""
        at = {tag: self.entries.index(e) for tag, e in self.tags.items() if tag in (a, b)}
        return max(at, key=at.get) if at else a

    def _jpeg_subsampling(self, offset: int, count: int) -> None:
        """``JPEGFixupTagsSubsampling``: without a YCbCrSubsampling tag,
        take the first strip's SOF sampling factors (the other components
        1 x 1, each factor 1, 2 or 4)."""
        seg = self.data[offset:offset + count]
        pos, n = 0, len(seg)
        while True:
            while pos < n and seg[pos] != 0xFF:
                pos += 1
            while pos < n and seg[pos] == 0xFF:
                pos += 1
            if pos >= n:
                return
            m = seg[pos]
            pos += 1
            if m == 0xD8:
                continue
            if m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF:
                if pos + 2 > n or seg[pos] << 8 | seg[pos + 1] < 2:
                    return
                pos += seg[pos] << 8 | seg[pos + 1]
                continue
            if m not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
                return
            if pos + 2 > n or seg[pos] << 8 | seg[pos + 1] != 8 + 3 * self.spp:
                return
            body = seg[pos + 2:pos + 2 + 6 + 3 * self.spp]
            if len(body) < 6 + 3 * self.spp:
                return
            h, v = body[7] >> 4, body[7] & 15
            if any(body[6 + 3 * i + 1] != 0x11 for i in range(1, self.spp)):
                return
            if h in (1, 2, 4) and v in (1, 2, 4):
                self.subsampling = (h, v)
            return

    def _count_looks_bad(self, offset: int, count: int) -> bool:
        """``ByteCountLooksBad`` of a file's single strip."""
        if offset == 0:
            return False
        if count == 0:
            return True
        if self.compression != NONE:
            return False
        size = len(self.data)
        if offset <= size and count > size - offset:
            return True
        return count < self.scanline() * self.height

    def _estimate(self, n: int) -> list:
        """``EstimateStripByteCounts``: what is left of the file after the
        header and the directory (the last strip cut at the file's end) for
        compressed data, else the rows' size."""
        size = len(self.data)
        if self.compression != NONE:
            space = (16 + 8 + len(self.entries) * 20 + 8) if self.big else \
                (8 + 2 + len(self.entries) * 12 + 4)
            for e in self.entries:
                width = {1: 1, 2: 1, 6: 1, 7: 1, 3: 2, 8: 2, 4: 4, 9: 4, 11: 4, 13: 4}.get(
                    e.type, 8 if e.type in (5, 10, 12, 16, 17, 18) else 0)
                if width == 0:
                    raise _Bad(f"tag type {e.type} of unknown size")
                nbytes = width * e.count
                space += 0 if nbytes <= (8 if self.big else 4) else nbytes
            space = size if size < space else size - space
            if self.planar == 2:
                space //= self.spp
            counts = [space] * n
            last = self.offsets[-1]
            if last + space > size:
                counts[-1] = 0 if last >= size else size - last
            return counts
        if self.tiled:
            return [self.strip_size(self.tile[1], self.tile[0])] * n
        per_image = n if self.planar == 1 else n // self.spp
        return [self.scanline() * (self.height // per_image)] * n

    def scanline(self) -> int:
        """``TIFFScanlineSize``: a row's bytes (of a block row shared by
        ``vs`` rows, for subsampled YCbCr)."""
        if self.ycbcr_subsampled():
            return self.strip_size(self.sub[1]) // self.sub[1]
        return self.row_bytes(self.width, self.spp if self.planar == 1 else 1)

    def _rows(self, strip: int) -> int:
        rps = min(self.rps, self.height)
        return min(rps, self.height - strip * rps)

    def row_bytes(self, width: int, plane_spp: int) -> int:
        return -(-width * plane_spp * self.bps // 8)

    def ycbcr_subsampled(self) -> bool:
        return (self.photometric == YCBCR and self.planar == 1 and self.compression != JPEG
                and self.sub != (1, 1))

    @property
    def sub(self) -> tuple:
        return tuple(self.subsampling) if self.subsampling else (2, 2)

    def strip_size(self, rows: int, width: int | None = None) -> int:
        """Bytes of ``rows`` decoded rows of one strip or tile (of ``width``
        samples; the image's by default): TIFFVStripSize."""
        width = self.width if width is None else width
        if self.ycbcr_subsampled():
            hs, vs = self.sub
            block = (-(-width // hs)) * (hs * vs + 2) * self.bps
            return -(-rows // vs) * -(-block // 8)
        return rows * self.row_bytes(width, self.spp if self.planar == 1 else 1)


def _raise(e: Exception):
    raise e


def _floats(count: int):
    """A reader of a ``TIFF_SETGET_C0_FLOAT`` tag of ``count`` values
    (``TIFFReadDirEntryFloatArray``: a rational as ``(float) num / (float)
    den``, 0 for a zero denominator; other types cast to float)."""
    def read(e: _Entry) -> tuple:
        if e.count != count or e.type not in _TYPES:
            raise _EntryError("count")
        if e.type in (5, 10):
            size = 8
            at = e.pos if size * count <= (8 if e.big else 4) else \
                struct.unpack_from(e.order + ("Q" if e.big else "I"), e.data, e.pos)[0]
            if at + size * count > len(e.data):
                raise _EntryError("io")
            raw = struct.unpack_from(e.order + ("ii" if e.type == 10 else "II") * count,
                                     e.data, at)
            return tuple(np.float32(0.0) if den == 0 else np.float32(num) / np.float32(den)
                         for num, den in zip(raw[::2], raw[1::2]))
        return tuple(np.float32(v) for v in e.values())
    return read


#: TIFFGetFieldDefaulted's WhitePoint: CIE D50 in float arithmetic
_D50 = (np.float32(96.4250), np.float32(100.0), np.float32(82.4680))
_D50_WHITEPOINT = (_D50[0] / (_D50[0] + _D50[1] + _D50[2]), _D50[1] / (_D50[0] + _D50[1] + _D50[2]))


# -- the RGBA read -------------------------------------------------------------------


def _ycbcr_tables(luma, refbw) -> tuple:
    """``TIFFYCbCrToRGBInit``'s tables (float arithmetic as libtiff's, in
    float32): Y, Cr->R, Cb->B, Cr->G, Cb->G."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    rb = [f32(v) for v in refbw]

    def clamp(f, lo, hi):
        return lo if not f >= lo else hi if f > hi else f

    def fix(x):
        return int(np.float64(f32(x) * f32(65536.0)) + 0.5)

    def code2v(c, blk, wht, cr):
        den = f32(wht - blk) if f32(wht - blk) != 0 else f32(1)
        return f32(f32(np.float32(c - int(blk)) * f32(cr)) / den)

    f1 = f32(f32(2) - f32(f32(2) * lr))
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = f32(f32(lr * f1) / lg)
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(f32(2) - f32(f32(2) * lb))
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = f32(f32(lb * f3) / lg)
    d4 = -fix(clamp(f4, f32(0), f32(2)))
    y_tab, crr, cbb, crg, cbg = (np.zeros(256, np.int64) for _ in range(5))
    lo, hi = f32(-128.0 * 32), f32(128.0 * 32)
    for i in range(256):
        x = i - 128
        cr = int(clamp(code2v(x, f32(rb[4] - f32(128)), f32(rb[5] - f32(128)), 127), lo, hi))
        cb = int(clamp(code2v(x, f32(rb[2] - f32(128)), f32(rb[3] - f32(128)), 127), lo, hi))
        crr[i] = (d1 * cr + (1 << 15)) >> 16
        cbb[i] = (d3 * cb + (1 << 15)) >> 16
        crg[i] = d2 * cr
        cbg[i] = d4 * cb + (1 << 15)
        y_tab[i] = int(clamp(code2v(x + 128, rb[0], rb[1], 255), lo, hi))
    return y_tab, crr, cbb, crg, cbg


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tables) -> np.ndarray:
    """``TIFFYCbCrtoRGB`` of uint8 planes: ``[..., 3]`` uint8."""
    y_tab, crr, cbb, crg, cbg = tables
    yy = y_tab[y]
    r = yy + crr[cr]
    g = yy + ((cbg[cb] + crg[cr]) >> 16)
    b = yy + cbb[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _to8(v: np.ndarray) -> np.ndarray:
    """``Bitdepth16To8``."""
    return ((v.astype(np.int64) + 128) // 257).astype(np.int64)


def _premultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """``UaToAa``: ``(v * a + 127) // 255``."""
    return (rgb * a[..., None] + 127) // 255


class _Image:
    """``TIFFRGBAImageOK`` / ``TIFFRGBAImageBegin``'s decisions for one
    directory, then the put routine of each strip or tile."""

    def __init__(self, d: _Directory):
        self.d = d
        self.sgilog = None
        if d.compression in _NOT_CONFIGURED:
            raise _Bad(f"{_NOT_CONFIGURED[d.compression]} compression is not configured in cv2's "
                       "libtiff")
        if d.bps not in (1, 2, 4, 8, 16):
            raise _Bad(f"{d.bps}-bit samples")
        if d.sample_format == 3:
            raise _Bad("floating-point samples")
        photometric = d.photometric
        colorchannels = d.spp - len(d.extra)
        if photometric is None:
            photometric = {1: MINISBLACK, 3: RGB}.get(colorchannels)
            if photometric is None:
                raise _Bad("no Photometric tag")
        if photometric in (MINISWHITE, MINISBLACK, PALETTE):
            if d.planar == 1 and d.spp != 1 and d.bps < 8:
                raise _Bad("contiguous multi-sample data below 8 bits")
        elif photometric == RGB:
            if colorchannels < 3:
                raise _Bad("RGB with fewer than 3 colour channels")
        elif photometric == SEPARATED:
            if d.inkset != 1 or d.spp < 4:
                raise _Bad("separated image that is not CMYK")
        elif photometric == CIELAB:
            if d.spp != 3 or colorchannels != 3 or d.bps not in (8, 16) or d.planar != 1:
                raise _Bad("a CIELab form TIFFRGBAImage cannot handle")
            self.whitepoint = d.whitepoint or _D50_WHITEPOINT
            if self.whitepoint[1] == 0:  # initCIELabConversion
                raise _Bad("CIELab with a WhitePoint y of 0")
        elif photometric in (LOGL, LOGLUV):
            if photometric == LOGL and d.compression != SGILOG or photometric == LOGLUV and (
                    d.compression not in (SGILOG, SGILOG24) or d.planar != 1 or d.spp != 3
                    or colorchannels != 3):
                raise _Bad("LogL / LogLuv data without SGILog compression")
            if photometric == LOGL and d.spp != 1:  # LogL16InitState
                raise _Bad("LogL with more than one sample per pixel")
            # TIFFRGBAImageBegin asks the codec for 8-bit data (its
            # SGILOGDATAFMT_8BIT sets BitsPerSample 8): LogL as 8-bit gray,
            # LogLuv as 8-bit RGB
            self.sgilog = 0 if photometric == LOGL else 1 if d.compression == SGILOG else 2
            d.bps, d.sample_format = 8, 1
            photometric = MINISBLACK if photometric == LOGL else RGB
        elif photometric != YCBCR:
            raise _Bad(f"photometric {photometric}")
        alpha = 0
        if d.extra:
            if d.extra[0] == 0 and d.spp > 3:
                alpha = ASSOCALPHA
            elif d.extra[0] in (ASSOCALPHA, UNASSALPHA):
                alpha = d.extra[0]
        elif d.spp == 4 and photometric == RGB:
            alpha = ASSOCALPHA
        if photometric == PALETTE:
            cmap = d.colormap
            if (cmap >= 256).any():
                cmap = cmap >> 8
            self.cmap = (cmap & 0xFF).T.astype(np.uint8)
        self.rgb_jpeg = photometric == YCBCR and d.planar == 1 and d.compression == JPEG
        if self.rgb_jpeg:
            photometric = RGB
        self.photometric, self.alpha = photometric, alpha
        self.contig = not (d.planar == 2 and d.spp > 1)
        bps, spp = d.bps, d.spp
        if self.contig:
            ok = {RGB: bps in (8, 16) and spp >= 3, CIELAB: True,
                  SEPARATED: bps == 8 and spp >= 4,
                  PALETTE: bps in (1, 2, 4, 8),
                  MINISWHITE: bps in (1, 2, 4, 8, 16),
                  MINISBLACK: bps in (1, 2, 4, 8, 16),
                  YCBCR: bps == 8 and spp == 3 and tuple(d.sub) in (
                      (4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))}[photometric]
        else:
            ok = {RGB: bps in (8, 16), MINISWHITE: bps in (8, 16), MINISBLACK: bps in (8, 16),
                  SEPARATED: bps == 8 and spp == 4, CIELAB: False,
                  YCBCR: bps == 8 and spp == 3 and tuple(d.sub) == (1, 1),
                  PALETTE: False}[photometric]
        if not ok:
            raise _Bad("a form TIFFRGBAImage cannot handle")
        if photometric == YCBCR:
            luma = d.luma if d.luma else (0.299, 0.587, 0.114)
            refbw = d.refbw if d.refbw else (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
            luma32 = [np.float32(v) for v in luma]
            if any(np.isnan(v) for v in luma32) or luma32[1] == 0:
                raise _Bad("bad YCbCrCoefficients")
            self.ycbcr = _ycbcr_tables(luma32, refbw)

    def samples(self, buf: np.ndarray, rows: int, width: int, spp: int,
                stride: int | None = None) -> np.ndarray:
        """``[rows, width, spp]`` samples of a buffer whose rows start every
        ``stride`` bytes (whole rows by default; 16-bit in the file's byte
        order, bits MSB first)."""
        d = self.d
        used = -(-width * spp * d.bps // 8)
        stride = used if stride is None else stride
        need = (rows - 1) * stride + used if rows else 0
        if need > buf.size:  # a put routine that drifts past its buffer reads zeros
            buf = np.concatenate([buf, np.zeros(need - buf.size, np.uint8)])
        rows_u8 = np.lib.stride_tricks.as_strided(buf, (rows, used), (stride, 1))
        if d.bps == 16:
            v = np.ascontiguousarray(rows_u8).view(d.order + "u2")
            return v.reshape(rows, width, spp).astype(np.int64)
        if d.bps == 8:
            return rows_u8.reshape(rows, width, spp).astype(np.int64)
        bits = np.unpackbits(rows_u8, axis=1)[:, :width * spp * d.bps]
        v = bits.reshape(rows, -1, d.bps).astype(np.int64) << np.arange(d.bps - 1, -1, -1)
        return v.sum(axis=2).reshape(rows, width, spp)

    def gray(self, v: np.ndarray) -> np.ndarray:
        """``BWmap`` of gray samples: ``[...]`` -> 8-bit gray."""
        d = self.d
        if d.bps == 16:
            v = v >> 8
            rng = 255
        else:
            rng = (1 << d.bps) - 1
        if self.photometric == MINISWHITE:
            return (rng - v) * 255 // rng
        return v * 255 // rng

    def skip_bytes(self, fromskew: int, spp: int) -> int:
        """The bytes the put routine steps over after each row of a tile
        clipped by ``fromskew`` pixels (as libtiff's routines scale it: by
        the samples of an RGB or CMYK pixel, but not of a gray or palette
        pixel, not by the two bytes of a 16-bit gray sample)."""
        d, ph = self.d, self.photometric
        if d.bps < 8:
            return fromskew // (8 // d.bps)
        if ph in (RGB, SEPARATED, CIELAB):
            return fromskew * spp * (d.bps // 8)
        return fromskew

    def put_contig(self, buf: np.ndarray, rows: int, width: int, fromskew: int = 0) -> np.ndarray:
        """The RGB ``[rows, width, 3]`` of one contig strip or tile buffer
        whose rows are ``width + fromskew`` pixels, as the put routines of
        ``PickContigCase`` step through it."""
        d, ph = self.d, self.photometric
        if ph == YCBCR:
            hs, vs = d.sub
            size = hs * vs + 2
            bw, bh = -(-width // hs), -(-rows // vs)
            # putcontig8bitYCbCr44tile steps over 10 bytes per skipped block
            skip = (fromskew // hs) * (10 if (hs, vs) == (4, 4) else size)
            stride = bw * size + skip
            need = (bh - 1) * stride + bw * size
            if need > buf.size:
                buf = np.concatenate([buf, np.zeros(need - buf.size, np.uint8)])
            blocks = np.lib.stride_tricks.as_strided(buf, (bh, bw, size), (stride, size, 1))
            y = blocks[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3)
            y = y.reshape(bh * vs, bw * hs)[:rows, :width]
            cb = np.repeat(np.repeat(blocks[..., -2], vs, 0), hs, 1)[:rows, :width]
            cr = np.repeat(np.repeat(blocks[..., -1], vs, 0), hs, 1)[:rows, :width]
            return _ycbcr_to_rgb(y, cb, cr, self.ycbcr)
        spp = 3 if self.rgb_jpeg else d.spp
        used = -(-width * spp * d.bps // 8)
        v = self.samples(buf, rows, width, spp, used + self.skip_bytes(fromskew, spp))
        if ph in (MINISWHITE, MINISBLACK):
            g = self.gray(v[..., 0])
            return np.repeat(g[..., None], 3, axis=2).astype(np.uint8)
        if ph == PALETTE:
            return self.cmap[v[..., 0]]
        if ph == CIELAB:
            return tiff_cielab(v[..., :3], d.bps, self.whitepoint)
        if ph == SEPARATED:
            k = 255 - v[..., 3:4]
            return (k * (255 - v[..., :3]) // 255).astype(np.uint8)
        rgb = v[..., :3]
        if d.bps == 16:
            rgb = _to8(rgb)
            if self.alpha == UNASSALPHA:
                rgb = _premultiply(rgb, _to8(v[..., 3]))
        elif self.alpha == UNASSALPHA and spp >= 4:
            rgb = _premultiply(rgb, v[..., 3])
        return rgb.astype(np.uint8)

    def put_separate(self, planes: list, rows: int, width: int) -> np.ndarray:
        """The RGB of one strip or tile's planes (each a buffer of one sample
        per pixel)."""
        d, ph = self.d, self.photometric
        p = [self.samples(b, rows, width, 1)[..., 0] for b in planes]
        if ph == YCBCR:
            return _ycbcr_to_rgb(p[0], p[1], p[2], self.ycbcr)
        if ph == SEPARATED:
            k = 255 - p[3]
            return np.stack([k * (255 - c) // 255 for c in p[:3]], axis=-1).astype(np.uint8)
        colour = [p[0]] * 3 if ph in (MINISWHITE, MINISBLACK) else p[:3]
        rgb = np.stack(colour, axis=-1)
        if d.bps == 16:
            rgb = _to8(rgb)
        if self.alpha == UNASSALPHA:
            a = p[len(colour) if ph == RGB else 1]
            rgb = _premultiply(rgb, _to8(a) if d.bps == 16 else a)
        return rgb.astype(np.uint8)

    def planes_read(self) -> int:
        """The planes gtStripSeparate / gtTileSeparate read."""
        if self.photometric == SEPARATED:
            return 4
        colour = 1 if self.photometric in (MINISWHITE, MINISBLACK) else 3
        return colour + (1 if self.alpha else 0)


# -- the codecs ----------------------------------------------------------------------

_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _inflate(raw: bytes, size: int) -> tuple[np.ndarray, bool]:
    """``ZIPDecode``: ``size`` bytes inflated (zeros after where it stops)
    and whether libtiff reports an error (data corrupt or short)."""
    out = np.zeros(size, np.uint8)
    z = zlib.decompressobj()
    try:
        got = z.decompress(raw, size)
        ok = True
    except zlib.error:
        # the output before the error, one input byte at a time
        z, parts, n, ok = zlib.decompressobj(), [], 0, False
        try:
            for i in range(len(raw)):
                part = z.decompress(raw[i:i + 1], size - n)
                parts.append(part)
                n += len(part)
                if n >= size:
                    break
        except zlib.error:
            pass
        got = b"".join(parts)
    out[:len(got)] = np.frombuffer(got, np.uint8)
    return out, not ok or len(got) < size


def _predict(buf: np.ndarray, rows: int, row_bytes: int, stride: int, bps: int,
             order: str) -> None:
    """Undo horizontal differencing (``horAcc8`` / ``horAcc16``) in place."""
    if bps == 8:
        a = buf[:rows * row_bytes].reshape(rows, -1, stride)
        np.cumsum(a, axis=1, dtype=np.uint8, out=a)
    else:
        v = buf[:rows * row_bytes].view(order + "u2").reshape(rows, -1, stride)
        v[...] = np.cumsum(v.astype(np.uint64), axis=1).astype(np.uint16)


class _Reader:
    """The strips or tiles of one image, decoded as ``TIFFReadEncodedStrip``
    / ``TIFFReadTile`` give them."""

    def __init__(self, d: _Directory, img: _Image, path: str, mapped: bool):
        self.d, self.img, self.path = d, img, path
        # libtiff uses a mapped file's bytes where they need no bit reversal,
        # else reads them into its raw buffer, grown in steps of 1 KiB
        self.direct = mapped and d.fillorder == 1
        self.mapped = mapped
        self.raw_buffer = 0
        self.fax = None
        if d.compression in (LZW, DEFLATE, DEFLATE_OLD) and d.predictor != 1:
            if d.predictor == 2:
                if d.bps not in (8, 16, 32, 64):
                    raise _Bad(f"horizontal predictor with {d.bps}-bit samples")
            elif d.predictor == 3:
                raise _Bad("floating-point predictor on integer samples")
            else:
                raise _Bad(f"predictor {d.predictor}")
        if d.compression in (CCITTRLE, CCITTFAX3, CCITTFAX4, CCITTRLEW) and d.bps != 1:
            raise _Bad("CCITT compression of samples that are not 1-bit")
        if d.compression == THUNDERSCAN and d.bps != 4:
            raise _Bad("ThunderScan data that is not 4-bit")
        if d.compression == NEXT:  # NeXTPreDecode takes 2-bit samples only, which cv2 refuses
            raise _Bad("NeXT data")
        if d.compression in (SGILOG, SGILOG24) and img.sgilog is None:  # LogLuvSetupDecode
            raise _Bad("SGILog data of a photometric that is not LogL / LogLuv")

    def raw(self, index: int) -> bytes:
        """The strip or tile's bytes (``TIFFFillStrip``: past the end of the
        data, the read fails)."""
        d = self.d
        off, count = d.offsets[index], d.counts[index]
        if count == 0:
            raise _Bad(f"strip or tile {index} of 0 bytes")
        if count > 1 << 20:  # TIFFFillStrip / TIFFFillTile limit an absurd count
            full = (d.strip_size(d.tile[1], d.tile[0]) if d.tiled
                    else d.strip_size(min(d.rps, d.height)))
            if full and (count - 4096) // 10 > full:
                count = full * 10 + 4096
        if off + count > len(d.data):
            raise _Bad(f"strip or tile {index} lies past the end of the data")
        raw = d.data[off:off + count]
        if d.fillorder == 2 and d.compression != JPEG:  # tif_jpeg.c sets TIFF_NOBITREV
            raw = raw.translate(_REVERSE)
        return raw

    def decode(self, index: int, size: int, rows: int, width: int, spp: int,
               first: bool = True) -> np.ndarray:
        """``size`` decoded bytes of strip or tile ``index`` (``rows`` rows of
        ``width`` pixels of ``spp`` samples; ``first``: the read that
        allocates the buffer, whose failure fails the read)."""
        d = self.d
        raw = self.raw(index)
        c = d.compression
        if d.tiled and first:  # _TIFFReadEncodedTileAndAllocBuffer's checks
            count = len(raw)
            if not self.direct:
                self.raw_buffer = max(self.raw_buffer, -(-count // 1024) * 1024)
                count = self.raw_buffer
            if c == NONE and count != size:
                raise _Bad(f"uncompressed tile {index} of {d.counts[index]} bytes, not {size}")
            alloc = size * (1 if self.img.contig else self.img.planes_read())
            if c != NONE and alloc > 100 * 1000 * 1000 and count < size // 1000:
                raise _Bad(f"tile {index} of {len(raw)} bytes for {size} decoded")
        failed = False
        if c == NONE:
            out = np.zeros(size, np.uint8)
            if len(raw) >= size:
                out[:] = np.frombuffer(raw[:size], np.uint8)
        elif c in (LZW, PACKBITS):
            out, failed = tiff_codec("lzw" if c == LZW else "packbits", raw, size)
        elif c in (DEFLATE, DEFLATE_OLD):
            out, failed = _inflate(raw, size)
        elif c == JPEG:
            out = self._jpeg(raw, index, size, rows, width)
        elif c in (CCITTRLE, CCITTFAX3, CCITTFAX4, CCITTRLEW):
            # a mapped strip is read where it lies in the file (the CCITT
            # codec reverses FillOrder 2's bits itself), a read one from the
            # start of libtiff's aligned raw buffer
            parity = d.offsets[index] & 1 if self.mapped else 0
            if self.fax is None:
                self.fax = FaxState(width, c == CCITTFAX4 or (c == CCITTFAX3 and d.t4 & 1))
            out, failed = tiff_fax(c, d.t4, raw, rows, width, size, parity, self.fax)
        elif c == THUNDERSCAN:
            out, failed = tiff_thunder(raw, rows, d.width, size)
        elif c in (SGILOG, SGILOG24):
            out, failed = tiff_sgilog(self.img.sgilog, raw, rows, width, size)
        else:  # a code libtiff does not know: no decoder, the strip stays zero
            out = np.zeros(size, np.uint8)
        if not failed and d.predictor == 2 and c in (LZW, DEFLATE, DEFLATE_OLD):
            row_bytes = d.row_bytes(width, spp)
            _predict(out, size // row_bytes, row_bytes, spp, d.bps, d.order)
        return out

    def _jpeg(self, raw: bytes, index: int, size: int, rows: int, width: int) -> np.ndarray:
        """tif_jpeg.c's JPEGPreDecode, whose failures fail the read (the
        stream's header, its components, precision and sampling against the
        directory's, its size against the strip or tile's), then JPEGDecode:
        each scanline at the start of a row of the strip or tile, as many as
        both hold."""
        d, img = self.d, self.img
        out = np.zeros(size, np.uint8)
        try:
            pixels, (h_samp, v_samp), nc = decode_tiff_jpeg(d.jpeg_tables, raw, img.rgb_jpeg)
        except ValueError as e:
            raise _Bad(f"JPEG strip or tile: {e}") from None
        jh, jw = pixels.shape[:2]
        if nc != (d.spp if d.planar == 1 else 1) or d.bps != 8:
            raise _Bad("JPEG strip or tile whose components or precision differ")
        expect = tuple(d.sub) if img.rgb_jpeg else (1, 1)
        if (h_samp, v_samp) != expect:
            raise _Bad("JPEG strip or tile with improper sampling factors")
        last_strip = not d.tiled and jw == width and index % d.per_plane == d.per_plane - 1
        if (jw > width or jh > rows) and not last_strip:
            raise _Bad("JPEG strip or tile larger than expected")
        # each JPEG scanline at the start of a TIFF row (bytesperline)
        flat = pixels.reshape(jh, -1)
        n = min(rows, jh)
        out.reshape(rows, -1)[:n, :flat.shape[1]] = flat[:n]
        return out


# -- cv2's read ----------------------------------------------------------------------


def _gray(rgb: np.ndarray) -> np.ndarray:
    """imgcodecs' ``icvCvt_BGRA2Gray_8u_C4C1R``: 14-bit weights."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


def decode_tiff(data: bytes, mode: str = "color", path: str = "<bytes>",
                imread: bool = True) -> np.ndarray:
    """TIFF / BigTIFF bytes -> RGB ``[H, W, 3]`` (``"color"``) or
    ``[H, W]`` (``"gray"``) uint8, as ``cv2.imread`` reads the first image
    of the file (``imread=False``: as ``cv2.imdecode`` reads the bytes);
    raises ``ValueError`` where cv2 returns None."""
    try:
        d = _Directory(data)
    except _Bad as e:
        raise ValueError(f"{path}: {e}") from None
    # cv2's readHeader
    if d.photometric is None:
        raise ValueError(f"{path}: TIFF without a Photometric tag")
    if d.bps not in (1, 8, 10, 12, 14, 16, 32, 64) and not (d.bps == 4 and
                                                           d.photometric == PALETTE):
        raise ValueError(f"{path}: {d.bps}-bit TIFF samples (cv2 reads 1, 8, 10-16, 32, 64; "
                         "4 in a palette)")
    if d.bps in (1, 8, 10, 12, 14, 16) and d.sample_format not in (1, 2):
        raise ValueError(f"{path}: sample format {d.sample_format} at {d.bps} bits")
    check_size(d.width, d.height, path)
    # cv2's readData, 8-bit
    if d.orientation >= 5 and imread:
        raise ValueError(f"{path}: TIFF orientation {d.orientation} (cv2.imread returns None)")
    if d.tiled:
        tw, th = d.tile
    else:
        tw, th = d.width, d.rps
        if th == 0xFFFFFFFF:
            th = d.height
    if not (0 < tw <= 1 << 24 and 0 < th <= 1 << 24) or d.spp > 4 or \
            tw * th * d.spp * max(1, d.bps // 8) >= 1 << 30 or tw * th * 4 >= 1 << 30:
        raise ValueError(f"{path}: TIFF strip or tile geometry cv2 refuses (its RGBA buffer "
                         "holds under 1 GiB)")
    try:
        img = _Image(d)
        reader = _Reader(d, img, path, mapped=imread)
        rgb = _read(d, img, reader)
    except _Bad as e:
        raise ValueError(f"{path}: {e}") from None
    if d.orientation >= 5:  # cv2.imdecode turns the image as EXIF's orientation would
        undo = {5: 1, 6: 2, 7: 3, 8: 4}[d.orientation]
        rgb = apply_orientation(apply_orientation(rgb, undo), d.orientation)
    rgb = np.ascontiguousarray(rgb)
    return _gray(rgb) if mode == "gray" else rgb


def _read(d: _Directory, img: _Image, reader: _Reader) -> np.ndarray:
    """The image's RGB as cv2 assembles it strip by strip or tile by tile:
    stored rows, each tile mirrored in place where the orientation mirrors
    (libtiff mirrors each RGBA raster it returns), then the rows flipped
    where it flips them (cv2's own order of the rasters)."""
    h, w = d.height, d.width
    out = np.zeros((h, w, 3), np.uint8)
    mirror = d.orientation in (2, 3, 6, 7)
    if d.tiled:
        tw, th = d.tile
        across = -(-w // tw)
        boxes = [(r * th, c * tw, r * across + c, th, tw) for r in range(-(-h // th))
                 for c in range(across)]
    else:
        rps = min(d.rps, h)
        boxes = [(s * rps, 0, s, d._rows(s), w) for s in range(d.per_plane)]
    for y0, x0, index, rows, width in boxes:
        ys, xs = min(rows, h - y0), min(width, w - x0)
        if img.contig:
            spp = 3 if img.rgb_jpeg else d.spp
            if img.rgb_jpeg:
                size = rows * width * 3
            elif d.ycbcr_subsampled() and not d.tiled:
                size = d.strip_size(-(-rows // d.sub[1]) * d.sub[1], width)
            else:
                size = d.strip_size(rows, width)
            buf = reader.decode(index, size, rows, width, spp)
            rgb = img.put_contig(buf, ys, xs, width - xs)
        else:
            planes = []
            size = rows * d.row_bytes(width, 1)
            for p in range(img.planes_read()):
                try:
                    planes.append(reader.decode(p * d.per_plane + index, size, rows, width, 1,
                                                first=p == 0))
                except _Bad:
                    if p == 0:
                        raise
                    planes.append(np.zeros(size, np.uint8))
            rgb = img.put_separate(planes, rows, width)[:ys, :xs]
        out[y0:y0 + ys, x0:x0 + xs] = rgb[:, ::-1] if mirror else rgb
    if d.orientation in (3, 4, 7, 8):
        out = out[::-1]
    return out


def encode_tiff(pixels: np.ndarray) -> bytes:
    """TIFF bytes of uint8 ``[H, W, C]`` (C 1: gray, 3: RGB)."""
    h, w, c = pixels.shape
    row_bytes = w * c
    rows_per_strip = max(1, min(h, 8192 // row_bytes))
    rows = np.ascontiguousarray(pixels).reshape(h, row_bytes)
    strips = [tiff_lzw_encode(rows[y:y + rows_per_strip], c)
              for y in range(0, h, rows_per_strip)]
    offsets = np.cumsum([8] + [len(s) for s in strips[:-1]])
    end = 8 + sum(len(s) for s in strips)
    ifd = end + (end & 1)
    n_tags = 12
    extra_at = ifd + 2 + 12 * n_tags + 4
    extra = bytearray()

    def entry(tag: int, kind: int, values) -> bytes:
        fmt = "<%d%s" % (len(values), "H" if kind == 3 else "I")
        raw = struct.pack(fmt, *values)
        if len(raw) <= 4:
            return struct.pack("<HHI", tag, kind, len(values)) + raw.ljust(4, b"\0")
        at = extra_at + len(extra)
        extra.extend(raw)
        return struct.pack("<HHII", tag, kind, len(values), at)

    # the out-of-line values go in libtiff's order: 258, 279, 273, 339
    bits = entry(258, 3, [8] * c)
    counts = entry(279, 4, [len(s) for s in strips])
    offs = entry(273, 4, [int(o) for o in offsets])
    formats = entry(339, 3, [1] * c)
    entries = [entry(256, 3 if w < 65536 else 4, [w]), entry(257, 3 if h < 65536 else 4, [h]),
               bits, entry(259, 3, [5]), entry(262, 3, [1 if c == 1 else 2]), offs,
               entry(277, 3, [c]), entry(278, 3, [rows_per_strip]), counts,
               entry(284, 3, [1]), entry(317, 3, [2]), formats]
    return (b"II*\x00" + struct.pack("<I", ifd) + b"".join(strips) + bytes(ifd - end)
            + struct.pack("<H", n_tags) + b"".join(entries) + struct.pack("<I", 0)
            + bytes(extra))
