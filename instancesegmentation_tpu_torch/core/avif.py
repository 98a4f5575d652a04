"""AVIF still images as ``cv2.imread`` and ``cv2.imdecode`` read them (cv2 5.0,
its bundled libavif 1.4.2 over libaom 3.14.1), bit for bit: the HEIF boxes
and cv2's conversion here, the AV1 bit stream in ``ops/native/av1.cpp``.

``decode_avif(data, mode)`` gives RGB uint8 ``[H, W, 3]`` (``"color"``) or
``[H, W]`` (``"gray"``), or raises ``ValueError`` where cv2 returns None.
What libavif and cv2 do, in order (ROADMAP "not port faults" 24):

- the top-level boxes up to ``ftyp`` and the ``meta`` its ``avif`` brand
  needs (later boxes are not read); in ``meta``: ``hdlr`` first (``pict``),
  ``pitm``, ``iloc`` (versions 0-2, construction methods 0 and 1, the
  latter from ``idat``), ``iinf`` / ``infe`` (versions 2 and 3), ``iref``
  and ``iprp`` (``ipco``, then ``ipma`` with its essential flags), each
  checked as libavif checks it; box sizes 0 (to the end) and 1 (64-bit);
- the primary ``av01`` item with ``av1C`` and ``ispe``, and its alpha item
  (an ``auxl`` reference with the alpha URN in ``auxC``); an unknown
  property marked essential drops its item (``clap``, ``irot``, ``imir``,
  ``a1op`` and ``lsel`` must be marked essential, ``a1lx`` must not);
  ``irot``, ``imir``, ``clap`` and EXIF orientation are, as cv2 leaves
  them, not applied, but the EXIF and XMP items that describe the image
  are read and checked;
- the colour item's AV1 stream decoded, then the alpha item's (so a broken
  alpha stream fails the read; its values are then dropped);
- cv2's conversion: where ``av1C`` says monochrome, the Y plane (gray;
  three equal channels in colour); otherwise libavif's
  ``avifImageYUVToRGB`` into BGR: the identity matrix (cv2's lossless
  files) as G = Y, B = U, R = V; BT.601 / unspecified, BT.709, BT.2020
  and chroma-derived matrices through libyuv's fixed-point rows (full or
  limited range), 4:2:0 chroma upsampled by libyuv's bilinear filter, 4:2:2
  chroma by its linear filter along each row; gray is
  ``cvtColor(BGR2GRAY)`` of the colour read.

The colour description comes from the ``colr`` ``nclx`` box, else the AV1
sequence header.  ``UnsupportedImage`` naming ROADMAP A10 part 3, step 6b
for the forms left out, each of which cv2 decodes: 10 and 12 bits,
superres, film grain, ``grid`` and other derived items, sequences, an
``ispe`` other than the frame's sides (libavif scales the frame), matrices
libavif converts in floating point.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import cvtcolor_gray
from instancesegmentation_tpu_torch.core.png import UnsupportedImage
from instancesegmentation_tpu_torch.ops.native.av1 import Av1Image, decode_av1

#: the ISO-BMFF brands that libavif (cv2's AVIF decoder) takes
BRANDS = (b"avif", b"avis")
_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
_STEP = "ROADMAP A10 part 3, step 6b"


def is_avif(data: bytes) -> bool:
    """An ISO-BMFF file whose leading ``ftyp`` box names ``avif`` or
    ``avis`` as its major brand or among its compatible brands, the test
    libavif's parse applies first."""
    if len(data) < 16 or data[4:8] != b"ftyp":
        return False
    size = struct.unpack(">I", data[:4])[0]
    if size < 16 or size % 4:
        return False
    box = data[8:min(size, len(data))]
    brands = [box[:4]] + [box[i:i + 4] for i in range(8, len(box) - 3, 4)]
    return any(b in BRANDS for b in brands)


class _Reader:
    def __init__(self, b: bytes, path: str):
        self.b, self.o, self.path = b, 0, path

    def need(self, n: int) -> None:
        if self.o + n > len(self.b):
            raise ValueError(f"{self.path}: AVIF: box truncated")

    def u(self, n: int) -> int:
        self.need(n)
        v = int.from_bytes(self.b[self.o:self.o + n], "big")
        self.o += n
        return v

    def raw(self, n: int) -> bytes:
        self.need(n)
        v = self.b[self.o:self.o + n]
        self.o += n
        return v

    def string(self) -> bytes:
        end = self.b.find(b"\0", self.o)
        if end < 0:
            raise ValueError(f"{self.path}: AVIF: unterminated string")
        v = self.b[self.o:end]
        self.o = end + 1
        return v


def _header(b: bytes, o: int, end: int, path: str, top: bool = False) -> tuple:
    """(type, payload start, payload end) of the box at ``o``, as libavif's
    ``avifROStreamReadBoxHeader`` reads it (size 1: 64-bit; size 0: to the
    end, at the top level only; ``uuid``: 16 more bytes); the payload may
    run past ``end`` only at the top level, where the caller checks it."""
    if end - o < 8:
        raise ValueError(f"{path}: AVIF: box header truncated")
    size, kind = struct.unpack(">I4s", b[o:o + 8])
    head = 8
    if size == 1:
        if end - o < 16:
            raise ValueError(f"{path}: AVIF: box header truncated")
        size = struct.unpack(">Q", b[o + 8:o + 16])[0]
        head = 16
    if kind == b"uuid":
        if end - o < head + 16:
            raise ValueError(f"{path}: AVIF: box header truncated")
        head += 16
    if size == 0:
        if not top:
            raise ValueError(f"{path}: AVIF: box {kind!r} of size 0 inside a box")
        size = end - o
    if size < head:
        raise ValueError(f"{path}: AVIF: box {kind!r} smaller than its header")
    if not top and size > end - o:
        raise ValueError(f"{path}: AVIF: box {kind!r} past its parent")
    return kind, o + head, o + size


def _children(b: bytes, o: int, end: int, path: str):
    """(type, payload) of each box from ``o`` to ``end``."""
    while o < end:
        kind, start, stop = _header(b, o, end, path)
        yield kind, b[start:stop]
        o = stop


@dataclass
class _Item:
    id: int
    type: bytes = b""
    method: int = 0
    extents: list = field(default_factory=list)
    props: list = field(default_factory=list)  # (kind, parsed value or bytes)
    unsupported_essential: bool = False
    ipma_seen: bool = False
    aux_for: int = 0
    thumb_for: int = 0
    desc_for: int = 0
    content_type: bytes = b""

    @property
    def size(self) -> int:
        return sum(ln for _, ln in self.extents)

    def prop(self, kind: bytes):
        return next((v for k, v in self.props if k == kind), None)


def _full(r: _Reader, version: Optional[int] = None) -> tuple:
    v = r.u(1)
    flags = r.u(3)
    if version is not None and v != version:
        raise ValueError(f"{r.path}: AVIF: box version {v}")
    return v, flags


def _iloc(p: bytes, path: str, meta: "_Meta") -> None:
    r = _Reader(p, path)
    version, _ = _full(r)
    if version > 2:
        raise ValueError(f"{path}: AVIF: iloc version {version}")
    a = r.u(1)
    off_size, len_size = a >> 4, a & 15
    a = r.u(1)
    base_size, index_size = a >> 4, (a & 15) if version in (1, 2) else 0
    if any(v not in (0, 4, 8) for v in (off_size, len_size, base_size, index_size)):
        raise ValueError(f"{path}: AVIF: iloc field size")
    count = r.u(2) if version < 2 else r.u(4)
    for _ in range(count):
        iid = r.u(2) if version < 2 else r.u(4)
        if iid == 0:
            raise ValueError(f"{path}: AVIF: iloc item ID 0")
        it = meta.item(iid)
        if it.extents:
            raise ValueError(f"{path}: AVIF: item {iid} located twice")
        if version in (1, 2):
            it.method = r.u(2) & 15
            if it.method not in (0, 1):  # libavif: item construction unsupported
                raise ValueError(f"{path}: AVIF: construction method {it.method}")
        r.u(2)  # data_reference_index
        base = r.u(base_size)
        for _ in range(r.u(2)):
            # libavif reads no extent_index, whatever index_size says
            off = base + r.u(off_size)
            it.extents.append((off, r.u(len_size)))


def _infe(p: bytes, path: str, meta: "_Meta") -> None:
    r = _Reader(p, path)
    version, _ = _full(r)
    if version not in (2, 3):
        raise ValueError(f"{path}: AVIF: infe version {version}")
    iid = r.u(2) if version == 2 else r.u(4)
    if iid == 0:
        raise ValueError(f"{path}: AVIF: infe item ID 0")
    r.u(2)  # item_protection_index
    kind = r.raw(4)
    r.string()  # item_name
    it = meta.item(iid)
    if kind == b"mime":
        it.content_type = r.string()
    it.type = kind


def _iinf(p: bytes, path: str, meta: "_Meta") -> None:
    r = _Reader(p, path)
    version, _ = _full(r)
    if version > 1:
        raise ValueError(f"{path}: AVIF: iinf version {version}")
    count = r.u(2) if version == 0 else r.u(4)
    o = r.o
    for _ in range(count):
        kind, start, stop = _header(p, o, len(p), path)
        if kind != b"infe":
            raise ValueError(f"{path}: AVIF: iinf holds a {kind!r} box")
        _infe(p[start:stop], path, meta)
        o = stop


def _iref(p: bytes, path: str, meta: "_Meta") -> None:
    r = _Reader(p, path)
    version, _ = _full(r)
    if version > 1:
        raise ValueError(f"{path}: AVIF: iref version {version}")
    for kind, q in _children(p, r.o, len(p), path):
        s = _Reader(q, path)
        frm = s.u(2) if version == 0 else s.u(4)
        for _ in range(s.u(2)):
            to = s.u(2) if version == 0 else s.u(4)
            if frm and to:
                if kind == b"auxl":
                    meta.item(frm).aux_for = to
                elif kind == b"thmb":
                    meta.item(frm).thumb_for = to
                elif kind == b"cdsc":
                    meta.item(frm).desc_for = to


def _property(kind: bytes, q: bytes, path: str):
    """The parsed value of the properties libavif reads (else None)."""
    r = _Reader(q, path)
    if kind == b"ispe":
        _full(r, 0)
        return r.u(4), r.u(4)
    if kind == b"pixi":
        _full(r, 0)
        n = r.u(1)
        if not 1 <= n <= 4:
            raise ValueError(f"{path}: AVIF: pixi plane count {n}")
        depths = [r.u(1) for _ in range(n)]
        if len(set(depths)) != 1:
            raise ValueError(f"{path}: AVIF: pixi depths differ")
        return depths
    if kind == b"av1C":
        a = r.u(1)
        if a != 0x81:  # marker 1, version 1
            raise ValueError(f"{path}: AVIF: av1C marker or version")
        r.u(1)
        a = r.u(1)
        r.u(1)
        depth = 12 if a & 0x20 else 10 if a & 0x40 else 8
        return depth, bool(a & 0x10)
    if kind == b"colr":
        ctype = r.raw(4)
        if ctype == b"nclx":
            cp, tc, mc = r.u(2), r.u(2), r.u(2)
            a = r.u(1)
            if a & 0x7F:
                raise ValueError(f"{path}: AVIF: colr reserved bits")
            return b"nclx", (cp, tc, mc, bool(a >> 7))
        return ctype, None
    if kind == b"auxC":
        _full(r, 0)
        return r.string()
    if kind in (b"irot", b"imir", b"clap", b"pasp", b"clli", b"a1op", b"lsel", b"a1lx"):
        return q
    return None


#: the properties libavif parses; an unknown one marked essential makes
#: libavif skip its item
_KNOWN = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir", b"pixi", b"a1op",
          b"lsel", b"a1lx", b"clli")
#: the properties libavif wants marked essential (``a1lx`` must not be)
_ESSENTIAL = (b"a1op", b"lsel", b"clap", b"irot", b"imir")


def _iprp(p: bytes, path: str, meta: "_Meta") -> None:
    props = None
    for n, (kind, q) in enumerate(_children(p, 0, len(p), path)):
        if n == 0:
            if kind != b"ipco":
                raise ValueError(f"{path}: AVIF: iprp does not start with ipco")
            props = [(k, _property(k, v, path) if k in _KNOWN else None) for k, v in
                     _children(q, 0, len(q), path)]
        elif kind == b"ipma":
            r = _Reader(q, path)
            version, flags = _full(r)
            prev = 0
            for _ in range(r.u(4)):
                iid = r.u(2) if version < 1 else r.u(4)
                if iid == 0 or iid <= prev:
                    raise ValueError(f"{path}: AVIF: ipma item IDs out of order")
                prev = iid
                it = meta.item(iid)
                if it.ipma_seen:
                    raise ValueError(f"{path}: AVIF: item {iid} associated twice")
                it.ipma_seen = True
                for _ in range(r.u(1)):
                    a = r.u(2) if flags & 1 else r.u(1)
                    bits = 15 if flags & 1 else 7
                    essential, idx = a >> bits, a & ((1 << bits) - 1)
                    if idx == 0:
                        continue
                    if idx > len(props):
                        raise ValueError(f"{path}: AVIF: property index {idx} past ipco")
                    kind, value = props[idx - 1]
                    if kind in _KNOWN:
                        if essential != (kind in _ESSENTIAL) and kind in _ESSENTIAL + (b"a1lx",):
                            raise ValueError(f"{path}: AVIF: {kind!r} marked essential wrongly")
                        it.props.append((kind, value))
                    elif essential:
                        it.unsupported_essential = True


@dataclass
class _Meta:
    items: dict = field(default_factory=dict)
    primary: int = 0
    idat: bytes = b""

    def item(self, iid: int) -> _Item:
        return self.items.setdefault(iid, _Item(iid))


def _meta(p: bytes, path: str) -> _Meta:
    meta = _Meta()
    r = _Reader(p, path)
    _full(r, 0)
    seen = set()
    first = True
    for kind, q in _children(p, r.o, len(p), path):
        if first:
            if kind != b"hdlr":
                raise ValueError(f"{path}: AVIF: meta does not start with hdlr")
            h = _Reader(q, path)
            _full(h, 0)
            if h.u(4) != 0 or h.raw(4) != b"pict":
                raise ValueError(f"{path}: AVIF: hdlr is not pict")
            h.raw(12)
            h.string()
            first = False
            continue
        if kind in (b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref"):
            if kind in seen:
                raise ValueError(f"{path}: AVIF: second {kind!r} box")
            seen.add(kind)
        if kind == b"iloc":
            _iloc(q, path, meta)
        elif kind == b"pitm":
            s = _Reader(q, path)
            v, _ = _full(s)
            meta.primary = s.u(2) if v == 0 else s.u(4)
        elif kind == b"idat":
            meta.idat = q
        elif kind == b"iprp":
            _iprp(q, path, meta)
        elif kind == b"iinf":
            _iinf(q, path, meta)
        elif kind == b"iref":
            _iref(q, path, meta)
    if first:
        raise ValueError(f"{path}: AVIF: empty meta box")
    return meta


def _parse(data: bytes, path: str) -> _Meta:
    """The ``meta`` box as libavif's ``avifParse`` reaches it through the
    top-level boxes: it stops once it has ``ftyp`` and the ``meta`` (brand
    ``avif``) or ``moov`` (brand ``avis``) it needs, so boxes after those
    are not read.  A sequence (major brand ``avis``) is step 6b's."""
    o = 0
    ftyp = None
    meta = None
    moov = False
    need_meta = need_moov = False
    while True:
        if o > len(data):
            raise ValueError(f"{path}: AVIF: box past the data")
        if o == len(data):
            break
        kind, start, stop = _header(data, o, len(data), path, top=True)
        if kind in (b"ftyp", b"meta", b"moov") and stop > len(data):
            raise ValueError(f"{path}: AVIF: {kind!r} box truncated")
        if kind == b"ftyp":
            if ftyp is not None or (stop - start) < 8 or (stop - start - 8) % 4:
                raise ValueError(f"{path}: AVIF: bad ftyp box")
            q = data[start:stop]
            brands = [q[:4]] + [q[i:i + 4] for i in range(8, len(q), 4)]
            if not any(b in BRANDS for b in brands):
                raise ValueError(f"{path}: AVIF: ftyp names neither avif nor avis")
            ftyp = q[:4]
            need_meta, need_moov = b"avif" in brands, b"avis" in brands
        elif kind == b"meta":
            if meta is not None:
                raise ValueError(f"{path}: AVIF: second meta box")
            meta = _meta(data[start:stop], path)
        elif kind == b"moov":
            moov = True
        o = stop
        if ftyp is not None and (not need_meta or meta is not None) and (not need_moov or moov):
            break
    if ftyp is None or (need_meta and meta is None) or (need_moov and not moov):
        raise ValueError(f"{path}: AVIF: no ftyp, or the meta or moov box its brands need")
    if ftyp == b"avis" or meta is None:
        raise UnsupportedImage(f"{path}: AVIF: image sequence ({_STEP})")
    return meta


def _item_data(meta: _Meta, data: bytes, it: _Item, path: str) -> bytes:
    src = meta.idat if it.method == 1 else data
    chunks = []
    for off, ln in it.extents:
        if off > len(src) or ln > len(src) - off:
            raise ValueError(f"{path}: AVIF: item {it.id} extent past the data")
        chunks.append(src[off:off + ln])
    return b"".join(chunks)


def _metadata(meta: _Meta, data: bytes, color: _Item, path: str) -> None:
    """libavif's ``avifDecoderFindMetadata``: the EXIF and XMP items that
    describe the colour item are read (their extents must lie in the data)
    and an EXIF item's TIFF header offset must point at its TIFF header."""
    for it in meta.items.values():
        if not it.size or it.unsupported_essential or it.desc_for != color.id:
            continue
        if it.type == b"Exif":
            exif = _item_data(meta, data, it, path)
            if len(exif) < 4:
                raise ValueError(f"{path}: AVIF: EXIF item too short")
            body = exif[4:]
            found = next((i for i in range(len(body) - 4)
                          if body[i:i + 4] in (b"MM\x00*", b"II*\x00")), None)
            if found is None or found != struct.unpack(">I", exif[:4])[0]:
                raise ValueError(f"{path}: AVIF: EXIF item without its TIFF header")
        elif it.type == b"mime" and it.content_type == b"application/rdf+xml":
            _item_data(meta, data, it, path)


def _find_items(meta: _Meta, path: str) -> tuple:
    """(colour item, alpha item or None) as libavif finds them."""
    if not meta.primary:
        raise ValueError(f"{path}: AVIF: no pitm box")
    color = None
    for it in meta.items.values():
        if not it.size or it.unsupported_essential or it.type not in (b"av01", b"grid"):
            continue
        if it.thumb_for or it.id != meta.primary:
            continue
        color = it
        break
    if color is None:
        raise ValueError(f"{path}: AVIF: no primary image item")
    if color.type == b"grid":
        raise UnsupportedImage(f"{path}: AVIF: grid item ({_STEP})")
    alpha = None
    for it in meta.items.values():
        if not it.size or it.unsupported_essential or it.type not in (b"av01", b"grid"):
            continue
        if it.aux_for == color.id and it.prop(b"auxC") in _ALPHA_URNS:
            alpha = it
            break
    if alpha is not None and alpha.type == b"grid":
        raise UnsupportedImage(f"{path}: AVIF: grid alpha item ({_STEP})")
    # as libavif decides by file: every other AV1 item needs ispe, the
    # colour and alpha items av1C (and pixi, if any, at av1C's depth)
    for it in meta.items.values():
        if (it.size and not it.unsupported_essential and it.type == b"av01" and it is not alpha
                and it.prop(b"ispe") is None):
            raise ValueError(f"{path}: AVIF: item {it.id} lacks ispe")
    for it in (color, alpha):
        if it is None:
            continue
        if it.prop(b"av1C") is None:
            raise ValueError(f"{path}: AVIF: item {it.id} lacks av1C")
        pixi = it.prop(b"pixi")
        if pixi is not None and pixi[0] != it.prop(b"av1C")[0]:
            raise ValueError(f"{path}: AVIF: pixi depth differs from av1C's")
    return color, alpha


#: libyuv's YUV to RGB constants (YG, YB, UB, UG, VG, VR) by (matrix, full
#: range); libyuv caps UB at 128 (its SIMD rows multiply by a signed byte)
_LIBYUV = {
    ("601", True): (16320, 32, 113, 22, 46, 90),
    ("601", False): (18997, -1160, 128, 25, 52, 102),
    ("709", True): (16320, 32, 119, 12, 30, 101),
    ("709", False): (18997, -1160, 128, 14, 34, 115),
    ("2020", True): (16320, 32, 120, 11, 37, 94),
    ("2020", False): (19003, -1160, 128, 12, 42, 107),
}
#: the matrix coefficients libavif hands to libyuv: BT.709, unspecified,
#: BT.470BG, BT.601, BT.2020 NCL, and chroma-derived NCL by its primaries
_MATRIX = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}
_DERIVED = {1: "709", 2: "709", 5: "601", 6: "601", 9: "2020"}


def _upsample_linear(c: np.ndarray, w: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any: each row of ``c`` to ``w`` columns
    (the rows of ``I422ToRGB24MatrixFilter``'s linear filter)."""
    c = c.astype(np.int32)
    out = np.empty((c.shape[0], w), np.int32)
    out[:, 0] = c[:, 0]
    work = (w - 1) & ~1
    if work > 0:
        a, b = c[:, :work // 2], c[:, 1:work // 2 + 1]
        out[:, 1:work + 1:2] = (a * 3 + b + 2) >> 2
        out[:, 2:work + 2:2] = (a + b * 3 + 2) >> 2
    out[:, w - 1] = c[:, (w - 1) // 2]
    return out


def _upsample_420(c: np.ndarray, w: int, h: int) -> np.ndarray:
    """libyuv's I420 to 4:4:4 bilinear rows (``I420ToRGB24MatrixFilter``):
    the first row (and the last, for an even height) linear from one chroma
    row, each other pair of rows 9:3:3:1 from two."""
    c = c.astype(np.int32)
    out = np.empty((h, w), np.int32)
    lin = _upsample_linear(c, w)
    out[0] = lin[0]
    pairs = len(range(0, h - 2, 2))
    if pairs:
        work = (w - 1) & ~1
        s, t = c[:pairs], c[1:pairs + 1]
        da, db = np.empty((pairs, w), np.int32), np.empty((pairs, w), np.int32)
        da[:, 0] = (3 * s[:, 0] + t[:, 0] + 2) >> 2
        db[:, 0] = (s[:, 0] + 3 * t[:, 0] + 2) >> 2
        if work > 0:
            s0, s1 = s[:, :work // 2], s[:, 1:work // 2 + 1]
            t0, t1 = t[:, :work // 2], t[:, 1:work // 2 + 1]
            da[:, 1:work + 1:2] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4
            da[:, 2:work + 2:2] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4
            db[:, 1:work + 1:2] = (s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4
            db[:, 2:work + 2:2] = (s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4
        k = (w - 1) // 2
        da[:, w - 1] = (3 * s[:, k] + t[:, k] + 2) >> 2
        db[:, w - 1] = (s[:, k] + 3 * t[:, k] + 2) >> 2
        out[1:2 * pairs + 1:2] = da
        out[2:2 * pairs + 2:2] = db
    if not (h & 1):
        out[h - 1] = lin[(h - 1) // 2]
    return out


#: matrices libavif converts with its own floating-point rows (not ported)
_FLOAT_MATRICES = (4, 7, 12, 15)


def _yuv_to_rgb(img: Av1Image, cicp: tuple, path: str) -> np.ndarray:
    """libavif's ``avifImageYUVToRGB`` of an 8-bit image into RGB (a 4:0:0
    frame as Y with neutral chroma)."""
    cp, _, mc, full = cicp
    h, w = img.y.shape
    if img.mono:
        u = v = np.full((h, w), 128, np.uint8)
        ssx = ssy = 0
    else:
        u, v, ssx, ssy = img.u, img.v, img.ssx, img.ssy
    if mc == 0:
        if ssx or ssy:
            raise ValueError(f"{path}: AVIF: identity matrix with subsampled chroma")
        if not full:
            raise UnsupportedImage(f"{path}: AVIF: limited-range identity matrix ({_STEP})")
        return np.stack([v, img.y, u], axis=-1)
    name = _DERIVED.get(cp) if mc == 12 else _MATRIX.get(mc)
    if name is None:
        if mc in _FLOAT_MATRICES or (mc == 8 and full):
            raise UnsupportedImage(f"{path}: AVIF: matrix coefficients {mc} ({_STEP})")
        raise ValueError(f"{path}: AVIF: matrix coefficients {mc} libavif does not convert")
    yg, yb, ub, ug, vg, vr = _LIBYUV[(name, full)]
    if ssx and ssy:
        u, v = _upsample_420(u, w, h), _upsample_420(v, w, h)
    elif ssx:
        u, v = _upsample_linear(u, w), _upsample_linear(v, w)
    else:
        u, v = u.astype(np.int32), v.astype(np.int32)
    y1 = ((img.y.astype(np.int64) * 0x0101 * yg) >> 16).astype(np.int32)
    b = y1 + (u - 128) * ub + yb
    g = y1 - (u - 128) * ug - (v - 128) * vg + yb
    r = y1 + (v - 128) * vr + yb
    return np.clip(np.stack([r, g, b], axis=-1) >> 6, 0, 255).astype(np.uint8)


def _decode_item(meta: _Meta, data: bytes, it: _Item, size: tuple, path: str) -> Av1Image:
    w, h = size
    img = decode_av1(_item_data(meta, data, it, path), path, it.prop(b"av1C")[0])
    if (img.width, img.height) != (w, h):
        raise UnsupportedImage(f"{path}: AVIF: frame {img.width}x{img.height} scaled to its ispe "
                               f"{w}x{h} ({_STEP})")
    return img


def decode_avif(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    meta = _parse(data, path)
    color, alpha = _find_items(meta, path)
    _metadata(meta, data, color, path)
    w, h = color.prop(b"ispe")
    # libavif's default limits (32768 a side, 16384 x 16384 pixels) refuse
    # before cv2's own size check could raise
    if not (0 < w <= 32768 and 0 < h <= 32768 and w * h <= 16384 * 16384):
        raise ValueError(f"{path}: AVIF: image size {w} x {h}")
    # cv2 takes one channel (the Y plane) where av1C says monochrome
    mono = color.prop(b"av1C")[1]
    if mono and alpha is not None:
        raise ValueError(f"{path}: AVIF: cv2 reads no gray image with alpha")
    img = _decode_item(meta, data, color, (w, h), path)
    if alpha is not None:
        _decode_item(meta, data, alpha, alpha.prop(b"ispe") or (w, h), path)
    if mono:
        return img.y.copy() if mode == "gray" else np.repeat(img.y[..., None], 3, axis=-1)
    nclx = next((v[1] for k, v in color.props if k == b"colr" and v[0] == b"nclx"), None)
    cicp = nclx or (img.primaries, img.transfer, img.matrix, img.full_range)
    rgb = _yuv_to_rgb(img, cicp, path)
    if mode == "gray":
        return cvtcolor_gray(rgb[..., ::-1])
    return rgb
