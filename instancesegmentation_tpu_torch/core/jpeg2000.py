"""JPEG 2000 as ``cv2.imread`` and ``cv2.imdecode`` read it (cv2 5.0 and its
bundled OpenJPEG 2.5.3), bit for bit: the JP2 boxes and cv2's conversion
here, the codestream in ``ops/native/jpeg2000.cpp``.

``decode_jpeg2000(data, mode)`` gives RGB uint8 ``[H, W, 3]`` (``"color"``)
or ``[H, W]`` (``"gray"``), or raises ``ValueError`` where cv2 returns None.
What cv2 does, in order:

- ``readHeader``: OpenJPEG's ``opj_read_header``.  A file that starts with
  the 12-byte signature box is read as JP2: its top-level boxes in turn
  (``jP  `` first, ``ftyp`` second, ``jp2h`` with ``ihdr`` (exactly 14
  bytes; the first one counts), ``colr`` (the first one: method 1 an
  enumerated space, 2 an ICC profile, others ignored), ``bpcc``, ``pclr``,
  ``cmap`` and ``cdef``, each checked as OpenJPEG checks it; a header box
  met outside ``jp2h`` is read once ``jp2h`` was, unknown boxes skipped;
  box lengths 0 (to the end) and 1 (64-bit, high word 0)), up to ``jp2c``,
  whose codestream runs to the end of the data; ``FF 4F FF 51`` is a raw
  codestream.  Then the codestream's main header (its SIZ sides must equal
  ``ihdr``'s).  A signed component, or a greatest precision below 8, gives
  None;
- cv2's ``validateInputImageSize`` raises ``ImageSizeError`` on the sides;
- ``readData``: OpenJPEG's ``opj_decode`` (the codestream, then for JP2 the
  channel checks, the palette of ``pclr`` + ``cmap`` (indices clamped to
  the palette; a ``pclr`` without ``cmap`` ignored), then ``cdef``'s
  channel order), then cv2's rules: the colour space is ``colr``'s
  enumerated space, sRGB (16) as is, gray (17) replicated in colour, sYCC
  (18) through ``cvtColor(YUV2BGR)`` of the first three components, any other or none
  "SRGB is assumed" (so a raw one-component codestream gives None in
  colour), eYCC (24) and CMYK (12) None; every component must have
  ``dx = dy = 1``, origin 0 and the image's sides (so an image or tile
  offset, or subsampled components, give None); samples are shifted right
  by the greatest header precision less 8 and cut to 8 bits; colour takes
  the first three components as R, G, B; gray is the first component of a
  file of one or two, else ``cvtColor(BGR2GRAY)`` of the colour read.

``imread`` and ``imdecode`` read JPEG 2000 alike.

``encode_jpeg2000(image)`` writes what ``cv2.imwrite`` writes for ``.jp2``,
byte for byte: cv2 hands OpenJPEG 2.5.3 the BGR(A) image as R, G, B(, A)
components (gray as one), with one quality layer at rate 4
(``IMWRITE_JPEG2000_COMPRESSION_X1000`` 250), so photographs are cut by
the rate allocation.  The file is the signature box, ``ftyp`` (``jp2 ``),
``jp2h`` with ``ihdr`` and ``colr`` (enumerated: 17 gray, 16 sRGB), and
for four components ``cdef`` (the fourth an alpha channel of the whole
image), then ``jp2c`` with the codestream of ``ops/native/jpeg2000_enc.cpp``.
A side under 32 is refused (None); ``cv2.imwrite`` has then written the
boxes before ``jp2c`` (``jp2_header_boxes``).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import cvtcolor_gray
from instancesegmentation_tpu_torch.core.pnm import check_size
from instancesegmentation_tpu_torch.ops.native.jpeg2000 import (
    DEFAULT_X1000,
    decode_codestream,
    encode_codestream,
    read_header,
)

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
SIGNATURES = (JP2_SIGNATURE, J2K_SIGNATURE)

_SIG, _FTYP, _HEADER = 0x1, 0x2, 0x4
_TOP = (b"jP  ", b"ftyp", b"jp2h")
_IMG = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")
#: OpenJPEG's colour spaces as cv2 reads them
_SRGB, _GRAY, _SYCC, _OTHER = "srgb", "gray", "sycc", "other"


def _be(b: bytes, o: int, n: int) -> int:
    return int.from_bytes(b[o:o + n], "big")


@dataclass
class _JP2:
    """What OpenJPEG keeps of a JP2 file's boxes."""
    state: int = 0
    ihdr: Optional[tuple] = None  # (h, w, numcomps, bpc)
    has_colr: bool = False
    enumcs: int = 0
    pclr: Optional[dict] = None
    cmap: Optional[list] = None
    cdef: Optional[list] = None


def _jp(jp2: _JP2, p: bytes, path: str) -> None:
    if jp2.state != 0:
        raise ValueError(f"{path}: The signature box must be the first box in the file")
    if len(p) != 4 or _be(p, 0, 4) != 0x0D0A870A:
        raise ValueError(f"{path}: Error with JP signature Box")
    jp2.state |= _SIG


def _ftyp(jp2: _JP2, p: bytes, path: str) -> None:
    if jp2.state != _SIG:
        raise ValueError(f"{path}: The ftyp box must be the second box in the file")
    if len(p) < 8 or (len(p) - 8) % 4:
        raise ValueError(f"{path}: Error with FTYP signature Box size")
    jp2.state |= _FTYP


def _ihdr(jp2: _JP2, p: bytes, path: str) -> None:
    if jp2.ihdr is not None:
        return  # the first ihdr box counts
    if len(p) != 14:
        raise ValueError(f"{path}: Bad image header box (bad size)")
    h, w, nc = _be(p, 0, 4), _be(p, 4, 4), _be(p, 8, 2)
    if not 1 <= nc <= 16384:
        raise ValueError(f"{path}: Invalid number of components (ihdr)")
    jp2.ihdr = (h, w, nc, p[10])


def _colr(jp2: _JP2, p: bytes, path: str) -> None:
    if len(p) < 3:
        raise ValueError(f"{path}: Bad COLR header box (bad size)")
    if jp2.has_colr:
        return  # only the first colour specification counts
    meth = p[0]
    if meth == 1:
        if len(p) < 7:
            raise ValueError(f"{path}: Bad COLR header box (bad size)")
        jp2.enumcs = _be(p, 3, 4)
        jp2.has_colr = True
    elif meth == 2:
        jp2.has_colr = True


def _bpcc(jp2: _JP2, p: bytes, path: str) -> None:
    if len(p) != (jp2.ihdr[2] if jp2.ihdr else 0):
        raise ValueError(f"{path}: Bad BPCC header box (bad size)")


def _pclr(jp2: _JP2, p: bytes, path: str) -> None:
    if jp2.pclr is not None or len(p) < 3:
        raise ValueError(f"{path}: bad PCLR box")
    entries, channels = _be(p, 0, 2), p[2]
    if not 1 <= entries <= 1024:
        raise ValueError(f"{path}: Invalid PCLR box. Reports {entries} entries")
    if channels == 0 or len(p) < 3 + channels:
        raise ValueError(f"{path}: Invalid PCLR box")
    sizes = [(b & 0x7F) + 1 for b in p[3:3 + channels]]
    nbytes = [min(4, (s + 7) >> 3) for s in sizes]
    if 3 + channels + entries * sum(nbytes) > len(p):
        raise ValueError(f"{path}: PCLR box cut short")
    table = np.zeros((entries, channels), np.int64)
    o = 3 + channels
    for j in range(entries):
        for i in range(channels):
            table[j, i] = _be(p, o, nbytes[i])
            o += nbytes[i]
    jp2.pclr = {"table": table, "sizes": sizes}


def _cmap(jp2: _JP2, p: bytes, path: str) -> None:
    if jp2.pclr is None:
        raise ValueError(f"{path}: Need to read a PCLR box before the CMAP box")
    if jp2.cmap is not None:
        raise ValueError(f"{path}: Only one CMAP box is allowed")
    n = len(jp2.pclr["sizes"])
    if len(p) < 4 * n:
        raise ValueError(f"{path}: Insufficient data for CMAP box")
    jp2.cmap = [(_be(p, 4 * i, 2), p[4 * i + 2], p[4 * i + 3]) for i in range(n)]


def _cdef(jp2: _JP2, p: bytes, path: str) -> None:
    if jp2.cdef is not None or len(p) < 2:
        raise ValueError(f"{path}: bad CDEF box")
    n = _be(p, 0, 2)
    if n == 0 or len(p) < 2 + 6 * n:
        raise ValueError(f"{path}: bad CDEF box")
    jp2.cdef = [tuple(_be(p, 2 + 6 * i + 2 * k, 2) for k in range(3)) for i in range(n)]


_HANDLERS = {b"jP  ": _jp, b"ftyp": _ftyp, b"ihdr": _ihdr, b"colr": _colr, b"bpcc": _bpcc,
             b"pclr": _pclr, b"cmap": _cmap, b"cdef": _cdef}


def _jp2h(jp2: _JP2, p: bytes, path: str) -> None:
    if not jp2.state & _FTYP:
        raise ValueError(f"{path}: The jp2h box must follow the ftyp box")
    has_ihdr, o = False, 0
    while o < len(p):
        size = len(p) - o
        if size < 8:
            raise ValueError(f"{path}: Cannot handle box of less than 8 bytes")
        length, typ, hdr = _be(p, o, 4), p[o + 4:o + 8], 8
        if length == 1:
            if size < 16 or _be(p, o + 8, 4):
                raise ValueError(f"{path}: bad XL box in jp2h")
            length, hdr = _be(p, o + 12, 4), 16
        if length == 0 or length < hdr or length > size:
            raise ValueError(f"{path}: Stream error while reading JP2 Header box")
        if typ in _IMG:
            _HANDLERS[typ](jp2, p[o + hdr:o + length], path)
        has_ihdr |= typ == b"ihdr"
        o += length
    if not has_ihdr:
        raise ValueError(f"{path}: Stream error while reading JP2 Header box: no 'ihdr' box")
    jp2.state |= _HEADER


def _read_boxes(data: bytes, path: str) -> tuple:
    """OpenJPEG's ``opj_jp2_read_header_procedure``: (the JP2 facts, the
    offset of the codestream)."""
    jp2, pos, n = _JP2(), 0, len(data)
    while True:
        if n - pos < 8:
            pos = n
            break
        length, typ, hdr = _be(data, pos, 4), data[pos + 4:pos + 8], 8
        if length == 0:
            length = n - pos
        elif length == 1:
            if n - pos < 16 or _be(data, pos + 8, 4):
                # the header read fails: the box reading stops there, and the
                # codestream is read from where the stream stands
                pos = min(n, pos + 16)
                break
            length, hdr = _be(data, pos + 12, 4), 16
        pos += hdr
        if typ == b"jp2c":
            if not jp2.state & _HEADER:
                raise ValueError(f"{path}: bad placed jpeg codestream")
            return jp2, pos
        if length == 0:
            raise ValueError(f"{path}: Cannot handle box of undefined sizes")
        if length < hdr:
            raise ValueError(f"{path}: invalid box size")
        size = length - hdr
        if typ in _TOP or typ in _IMG:
            if typ not in _TOP and not jp2.state & _HEADER:
                if size > n - pos:
                    raise ValueError(f"{path}: Problem with skipping JPEG2000 box")
                pos += size
                continue
            if size > n - pos:
                raise ValueError(f"{path}: Invalid box size for box {typ!r}")
            payload = data[pos:pos + size]
            pos += size
            (_jp2h if typ == b"jp2h" else _HANDLERS[typ])(jp2, payload, path)
        else:
            if not jp2.state & _SIG:
                raise ValueError(f"{path}: first box must be JPEG 2000 signature box")
            if not jp2.state & _FTYP:
                raise ValueError(f"{path}: second box must be file type box")
            if size > n - pos:
                raise ValueError(f"{path}: Problem with skipping JPEG2000 box")
            pos += size
    if not jp2.state & _HEADER or jp2.ihdr is None:
        raise ValueError(f"{path}: JP2H or IHDR box missing")
    return jp2, pos


def _check_color(jp2: _JP2, numcomps: int, path: str) -> None:
    """OpenJPEG's ``opj_jp2_check_color``."""
    pclr = jp2.pclr if jp2.pclr is not None and jp2.cmap is not None else None
    if jp2.cdef is not None:
        nr = len(pclr["sizes"]) if pclr else numcomps
        for cn, _, asoc in jp2.cdef:
            if cn >= nr or (asoc not in (0, 65535) and asoc - 1 >= nr):
                raise ValueError(f"{path}: Invalid component index in cdef")
        if not set(range(nr)) <= {cn for cn, _, _ in jp2.cdef}:
            raise ValueError(f"{path}: Incomplete channel definitions")
    if pclr:
        nr = len(pclr["sizes"])
        sane, used = True, [False] * nr
        for i, (cmp, mtyp, pcol) in enumerate(jp2.cmap):
            if cmp >= numcomps:
                sane = False
            if mtyp not in (0, 1) or pcol >= nr or (used[pcol] and mtyp == 1) or \
                    (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        for i in range(nr):
            if not used[i] and jp2.cmap[i][1] != 0:
                sane = False
        if sane and numcomps == 1 and not all(used):
            jp2.cmap = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(jp2.cmap)]
        if not sane:
            raise ValueError(f"{path}: bad component mapping (cmap)")


def _apply_pclr(jp2: _JP2, planes: list) -> list:
    """OpenJPEG's ``opj_jp2_apply_pclr``: the palette's channels."""
    table = jp2.pclr["table"].astype(np.uint32).view(np.int32)  # entries read as uint32
    top = len(table) - 1
    out = []
    for i, (cmp, mtyp, pcol) in enumerate(jp2.cmap):
        src = planes[cmp]
        if mtyp == 0:
            out.append(src.copy())
        else:
            out.append(table[np.clip(src, 0, top), pcol])
    return out


def _apply_cdef(jp2: _JP2, planes: list) -> list:
    """OpenJPEG's ``opj_jp2_apply_cdef``: a colour channel associated with
    another channel's place is swapped into it."""
    planes, info = list(planes), [list(e) for e in jp2.cdef]
    n = len(planes)
    for i, (cn, typ, asoc) in enumerate(info):
        if cn >= n or asoc in (0, 65535):
            continue
        acn = asoc - 1
        if acn >= n:
            continue
        if cn != acn and typ == 0:
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for later in info[i + 1:]:
                if later[0] == cn:
                    later[0] = acn
                elif later[0] == acn:
                    later[0] = cn
    return planes


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(COLOR_YUV2BGR)`` of uint8 planes (14-bit fixed
    point), as RGB."""
    y, u, v = (a.astype(np.int32) for a in (y, u, v))
    u, v = u - 128, v - 128
    r = y + ((v * 18678 + (1 << 13)) >> 14)
    g = y + ((u * -6472 + v * -9519 + (1 << 13)) >> 14)
    b = y + ((u * 33292 + (1 << 13)) >> 14)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg2000(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    if data.startswith(J2K_SIGNATURE):
        jp2, start, ihdr_wh = None, 0, (0, 0)
    else:
        jp2, start = _read_boxes(data, path)
        ihdr_wh = (jp2.ihdr[1], jp2.ihdr[0])
    codestream = data[start:]
    header = read_header(codestream, ihdr_wh, path)
    if any(c.sgnd for c in header.comps):
        raise ValueError(f"{path}: OpenJPEG2000: a component is signed")
    max_prec = max(c.prec for c in header.comps)
    if max_prec < 8:
        raise ValueError(f"{path}: OpenJPEG2000: Precision < 8 not supported")
    width, height = header.x1 - header.x0, header.y1 - header.y0
    check_size(width, height, path)
    planes = decode_codestream(codestream, header, ihdr_wh, path)
    comps = list(header.comps)
    space = _SRGB
    if jp2 is not None:
        _check_color(jp2, len(planes), path)
        space = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _OTHER, 12: _OTHER}.get(jp2.enumcs, _SRGB)
        if jp2.pclr is not None and jp2.cmap is not None:
            comps = [comps[cmp] for cmp, _, _ in jp2.cmap]
            planes = _apply_pclr(jp2, planes)
        if jp2.cdef is not None:
            order = _apply_cdef(jp2, list(range(len(planes))))
            planes, comps = [planes[i] for i in order], [comps[i] for i in order]
    if space == _OTHER:
        raise ValueError(f"{path}: OpenJPEG2000: Unsupported color space conversion")
    for c in comps:
        if (c.dx, c.dy, c.x0, c.y0, c.w, c.h) != (1, 1, 0, 0, width, height):
            raise ValueError(f"{path}: OpenJPEG2000: tiles are not supported (a component's "
                             "origin, sides or sampling differ from the image's)")
    shift = max_prec - 8

    def eight(i: int) -> np.ndarray:
        return ((planes[i] >> shift) & 0xFF).astype(np.uint8)

    n = len(planes)
    if space == _GRAY:
        g = eight(0)
        return g if mode == "gray" else np.repeat(g[..., None], 3, axis=2)
    if space == _SYCC:
        if mode == "gray":
            return eight(0)
        if n < 3:
            raise ValueError(f"{path}: OpenJPEG2000: unsupported conversion for YUV image")
        return _yuv_to_rgb(eight(0), eight(1), eight(2))
    if mode == "gray" and n <= 2:
        return eight(0)
    if n < 3:
        raise ValueError(f"{path}: OpenJPEG2000: unsupported conversion from {n} components to 3 "
                         "for SRGB image decoding")
    rgb = np.stack([eight(0), eight(1), eight(2)], -1)
    return cvtcolor_gray(rgb[..., ::-1]) if mode == "gray" else rgb


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _planes(image: np.ndarray) -> np.ndarray:
    """``image`` as uint8 ``[C, H, W]`` components, C 1, 3 or 4."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_jpeg2000 takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in (1, 3, 4) or 0 in a.shape:
        raise ValueError(f"encode_jpeg2000 takes [H, W], [H, W, 1], [H, W, 3] or [H, W, 4], "
                         f"got {a.shape}")
    return np.ascontiguousarray(a.transpose(2, 0, 1))


def _header_boxes(n: int, h: int, w: int) -> bytes:
    header = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, n, 7, 7, 0, 0))
    header += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 17 if n == 1 else 16))
    if n == 4:
        header += _box(b"cdef", struct.pack(">H", 4) + b"".join(
            struct.pack(">HHH", i, 0, i + 1) for i in range(3)) + struct.pack(">HHH", 3, 1, 0))
    return (JP2_SIGNATURE + _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
            + _box(b"jp2h", header))


def jp2_header_boxes(image: np.ndarray) -> bytes:
    """The boxes OpenJPEG writes ahead of ``jp2c`` for ``image``: what
    ``cv2.imwrite`` leaves in a ``.jp2`` file whose image it refuses."""
    return _header_boxes(*_planes(image).shape)


def _encode_jp2(image: np.ndarray, x1000: int) -> Optional[bytes]:
    planes = _planes(image)
    boxes = _header_boxes(*planes.shape)
    codestream = encode_codestream(planes, len(boxes) + 8, x1000)
    if codestream is None:
        return None
    return boxes + _box(b"jp2c", codestream)


def encode_jpeg2000(image: np.ndarray) -> Optional[bytes]:
    """The ``.jp2`` bytes ``cv2.imwrite`` writes for the BGR(A) counterpart
    of uint8 RGB ``[H, W, 3]``, RGBA ``[H, W, 4]`` or gray ``[H, W]`` /
    ``[H, W, 1]``, or None where cv2 refuses the image (a side under 32)."""
    return _encode_jp2(image, DEFAULT_X1000)
