"""The port's small image decoders (``core/pnm.py``, ``core/sunras.py``,
``core/hdr.py``, ``core/gif.py`` and RLE BMP in ``core/bmp.py``, the codes
of ``ops/native/image_codes.cpp``) against cv2 (the JAX package's reader,
CPU), on seeded files written here field by field: every pixel equal in
both read modes, ``imread`` against ``cv2.imread`` and ``imdecode`` against
``cv2.imdecode``; ``FileNotFoundError`` exactly where cv2 returns None and
``ImageSizeError`` where cv2 raises.

- PNM P1-P6 (ASCII and binary, comments, maxvals 1-65535, 16-bit), PAM
  (every TUPLTYPE, depths 1-4, maxval 1's packed bits), PFM (both byte
  orders, scales, ties, NaN and overflow, the imread / imdecode split);
- Sun raster (types 0 and 1, 1 / 8 / 24 / 32 bits, colour maps; types 2
  and 3, which cv2 refuses);
- Radiance HDR (RLE and flat scanlines, header forms, exponents);
- GIF (global and local tables, interlace, transparency, a frame smaller
  than the screen, LZW code sizes 2-11, a full table, several frames);
- BMP RLE8 and RLE4 (runs, absolute runs, end of line, delta, end of
  bitmap, runs that overflow a row);
- cut files and broken headers of each;
- the committed fixtures of ``tests/data/imread/`` against cv2 and the
  port, and the set's completeness.
"""
import glob
import os
import shutil
import struct

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.png import ImageSizeError
from instancesegmentation_tpu_torch.ops.native import build as native_build
from instancesegmentation_tpu_torch.ops.native import image_codes

torch.set_num_threads(1)
MODES = (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE))


def _cv2(call, flag):
    try:
        got = call(flag)
    except cv2.error:
        return "raises"
    if got is None:
        return None
    return got[..., ::-1] if got.ndim == 3 else got


def _port(call, mode):
    try:
        return call(mode)
    except FileNotFoundError:
        return None
    except ImageSizeError:
        return "raises"


def _same(data: bytes, tmp_path=None, valid=None, width=None):
    """The port's ``imdecode`` (and ``imread`` through a file under
    ``tmp_path``) against cv2's in both modes; returns how many decodes
    cv2 gave.  ``width``: compare only the first ``width`` columns of a
    colour decode (cv2 leaves the rest of such rows unwritten).
    ``valid``: whether cv2 must decode the file."""
    pairs = [(lambda f: cv2.imdecode(np.frombuffer(data, np.uint8), f),
              lambda m: imdecode(data, m))]
    if tmp_path is not None:
        path = tmp_path / "image.bin"
        path.write_bytes(data)
        pairs.append((lambda f: cv2.imread(str(path), f), lambda m: imread(str(path), m)))
    decoded = 0
    for ref, port in pairs:
        for mode, flag in MODES:
            want, got = _cv2(ref, flag), _port(port, mode)
            if valid is not None and ref is pairs[0][0]:
                assert (want is not None) == valid, (mode, data[:40])
            if want is None or isinstance(want, str):
                assert got is None if want is None else got == "raises", (mode, data[:60])
                continue
            assert isinstance(got, np.ndarray), (mode, got, data[:60])
            assert got.dtype == np.uint8 and got.shape == want.shape, (mode, got.shape, want.shape)
            if width is not None and mode == "color":
                got, want = got[:, :width], want[:, :width]
            np.testing.assert_array_equal(got, want, err_msg=f"{mode} {data[:40]!r}")
            decoded += 1
    return decoded


# -- PNM ------------------------------------------------------------------------


def _pnm(kind, w, h, maxval, values, sep=b"\n", comment=b""):
    head = b"P%d\n%s%d %d\n" % (kind, comment, w, h)
    if kind not in (1, 4):
        head += b"%d%s" % (maxval, sep)
    if kind in (1, 2, 3):
        return head + b" ".join(b"%d" % v for v in np.ravel(values)) + b"\n"
    if kind == 4:
        return head + np.packbits(values, axis=1).tobytes()
    return head + np.asarray(values).astype(">u2" if maxval > 255 else np.uint8).tobytes()


@pytest.mark.parametrize("kind,maxval", [(1, 1), (4, 1)] + [(k, m) for k in (2, 3, 5, 6)
                                                         for m in (1, 100, 255, 1000, 65535)])
def test_pnm_forms(kind, maxval, tmp_path):
    """P1 and P4 (no maxval), the others at maxvals 1-65535."""
    rng = np.random.default_rng(kind * 7 + maxval)
    for w, h in ((1, 1), (5, 3), (13, 4)):
        shape = (h, w, 3) if kind in (3, 6) else (h, w)
        values = rng.integers(0, maxval + 1, shape)
        if kind in (2, 3) and values.size > 2:
            values.flat[0] = maxval + 7  # above maxval: clipped in ASCII files
        assert _same(_pnm(kind, w, h, maxval, values), tmp_path, valid=True) == 4


def test_pnm_headers_and_cut_files(tmp_path):
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (3, 5))
    good = _pnm(5, 5, 3, 255, gray)
    cases = [
        _pnm(5, 5, 3, 255, gray, comment=b"# a comment\n#\n"),
        b"P5 5 3 255 " + gray.astype(np.uint8).tobytes(),
        b"P5\n5 3\n255\r\n" + gray.astype(np.uint8).tobytes(),   # the \n is data
        b"P2\n3 1\n100\n50 #x\n 100 200 ",
        b"P2\n3 1\n100\n50#x\n 100 200 ",                       # a '#' ending a number
        b"P2\n3 1\n255\n1 2 3",                                  # the last value needs a byte
        b"P1\n3 1\n101", b"P1\n3 1\n2 0 1", b"P1\n3 1\n10 1",
        b"P2\n3 1\n255\n300 -1 2 ",
        b"P5\n2 1\n0\n\x01\x02", b"P5\n2 1\n65536\n\x00\x01\x00\x02",
        b"P5\n2 1\n99999999999\n\x01\x02", b"P5\n0 1\n255\n\x01", b"P5\n2 1\n255",
        b"P6\n2 1\n255\n\x01\x02\x03\x04\x05", b"P3\nx", b"P4\n9 2\n\xff\x80\x00",
        good[:len(good) - 1], good + b"trailing bytes",
        b"P5\n2000000 1\n255\n\x01",                             # cv2 raises
    ]
    for data in cases:
        _same(data, tmp_path)


# -- PAM ------------------------------------------------------------------------


def _pam(w, h, depth, maxval, tupltype, values, extra=b""):
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n%s" % (w, h, depth, maxval, extra)
    if tupltype:
        head += b"TUPLTYPE " + tupltype + b"\n"
    dtype = ">u2" if maxval > 255 else np.uint8
    return head + b"ENDHDR\n" + np.asarray(values).astype(dtype).tobytes()


@pytest.mark.parametrize("maxval", [1, 100, 255, 1000, 65535])
@pytest.mark.parametrize("tupltype,depth", [(b"BLACKANDWHITE", 1), (b"GRAYSCALE", 1),
                                            (b"GRAYSCALE_ALPHA", 2), (b"RGB", 3),
                                            (b"RGB_ALPHA", 4), (None, 1), (None, 2),
                                            (None, 3), (None, 4)])
def test_pam_forms(tupltype, depth, maxval, tmp_path):
    """Colour decodes of the *_ALPHA forms are held on the pixels cv2
    converts (the first ceil(W / depth)); cv2 leaves the rest unwritten."""
    rng = np.random.default_rng(depth * 31 + maxval)
    for w, h in ((1, 2), (6, 3), (11, 2)):
        values = rng.integers(0, (2 if maxval == 1 else maxval + 1), (h, w, depth))
        if maxval == 1:  # packed bits in each row's first bytes
            values = rng.integers(0, 256, (h, w, depth))
        valid = tupltype is not None or (depth in (1, 3) and maxval < 256)
        prefix = -(-w // depth) if depth in (2, 4) else None
        decoded = _same(_pam(w, h, depth, maxval, tupltype, values), tmp_path,
                        valid=valid if maxval != 1 or tupltype is not None else None, width=prefix)
        assert decoded == (4 if valid else 0) or maxval == 1


def test_pam_headers_and_cut_files(tmp_path):
    px = b"\x05\x06"
    base = b"WIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
    for head in (b"P7\n# hi\n" + base + b"ENDHDR\n", b"P7\nHEIGHT 1\nWIDTH 2\nMAXVAL 255\nDEPTH 1\nENDHDR\n",
                 b"P7\n" + base, b"P7 WIDTH 2 HEIGHT 1 DEPTH 1 MAXVAL 255 ENDHDR\n",
                 b"P7\n  WIDTH   2\t\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
                 b"P7\n" + base + b"ENDHDR\r\n", b"P7\n" + base + b"WIDTH 2\nENDHDR\n",
                 b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 0\nENDHDR\n",
                 b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 0\nMAXVAL 255\nENDHDR\n",
                 b"P7\n" + base + b"FOO 3\nENDHDR\n", b"P7\nWIDTH 2x\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
                 b"P7\n" + base + b"TUPLTYPE RGB\nTUPLTYPE GRAYSCALE\nENDHDR\n",
                 b"P7\n" + base + b"TUPLTYPE FOO\nENDHDR\n",
                 b"P7\n" + base + b"TUPLTYPE BLACKANDWHITE_ALPHA\nENDHDR\n",
                 b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 70000\nENDHDR\n"):
        _same(head + px, tmp_path)
        _same(head + px[:1], tmp_path)


# -- PFM ------------------------------------------------------------------------


def _pfm(values, scale=-1.0, header=None):
    h, w = values.shape[:2]
    kind = b"PF" if values.ndim == 3 else b"Pf"
    order = "<f4" if scale < 0 else ">f4"
    head = header if header is not None else kind + b"\n%d %d\n%r\n" % (w, h, scale)
    return head + values[::-1].astype(order).tobytes()


@pytest.mark.parametrize("scale", [-1.0, 1.0, -3.0, 0.5, -255.0])
@pytest.mark.parametrize("channels", [1, 3])
def test_pfm_values_and_the_mode_split(channels, scale, tmp_path):
    """Values on .5 ties, saturation, NaN, infinities and beyond int32;
    ``imread`` is None where the channels differ from the mode's, and
    ``imdecode`` returns the file's own channels."""
    rng = np.random.default_rng(channels + int(abs(scale) * 10))
    shape = (4, 7, 3) if channels == 3 else (4, 7)
    v = rng.integers(-20, 300, shape).astype(np.float32) * np.float32(abs(scale))
    v += np.where(rng.random(shape) < 0.5, np.float32(0.5 * abs(scale)), 0).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, 1e10, -1e10, 2147483520.0, 2147483648.0, 254.5, 0.51]
    v.flat[:len(special)] = special
    data = _pfm(v, scale)
    decoded = _same(data, tmp_path, valid=True)
    assert decoded == 3  # imdecode in both modes, imread in the file's own mode
    mode = "gray" if channels == 3 else "color"
    with pytest.raises(FileNotFoundError):
        path = tmp_path / "m.pfm"
        path.write_bytes(data)
        imread(str(path), mode)
    assert imdecode(data, mode).shape == shape


def test_pfm_headers_and_cut_files(tmp_path):
    v = np.arange(8, dtype=np.float32).reshape(2, 4) * np.float32(0.7)
    body = v[::-1].astype("<f4").tobytes()
    for head in (b"Pf\n4 2\n-1\n", b"Pf 4 2 -1.0\n", b"Pf\n4 2\n-1.0 ", b"Pf\n4\n2\n-1.0\n",
                 b"Pf\n4 2\n0\n", b"Pf\n4 2\n-1.0e0\n", b"Pf\n4 2\nabc\n", b"Pf\n# c\n4 2\n-1.0\n",
                 b"Pf\n4x 2\n-1.0\n", b"Pf\n-4 2\n-1.0\n", b"Pf\n4  2\n-1.0\n", b"Pf\n4 2\n-1.0\r\n",
                 b"Pf\r\n4 2\n-1.0\n", b"Pf\n4 2\nnan\n", b"Pf\n4 2\n-inf\n", b"Pf\n4 2\n-0x1p1\n",
                 b"Pf\n4 2\n-.25\n", b"Pf\n4 2\n+1\n", b"Pf\n4294967300 2\n-1\n",
                 b"Pf\n99999999999999999999 2\n-1\n"):
        _same(head + body + b"\x00" * 4, tmp_path)
    _same(b"Pf\n4 2\n-1.0\n" + body[:-1], tmp_path, valid=False)


# -- Sun raster -------------------------------------------------------------------


def _ras(w, h, bpp, kind, rows, cmap=b"", maptype=None):
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    body = np.zeros((h, pitch), np.uint8)
    body[:, :rows.shape[1]] = rows
    maptype = (1 if cmap else 0) if maptype is None else maptype
    return (struct.pack(">8I", 0x59A66A95, w, h, bpp, body.size, kind, maptype, len(cmap))
            + cmap + body.tobytes())


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("bpp", [1, 8, 24, 32])
def test_sun_raster_forms(bpp, kind, tmp_path):
    """Types 0 and 1 decode, with and without a colour map where the depth
    takes one; cv2 refuses types 2 and 3 (its header check compares the
    wrong field), and so does the port."""
    rng = np.random.default_rng(bpp * 4 + kind)
    for w in (1, 5, 11):
        rows = rng.integers(0, 256, (3, (w * bpp + 7) // 8), dtype=np.uint8)
        maps = [b""]
        if bpp <= 8:
            n = 1 << bpp
            maps += [rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes(),
                     rng.integers(0, 256, 3 * (n // 2 + 1) - 1, dtype=np.uint8).tobytes()]
        for cmap in maps:
            _same(_ras(w, 3, bpp, kind, rows, cmap), tmp_path, valid=kind in (0, 1))


def test_sun_raster_refusals_and_cut_files(tmp_path):
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    good = _ras(5, 3, 8, 1, rows)
    cases = [good[:-1], good[:31], good + b"more",
             _ras(5, 3, 8, 1, rows, rng.integers(0, 256, 771, dtype=np.uint8).tobytes()),
             _ras(5, 3, 24, 1, rng.integers(0, 256, (3, 15), dtype=np.uint8), b"\x01" * 6),
             _ras(5, 3, 8, 1, rows, maptype=2), _ras(5, 3, 16, 1, rows),
             _ras(5, 3, 8, 4, rows), struct.pack(">8I", 0x59A66A95, 0, 3, 8, 0, 1, 0, 0),
             struct.pack(">8I", 0x59A66A95, 0xFFFFFFFB, 3, 8, 0, 1, 0, 0),
             struct.pack(">8I", 0x59A66A95, 2000000, 1, 8, 0, 1, 0, 0) + bytes(64)]
    for data in cases:
        _same(data, tmp_path)


# -- Radiance HDR -----------------------------------------------------------------

_HDR_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"


def _hdr_rle(rgbe, runs=True):
    """New-style RLE scanlines of RGBE ``[H, W, 4]``: runs of 3 or more as
    runs, the rest as literals of at most 128."""
    out = b""
    h, w = rgbe.shape[:2]
    for row in rgbe:
        out += bytes([2, 2, w >> 8, w & 255])
        for ch in range(4):
            v, i = row[:, ch], 0
            while i < w:
                j = i
                while runs and j < w and v[j] == v[i] and j - i < 127:
                    j += 1
                if j - i >= 3:
                    out += bytes([128 + j - i, v[i]])
                    i = j
                    continue
                k = i
                while k < w and k - i < 128 and not (k + 2 < w and v[k] == v[k + 1] == v[k + 2]
                                                     and runs):
                    k += 1
                k = max(k, i + 1)
                out += bytes([k - i]) + v[i:k].tobytes()
                i = k
    return out


def _rgbe(rng, h, w, lo=120, hi=140):
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(lo, hi, (h, w))
    rgbe[rng.random((h, w)) < 0.1] = 0
    rgbe[:, w // 3:w // 2] = rgbe[:, w // 3:w // 3 + 1]  # runs
    return rgbe


@pytest.mark.parametrize("width", [3, 8, 40, 130])
def test_hdr_scanlines(width, tmp_path):
    """RLE scanlines (width 8-0x7fff), flat ones (below 8, and from a
    scanline that does not start 2, 2), exponents from 0 to 255 (beyond
    int32 after x255: 0), cv2's own files."""
    rng = np.random.default_rng(width)
    head = b"#?RADIANCE\n" + _HDR_FORMAT + b"\n-Y 5 +X %d\n" % width
    rgbe = _rgbe(rng, 5, width)
    flat = rgbe.tobytes()
    cases = [head + flat]
    if width >= 8:
        cases += [head + _hdr_rle(rgbe), head + _hdr_rle(rgbe, runs=False),
                  head + _hdr_rle(rgbe[:2]) + rgbe[2:].tobytes()]
    wide = _rgbe(rng, 5, width, 0, 256)
    cases += [head + (_hdr_rle(wide) if width >= 8 else wide.tobytes())]
    for data in cases:
        assert _same(data, tmp_path, valid=True) == 4
    ok, enc = cv2.imencode(".hdr", rng.random((6, width, 3)).astype(np.float32) * 4)
    assert _same(enc.tobytes(), tmp_path, valid=True) == 4


def test_hdr_headers_and_cut_files(tmp_path):
    rng = np.random.default_rng(9)
    rgbe = _rgbe(rng, 2, 10)
    px = _hdr_rle(rgbe)
    size = b"\n-Y 2 +X 10\n"
    heads = [b"#?RGBE\n" + _HDR_FORMAT + size, b"#?RADIANCE\n# c\nEXPOSURE=2\n" + _HDR_FORMAT
             + b"\n-Y  2  +X 10 junk\n", b"#?RADIANCE\n" + _HDR_FORMAT + b"\n-Y2+X10\n",
             b"#?RADIANCE junk\n" + b"X" * 200 + b"\n" + _HDR_FORMAT + size,
             b"#?RADIANCE\n" + b"Y" * 127 + b"\n" + _HDR_FORMAT + size,   # fgets' 127 bytes
             b"#?RADIANCE\n" + _HDR_FORMAT[:-1] + b"\r\n" + size, b"#?RADIANCE\n" + size,
             b"#?RADIANCE\n" + _HDR_FORMAT + b"\n" + size, b"#?RADIANCE\n" + _HDR_FORMAT + b" \n-Y 2 +X 10\n",
             b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n" + size, b"#?RADIANCE\n" + _HDR_FORMAT + b"\n+Y 2 +X 10\n",
             b"#?RADIANCE\n" + _HDR_FORMAT + b"\n-Y 2 -X 10\n", b"#?RADIANCE\n" + _HDR_FORMAT + b"\n-Y -2 +X 10\n",
             b"#?RADIANCE\n" + _HDR_FORMAT + b"\n-Y 2 +X 2000000\n"]
    for head in heads:
        _same(head + px, tmp_path)
    good = heads[0] + px
    for cut in (len(good) - 1, len(good) - 20, len(heads[0]) + 3, len(heads[0]) - 2):
        _same(good[:cut], tmp_path, valid=False)
    bad = bytearray(good)
    bad[len(heads[0]) + 4] = 0  # a zero count
    _same(bytes(bad), tmp_path, valid=False)
    bad = bytearray(good)
    bad[len(heads[0]) + 3] = 11  # another scanline width
    _same(bytes(bad), tmp_path, valid=False)


# -- GIF --------------------------------------------------------------------------


def _lzw(indices, min_size, clear_first=True, end=True, clear_when_full=True):
    """GIF LZW codes ``[(code, width)]`` of a flat index list."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    table = {(i,): i for i in range(clear)}
    nxt, width, out, w = eoi + 1, min_size + 1, [], ()
    if clear_first:
        out.append((clear, width))
    for k in indices:
        if w + (k,) in table:
            w = w + (k,)
            continue
        out.append((table[w], width))
        if nxt < 4096:
            table[w + (k,)] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        elif clear_when_full:
            out.append((clear, width))
            table = {(i,): i for i in range(clear)}
            nxt, width = eoi + 1, min_size + 1
        w = (k,)
    if w:
        out.append((table[w], width))
    if end:
        out.append((eoi, width))
    return out


def _pack(codes):
    bits = n = 0
    out = bytearray()
    for c, w in codes:
        bits |= c << n
        n += w
        while n >= 8:
            out.append(bits & 255)
            bits >>= 8
            n -= 8
    if n:
        out.append(bits & 255)
    return bytes(out)


def _table(pal):
    if pal is None:
        return 0, b""
    bits = max(1, int(np.ceil(np.log2(len(pal)))))
    t = np.zeros((1 << bits, 3), np.uint8)
    t[:len(pal)] = pal
    return 0x80 | (bits - 1), t.tobytes()


def _gif(screen, frames, gpal=None, bg=0, trailer=True):
    """A GIF of ``frames``: dicts of ``idx [h, w]`` and optional left, top,
    lpal, interlace, transparent, disposal, min_size, lzw (encoder
    options), codes (raw LZW bytes), block (sub-block size)."""
    flags, table = _table(gpal)
    out = b"GIF89a" + struct.pack("<HHBBB", *screen, flags, bg, 0) + table
    for f in frames:
        idx = np.asarray(f["idx"], np.uint8)
        h, w = idx.shape
        if "transparent" in f or "disposal" in f:
            packed = f.get("disposal", 0) << 2 | int("transparent" in f)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, 0, f.get("transparent", 0)) + b"\x00"
        lflags, ltable = _table(f.get("lpal"))
        rows = idx
        if f.get("interlace"):
            lflags |= 0x40
            rows = idx[np.concatenate([np.arange(s, h, d) for s, d in ((0, 8), (4, 8), (2, 4),
                                                                       (1, 2))])]
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), w, h,
                                     lflags) + ltable
        ms = f.get("min_size", 8)
        data = f.get("codes")
        if data is None:
            data = _pack(_lzw(rows.ravel().tolist(), ms, **f.get("lzw", {})))
        size = f.get("block", 255)
        out += bytes([ms]) + b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                                      for i in range(0, len(data), size)) + b"\x00"
    return out + (b"\x3b" if trailer else b"")


@pytest.mark.parametrize("min_size", [2, 3, 5, 8, 11])
def test_gif_code_sizes_and_tables(min_size, tmp_path):
    """Code sizes 2-11 with and without clear codes after a full table,
    global and local tables, interlace, sub-blocks of 1-255 bytes."""
    rng = np.random.default_rng(min_size)
    colours = min(1 << min_size, 256)
    pal = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    big = rng.integers(0, colours, (40, 120), dtype=np.uint8)  # fills the table
    small = rng.integers(0, colours, (9, 13), dtype=np.uint8)
    frames = [dict(idx=big, min_size=min_size), dict(idx=big, min_size=min_size,
                                                     lzw=dict(clear_when_full=False)),
              dict(idx=small, min_size=min_size, interlace=True, block=7),
              dict(idx=small, min_size=min_size, lzw=dict(clear_first=False, end=False))]
    for f in frames:
        screen = f["idx"].shape[::-1]
        for gpal, lpal in ((pal, None), (None, pal), (pal[::-1], pal)):
            assert _same(_gif(screen, [dict(f, lpal=lpal)], gpal=gpal), tmp_path, valid=True) == 4


def test_gif_screen_transparency_and_frames(tmp_path):
    """A frame smaller than the screen on the background colour, the
    transparent index (equal to the background or not), every disposal,
    no global table, several frames, extensions before the image."""
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, (5, 7), dtype=np.uint8)
    part = idx[:3, :4]
    cases = [_gif((7, 5), [dict(idx=idx, min_size=4, transparent=int(idx[0, 0]))], gpal=pal)]
    for disposal in range(4):
        for t in (None, 5, 7):
            fr = dict(idx=part, min_size=4, left=2, top=1, disposal=disposal)
            if t is not None:
                fr["transparent"] = t
            cases += [_gif((7, 5), [fr], gpal=pal, bg=5), _gif((7, 5), [dict(fr, lpal=pal)], bg=3)]
    cases += [_gif((7, 5), [dict(idx=idx, min_size=4)]),                # no table
              _gif((16, 16), [dict(idx=np.arange(256, dtype=np.uint8).reshape(16, 16))]),
              _gif((7, 5), [dict(idx=idx, min_size=4), dict(idx=idx[::-1], min_size=4)], gpal=pal),
              _gif((7, 5), [dict(idx=idx, min_size=4, lpal=pal[:8])], gpal=pal),
              _gif((7, 5), [dict(idx=idx, min_size=4, lpal=pal)], gpal=pal[:8]),
              _gif((7, 5), [dict(idx=idx % 8, min_size=4)], gpal=pal[:8])]
    plain = _gif((7, 5), [dict(idx=idx, min_size=4)], gpal=pal)
    at = plain.index(b"\x2c")
    cases.append(plain[:at] + b"\x21\xfe\x05hello\x00\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
                 + plain[at:])
    for data in cases:
        assert _same(data, tmp_path, valid=True) == 4


def test_gif_refusals_and_cut_files(tmp_path):
    rng = np.random.default_rng(4)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, (5, 7), dtype=np.uint8)
    codes = _lzw(idx.ravel().tolist(), 4)
    bad = list(codes)
    bad[3] = (30, bad[3][1])
    good = _gif((7, 5), [dict(idx=idx, min_size=4)], gpal=pal)
    at = good.index(b"\x2c")
    cases = [good[:cut] for cut in (len(good) - 1, len(good) - 3, len(good) // 2, 20, 12)]
    cases += [
        _gif((7, 5), [dict(idx=idx, min_size=4, codes=_pack(bad))], gpal=pal),
        _gif((7, 5), [dict(idx=idx, min_size=4, codes=b"")], gpal=pal),
        _gif((7, 5), [dict(idx=idx, min_size=4, codes=_pack(_lzw(idx.ravel().tolist()[:20], 4)))],
             gpal=pal),
        _gif((7, 5), [dict(idx=idx, min_size=4, codes=_pack(_lzw(idx.ravel().tolist() + [1] * 9,
                                                                  4)))], gpal=pal),
        _gif((7, 5), [dict(idx=idx, min_size=4)], gpal=pal[:8]),          # index past the table
        _gif((7, 5), [dict(idx=idx, min_size=4, lpal=pal[:8])]),
        _gif((7, 5), [dict(idx=idx % 2, min_size=1)], gpal=pal),
        _gif((7, 5), [dict(idx=idx, min_size=12)], gpal=pal),
        _gif((6, 5), [dict(idx=idx, min_size=4)], gpal=pal),              # frame past the screen
        _gif((7, 5), [dict(idx=idx, min_size=4)], gpal=pal, bg=20),
        _gif((0, 5), [dict(idx=idx, min_size=4)], gpal=pal),
        _gif((7, 5), [dict(idx=idx, min_size=4), dict(idx=idx, min_size=4, codes=b"\x01\x02")],
             gpal=pal)[:-4] + b";",
        good[:at] + b"\x99" + good[at:], good[:at] + b";", good + b"garbage",
        _gif((7, 5), [dict(idx=idx, min_size=4), dict(idx=idx, min_size=4, codes=b"\xff" * 4)],
             gpal=pal),
    ]
    for data in cases:
        _same(data, tmp_path)


# -- BMP RLE8 / RLE4 --------------------------------------------------------------


def _rle_bmp(w, h, bits, stream, palette, top_down=False):
    n = 1 << bits
    table = np.zeros((n, 4), np.uint8)
    table[:len(palette), :3] = palette
    info = struct.pack("<IiiHHIIIIII", 40, w, -h if top_down else h, 1, bits,
                       1 if bits == 8 else 2, len(stream), 2835, 2835, n, 0)
    offset = 14 + len(info) + table.nbytes
    return (b"BM" + struct.pack("<IHHI", offset + len(stream), 0, 0, offset) + info
            + table.tobytes() + bytes(stream))


def _rle_stream(rng, w, h, bits):
    """A seeded RLE stream of runs, absolute runs, ends of line and deltas
    that stays inside its rows, then end of bitmap or not."""
    out, x, y = [], 0, 0
    hi = 256 if bits == 8 else 256
    while y < h:
        room = w - x
        r = rng.random()
        if room == 0 or r < 0.12:
            out += [0, 0]  # end of line
            x, y = 0, y + 1
        elif r < 0.2 and y + 1 < h:
            dx, dy = int(rng.integers(0, room + 1)), int(rng.integers(0, 2))
            out += [0, 2, dx, dy]
            x, y = (x + dx) % w if dy == 0 else x + dx, y + dy + (x + dx) // w if dy == 0 else y + dy
            if x >= w:
                x, y = x - w, y + 1
        elif r < 0.45 and room >= 3:
            k = int(rng.integers(3, room + 1))
            vals = rng.integers(0, 256 if bits == 8 else 16, k).tolist()
            if bits == 8:
                body = vals + [0] * (k % 2)
            else:
                pairs = vals + [0] * (k % 2)
                body = [pairs[i] << 4 | pairs[i + 1] for i in range(0, len(pairs), 2)]
                body += [0] * (len(body) % 2)
            out += [0, k] + body
            x += k
        else:
            k = int(rng.integers(1, room + 1))
            out += [k, int(rng.integers(0, hi))]
            x += k
            if bits == 8 and x == w:
                x, y = 0, y + 1
    if rng.random() < 0.5:
        out += [0, 1]
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_rle_bmp_streams(bits, tmp_path):
    """Seeded streams (runs, absolute runs with their padding, ends of line
    at and before a row's end, deltas, end of bitmap), bottom-up and
    top-down, against cv2 in both modes."""
    rng = np.random.default_rng(bits)
    decoded = 0
    for case in range(24):
        w, h = int(rng.integers(1, 19)), int(rng.integers(1, 7))
        palette = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
        stream = _rle_stream(rng, w, h, bits)
        decoded += _same(_rle_bmp(w, h, bits, stream, palette, top_down=case % 5 == 4), tmp_path)
    assert decoded >= 40


@pytest.mark.parametrize("bits", [8, 4])
def test_rle_bmp_edges(bits, tmp_path):
    """An end of line right after a run that ends a row, two ends of line
    in a row, a delta across rows, end of bitmap mid-row, a run or an
    absolute run past its row, a stream cut short or without its end."""
    pal = np.random.default_rng(11).integers(0, 256, (16, 3), dtype=np.uint8)
    w, h = 6, 4
    run = 6 if bits == 8 else 6
    streams = [
        [run, 0x12, 0, 0, 3, 0x34, 0, 0, 0, 0, 2, 0x56, 0, 1],
        [3, 0x21, 0, 2, 4, 1, 2, 0x43, 0, 1],
        [2, 0x11, 0, 1],
        [0, 1],
        [7, 0x11, 0, 1],
        [0, 7] + [1] * 8 + [0, 1],
        [0, 3, 0x12, 0x30, 0, 0, 0, 3, 1, 2, 3, 0, 0, 1],
        [6, 0x12, 6, 0x34, 6, 0x56, 6, 0x78],
        [6, 0x12, 0, 0, 6, 0x34],
        [6, 0x12, 0],
    ]
    for stream in streams:
        _same(_rle_bmp(w, h, bits, stream, pal), tmp_path)


# -- the committed fixtures ----------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "imread")
FIXTURE_FILES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES, "*"))
                       if not p.endswith((".npz", ".py")))


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixtures_equal_cv2_and_the_port(name):
    """The arrays stored beside each fixture are still ``cv2.imread``'s
    decode (a mode cv2 returns None for is absent), and the port's
    ``imread`` gives them or raises ``FileNotFoundError`` where they are
    absent (``chip_smoke.py`` repeats the latter on the card's machine,
    which has no cv2)."""
    path = os.path.join(FIXTURES, name)
    stored = np.load(path + ".npz")
    for mode, flag in MODES:
        want = _cv2(lambda f: cv2.imread(path, f), flag)
        if mode not in stored:
            assert want is None
            with pytest.raises(FileNotFoundError):
                imread(path, mode)
            continue
        np.testing.assert_array_equal(stored[mode], want)
        np.testing.assert_array_equal(imread(path, mode), stored[mode])


def test_fixture_set_is_complete():
    """Every form has a fixture, the two timed files are 480 x 640, the
    set stays small, and the library of the decoders' codes is built."""
    exts = {os.path.splitext(n)[1] for n in FIXTURE_FILES}
    assert {".pbm", ".pgm", ".ppm", ".pam", ".pfm", ".ras", ".hdr", ".gif", ".bmp"} <= exts
    for name in ("screen_480x640.gif", "rle_480x640.hdr"):
        assert name in FIXTURE_FILES
        assert np.load(os.path.join(FIXTURES, name + ".npz"))["color"].shape == (480, 640, 3)
    names = set(os.listdir(FIXTURES))
    assert {n + ".npz" for n in FIXTURE_FILES} <= names
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 2 << 20
    assert shutil.which("g++") is None or native_build.lib_path(image_codes.SRC).exists()


def test_gif_and_hdr_gray_take_cvtcolors_weights(tmp_path):
    """GIF and HDR convert to gray through ``cvtColor`` (15-bit weights),
    the other codecs through their own (14-bit): colours on which the two
    differ, as a GIF palette and as HDR pixels."""
    c = np.stack(np.meshgrid(np.arange(0, 256, 3), np.arange(0, 256, 3), np.arange(0, 256, 7),
                             indexing="ij"), -1).reshape(-1, 3)
    b, g, r = c[:, 0], c[:, 1], c[:, 2]
    differ = c[((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14)
               != ((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15)][:256].astype(np.uint8)
    assert len(differ) == 256
    idx = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert _same(_gif((16, 16), [dict(idx=idx)], gpal=differ[:, ::-1]), tmp_path, valid=True) == 4
    rgbe = np.concatenate([differ[:, ::-1].reshape(16, 16, 3),
                           np.full((16, 16, 1), 136, np.uint8)], axis=2)  # byte / 256 * 255
    head = b"#?RADIANCE\n" + _HDR_FORMAT + b"\n-Y 16 +X 16\n"
    assert _same(head + _hdr_rle(rgbe), tmp_path, valid=True) == 4
