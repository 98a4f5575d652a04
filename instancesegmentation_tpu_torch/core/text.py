"""``put_text``: cv2 5.0's ``putText`` for ``FONT_HERSHEY_SIMPLEX``, which
``core/visualize.py:draw_label`` calls.

cv2 5.0 no longer draws the Hershey stroke fonts: it maps them onto its
embedded TrueType font, Rubik (``fonts/Rubik.ttf.gz``, the bytes cv2
carries; ``fonts/LICENSE``), a variable font with one ``wght`` axis from
300 to 900.  What this module reproduces, found by matching cv2's output:

- ``FONT_HERSHEY_SIMPLEX`` at ``scale`` is Rubik at ``round(scale * 100 /
  3.7)`` pixels (about 27 per unit of scale, ties to even) per ascender
  (935 units): the outline scale is ``float32(size) / 935``.  Thickness 1
  or less (-1 too) draws weight 400, thickness 2 or more weight 600.  The line type is ignored (every line
  type is anti-aliased).
- An instance is made from the font's ``fvar`` / ``avar`` / ``gvar`` as
  cv2's copy of stb_truetype makes it (``HVAR`` is not read: the advance
  moves with the phantom points' deltas): the weight normalised
  to F2Dot14, a region's scalar rounded to F2Dot14, deltas inferred for
  untouched points of a simple glyph (IUP) truncated to whole units, with
  cv2's rule at a contour's end (``_iup``; a composite's untouched
  components do not move), each point ``floor(coordinate + sum of scaled
  deltas)``.
  The bitmap box is the glyph header's (the default instance's) with its
  x ends moved by the floored phantom-point deltas, padded by
  ``max(ceil(h / 10), ceil(w / 10)) + 10`` pixels on each side.
- Glyphs are flattened and filled by stb's rasteriser in single precision
  (``ops/native/text.cpp``).  The pen advances by whole pixels: the varied
  advance (``hmtx`` plus the floored delta of the advance phantom point)
  times the scale, rounded to 1/64 pixel, the fraction dropped.  No
  kerning (``GPOS`` is not read by cv2 either); ``org`` is the baseline's
  left end.
- Each glyph is blended on its own: ``round(bg + (c - bg) * a / 255)`` per
  colour channel, a 4th channel set to the coverage ``a``.
- ``'\\n'`` starts a new line ``round((ascent - descent + lineGap) * size
  / ascent)`` pixels lower, with ``size`` the pixel size above: for Rubik
  ``round(1185 * size / 935)`` (11 pixels at scale 0.35, 34 at 1.0), in
  float32, ties to even, the largest such step of the faces that drew the
  line's characters (an empty line steps as the line before it); newlines
  before the first character are skipped.  The empty string and spaces
  draw nothing, nor does text whose origin lies right of the image.
- Only uint8 images of 1, 3 or 4 channels are drawn (cv2 asserts).
- A character outside Rubik's ``cmap`` is drawn with cv2's fallback font,
  WenQuanYi Micro Hei (``fonts/WenQuanYiMicroHei.ttf.gz``, the bytes cv2
  carries; ``fonts/WenQuanYiMicroHei.LICENSE``), a static font: the same
  pixel size over its own ascent (1918 units; the scale ``float32(size) /
  1918``), no weights (thickness changes nothing), its glyphs rasterised,
  boxed, padded, advanced and blended as Rubik's, on the same baseline.
  Its ``cmap`` is the one stb_truetype keeps, the last Unicode
  subtable (format 12, planes past the BMP too); 1,620 of its composite
  components carry a scale, which stb applies and then multiplies again
  by the column norms (``glyph_outline``).  It is unpacked only when a
  string first needs it, and its glyphs are parsed one by one.
- A character in neither font (controls such as ``'\\t'`` and ``'\\r'``,
  private-use and unassigned code points) is drawn as Rubik's ``'?'``.
  The text ends at its first ``'\\0'``, as cv2 reads a C string.
"""
from __future__ import annotations

import ctypes
import gzip
import math
import struct
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.ops.native.build import build_library

FONT_PATH = Path(__file__).with_name("fonts") / "Rubik.ttf.gz"
FALLBACK_FONT_PATH = FONT_PATH.with_name("WenQuanYiMicroHei.ttf.gz")
#: the faces: Rubik, and the fallback font for the characters Rubik lacks
RUBIK, FALLBACK = 0, 1
SRC = Path(__file__).resolve().parents[1] / "ops" / "native" / "text.cpp"

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """``text.cpp``, built with g++ on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(SRC)))
        c_int = ctypes.c_int
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.text_glyph.argtypes = [u8p, f32p, c_int, ctypes.c_float, c_int, c_int, c_int, c_int,
                                   c_int, u8p]
        lib.text_glyph.restype = c_int
        lib.text_blend.argtypes = [ctypes.c_void_p, c_int, c_int, c_int, ctypes.c_int64, u8p,
                                   c_int, c_int, c_int, c_int, u8p]
        lib.text_blend.restype = None
        _lib = lib
    return _lib


def _f2dot14(v: int) -> float:
    return (v - 0x10000 if v & 0x8000 else v) / 16384.0


def _region_scalar(n: float, start: float, peak: float, end: float) -> float:
    """One axis's scalar of a variation region at normalised coordinate n,
    rounded to F2Dot14 as cv2 rounds it (an intermediate region's 0.3 is
    4915 / 16384)."""
    if peak == 0 or start > peak or peak > end or (start < 0 < end):
        return 1.0
    if n == peak:
        return 1.0
    if n <= start or n >= end:
        return 0.0
    if n < peak:
        scalar = (n - start) / (peak - start)
    else:
        scalar = (end - n) / (end - peak)
    return math.floor(scalar * 16384 + 0.5) / 16384


def _iup(deltas: list, coords: np.ndarray) -> list:
    """Inferred deltas of one contour's untouched points (``None`` in
    ``deltas``) in whole units, as cv2 infers them: ``d1 + (c - c1) * (d2 -
    d1) / (c2 - c1)`` truncated toward zero between two touched neighbours,
    the nearer one's delta outside them.  Where the contour's first point is
    untouched, the points after the last touched one take its delta (cv2
    does not interpolate them across the contour's end); the points before
    the first touched one are interpolated across it."""
    n = len(deltas)
    touched = [i for i in range(n) if deltas[i] is not None]
    if not touched:
        return [(0, 0)] * n
    if len(touched) == 1:
        return [deltas[touched[0]]] * n
    out = list(deltas)
    for t, i1 in enumerate(touched):
        i2 = touched[(t + 1) % len(touched)]
        j = (i1 + 1) % n
        if i2 < i1 and touched[0] != 0:
            while j != 0:
                out[j] = deltas[i1]
                j = (j + 1) % n
        while j != i2:
            d = []
            for k in (0, 1):
                c1, c2 = int(coords[i1, k]), int(coords[i2, k])
                d1, d2 = deltas[i1][k], deltas[i2][k]
                if c1 == c2:
                    d.append(d1 if d1 == d2 else 0)
                    continue
                if c1 > c2:
                    c1, c2, d1, d2 = c2, c1, d2, d1
                c = int(coords[j, k])
                if c <= c1:
                    d.append(d1)
                elif c >= c2:
                    d.append(d2)
                else:
                    d.append(math.trunc(d1 + (c - c1) * (d2 - d1) / (c2 - c1)))
            out[j] = tuple(d)
            j = (j + 1) % n
    return out


class Font:
    """The tables of a TrueType font that ``put_text`` reads: a variable
    font with a ``wght`` axis, or a static one (no ``fvar``)."""

    def __init__(self, data: bytes):
        self.data = data
        num_tables = struct.unpack_from(">H", data, 4)[0]
        self.tables = {}
        for i in range(num_tables):
            tag, _, offset, length = struct.unpack_from(">4sIII", data, 12 + 16 * i)
            self.tables[tag.decode("latin-1")] = (offset, length)
        head = self.tables["head"][0]
        self.long_loca = struct.unpack_from(">h", data, head + 50)[0] == 1
        self.num_glyphs = struct.unpack_from(">H", data, self.tables["maxp"][0] + 4)[0]
        hhea = self.tables["hhea"][0]
        self.ascent, self.descent, self.line_gap = struct.unpack_from(">hhh", data, hhea + 4)
        self.num_hmetrics = struct.unpack_from(">H", data, hhea + 34)[0]
        self.cmap = self._read_cmap()
        self.axis = self._read_fvar() if "fvar" in self.tables else None
        self.avar = self._read_avar()
        if "gvar" in self.tables:
            self._read_gvar()

    def _u16(self, pos):
        return struct.unpack_from(">H", self.data, pos)[0]

    def _read_cmap(self) -> dict:
        """Code point -> glyph of the subtable stb_truetype keeps: the last
        Unicode one (platform 0, or Microsoft's BMP or full Unicode), read
        as format 4 or 12."""
        base = self.tables["cmap"][0]
        pos = None
        for i in range(self._u16(base + 2)):
            pid, eid, off = struct.unpack_from(">HHI", self.data, base + 4 + 8 * i)
            if pid == 0 or (pid, eid) in ((3, 1), (3, 10)):
                pos = base + off
        fmt = None if pos is None else self._u16(pos)
        if fmt == 12:
            cmap = {}
            count = struct.unpack_from(">I", self.data, pos + 12)[0]
            for start, end, glyph in struct.iter_unpack(
                    ">III", self.data[pos + 16:pos + 16 + 12 * count]):
                cmap.update(zip(range(start, end + 1), range(glyph, glyph + end - start + 1)))
            return {c: g for c, g in cmap.items() if g}
        if fmt != 4:
            raise ValueError("font has no Unicode cmap of format 4 or 12")
        cmap = {}
        seg2 = self._u16(pos + 6)
        ends = pos + 14
        starts = ends + seg2 + 2
        deltas = starts + seg2
        ranges = deltas + seg2
        for s in range(seg2 // 2):
            end, start = self._u16(ends + 2 * s), self._u16(starts + 2 * s)
            delta, roff = self._u16(deltas + 2 * s), self._u16(ranges + 2 * s)
            for c in range(start, min(end, 0xFFFE) + 1):
                if roff == 0:
                    g = (c + delta) & 0xFFFF
                else:
                    g = self._u16(ranges + 2 * s + roff + 2 * (c - start))
                    if g:
                        g = (g + delta) & 0xFFFF
                if g:
                    cmap[c] = g
        return cmap

    def _read_fvar(self):
        base = self.tables["fvar"][0]
        axes_off, _, count, size = struct.unpack_from(">HHHH", self.data, base + 4)
        for i in range(count):
            tag, lo, default, hi = struct.unpack_from(">4siii", self.data, base + axes_off + i * size)
            if tag == b"wght":
                return lo / 65536.0, default / 65536.0, hi / 65536.0
        raise ValueError("font has no wght axis")

    def _read_avar(self):
        if "avar" not in self.tables:
            return None
        base = self.tables["avar"][0]
        count = self._u16(base + 8)  # the wght axis's segment map
        pairs = [struct.unpack_from(">HH", self.data, base + 10 + 4 * i) for i in range(count)]
        return [(_f2dot14(a), _f2dot14(b)) for a, b in pairs]

    def _read_gvar(self):
        base = self.tables["gvar"][0]
        (_, _, axis_count, shared_count, shared_off, glyph_count, flags,
         data_off) = struct.unpack_from(">HHHHIHHI", self.data, base)
        self.gvar_data = base + data_off
        self.shared_tuples = [
            _f2dot14(self._u16(base + shared_off + 2 * i)) for i in range(shared_count * axis_count)]
        if flags & 1:
            self.gvar_offsets = struct.unpack_from(f">{glyph_count + 1}I", self.data, base + 20)
        else:
            self.gvar_offsets = [2 * o for o in
                                 struct.unpack_from(f">{glyph_count + 1}H", self.data, base + 20)]

    def normalise(self, weight: float) -> float:
        """The ``wght`` coordinate in [-1, 1], as F2Dot14 before and after
        ``avar``; 0 for a static font."""
        if self.axis is None:
            return 0.0
        lo, default, hi = self.axis
        w = min(max(weight, lo), hi)
        if w < default:
            n = (w - default) / (default - lo)
        elif w > default:
            n = (w - default) / (hi - default)
        else:
            n = 0.0
        n = round(n * 16384) / 16384
        if self.avar:
            for (a0, b0), (a1, b1) in zip(self.avar, self.avar[1:]):
                if a0 <= n <= a1:
                    n = b0 if a1 == a0 else b0 + (n - a0) * (b1 - b0) / (a1 - a0)
                    break
            n = round(n * 16384) / 16384
        return n

    def advance(self, gid: int) -> int:
        i = min(gid, self.num_hmetrics - 1)
        return self._u16(self.tables["hmtx"][0] + 4 * i)

    def glyph_range(self, gid: int) -> tuple[int, int]:
        loca = self.tables["loca"][0]
        if self.long_loca:
            a, b = struct.unpack_from(">II", self.data, loca + 4 * gid)
        else:
            a, b = (2 * v for v in struct.unpack_from(">HH", self.data, loca + 2 * gid))
        return self.tables["glyf"][0] + a, b - a

    def header_box(self, gid: int) -> Optional[tuple[int, int, int, int]]:
        pos, length = self.glyph_range(gid)
        if length == 0:
            return None
        return struct.unpack_from(">hhhh", self.data, pos + 2)

    def simple_points(self, gid: int):
        """(points [n, 2] int, on-curve flags [n], contour ends) of a simple
        glyph, or None for a composite one."""
        pos, length = self.glyph_range(gid)
        if length == 0:
            return np.zeros((0, 2), np.int64), np.zeros(0, bool), []
        ncont = struct.unpack_from(">h", self.data, pos)[0]
        if ncont < 0:
            return None
        ends = list(struct.unpack_from(f">{ncont}H", self.data, pos + 10))
        n = ends[-1] + 1 if ends else 0
        p = pos + 10 + 2 * ncont
        p += 2 + self._u16(p)
        flags = []
        while len(flags) < n:
            f = self.data[p]
            p += 1
            flags.append(f)
            if f & 8:
                flags.extend([f] * self.data[p])
                p += 1
        flags = flags[:n]
        coords = np.zeros((n, 2), np.int64)
        for axis, short_bit, same_bit in ((0, 2, 16), (1, 4, 32)):
            v = 0
            for i, f in enumerate(flags):
                if f & short_bit:
                    d = self.data[p]
                    p += 1
                    v += d if f & same_bit else -d
                elif not f & same_bit:
                    v += struct.unpack_from(">h", self.data, p)[0]
                    p += 2
                coords[i, axis] = v
        return coords, np.array([bool(f & 1) for f in flags]), ends

    def components(self, gid: int):
        """[(glyph, flags, dx, dy, matrix)] of a composite glyph."""
        pos, _ = self.glyph_range(gid)
        p = pos + 10
        out = []
        while True:
            flags, glyph = struct.unpack_from(">HH", self.data, p)
            p += 4
            if flags & 1:
                dx, dy = struct.unpack_from(">hh", self.data, p)
                p += 4
            else:
                dx, dy = struct.unpack_from(">bb", self.data, p)
                p += 2
            if not flags & 2:
                raise NotImplementedError("composite glyphs placed by point numbers")
            mtx = (1.0, 0.0, 0.0, 1.0)
            if flags & 8:
                s = np.float32(struct.unpack_from(">h", self.data, p)[0] / 16384.0)
                mtx, p = (s, 0.0, 0.0, s), p + 2
            elif flags & 0x40:
                a, d = struct.unpack_from(">hh", self.data, p)
                mtx, p = (np.float32(a / 16384.0), 0.0, 0.0, np.float32(d / 16384.0)), p + 4
            elif flags & 0x80:
                v = struct.unpack_from(">hhhh", self.data, p)
                mtx, p = tuple(np.float32(x / 16384.0) for x in v), p + 8
            out.append((glyph, flags, dx, dy, mtx))
            if not flags & 0x20:
                return out

    def deltas(self, gid: int, npoints: int, coords: np.ndarray, ends: Optional[list],
               n: float) -> np.ndarray:
        """Summed scaled deltas [npoints + 4, 2] (float64) of glyph ``gid``
        at normalised coordinate n; ``coords`` [npoints, 2] and the contour
        ``ends`` for IUP, ``ends`` None for a composite glyph (whose
        untouched components move by 0)."""
        total = np.zeros((npoints + 4, 2))
        if n == 0:
            return total
        start, stop = self.gvar_offsets[gid], self.gvar_offsets[gid + 1]
        if stop == start:
            return total
        data, pos = self.data, self.gvar_data + start
        count, data_off = struct.unpack_from(">HH", data, pos)
        shared_points = bool(count & 0x8000)
        count &= 0x0FFF
        headers, h = [], pos + 4
        for _ in range(count):
            size, index = struct.unpack_from(">HH", data, h)
            h += 4
            if index & 0x8000:
                peak = _f2dot14(self._u16(h))
                h += 2
            else:
                peak = self.shared_tuples[index & 0x0FFF]
            if index & 0x4000:
                lo, hi = _f2dot14(self._u16(h)), _f2dot14(self._u16(h + 2))
                h += 4
            else:
                lo, hi = min(peak, 0.0), max(peak, 0.0)
            headers.append((size, bool(index & 0x2000), lo, peak, hi))
        p = pos + data_off
        all_n = npoints + 4
        common = None
        if shared_points:
            common, p = self._packed_points(p, all_n)
        for size, private, lo, peak, hi in headers:
            q, end = p, p + size
            p = end
            points = common
            if private:
                points, q = self._packed_points(q, all_n)
            scalar = _region_scalar(n, lo, peak, hi)
            if scalar == 0:
                continue
            dx, q = self._packed_deltas(q, len(points))
            dy, q = self._packed_deltas(q, len(points))
            if len(points) == all_n:
                total[:, 0] += scalar * np.asarray(dx, float)
                total[:, 1] += scalar * np.asarray(dy, float)
                continue
            explicit = [None] * all_n
            for pt, a, b in zip(points, dx, dy):
                if pt < all_n:
                    explicit[pt] = (a, b)
            inferred = []
            c0 = 0
            for e in ends or ():
                inferred += _iup(explicit[c0:e + 1], coords[c0:e + 1])
                c0 = e + 1
            inferred += [d if d is not None else (0, 0) for d in explicit[c0:]]
            total += scalar * np.asarray(inferred, float)
        return total

    def _packed_points(self, p: int, all_n: int):
        data = self.data
        count = data[p]
        p += 1
        if count & 0x80:
            count = ((count & 0x7F) << 8) | data[p]
            p += 1
        if count == 0:
            return list(range(all_n)), p
        points, v = [], 0
        while len(points) < count:
            ctrl = data[p]
            p += 1
            run = (ctrl & 0x7F) + 1
            for _ in range(run):
                if ctrl & 0x80:
                    d = self._u16(p)
                    p += 2
                else:
                    d = data[p]
                    p += 1
                v += d
                points.append(v)
        return points, p

    def _packed_deltas(self, p: int, count: int):
        data, out = self.data, []
        while len(out) < count:
            ctrl = data[p]
            p += 1
            run = (ctrl & 0x3F) + 1
            if ctrl & 0x80:
                out.extend([0] * run)
            elif ctrl & 0x40:
                out.extend(struct.unpack_from(f">{run}h", data, p))
                p += 2 * run
            else:
                out.extend(struct.unpack_from(f">{run}b", data, p))
                p += run
        return out[:count], p


def load_font(face: int = RUBIK) -> Font:
    """Rubik, or the fallback font, read from the package's own
    ``fonts/Rubik.ttf.gz`` or ``fonts/WenQuanYiMicroHei.ttf.gz``."""
    return _read_font(face)


@lru_cache(maxsize=2)
def _read_font(face: int) -> Font:
    return Font(gzip.decompress((FALLBACK_FONT_PATH if face == FALLBACK else FONT_PATH)
                                .read_bytes()))


@lru_cache(maxsize=4096)
def face_glyph(code: int) -> tuple[int, int]:
    """(face, glyph) cv2 draws code point ``code`` with: Rubik's glyph,
    else the fallback font's, else Rubik's ``'?'``.  Rubik's characters
    never open the fallback font."""
    rubik = load_font().cmap
    if code in rubik:
        return RUBIK, rubik[code]
    gid = load_font(FALLBACK).cmap.get(code)
    return (FALLBACK, gid) if gid else (RUBIK, rubik[ord("?")])


def _stb_vertices(coords: np.ndarray, on: np.ndarray, ends: list) -> tuple[list, list]:
    """stb_truetype's move / line / curve vertices of a simple glyph's
    integer points (implied on-curve points at ``(a + b) >> 1``)."""
    types, xy = [], []

    def add(t, x, y, cx=0, cy=0):
        types.append(t)
        xy.append((x, y, cx, cy))

    start = 0
    for e in ends:
        pts = [(int(x), int(y)) for x, y in coords[start:e + 1]]
        onc = list(on[start:e + 1])
        m = len(pts)
        start = e + 1
        if m == 0:
            continue
        start_off = not onc[0]
        scx, scy = pts[0]
        if start_off:
            nxt = pts[1 % m]
            if not onc[1 % m]:
                sx, sy, i = (pts[0][0] + nxt[0]) >> 1, (pts[0][1] + nxt[1]) >> 1, 1
            else:
                (sx, sy), i = nxt, 2
        else:
            (sx, sy), i = pts[0], 1
        add(1, sx, sy)
        was_off, cx, cy = False, 0, 0
        for k in range(i, m):
            x, y = pts[k]
            if not onc[k]:
                if was_off:
                    add(3, (cx + x) >> 1, (cy + y) >> 1, cx, cy)
                cx, cy, was_off = x, y, True
            else:
                if was_off:
                    add(3, x, y, cx, cy)
                else:
                    add(2, x, y)
                was_off = False
        if start_off:
            if was_off:
                add(3, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy)
            add(3, sx, sy, scx, scy)
        elif was_off:
            add(3, sx, sy, cx, cy)
        else:
            add(2, sx, sy)
    return types, xy


def _to_short(v: float) -> int:
    return ((int(math.floor(v)) + 0x8000) & 0xFFFF) - 0x8000


@lru_cache(maxsize=4096)
def glyph_outline(gid: int, weight: int, face: int = RUBIK
                  ) -> tuple[np.ndarray, np.ndarray, int, int]:
    """stb vertices (types [n] uint8, xy [n, 4] float32) of glyph ``gid`` of
    ``face`` at ``weight``, and the floored x deltas of its two horizontal
    phantom points (left side bearing, advance; 0 in a static font).  A
    composite's component is placed as stb places it: each point ``p`` of
    the child goes to ``trunc(m * (M p + offset))`` per axis, ``m`` the norm
    of the matrix's column for that axis."""
    font = load_font(face)
    n = font.normalise(weight)
    simple = font.simple_points(gid)
    if simple is not None:
        coords, on, ends = simple
        d = font.deltas(gid, len(coords), coords, ends, n)
        varied = np.array([[_to_short(c + dv) for c, dv in zip(p, dp)]
                           for p, dp in zip(coords.tolist(), d[:len(coords)].tolist())],
                          np.int64).reshape(-1, 2)
        types, xy = _stb_vertices(varied, on, ends)
        npoints = len(coords)
    else:
        comps = font.components(gid)
        npoints = len(comps)
        offsets = np.array([[dx, dy] for _, _, dx, dy, _ in comps], np.int64).reshape(-1, 2)
        d = font.deltas(gid, npoints, offsets, None, n)
        types, xy = [], []
        for (child, _, dx, dy, mtx), dd in zip(comps, d[:npoints].tolist()):
            ox, oy = math.floor(dx + dd[0]), math.floor(dy + dd[1])
            ct, cxy, _, _ = glyph_outline(child, weight, face)
            a, b, c, e = (np.float32(v) for v in mtx)
            sm = np.float32(math.sqrt(float(a * a + b * b)))
            sn = np.float32(math.sqrt(float(c * c + e * e)))

            def tr(px, py):
                px, py = np.float32(px), np.float32(py)
                return (_to_short(float(np.trunc(sm * (a * px + c * py + np.float32(ox))))),
                        _to_short(float(np.trunc(sn * (b * px + e * py + np.float32(oy))))))

            for t, (x, y, cx, cy) in zip(ct.tolist(), cxy.tolist()):
                types.append(t)
                xy.append((*tr(x, y), *tr(cx, cy)))
    return (np.asarray(types, np.uint8).reshape(-1),
            np.ascontiguousarray(np.asarray(xy, np.float32).reshape(-1, 4)),
            math.floor(d[npoints, 0]), math.floor(d[npoints + 1, 0]))


def _glyph_box(gid: int, weight: int, face: int = RUBIK) -> Optional[tuple[int, int, int, int]]:
    """cv2's box of a varied glyph: the header's box, its x ends moved by
    the floored deltas of the phantom points."""
    box = load_font(face).header_box(gid)
    if box is None:
        return None
    _, _, d_lsb, d_adv = glyph_outline(gid, weight, face)
    return box[0] + d_lsb, box[1], box[2] + d_adv, box[3]


@lru_cache(maxsize=4096)
def glyph_bitmap(gid: int, size: int, weight: int, face: int = RUBIK
                 ) -> tuple[np.ndarray, int, int]:
    """(coverage [h, w] uint8, x, y) of glyph ``gid`` of ``face``: the
    bitmap's top-left corner relative to the pen on the baseline."""
    font = load_font(face)
    box = _glyph_box(gid, weight, face)
    types, xy, _, _ = glyph_outline(gid, weight, face)
    if box is None or len(types) == 0:
        return np.zeros((0, 0), np.uint8), 0, 0
    scale = np.float32(np.float32(size) / np.float32(font.ascent))
    x0, y0, x1, y1 = (np.float32(v) for v in box)
    ix0 = int(np.floor(x0 * scale))
    iy0 = int(np.floor(-y1 * scale))
    ix1 = int(np.ceil(x1 * scale))
    iy1 = int(np.ceil(-y0 * scale))
    w, h = ix1 - ix0, iy1 - iy0
    margin = max(int((h + 9) / 10), int((w + 9) / 10)) + 10
    width, height = w + 2 * margin, h + 2 * margin
    out = np.zeros((height, width), np.uint8)
    _load().text_glyph(types, xy, len(types), float(scale), ix0, iy0, margin, width, height, out)
    return out, ix0 - margin, iy0 - margin


@lru_cache(maxsize=4096)
def _advance_pixels(gid: int, size: int, weight: int, face: int = RUBIK) -> int:
    """The pen's advance in whole pixels: the varied advance (the hmtx
    advance, less the header box's width, plus the varied box's) times the
    scale, rounded to 1/64 pixel (nearest even), the 1/64 dropped."""
    font = load_font(face)
    scale = np.float32(np.float32(size) / np.float32(font.ascent))
    adv = font.advance(gid)
    box, varied = font.header_box(gid), _glyph_box(gid, weight, face)
    if box is not None:
        adv = adv - (box[2] - box[0]) + (varied[2] - varied[0])
    return int(np.rint(np.float32(np.float32(adv) * scale) * np.float32(64))) >> 6


@lru_cache(maxsize=256)
def _line_step(face: int, size: int) -> int:
    """``round((ascent - descent + lineGap) * size / ascent)`` of ``face``,
    in float32, ties to even: for Rubik ``round(1185 * size / 935)``, for
    the fallback font ``round(2401 * size / 1918)``, never more."""
    font = load_font(face)
    return int(np.rint(float(np.float32(font.ascent - font.descent + font.line_gap)
                             * np.float32(np.float32(size) / np.float32(font.ascent)))))


def hershey_to_truetype(scale: float, thickness: int) -> tuple[int, int]:
    """(pixel size, weight) cv2 5.0 draws ``FONT_HERSHEY_SIMPLEX`` with."""
    return round(scale * 100 / 3.7), 400 if thickness <= 1 else 600


def _colour(color, channels: int) -> np.ndarray:
    if np.isscalar(color):
        color = (color,)
    vals = [float(v) for v in color][:4]
    vals += [0.0] * (4 - len(vals))
    return np.array([min(max(int(np.rint(v)), 0), 255) for v in vals], np.uint8)


def put_text(image: np.ndarray, text: str, org, scale: float, color, thickness: int = 1) -> np.ndarray:
    """``cv2.putText(image, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale,
    color, thickness, line_type)`` in place (any line type)."""
    if not isinstance(image, np.ndarray) or image.dtype != np.uint8:
        raise ValueError("put_text draws on uint8 images only (cv2 asserts img.depth() == CV_8U)")
    channels = 1 if image.ndim == 2 else image.shape[2]
    if image.ndim not in (2, 3) or channels not in (1, 3, 4):
        raise ValueError("put_text draws on images of 1, 3 or 4 channels (cv2 asserts it)")
    try:
        text.encode("utf-8")
    except UnicodeEncodeError as e:  # a lone surrogate, which cv2's binding cannot convert
        raise ValueError("put_text takes text that encodes as UTF-8") from e
    size, weight = hershey_to_truetype(scale, thickness)
    text = text.split("\0", 1)[0].lstrip("\n")
    if size <= 0 or not text or int(org[0]) >= image.shape[1]:
        return image
    x, y = int(org[0]), int(org[1])
    colour = _colour(color, channels)
    target = image if image.flags.c_contiguous else np.ascontiguousarray(image)
    h, w = target.shape[:2]
    lib = _load()
    line, new_line = 0, True
    for c in text:
        if c == "\n":
            x, y, new_line = int(org[0]), y + line, True
            continue
        face, gid = face_glyph(ord(c))
        step = _line_step(face, size)
        line, new_line = step if new_line else max(line, step), False
        bitmap, bx, by = glyph_bitmap(gid, size, weight, face)
        if bitmap.size:
            lib.text_blend(target.ctypes.data, h, w, channels, target.strides[0], bitmap,
                           bitmap.shape[0], bitmap.shape[1], x + bx, y + by, colour)
        x += _advance_pixels(gid, size, weight, face)
    if target is not image:
        image[...] = target
    return image
