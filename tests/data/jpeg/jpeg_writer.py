"""A small JPEG writer for the forms that neither cv2 nor PIL writes:
arithmetic coding (sequential and progressive, jcarith.c's QM
coder, with or without DAC conditioning), lossless (SOF3, predictors 1-7,
point transform), 12-bit DCT files, any sampling layout and any component
count, restart intervals.

Test-only code, used by ``make_fixtures.py`` and the JPEG tests: its files
are valid JPEG, not good ones (a float DCT, Huffman tables of equal-length
codes).  Only the decoders' agreement matters: the tests hold the port's
decode against cv2's of the same bytes.

``write_jpeg(planes, ...)`` takes one full-size plane per component (values
below ``2 ** precision``) and the components' ``(id, h, v)``; a component
below the largest sampling factors is averaged down over whole blocks of
pixels (or sampled, where the ratio is not a whole number).
"""
from __future__ import annotations

import struct

import numpy as np

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
                    + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38)

# jaricom.c's Table D.2: (Qe, next state after LPS, after MPS, switch MPS)
QM_TABLE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
FIXED_BIN = 113  # the state of the fixed 0.5 probability estimate

#: jpeg_simple_progression's script for three components, as (components,
#: Ss, Se, Ah, Al): every kind of scan, first and refine, DC and AC
SIMPLE_PROGRESSION = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                      ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                      ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                      ((0,), 1, 63, 1, 0))


def segment(code: int, body: bytes = b"") -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def jfif() -> bytes:
    return segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    return segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


def quant_table(quality: int, chroma: bool) -> np.ndarray:
    """jcparam.c's scaling of the Annex K table, natural order."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    t = ((CHROMA_Q if chroma else LUMA_Q) * scale + 50) // 100
    return np.clip(t, 1, 255)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


DCT = _dct_matrix()


def _component_plane(plane: np.ndarray, h: int, v: int, hmax: int, vmax: int, rows: int,
                     cols: int) -> np.ndarray:
    """The component's samples over ``rows`` x ``cols`` (whole blocks or
    MCUs), from the full-size ``plane`` with its edges repeated."""
    H, W = plane.shape
    fy, fx = vmax / v, hmax / h
    if fy == int(fy) and fx == int(fx):
        fy, fx = int(fy), int(fx)
        full = np.pad(plane.astype(np.float64),
                      ((0, max(0, rows * fy - H)), (0, max(0, cols * fx - W))), mode="edge")
        full = full[:rows * fy, :cols * fx]
        return full.reshape(rows, fy, cols, fx).mean(axis=(1, 3))
    ys = np.minimum((np.arange(rows) * fy).astype(int), H - 1)
    xs = np.minimum((np.arange(cols) * fx).astype(int), W - 1)
    return plane.astype(np.float64)[ys][:, xs]


class Frame:
    """The layout of a frame: sizes, sampling and the block grid."""

    def __init__(self, height: int, width: int, comps, data_unit: int):
        self.height, self.width, self.comps = height, width, list(comps)
        self.hmax = max(h for _, h, _ in self.comps)
        self.vmax = max(v for _, _, v in self.comps)
        self.mcux = -(-width // (data_unit * self.hmax))
        self.mcuy = -(-height // (data_unit * self.vmax))
        self.dw = [-(-width * h // self.hmax) for _, h, _ in self.comps]
        self.dh = [-(-height * v // self.vmax) for _, _, v in self.comps]
        self.unit = data_unit

    def units(self, scan_comps):
        """(component, unit row, unit column) in the scan's order, with the
        MCU index of each: the interleaved MCUs, or one component's units
        over its own (not MCU-padded) size."""
        if len(scan_comps) == 1:
            c = scan_comps[0]
            rows = -(-self.dh[c] // self.unit)
            cols = -(-self.dw[c] // self.unit)
            n = 0
            for y in range(rows):
                for x in range(cols):
                    yield n, ((c, y, x),)
                    n += 1
            return
        n = 0
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                mcu = []
                for c in scan_comps:
                    _, h, v = self.comps[c]
                    for yy in range(v):
                        for xx in range(h):
                            mcu.append((c, my * v + yy, mx * h + xx))
                yield n, tuple(mcu)
                n += 1


# ----------------------------------------------------------------- Huffman


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> int:
    return abs(v).bit_length()


def _bits(v: int, s: int) -> int:
    return v if v >= 0 else v - 1 + (1 << s)


class Huffman:
    """Equal-length codes for the symbols a scan uses."""

    def __init__(self, symbols):
        self.symbols = sorted(set(symbols)) or [0]
        self.length = len(self.symbols).bit_length()  # the all-ones code stays free
        self.code = {s: i for i, s in enumerate(self.symbols)}

    def dht(self, index: int) -> bytes:
        bits = [0] * 16
        bits[self.length - 1] = len(self.symbols)
        return bytes([index]) + bytes(bits) + bytes(self.symbols)

    def put(self, bw: BitWriter, symbol: int) -> None:
        bw.put(self.code[symbol], self.length)


def _huffman_block_symbols(block, last_dc):
    """(symbol kind, symbol, extra bits value, extra bits length) of one
    sequential block, natural-order ``block``."""
    out = []
    diff = int(block[0]) - last_dc
    s = _category(diff)
    out.append(("dc", s, _bits(diff, s), s))
    run = 0
    zz = [int(block[NATURAL[k]]) for k in range(64)]
    last = max([k for k in range(1, 64) if zz[k]] or [0])
    for k in range(1, last + 1):
        if zz[k] == 0:
            run += 1
            continue
        while run > 15:
            out.append(("ac", 0xF0, 0, 0))
            run -= 16
        s = _category(zz[k])
        out.append(("ac", (run << 4) | s, _bits(zz[k], s), s))
        run = 0
    if last < 63:
        out.append(("ac", 0x00, 0, 0))
    return out


# -------------------------------------------------------------- arithmetic


class QMEncoder:
    """jcarith.c's arithmetic encoder (sections D.1.4-D.1.8 of T.81)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit_zeros(self):
        while self.zc:
            self.out.append(0)
            self.zc -= 1

    def _byte_out(self, temp):
        if temp > 0xFF:
            if self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._emit_zeros()
                for _ in range(self.sc):
                    self.out += b"\xff\x00"
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, stats: bytearray, i: int, val: int) -> None:
        sv = stats[i]
        qe, nl, nm, switch = QM_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (nl | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._emit_zeros()
                for _ in range(self.sc):
                    self.out += b"\xff\x00"
                self.sc = 0
        if self.c & 0x7FFF800:
            self._emit_zeros()
            self.out.append((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                self.out.append((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self.out.append(0)


class ArithScan:
    """One scan's statistics and the jcarith.c encoding procedures."""

    def __init__(self, enc: QMEncoder, dc_l, dc_u, ac_k):
        self.enc, self.dc_l, self.dc_u, self.ac_k = enc, dc_l, dc_u, ac_k
        self.dc_stats = [bytearray(64) for _ in range(16)]
        self.ac_stats = [bytearray(256) for _ in range(16)]
        self.fixed = bytearray([FIXED_BIN])
        self.last_dc = {}
        self.dc_context = {}

    def reset(self, ci):
        self.last_dc[ci] = 0
        self.dc_context[ci] = 0

    def dc(self, ci, tbl, value):
        e, st = self.enc, self.dc_stats[tbl]
        s0 = self.dc_context[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            e.encode(st, s0, 0)
            self.dc_context[ci] = 0
            return
        self.last_dc[ci] = value
        e.encode(st, s0, 1)
        if v > 0:
            e.encode(st, s0 + 1, 0)
            i = s0 + 2
            self.dc_context[ci] = 4
        else:
            v = -v
            e.encode(st, s0 + 1, 1)
            i = s0 + 3
            self.dc_context[ci] = 8
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            i = 20
            v2 >>= 1
            while v2:
                e.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        e.encode(st, i, 0)
        if m < (1 << self.dc_l[tbl]) >> 1:
            self.dc_context[ci] = 0
        elif m > (1 << self.dc_u[tbl]) >> 1:
            self.dc_context[ci] += 8
        i += 14
        m >>= 1
        while m:
            e.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def _magnitude(self, st, i, v, k, tbl):
        e = self.enc
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                e.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= self.ac_k[tbl] else 217
                v2 >>= 1
                while v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        e.encode(st, i, 0)
        i += 14
        m >>= 1
        while m:
            e.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def ac(self, tbl, zz, ss, se, al):
        """AC coefficients ``zz[ss..se]`` (zigzag order), point-transformed
        by ``al`` (sequential: ss 1, se 63, al 0)."""
        e, st = self.enc, self.ac_stats[tbl]

        def shifted(x):
            return x >> al if x >= 0 else -((-x) >> al)

        ke = 0
        for k in range(se, 0, -1):
            if shifted(zz[k]):
                ke = k
                break
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while True:
                v = shifted(zz[k])
                if v:
                    e.encode(st, i + 1, 1)
                    e.encode(self.fixed, 0, 0 if v > 0 else 1)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            self._magnitude(st, i + 2, abs(v), k, tbl)
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl, zz, ss, se, ah, al):
        e, st = self.enc, self.ac_stats[tbl]
        ke = kex = 0
        for k in range(se, 0, -1):
            if abs(zz[k]) >> al:
                ke = k
                break
        for k in range(ke, 0, -1):
            if abs(zz[k]) >> ah:
                kex = k
                break
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = abs(zz[k]) >> al
                if v:
                    if v >> 1:
                        e.encode(st, i + 2, v & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(self.fixed, 0, 0 if zz[k] > 0 else 1)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


# ------------------------------------------------------------------ writer


def _restart_bytes(n: int) -> bytes:
    return bytes([0xFF, 0xD0 + (n & 7)])


def _huffman_scan(frame, blocks, scan_comps, tables, restart):
    """Entropy-coded bytes and DHT body of one sequential Huffman scan."""
    plan = []  # per MCU: list of (component, symbols)
    last = {c: 0 for c in scan_comps}
    for n, mcu in frame.units(scan_comps):
        if restart and n % restart == 0:
            last = {c: 0 for c in scan_comps}
        syms = []
        for c, y, x in mcu:
            b = blocks[c][y, x]
            syms.append((c, _huffman_block_symbols(b, last[c])))
            last[c] = int(b[0])
        plan.append(syms)
    dc_syms, ac_syms = {}, {}
    for syms in plan:
        for c, ss in syms:
            for kind, s, _, _ in ss:
                (dc_syms if kind == "dc" else ac_syms).setdefault(tables[c], []).append(s)
    dc = {t: Huffman(s) for t, s in dc_syms.items()}
    ac = {t: Huffman(s) for t, s in ac_syms.items()}
    dht = b"".join(h.dht(t) for t, h in dc.items()) + b"".join(h.dht(0x10 | t)
                                                               for t, h in ac.items())
    bw = BitWriter()
    for n, syms in enumerate(plan):
        if restart and n and n % restart == 0:
            bw.flush()
            bw.out += _restart_bytes(n // restart - 1)
        for c, ss in syms:
            for kind, s, bits, length in ss:
                (dc if kind == "dc" else ac)[tables[c]].put(bw, s)
                bw.put(bits, length)
    bw.flush()
    return bytes(bw.out), dht


def _arith_scan(frame, blocks, scan, tables, restart, cond):
    comps, ss, se, ah, al = scan
    enc = QMEncoder()
    coder = ArithScan(enc, *cond)
    for c in comps:
        coder.reset(c)
    for n, mcu in frame.units(list(comps)):
        if restart and n and n % restart == 0:
            enc.finish()
            enc.out += _restart_bytes(n // restart - 1)
            enc.reset()
            coder = ArithScan(enc, *cond)
            for c in comps:
                coder.reset(c)
        for c, y, x in mcu:
            b = blocks[c][y, x]
            zz = [int(b[NATURAL[k]]) for k in range(64)]
            t = tables[c]
            if ss == 0 and ah == 0:
                coder.dc(c, t, zz[0] >> al)
                if se:  # sequential
                    coder.ac(t, zz, 1, 63, 0)
            elif ss == 0:
                enc.encode(coder.fixed, 0, (zz[0] >> al) & 1)
            elif ah == 0:
                coder.ac(t, zz, ss, se, al)
            else:
                coder.ac_refine(t, zz, ss, se, ah, al)
    enc.finish()
    return bytes(enc.out)


def _lossless_diffs(samples, predictor, pt, precision, first_rows):
    """Differences of one component's samples over its MCU-padded grid,
    predicted as jdlossls.c undoes them (the rows in ``first_rows`` by the
    1-D predictor from 2 ** (P - Pt - 1))."""
    x = samples >> pt
    rows, cols = x.shape
    d = np.zeros_like(x)
    prev = None
    for r in range(rows):
        first = r in first_rows
        row = x[r]
        for col in range(cols):
            ra = row[col - 1] if col else None
            if first:
                pred = (1 << (precision - pt - 1)) if col == 0 else ra
            elif col == 0:
                pred = prev[0]
            else:
                rb, rc = prev[col], prev[col - 1]
                pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                        6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
            d[r, col] = ((int(row[col]) - int(pred) + 32768) & 0xFFFF) - 32768
        prev = row
    return d


def _lossless_scan(frame, planes, comps, group, tables, predictor, pt, precision, restart, sos):
    """DHT, SOS and data of one lossless scan of the components ``group``.
    jddiffct.c undoes the predictor one iMCU row at a time: a restart resets
    it for the first row of the iMCU row it falls in."""
    samples = {}
    for c in group:
        _, h, v = comps[c]
        rows, cols = frame.mcuy * v, frame.mcux * h
        p = _component_plane(planes[c], h, v, frame.hmax, frame.vmax, rows, cols)
        samples[c] = np.rint(p).astype(np.int64)
    single = len(group) == 1
    per_row = frame.dw[group[0]] if single else frame.mcux
    if restart:
        assert restart % per_row == 0, "lossless restarts fall on whole MCU rows"
    every = restart // per_row if restart else 0  # MCU rows per restart interval
    diffs = {}
    for c in group:
        v = comps[c][2]
        mcu_rows = frame.dh[c] if single else frame.mcuy
        starts = [0] + [m for m in range(1, mcu_rows) if every and m % every == 0]
        first = {(m // v) * v for m in starts} if single else {m * v for m in starts}
        diffs[c] = _lossless_diffs(samples[c], predictor, pt, precision, first)
    seq = [[(c, int(diffs[c][y, x])) for c, y, x in mcu] for _, mcu in frame.units(list(group))]
    syms = {}
    for mcu in seq:
        for c, d in mcu:
            syms.setdefault(tables[c], []).append(16 if d == -32768 else _category(d))
    dc = {t: Huffman(s) for t, s in syms.items()}
    out = segment(0xC4, b"".join(h.dht(t) for t, h in dc.items()))
    out += sos(list(group), predictor, 0, 0, pt)
    bw = BitWriter()
    for n, mcu in enumerate(seq):
        if restart and n and n % restart == 0:
            bw.flush()
            bw.out += _restart_bytes(n // restart - 1)
        for c, d in mcu:
            s = 16 if d == -32768 else _category(d)
            dc[tables[c]].put(bw, s)
            if s != 16:
                bw.put(_bits(d, s), s)
    bw.flush()
    return out + bytes(bw.out)


def write_jpeg(planes, comps, *, mode: str = "sequential", coding: str = "huffman",
               precision: int = 8, quality: int = 75, restart: int = 0, dac: bytes = b"",
               markers: bytes = b"", scans=None, predictor: int = 1, pt: int = 0) -> bytes:
    """A JPEG file of ``planes`` (full-size, one per component) with the
    components ``comps`` = ``[(id, h, v), ...]``.

    ``mode``: ``"sequential"``, ``"progressive"`` (arithmetic only; scans
    from ``scans``, default ``SIMPLE_PROGRESSION`` or one DC and AC pass per
    component) or ``"lossless"`` (Huffman, ``predictor`` 1-7, point
    transform ``pt``); in the sequential and lossless modes ``scans`` lists
    the component indices of each scan (default: one scan of all);
    ``coding``: ``"huffman"`` or ``"arith"``;
    ``restart``: MCUs per restart interval (0: none); ``dac``: the DAC
    segment's body (conditioning; none: the defaults); ``markers``: segments
    written after SOI (JFIF, Adobe, EXIF)."""
    planes = [np.asarray(p) for p in planes]
    H, W = planes[0].shape
    lossless = mode == "lossless"
    frame = Frame(H, W, comps, 1 if lossless else 8)
    tables = [0 if i == 0 else 1 for i in range(len(comps))]
    out = bytearray(b"\xff\xd8") + markers
    sof = {("sequential", "huffman"): 0xC0 if precision == 8 else 0xC1,
           ("sequential", "arith"): 0xC9, ("progressive", "arith"): 0xCA,
           ("lossless", "huffman"): 0xC3}[mode, coding]
    if not lossless:
        qts = [quant_table(quality, t == 1) for t in sorted(set(tables))]
        if precision == 12:
            qts = [np.clip(q * 4, 1, 1023) for q in qts]
        body = b""
        for t, q in enumerate(qts):
            wide = int(q.max()) > 255
            zz = q[NATURAL]
            body += bytes([(16 if wide else 0) | t]) + (
                b"".join(struct.pack(">H", int(v)) for v in zz) if wide else bytes(int(v) for v in zz))
        out += segment(0xDB, body)
    sof_body = struct.pack(">BHHB", precision, H, W, len(comps)) + b"".join(
        bytes([cid, (h << 4) | v, 0 if lossless else tables[i]])
        for i, (cid, h, v) in enumerate(comps))
    out += segment(sof, sof_body)
    if dac:
        out += segment(0xCC, dac)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    cond = ([0] * 16, [1] * 16, [5] * 16)
    for i in range(0, len(dac), 2):
        idx, val = dac[i], dac[i + 1]
        if idx >= 16:
            cond[2][idx - 16] = val
        else:
            cond[0][idx], cond[1][idx] = val & 15, val >> 4

    def sos(scan_comps, ss, se, ah, al):
        return segment(0xDA, bytes([len(scan_comps)]) + b"".join(
            bytes([comps[c][0], (tables[c] << 4) | tables[c]]) for c in scan_comps)
            + bytes([ss, se, (ah << 4) | al]))

    groups = [tuple(g) for g in scans] if scans and mode != "progressive" else [
        tuple(range(len(comps)))]
    if lossless:
        for group in groups:
            out += _lossless_scan(frame, planes, comps, group, tables, predictor, pt, precision,
                                  restart, sos)
        return bytes(out + b"\xff\xd9")

    blocks = []
    level = 1 << (precision - 1)
    top = (1 << (precision + 3)) - 1
    for c, (_, h, v) in enumerate(comps):
        rows, cols = frame.mcuy * v * 8, frame.mcux * h * 8
        p = _component_plane(planes[c], h, v, frame.hmax, frame.vmax, rows, cols) - level
        b = p.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3)
        coef = DCT @ b @ DCT.T
        q = qts[tables[c]].reshape(8, 8)
        blocks.append(np.clip(np.rint(coef / q), -top, top).astype(np.int64).reshape(
            rows // 8, cols // 8, 64))
    if coding == "huffman":
        assert mode == "sequential"
        for group in groups:
            data, dht = _huffman_scan(frame, blocks, list(group), tables, restart)
            out += segment(0xC4, dht) + sos(list(group), 0, 63, 0, 0) + data
        return bytes(out + b"\xff\xd9")
    if mode == "sequential":
        scans = [(group, 0, 63, 0, 0) for group in groups]
    elif scans is None:
        scans = SIMPLE_PROGRESSION if len(comps) == 3 else (
            [(tuple(range(len(comps))), 0, 0, 0, 0)]
            + [((c,), 1, 63, 0, 0) for c in range(len(comps))])
    for scan in scans:
        scan_comps, ss, se, ah, al = scan
        if mode == "sequential":
            ss, se = 0, 63
        out += sos(list(scan_comps), ss, se, ah, al)
        out += _arith_scan(frame, blocks, (scan_comps, ss, se, ah, al), tables, restart, cond)
    return bytes(out + b"\xff\xd9")
