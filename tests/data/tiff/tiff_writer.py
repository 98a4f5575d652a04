"""A small TIFF writer for the forms that neither cv2 nor PIL writes: tiles,
planar configuration 2, 1-, 2-, 4- and 16-bit samples, MinIsWhite,
uncompressed subsampled YCbCr, separated CMYK, associated alpha, old-style
(LSB-first) LZW, the horizontal predictor, FillOrder 2, orientations 2-8,
BigTIFF in either byte order, JPEG-in-TIFF strips whose tables sit in
JPEGTables.

Test-only code, used by ``make_fixtures.py`` and the TIFF tests: its files
are valid TIFF, not good ones.  Only the decoders' agreement matters: the
tests hold the port's decode against cv2's of the same bytes.

``write_tiff(samples, ...)`` takes ``[H, W, spp]`` integer samples (each
below ``2 ** bps``; for subsampled YCbCr the full-size Y, Cb and Cr planes,
whose chroma is averaged over each block).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

NONE, LZW, JPEG, DEFLATE, PACKBITS = 1, 5, 7, 8, 32773
TYPES = {"B": 1, "A": 2, "H": 3, "I": 4, "R": 5, "Q": 16}


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw(data: bytes, old: bool = False) -> bytes:
    """TIFF LZW: 9- to 12-bit codes MSB first, the width growing one entry
    early (at 511, 1023, 2047), a clear code before the table fills; ``old``:
    the pre-5.0 form, LSB first and without the early change."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code: int) -> None:
        nonlocal acc, nacc
        if old:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << width) | code
            nacc += width
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
                acc &= (1 << nacc) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        limit = nxt if old else nxt + 1
        if limit > (1 << width) and width < 12:
            width += 1
        if nxt >= 4093:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = bytes([c])
    if w:
        put(table[w])
        nxt += 1
        limit = nxt if old else nxt + 1
        if limit > (1 << width) and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append(((acc << (8 - nacc)) & 0xFF) if not old else acc & 0xFF)
    return bytes(out)


def pack_rows(a: np.ndarray, bps: int, order: str) -> bytes:
    """``[rows, values]`` samples as TIFF rows: bits MSB first, each row
    byte-aligned; 16-bit values in the file's byte order."""
    a = np.asarray(a, np.int64)
    if bps == 8:
        return a.astype(np.uint8).tobytes()
    if bps == 16:
        return a.astype(order + "u2").tobytes()
    rows = []
    for row in a:
        bits = ((row[:, None] >> np.arange(bps - 1, -1, -1)) & 1).astype(np.uint8).ravel()
        rows.append(np.packbits(bits).tobytes())
    return b"".join(rows)


def ycbcr_blocks(planes: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """Full-size Y, Cb, Cr ``[H, W, 3]`` as TIFF's subsampled blocks, one
    row of blocks per ``vs`` image rows: ``[ceil(H / vs), ceil(W / hs) *
    (hs * vs + 2)]`` (edges padded by repetition)."""
    h, w, _ = planes.shape
    bh, bw = -(-h // vs), -(-w // hs)
    p = np.pad(planes, ((0, bh * vs - h), (0, bw * hs - w), (0, 0)), mode="edge").astype(np.int64)
    y = p[..., 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, vs * hs)
    cb = p[..., 1].reshape(bh, vs, bw, hs).mean(axis=(1, 3)).round().astype(np.int64)
    cr = p[..., 2].reshape(bh, vs, bw, hs).mean(axis=(1, 3)).round().astype(np.int64)
    return np.concatenate([y, cb[..., None], cr[..., None]], axis=-1).reshape(bh, -1)


def predict(rows: np.ndarray, spp: int, bps: int) -> np.ndarray:
    """Horizontal differencing (predictor 2) of ``[rows, width * spp]``."""
    d = rows.astype(np.int64).copy()
    d[:, spp:] = rows[:, spp:].astype(np.int64) - rows[:, :-spp].astype(np.int64)
    return d & ((1 << bps) - 1)


def reverse_bits(data: bytes) -> bytes:
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return data.translate(table)


def split_jpeg_tables(stream: bytes) -> tuple[bytes, bytes]:
    """A whole JPEG stream as (JPEGTables: SOI, DQT, DHT, EOI) and the
    abbreviated stream that is left (SOI, the other segments, the scan)."""
    tables, rest, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while True:
        marker = stream[pos + 1]
        if marker == 0xDA:
            rest += stream[pos:]
            break
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        (tables if marker in (0xDB, 0xC4) else rest).extend(stream[pos:pos + 2 + n])
        pos += 2 + n
    return bytes(tables + b"\xff\xd9"), bytes(rest)


def write_tiff(samples: np.ndarray, *, bps: int = 8, photometric: int = 1, compression: int = NONE,
               planar: int = 1, rows_per_strip: int | None = None, tile: tuple | None = None,
               predictor: int = 1, fillorder: int = 1, orientation: int | None = None,
               extra_samples: tuple | None = None, colormap: np.ndarray | None = None,
               sample_format: int | None = None, subsampling: tuple | None = None,
               order: str = "<", big: bool = False, lzw_old: bool = False,
               jpeg_strip=None, jpeg_tables: bytes | None = None, ifd_first: bool = False,
               extra_tags: dict | None = None, omit: tuple = (), lead: int = 0) -> bytes:
    """One TIFF image of ``samples`` ``[H, W, spp]``; ``jpeg_strip(rows
    [h, w, spp] uint8) -> bytes`` encodes a strip or tile for compression 7
    (its tables, if ``jpeg_tables`` is given, already taken out); ``lead``
    zero bytes come before the first strip (odd offsets for odd ``lead``)."""
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[..., None]
    h, w, spp = a.shape
    ycc = photometric == 6 and subsampling not in (None, (1, 1)) and planar == 1 \
        and compression != JPEG
    hs, vs = subsampling or (1, 1)
    if tile:
        tw, th = tile
        cols, rows = -(-w // tw), -(-h // th)
        boxes = [(r * th, c * tw, th, tw) for r in range(rows) for c in range(cols)]
    else:
        rps = rows_per_strip or h
        boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    planes = [a] if planar == 1 else [a[..., i:i + 1] for i in range(spp)]
    chunks = []
    for plane in planes:
        for y0, x0, bh, bw in boxes:
            if tile:
                part = np.zeros((bh, bw, plane.shape[2]), a.dtype)
                src = plane[y0:y0 + bh, x0:x0 + bw]
                part[:src.shape[0], :src.shape[1]] = src
            else:
                part = plane[y0:y0 + bh]
            if compression == JPEG:
                data = jpeg_strip(part.astype(np.uint8))
            else:
                if ycc:
                    rows2d = ycbcr_blocks(part, hs, vs)
                else:
                    rows2d = part.reshape(part.shape[0], -1)
                    if predictor == 2:
                        rows2d = predict(rows2d, part.shape[2], bps)
                raw = pack_rows(rows2d, bps, order)
                data = {NONE: lambda b: b, PACKBITS: packbits, DEFLATE: zlib.compress,
                        32946: zlib.compress,
                        LZW: lambda b: lzw(b, lzw_old)}[compression](raw)
            if fillorder == 2:
                data = reverse_bits(data)
            chunks.append(data)
    tags = {256: ("I", [w]), 257: ("I", [h]), 258: ("H", [bps] * spp), 259: ("H", [compression]),
            262: ("H", [photometric]), 277: ("H", [spp]), 284: ("H", [planar])}
    if fillorder != 1:
        tags[266] = ("H", [fillorder])
    if orientation is not None:
        tags[274] = ("H", [orientation])
    if predictor != 1:
        tags[317] = ("H", [predictor])
    if extra_samples is not None:
        tags[338] = ("H", list(extra_samples))
    if sample_format is not None:
        tags[339] = ("H", [sample_format] * spp)
    if colormap is not None:
        tags[320] = ("H", list(np.asarray(colormap, np.int64).T.ravel()))
    if subsampling is not None:
        tags[530] = ("H", list(subsampling))
    if jpeg_tables is not None:
        tags[347] = ("B", list(jpeg_tables))
    if tile:
        tags[322], tags[323] = ("I", [tile[0]]), ("I", [tile[1]])
    else:
        tags[278] = ("I", [rows_per_strip or h])
    for k, v in (extra_tags or {}).items():
        tags[k] = v
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    off_type = "Q" if big else "I"
    tags[off_tag] = (off_type, [0] * len(chunks))
    tags[cnt_tag] = (off_type, [len(c) for c in chunks])
    for t in omit:
        tags.pop(t, None)
    return _assemble(tags, chunks, off_tag, order, big, ifd_first, lead)


def _assemble(tags: dict, chunks: list, off_tag: int, order: str, big: bool,
              ifd_first: bool, lead: int = 0) -> bytes:
    entry, count_fmt, off_fmt, inline = ("HHQ8s", "Q", "Q", 8) if big else ("HHI4s", "H", "I", 4)
    head = (b"II" if order == "<" else b"MM") + (
        struct.pack(order + "HHHQ", 43, 8, 0, 0) if big else struct.pack(order + "HI", 42, 0))
    n = len(tags)
    ifd_size = struct.calcsize(order + count_fmt) + n * struct.calcsize(order + entry) + \
        struct.calcsize(order + off_fmt)

    def layout(ifd_at: int, values_at: int, data_at: int):
        values, blobs, pos = {}, bytearray(), values_at
        offsets, dpos = [], data_at
        for c in chunks:
            offsets.append(dpos)
            dpos += len(c)
        for tag in sorted(tags):
            typ, vals = tags[tag]
            if tag == off_tag:
                vals = offsets
            raw = (bytes(vals) if typ == "A" else
                   struct.pack(order + typ * len(vals), *vals))
            if len(raw) <= inline:
                values[tag] = (typ, len(vals), raw.ljust(inline, b"\0"))
            else:
                if len(blobs) % 2:
                    blobs.append(0)
                values[tag] = (typ, len(vals), struct.pack(order + off_fmt, values_at + len(blobs)))
                blobs += raw
        ifd = struct.pack(order + count_fmt, n) + b"".join(
            struct.pack(order + entry, tag, TYPES[values[tag][0]], values[tag][1], values[tag][2])
            for tag in sorted(tags)) + struct.pack(order + off_fmt, 0)
        return ifd, bytes(blobs)

    data = bytes(lead) + b"".join(chunks)
    hlen = len(head)
    if ifd_first:
        ifd, blobs = layout(hlen, hlen + ifd_size, 0)
        data_at = hlen + ifd_size + len(blobs)
        ifd, blobs = layout(hlen, hlen + ifd_size, data_at + lead)
        body = ifd + blobs + data
        ifd_at = hlen
    else:
        data_at = hlen + lead
        values_at = hlen + len(data) + (len(data) % 2)
        _, blobs = layout(0, values_at, data_at)
        ifd_at = values_at + len(blobs) + (len(blobs) % 2)
        ifd, blobs = layout(ifd_at, values_at, data_at)
        body = data + b"\0" * (len(data) % 2) + blobs + b"\0" * (len(blobs) % 2) + ifd
    head = head[:-8] + struct.pack(order + "Q", ifd_at) if big else \
        head[:-4] + struct.pack(order + "I", ifd_at)
    return head + body


# -- CCITT modified Huffman (T.4), for RLEW strips ------------------------------------

#: the white and black codes of runs 0-63 and 64-1728 (in steps of 64), then
#: the make-up codes both colours share (1792-2560)
_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100 11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 011010101 "
    "011010110 011010111 011011000 011011001 011011010 011011011 010011000 010011001 "
    "010011010 011000 010011011").split()
_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111 "
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
    "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
    "000000011111").split()


def _mh_code(run: int, black: bool) -> str:
    """The modified Huffman codes of one run (make-up codes first)."""
    table = _BLACK if black else _WHITE
    out = ""
    while run > 2560:
        out += _MAKEUP[-1]
        run -= 2560
    if run >= 1792:
        out += _MAKEUP[(run - 1792) // 64]
        run %= 64
    elif run >= 64:
        out += table[63 + run // 64]
        run %= 64
    return out + table[run]


def mh_runs(runs) -> str:
    """The bits of one row given as its runs, white first (a white run of 0
    where the row starts black)."""
    return "".join(_mh_code(int(r), i % 2 == 1) for i, r in enumerate(runs))


def row_runs(row: np.ndarray) -> list:
    """The runs of one row of 1-bit samples (1 black), white first."""
    runs, colour, n = [], 0, 0
    for v in np.asarray(row).astype(int):
        if v != colour:
            runs.append(n)
            colour, n = v, 0
        n += 1
    return runs + [n]


def bits_to_bytes(bits: str) -> bytes:
    """A string of bits, MSB first, padded with zeros to a whole byte."""
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def ccitt_rlew(part: np.ndarray, rows=None) -> bytes:
    """CCITT RLEW (32771): each row's modified Huffman codes padded with
    zeros to 16 bits (``rows``: bit strings to use instead of the rows of
    ``part`` [h, w, 1], 1 black)."""
    rows = [mh_runs(row_runs(r)) for r in np.asarray(part)[..., 0]] if rows is None else rows
    return b"".join(bits_to_bytes(b + "0" * (-len(b) % 16)) for b in rows)
