"""Copy Rubik and WenQuanYi Micro Hei out of cv2's binary into the port and
check them.

    python tests/data/text/extract_font.py [--check]

cv2 5.0 carries its TrueType fonts as gzip streams inside
``cv2.abi3.so``.  This script finds every gzip stream there that unpacks to
a TrueType font and picks two by the English full name in their name
tables: "Rubik for OpenCV Light" (the upright sans face ``putText`` draws
``FONT_HERSHEY_SIMPLEX`` with) and "WenQuanYi Micro Hei" (the fallback font
it draws every character Rubik lacks with).  It writes their gzip bytes, as
they stand in the binary, to ``instancesegmentation_tpu_torch/core/fonts/
Rubik.ttf.gz`` and ``WenQuanYiMicroHei.ttf.gz``; with ``--check`` it only
compares them with those files.  Either way it checks that the bytes unpack
to the fonts the port parses (``core/text.py:Font``): Rubik's ``wght`` axis
300-900, each font's glyph count and its ``cmap`` (WenQuanYi's the format 12
subtable, six code points past the BMP among them).
"""
import argparse
import gzip
import os
import re
import sys
import zlib

import cv2

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)

from instancesegmentation_tpu_torch.core.text import (  # noqa: E402
    FALLBACK_FONT_PATH, FONT_PATH, Font)

NAME = "Rubik for OpenCV Light"
FALLBACK_NAME = "WenQuanYi Micro Hei"


def full_name(ttf: bytes) -> str:
    """The font's English full name (name ID 4, Windows platform, US
    English)."""
    import struct
    for i in range(struct.unpack_from(">H", ttf, 4)[0]):
        tag, _, offset, _ = struct.unpack_from(">4sIII", ttf, 12 + 16 * i)
        if tag == b"name":
            _, count, strings = struct.unpack_from(">HHH", ttf, offset)
            for k in range(count):
                pid, _, lang, nid, length, off = struct.unpack_from(">6H", ttf,
                                                                    offset + 6 + 12 * k)
                if pid == 3 and lang == 0x409 and nid == 4:
                    start = offset + strings + off
                    return ttf[start:start + length].decode("utf-16-be")
    return ""


def fonts_in(binary: bytes):
    """(gzip bytes, unpacked bytes) of every gzip stream holding a TrueType font."""
    for m in re.finditer(b"\x1f\x8b\x08", binary):
        d = zlib.decompressobj(31)
        try:
            out = d.decompress(binary[m.start():m.start() + 8_000_000])
        except zlib.error:
            continue
        if d.eof and out[:4] == b"\x00\x01\x00\x00":
            end = m.start() + min(8_000_000, len(binary) - m.start()) - len(d.unused_data)
            yield binary[m.start():end], out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args(argv)
    so = os.path.join(os.path.dirname(cv2.__file__), "cv2.abi3.so")
    with open(so, "rb") as f:
        binary = f.read()
    fonts = list(fonts_in(binary))
    for name, path in ((NAME, FONT_PATH), (FALLBACK_NAME, FALLBACK_FONT_PATH)):
        found = [(gz, ttf) for gz, ttf in fonts if full_name(ttf) == name]
        assert len(found) == 1, f"{len(found)} fonts named {name!r} in {so}"
        gz, ttf = found[0]
        if args.check:
            assert path.read_bytes() == gz, f"{path} differs from cv2's blob"
        else:
            path.write_bytes(gz)
        assert gzip.decompress(path.read_bytes()) == ttf
        font = Font(ttf)
        if path == FONT_PATH:
            assert font.axis == (300.0, 300.0, 900.0) and font.num_glyphs == 1174
            assert all(ord(c) in font.cmap for c in map(chr, range(32, 127)))
        else:
            assert font.axis is None and font.num_glyphs == 49531
            assert (font.ascent, font.descent, font.line_gap) == (1918, -483, 0)
            assert len(font.cmap) == 34600 and sum(c > 0xFFFF for c in font.cmap) == 6
        print(f"{path}: {len(gz)} bytes gzipped, {len(ttf)} unpacked, "
              f"{len(font.cmap)} characters")


if __name__ == "__main__":
    main()
