"""Copy Rubik out of cv2's binary into the port and check it.

    python tests/data/text/extract_font.py [--check]

cv2 5.0 carries its TrueType fonts as gzip streams inside
``cv2.abi3.so``.  This script finds every gzip stream there that unpacks to
a TrueType font, picks the one whose name table says "Rubik for OpenCV
Light" (the upright sans face ``putText`` draws ``FONT_HERSHEY_SIMPLEX``
with), and writes its gzip bytes, as they stand in the binary, to
``instancesegmentation_tpu_torch/core/fonts/Rubik.ttf.gz``; with
``--check`` it only compares them with that file.  Either way it checks
that the bytes unpack to the font the port parses (``core/text.py:Font``):
the same ``cmap``, the ``wght`` axis 300-900 and the glyph count.
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

from instancesegmentation_tpu_torch.core.text import FONT_PATH, Font  # noqa: E402

NAME = "Rubik for OpenCV Light"


def full_name(ttf: bytes) -> str:
    """The font's full name (name ID 4, Windows platform)."""
    import struct
    for i in range(struct.unpack_from(">H", ttf, 4)[0]):
        tag, _, offset, _ = struct.unpack_from(">4sIII", ttf, 12 + 16 * i)
        if tag == b"name":
            _, count, strings = struct.unpack_from(">HHH", ttf, offset)
            for k in range(count):
                pid, _, _, nid, length, off = struct.unpack_from(">6H", ttf, offset + 6 + 12 * k)
                if pid == 3 and nid == 4:
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
    found = [(gz, ttf) for gz, ttf in fonts_in(binary) if full_name(ttf) == NAME]
    assert len(found) == 1, f"{len(found)} Rubik fonts in {so}"
    gz, ttf = found[0]
    if args.check:
        assert FONT_PATH.read_bytes() == gz, f"{FONT_PATH} differs from cv2's blob"
    else:
        FONT_PATH.write_bytes(gz)
    assert gzip.decompress(FONT_PATH.read_bytes()) == ttf
    font = Font(ttf)
    assert font.axis == (300.0, 300.0, 900.0) and font.num_glyphs == 1174
    assert all(ord(c) in font.cmap for c in map(chr, range(32, 127)))
    print(f"{FONT_PATH}: {len(gz)} bytes gzipped, {len(ttf)} unpacked, "
          f"{len(font.cmap)} characters")


if __name__ == "__main__":
    main()
