"""Write the EXIF fixtures of the port's orientation rule, with cv2's
decodes beside them.

    python tests/data/exif/make_fixtures.py

Each file is a small picture (24 x 40) whose EXIF block (a JPEG's APP1
segment, a PNG's ``eXIf`` chunk or a WebP's ``EXIF`` chunk) holds an
orientation 6 entry after another entry of IFD0.  Where cv2's
``ExifReader`` reads that earlier entry's data and finds it outside the
block, it stops and the image stays unturned; where the data fits, or the
tag's data is not read, the image is turned (``core/exif.py``).

``<name>.npz`` holds what cv2 gives for it in the layout of
``tests/data/tiff/make_fixtures.py``'s ``cv2_reads`` (``imread`` of the file,
``imdecode`` of its bytes where they differ), which
``tests/test_torch_port_imread.py`` holds against cv2 and the port and
``chip_smoke.py``'s ``tiff_phase`` holds the port against on a machine
without cv2.
"""
import glob
import importlib.util
import os
import struct
import zlib

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.dirname(HERE)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: (tag, type, count, offset or None for "past the block") of the entry
#: before the orientation, and whether cv2 turns the image
CASES = {
    "make_past_end": ((0x010F, 2, 10, None), False),
    "make_at_end": ((0x010F, 2, 6, -6), True),
    "make_one_past_end": ((0x010F, 2, 6, -5), False),
    "make_inline": ((0x010F, 2, 4, 9000), True),
    "make_as_short": ((0x010F, 3, 10, None), False),
    "xresolution_fits": ((0x011A, 5, 1, -8), True),
    "xresolution_short": ((0x011A, 5, 1, -7), False),
    "whitepoint_short": ((0x013E, 5, 2, -15), False),
    "refblackwhite_past_end": ((0x0214, 5, 6, None), False),
    "artist_past_end": ((0x013B, 2, 10, None), True),
    "exif_ifd_past_end": ((0x8769, 4, 1, None), True),
}
#: the containers each case is written in
CONTAINERS = {"make_past_end": ("jpg", "png", "webp"), "make_at_end": ("jpg", "png", "webp"),
              "xresolution_short": ("jpg", "png", "webp"), "artist_past_end": ("jpg", "png")}


def exif_block(entry: tuple, order: str = "<", tail: int = 12) -> bytes:
    """A TIFF block: ``II`` or ``MM``, IFD0 at 8 with ``entry`` then
    orientation 6, a next-IFD offset of 0 and ``tail`` bytes of ``'A'``;
    an offset of None points past the block, a negative one counts back
    from its end."""
    tag, typ, count, offset = entry
    size = 8 + 2 + 2 * 12 + 4 + tail
    offset = 9000 if offset is None else size + offset if offset < 0 else offset
    head = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, 8)
    ifd = struct.pack(order + "H", 2) + struct.pack(order + "HHII", tag, typ, count, offset) + \
        struct.pack(order + "HHIHH", 0x0112, 3, 1, 6, 0) + struct.pack(order + "I", 0)
    return head + ifd + b"A" * tail


def jpeg_with_exif(jpeg: bytes, block: bytes) -> bytes:
    """``jpeg`` with an APP1 ``Exif`` segment holding ``block`` after SOI."""
    body = b"Exif\0\0" + block
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


def png_with_exif(png: bytes, block: bytes) -> bytes:
    """``png`` with an ``eXIf`` chunk holding ``block`` after IHDR."""
    chunk = struct.pack(">I", len(block)) + b"eXIf" + block + struct.pack(
        ">I", zlib.crc32(b"eXIf" + block))
    return png[:33] + chunk + png[33:]


def picture() -> np.ndarray:
    """A 24 x 40 RGB picture, its turned form plainly different."""
    y, x = np.mgrid[0:24, 0:40]
    return np.stack([x * 6, y * 10, (x + 2 * y) * 3], -1).astype(np.uint8)


def fixtures() -> dict[str, bytes]:
    webp = _load(os.path.join(DATA, "webp", "make_fixtures.py"), "webp_fixtures")
    img = picture()
    bgr = np.ascontiguousarray(img[..., ::-1])
    jpeg = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
    png = cv2.imencode(".png", bgr)[1].tobytes()
    stream = webp.chunks_of(webp.cv2_webp(img, 101))[0]
    out = {}
    for name, (entry, _) in CASES.items():
        for ext in CONTAINERS.get(name, ("jpg", "png")):
            for order in "<>" if name == "make_past_end" else "<":
                block = exif_block(entry, order)
                data = {"jpg": lambda: jpeg_with_exif(jpeg, block),
                        "png": lambda: png_with_exif(png, block),
                        "webp": lambda: webp.riff([webp.vp8x(0x08, 40, 24), stream,
                                                   (b"EXIF", block)])}[ext]()
                out[f"{name}{'_be' if order == '>' else ''}.{ext}"] = data
    return out


def main() -> None:
    tiff = _load(os.path.join(DATA, "tiff", "make_fixtures.py"), "tiff_fixtures")
    for old in glob.glob(os.path.join(HERE, "*.*")):
        if not old.endswith(".py"):
            os.remove(old)
    for name, data in fixtures().items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        arrays = tiff.cv2_reads(path, data)
        np.savez_compressed(os.path.splitext(path)[0] + "_" + name.rsplit(".", 1)[1] + ".npz",
                            **arrays)
        print(f"{name}: {len(data)} bytes, {sorted(arrays)}")


if __name__ == "__main__":
    main()
