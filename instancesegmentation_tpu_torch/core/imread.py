"""``imread(path, mode)`` and ``imdecode(data, mode)``: the port's
``cv2.imread`` / ``cv2.imdecode``, for every image and mask that the port's
dataset reader, ``eval``, ``infer`` and the dataset converters open.

``"color"`` gives RGB uint8 ``[H, W, 3]`` (cv2's BGR converted, as the JAX
package's readers do), ``"gray"`` uint8 ``[H, W]``; both turned by the
file's EXIF orientation.  The decoder is chosen by the file's leading bytes,
as cv2 chooses it, never by its extension:

- PNG signature: ``core/png.py`` (every valid PNG);
- JPEG ``FF D8 FF``: ``ops/native/jpeg.py`` (C++, built with g++ at first
  use; without a compiler the read raises ``RuntimeError``);
- ``BM``: ``core/bmp.py``.

Where cv2 returns None, ``imread`` raises ``FileNotFoundError``: a missing
or empty file, leading bytes that no decoder claims, a file that is cut or
corrupt where cv2's decoder gives up.  A valid file of a form the port
does not decode (RLE BMPs, arithmetic-coded, 12-bit, lossless or CMYK
JPEGs, and the other formats cv2 reads: TIFF, WebP, PNM, JPEG 2000, ...)
raises ``UnsupportedImage``, a ``ValueError`` naming ROADMAP A10 part 3:
the port never drops silently what the JAX package reads.
"""
from __future__ import annotations

import os

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import SIGNATURE as BMP_SIGNATURE
from instancesegmentation_tpu_torch.core.bmp import decode_bmp
from instancesegmentation_tpu_torch.core.png import SIGNATURE as PNG_SIGNATURE
from instancesegmentation_tpu_torch.core.png import UnsupportedImage, png_pixels
from instancesegmentation_tpu_torch.ops.native.jpeg import SIGNATURE as JPEG_SIGNATURE
from instancesegmentation_tpu_torch.ops.native.jpeg import decode_jpeg

#: leading bytes of the other formats cv2 decodes, which the port does not
_OTHER_FORMATS = (
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
    (b"GIF87a", "GIF"),
    (b"GIF89a", "GIF"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
    (b"\xff\x4f\xff\x51", "JPEG 2000"),
    (b"\x76\x2f\x31\x01", "OpenEXR"),
    (b"#?RADIANCE", "Radiance HDR"),
    (b"#?RGBE", "Radiance HDR"),
    (b"\x59\xa6\x6a\x95", "Sun raster"),
)


def _other_format(data: bytes) -> str | None:
    for sig, name in _OTHER_FORMATS:
        if data.startswith(sig):
            return name
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if len(data) >= 3 and data[:1] == b"P" and data[1:2] in b"1234567" and data[2:3].isspace():
        return "PNM"
    if data[:2] in (b"PF", b"Pf") and data[2:3].isspace():
        return "PFM"
    return None


def imdecode(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """Decode the image bytes ``data`` as ``cv2.imdecode`` (``"color"``: RGB
    ``[H, W, 3]``; ``"gray"``: ``[H, W]``); raises as ``imread`` does, with
    ``path`` in the messages."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    if data.startswith(PNG_SIGNATURE):
        decode = png_pixels
    elif data.startswith(JPEG_SIGNATURE):
        decode = decode_jpeg
    elif data.startswith(BMP_SIGNATURE):
        decode = decode_bmp
    else:
        name = _other_format(data)
        if name is not None:
            raise UnsupportedImage(f"{path}: {name} files are not decoded (ROADMAP A10 part 3)")
        what = "empty data" if not data else "no decoder claims its leading bytes"
        raise FileNotFoundError(f"cannot decode image: {path} ({what})")
    try:
        return decode(data, mode, path)
    except UnsupportedImage:
        raise
    except ValueError as e:
        raise FileNotFoundError(f"cannot decode image: {path} ({e})") from e


def imread(path: str, mode: str = "color") -> np.ndarray:
    """Decode the image file ``path`` as ``cv2.imread`` (``"color"``: RGB
    ``[H, W, 3]``; ``"gray"``: ``[H, W]``); see the module's docstring for
    what raises."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot decode image: {path} (no such file)")
    with open(path, "rb") as f:
        return imdecode(f.read(), mode, path)
