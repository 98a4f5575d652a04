"""``imread(path, mode)`` and ``imdecode(data, mode)``: the port's
``cv2.imread`` / ``cv2.imdecode``, for every image and mask that the port's
dataset reader, ``eval``, ``infer`` and the dataset converters open.

``"color"`` gives RGB uint8 ``[H, W, 3]`` (cv2's BGR converted, as the JAX
package's readers do), ``"gray"`` uint8 ``[H, W]``; PNG, JPEG and WebP
turned by the file's EXIF orientation.  The decoder is chosen by the file's
leading bytes, as cv2 chooses it, never by its extension:

- PNG signature: ``core/png.py`` (every valid PNG);
- JPEG ``FF D8 FF``: ``ops/native/jpeg.py`` (C++, built with g++ at first
  use; without a compiler the read raises ``RuntimeError``): every form cv2
  decodes (Huffman or arithmetic, sequential, progressive or lossless, any
  whole-number sampling, gray, YCbCr, RGB, CMYK, YCCK);
- ``BM``: ``core/bmp.py`` (uncompressed, RLE4 and RLE8);
- ``P1``-``P6``, ``P7``, ``PF`` / ``Pf`` (then whitespace): ``core/pnm.py``
  (PNM, PAM, PFM);
- ``59 A6 6A 95``: ``core/sunras.py`` (Sun raster);
- ``#?RGBE`` / ``#?RADIANCE``: ``core/hdr.py`` (Radiance HDR);
- ``GIF87a`` / ``GIF89a``: ``core/gif.py`` (the first frame);
- ``49 49 2A 00`` / ``4D 4D 00 2A`` (TIFF), ``49 49 2B 00`` / ``4D 4D 00 2B`` (BigTIFF):
  ``core/tiff.py`` (the first image, as libtiff's RGBA interface and cv2
  read it: strips or tiles, none, PackBits, LZW, Deflate, JPEG, CCITT (RLE,
  RLEW, Group 3, Group 4), ThunderScan and SGILog data, gray, palette,
  RGB(A), CMYK, YCbCr, CIELab, LogL and LogLuv pixels: every form cv2
  reads);
- ``RIFF....WEBP``: ``core/webp.py`` with its bit streams in
  ``ops/native/webp.cpp`` (built like the JPEG decoder): lossless (VP8L),
  lossy (VP8, its ALPH stream decoded and dropped), VP8X with EXIF, the
  first frame of an animation, as cv2's libwebp reads them;
- the JP2 signature box ``00 00 00 0C 6A 50 20 20 0D 0A 87 0A`` and the raw
  codestream's ``FF 4F FF 51``: ``core/jpeg2000.py`` with its codestream
  decoder in ``ops/native/jpeg2000.cpp`` (built like the JPEG decoder):
  JPEG 2000 as cv2's OpenJPEG 2.5.3 reads it (5/3 and 9/7, RCT and ICT,
  every progression order, tiles, layers, precincts, code-block styles,
  ROI, the JP2 boxes, palettes and channel definitions) and cv2 converts
  it;
- an ISO-BMFF ``ftyp`` naming ``avif`` or ``avis``: ``core/avif.py`` with
  its AV1 decoder in ``ops/native/av1.cpp`` (built like the JPEG decoder):
  AVIF still images as cv2's libavif 1.4.2 over libaom 3.14.1 reads them
  (one AV1 key frame at 8 bits in 4:2:0, 4:4:4 or 4:0:0, every intra tool
  and post-filter, its alpha item decoded and dropped) and cv2 converts
  them.

The RLE and LZW codes of BMP, Sun raster, HDR, GIF and TIFF, and TIFF's
CCITT, ThunderScan and SGILog codes and its CIELab conversion, are unpacked
by ``ops/native/image_codes.cpp``
(built like the JPEG decoder; without a compiler such a read raises
``RuntimeError``).

Where cv2 returns None, ``imread`` raises ``FileNotFoundError``: a missing
or empty file, leading bytes that no decoder claims (among them OpenEXR's
``76 2F 31 01``: this container's cv2 is built without OpenEXR), a file
that is cut or corrupt where cv2's decoder gives up (an AVIF file where
libavif or libaom does), a JPEG form that
libjpeg-turbo refuses (hierarchical, 12-bit, lossless arithmetic, ...: see
``ops/native/jpeg.py``), a TIFF form libtiff or cv2 refuses (see
``core/tiff.py``), a WebP shorter than cv2's 32-byte header read (even one
that starts ``RIFF....WEBP``) or one libwebp refuses (see
``core/webp.py``), a JPEG 2000 file OpenJPEG or cv2 refuses (see
``core/jpeg2000.py``).  A header whose size cv2 itself raises on raises
``ImageSizeError`` (``core/png.py``).  A valid file of a form the port does not decode raises
``UnsupportedImage``, a ``ValueError`` naming ROADMAP A10 part 3: the port
never drops silently what the JAX package reads.  Those forms are AVIF's of
step 6b (10 and 12 bits, superres, film grain, ``grid`` and other derived
items, sequences, an ``ispe`` that scales the frame, colour matrices
libavif converts without libyuv: see ``core/avif.py``) and JPEG 2000's of step 5
(HTJ2K code-blocks, Part 2 transforms).  ``cv2.imread`` and
``cv2.imdecode`` differ on three forms,
which the port follows (``imdecode`` reads as ``cv2.imdecode``; WebP and
JPEG 2000 read alike through both):
a PFM whose channels differ from the read mode's is None to ``imread`` and
its own channels to ``imdecode``; JPEG data that ends before its decode
does is None to ``imdecode`` (cv2's memory source suspends where a file's
inserts an end marker) and decoded by ``imread``; a TIFF turned by
orientation 5-8 is None to ``imread`` and turned by ``imdecode``, and
libtiff's buffer takes an uncompressed tile whose size is not a whole KiB
from a mapped file only, and CCITT RLEW's rows are aligned by the address
of each strip's first byte (its file offset to a mapped file).
"""
from __future__ import annotations

import os

import numpy as np

from instancesegmentation_tpu_torch.core.avif import decode_avif, is_avif
from instancesegmentation_tpu_torch.core.bmp import SIGNATURE as BMP_SIGNATURE
from instancesegmentation_tpu_torch.core.bmp import decode_bmp
from instancesegmentation_tpu_torch.core.gif import SIGNATURES as GIF_SIGNATURES
from instancesegmentation_tpu_torch.core.gif import decode_gif
from instancesegmentation_tpu_torch.core.hdr import SIGNATURES as HDR_SIGNATURES
from instancesegmentation_tpu_torch.core.hdr import decode_hdr
from instancesegmentation_tpu_torch.core.jpeg2000 import SIGNATURES as JPEG2000_SIGNATURES
from instancesegmentation_tpu_torch.core.jpeg2000 import decode_jpeg2000
from instancesegmentation_tpu_torch.core.png import SIGNATURE as PNG_SIGNATURE
from instancesegmentation_tpu_torch.core.png import (
    ImageSizeError,
    UnsupportedImage,
    png_pixels,
)
from instancesegmentation_tpu_torch.core.pnm import decode_pam, decode_pfm, decode_pnm
from instancesegmentation_tpu_torch.core.sunras import SIGNATURE as SUNRAS_SIGNATURE
from instancesegmentation_tpu_torch.core.sunras import decode_sunras
from instancesegmentation_tpu_torch.core.tiff import SIGNATURES as TIFF_SIGNATURES
from instancesegmentation_tpu_torch.core.tiff import decode_tiff
from instancesegmentation_tpu_torch.core.webp import decode_webp, is_webp
from instancesegmentation_tpu_torch.ops.native.jpeg import SIGNATURE as JPEG_SIGNATURE
from instancesegmentation_tpu_torch.ops.native.jpeg import decode_jpeg

def _decoder(data: bytes, read_file: bool):
    """The decoder that claims ``data``'s leading bytes, or None."""
    if data.startswith(PNG_SIGNATURE):
        return png_pixels
    if data.startswith(JPEG_SIGNATURE):
        return lambda d, mode, path: decode_jpeg(d, mode, path, imread=read_file)
    if data.startswith(BMP_SIGNATURE):
        return decode_bmp
    if len(data) >= 3 and data[:1] == b"P" and data[2:3].isspace():
        if data[1:2] in b"123456":
            return decode_pnm
        if data[1:2] == b"7":
            return decode_pam
        if data[1:2] in (b"f", b"F"):
            return lambda d, mode, path: decode_pfm(d, mode, path, imread=read_file)
    if data.startswith(SUNRAS_SIGNATURE):
        return decode_sunras
    if data.startswith(HDR_SIGNATURES):
        return decode_hdr
    if data.startswith(GIF_SIGNATURES):
        return decode_gif
    if data.startswith(TIFF_SIGNATURES):
        return lambda d, mode, path: decode_tiff(d, mode, path, imread=read_file)
    if is_webp(data):
        return decode_webp
    if data.startswith(JPEG2000_SIGNATURES):
        return decode_jpeg2000
    if is_avif(data):
        return decode_avif
    return None


def _decode(data: bytes, mode: str, path: str, read_file: bool) -> np.ndarray:
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    decode = _decoder(data, read_file)
    if decode is None:
        what = "empty data" if not data else "no decoder claims its leading bytes"
        raise FileNotFoundError(f"cannot decode image: {path} ({what})")
    try:
        return decode(data, mode, path)
    except (UnsupportedImage, ImageSizeError):
        raise
    except ValueError as e:
        raise FileNotFoundError(f"cannot decode image: {path} ({e})") from e


def imdecode(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """Decode the image bytes ``data`` as ``cv2.imdecode`` (``"color"``: RGB
    ``[H, W, 3]``; ``"gray"``: ``[H, W]``; a PFM in its own channels);
    raises as ``imread`` does, with ``path`` in the messages."""
    return _decode(data, mode, path, read_file=False)


def imread(path: str, mode: str = "color") -> np.ndarray:
    """Decode the image file ``path`` as ``cv2.imread`` (``"color"``: RGB
    ``[H, W, 3]``; ``"gray"``: ``[H, W]``); see the module's docstring for
    what raises."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot decode image: {path} (no such file)")
    with open(path, "rb") as f:
        return _decode(f.read(), mode, path, read_file=True)
