"""``imwrite(path, image)`` and ``imencode(ext, image)``: the port's
``cv2.imwrite`` / ``cv2.imencode``, with the encoder chosen by the
extension as cv2 5.0 chooses it (letter case ignored), each giving cv2's
bytes at its default parameters:

- ``.png``: ``core/png.py:encode_png`` (rows in filter Sub, zlib level 1
  with ``Z_RLE`` as libpng writes them);
- ``.jpg`` / ``.jpeg`` / ``.jpe``: ``ops/native/jpeg.py:encode_jpeg``
  (quality 95, 4:2:0);
- ``.bmp`` / ``.dib``: ``core/bmp.py:encode_bmp``;
- ``.pbm`` (gray only), ``.pgm`` (gray only), ``.ppm`` (colour only),
  ``.pnm``, ``.pam`` and ``.pfm``: ``core/pnm.py``;
- ``.sr`` / ``.ras``: ``core/sunras.py:encode_sunras``;
- ``.hdr`` / ``.pic``: ``core/hdr.py:encode_hdr``;
- ``.gif`` (colour only): ``core/gif.py:encode_gif``;
- ``.tif`` / ``.tiff``: ``core/tiff.py:encode_tiff`` (LZW and the
  horizontal predictor, as libtiff 4.7.1 writes them for cv2);
- ``.webp``: ``core/webp.py:encode_webp``, a lossless VP8L file as cv2
  writes it by default: not cv2's bytes (libwebp's choices are heuristic)
  but the same pixels in every reader;
- ``.jp2``: ``core/jpeg2000.py:encode_jpeg2000``, OpenJPEG 2.5.3's file at
  cv2's default rate 4, byte for byte.

``image`` is RGB ``[H, W, 3]`` or gray ``[H, W]`` (or ``[H, W, 1]``) uint8,
as the port's readers return it, and RGBA ``[H, W, 4]`` for PNG, BMP, WebP
and JPEG 2000: the file holds what ``cv2.imwrite`` writes for the BGR(A)
counterpart.  Where cv2's encoder refuses the image (gray to ``.ppm`` or
``.gif``, colour to ``.pbm`` or ``.pgm``, four channels to a PNM, PFM or
HDR file, a side above 16,383 to ``.webp``, a side under 32 to ``.jp2``),
``imencode`` returns None and ``imwrite`` returns False and writes no
file, except where cv2 has opened the file already: ``.gif`` leaves it
empty, ``.pfm`` leaves the one byte ``P`` it wrote before its check and
``.jp2`` the JP2 boxes OpenJPEG wrote before its check; ``.webp`` removes
a file that was there.  ``.avif``, which cv2 writes with a codec the port
has not ported (ROADMAP queue A), four channels to a format other than
PNG, BMP, WebP and JPEG 2000, and an extension cv2 has no writer for raise
``ValueError`` naming the extension.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import encode_bmp
from instancesegmentation_tpu_torch.core.gif import encode_gif
from instancesegmentation_tpu_torch.core.hdr import encode_hdr
from instancesegmentation_tpu_torch.core.jpeg2000 import encode_jpeg2000, jp2_header_boxes
from instancesegmentation_tpu_torch.core.png import encode_png
from instancesegmentation_tpu_torch.core.pnm import (
    encode_pam,
    encode_pbm,
    encode_pfm,
    encode_pgm,
    encode_pnm,
    encode_ppm,
)
from instancesegmentation_tpu_torch.core.sunras import encode_sunras
from instancesegmentation_tpu_torch.core.tiff import encode_tiff
from instancesegmentation_tpu_torch.core.webp import encode_webp
from instancesegmentation_tpu_torch.ops.native.jpeg import encode_jpeg

#: encoders that take the image as given (their own checks, RGBA for PNG, BMP, WebP
#: and JPEG 2000)
_WHOLE = {".png": encode_png, ".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".jpe": encode_jpeg,
          ".bmp": encode_bmp, ".dib": encode_bmp, ".webp": encode_webp,
          ".jp2": encode_jpeg2000}
#: encoders of ``[H, W, C]`` (C 1 or 3) that return None where cv2 refuses
_PIXELS = {".pbm": encode_pbm, ".pgm": encode_pgm, ".ppm": encode_ppm, ".pnm": encode_pnm,
           ".pam": encode_pam, ".pfm": encode_pfm, ".sr": encode_sunras,
           ".ras": encode_sunras, ".hdr": encode_hdr, ".pic": encode_hdr,
           ".gif": encode_gif, ".tif": encode_tiff, ".tiff": encode_tiff}
#: where cv2 refuses a four-channel image (the others write it)
_REFUSE_FOUR = {".pbm", ".pgm", ".ppm", ".pnm", ".pfm", ".hdr", ".pic"}
#: extensions cv2 writes with a codec the port has not ported
_QUEUED = {".avif": "AVIF, ROADMAP queue A"}
#: what ``cv2.imwrite`` leaves in the file where the encoder refuses the image
_LEFT_ON_REFUSAL = {".gif": lambda image: b"", ".pfm": lambda image: b"P",
                    ".jp2": jp2_header_boxes}
#: where ``cv2.imwrite`` removes the file when the encoder refuses the image
_REMOVED_ON_REFUSAL = {".webp"}
EXTENSIONS = tuple(_WHOLE) + tuple(_PIXELS)


def imencode(ext: str, image: np.ndarray) -> Optional[bytes]:
    """The bytes of ``image`` in the format of the extension ``ext``, or
    None where cv2's encoder refuses the image."""
    key = ext.lower()
    if key in _WHOLE:
        return _WHOLE[key](image)
    if key not in _PIXELS:
        why = _QUEUED.get(key, "cv2 has no writer for it")
        raise ValueError(f"no encoder for the extension {ext!r} ({why}; the port writes "
                         f"{', '.join(EXTENSIONS)})")
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"imencode({ext!r}) takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in (1, 3, 4) or 0 in a.shape:
        raise ValueError(f"imencode({ext!r}) takes [H, W], [H, W, 1] or [H, W, 3], "
                         f"got {a.shape}")
    if a.shape[2] == 4:
        if key in _REFUSE_FOUR:
            return None
        raise ValueError(f"the port writes four channels to .png, .bmp, .dib, .webp and "
                         f".jp2 only, not to {ext!r}")
    return _PIXELS[key](np.ascontiguousarray(a))


def imwrite(path: str, image: np.ndarray) -> bool:
    """Write ``image`` to ``path`` in the format of its extension, as
    ``cv2.imwrite``: True when written; False where cv2's encoder refuses
    the image (no file, or what cv2 leaves in it: ``_LEFT_ON_REFUSAL``,
    ``_REMOVED_ON_REFUSAL``)."""
    ext = os.path.splitext(path)[1]
    data = imencode(ext, image)
    if data is None:
        if ext.lower() in _REMOVED_ON_REFUSAL and os.path.lexists(path):
            os.remove(path)
        left = _LEFT_ON_REFUSAL.get(ext.lower())
        if left is not None:
            with open(path, "wb") as f:
                f.write(left(image))
        return False
    with open(path, "wb") as f:
        f.write(data)
    return True
