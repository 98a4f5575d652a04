"""``imwrite(path, image)`` and ``imencode(ext, image)``: the port's
``cv2.imwrite`` / ``cv2.imencode``, with the encoder chosen by the
extension as cv2 chooses it (letter case ignored):

- ``.png``: ``core/png.py:encode_png``, cv2's bytes (rows in filter Sub,
  zlib level 1 with ``Z_RLE`` as libpng writes them);
- ``.jpg`` / ``.jpeg``: ``ops/native/jpeg.py:encode_jpeg``, cv2's bytes
  (quality 95, 4:2:0);
- ``.bmp``: ``core/bmp.py:encode_bmp``, cv2's bytes.

``image`` is RGB ``[H, W, 3]`` (or RGBA ``[H, W, 4]`` for PNG and BMP) or
gray ``[H, W]`` uint8, as the port's readers return it: the file holds what
``cv2.imwrite`` writes for the BGR counterpart.  Any other extension raises
``ValueError``.
"""
from __future__ import annotations

import os

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import encode_bmp
from instancesegmentation_tpu_torch.core.png import encode_png
from instancesegmentation_tpu_torch.ops.native.jpeg import encode_jpeg

_ENCODERS = {".png": encode_png, ".jpg": encode_jpeg, ".jpeg": encode_jpeg,
             ".bmp": encode_bmp}


def imencode(ext: str, image: np.ndarray) -> bytes:
    """The bytes of ``image`` in the format of the extension ``ext``
    (``".png"``, ``".jpg"``, ``".jpeg"`` or ``".bmp"``)."""
    encode = _ENCODERS.get(ext.lower())
    if encode is None:
        raise ValueError(f"no encoder for the extension {ext!r} (the port writes "
                         f"{', '.join(_ENCODERS)})")
    return encode(image)


def imwrite(path: str, image: np.ndarray) -> None:
    """Write ``image`` to ``path`` in the format of its extension."""
    data = imencode(os.path.splitext(path)[1], image)
    with open(path, "wb") as f:
        f.write(data)
