"""Host-side record-level geometric augmentation (``common_aug``).

Port of ``instancesegmentation_tpu/core/augment.py``: one geometric
transform, an explicit 2x3 affine (``Affine``), applied consistently to
every image, mask, box and keypoint of a common-format record, recursing
into ``sub_list`` / ``sub_dict`` values.  Training never calls it (the
device pipeline fuses the same geometry); it serves host tooling.

``Affine.apply_image`` is ``cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT,
0)`` without cv2: ``warp_affine`` repeats the arithmetic that cv2 5.0's
warp kernels run on x86-64 with AVX2, found by experiment against cv2
(``tests/test_torch_port_augment_debug.py``):

- the float32 matrix is inverted in float64 (cv2's ``warpAffine``), then
  rounded to float32;
- per output row ``y``, ``M[1]*y + M[2]`` and ``M[4]*y + M[5]`` in float32
  with two roundings; each source coordinate of the first ``16 * floor(W /
  16)`` columns (the SIMD blocks of 16 pixels) is ``fma(M[0], x, row)``,
  of the other columns ``fma(x, M[0], M[1]*y) + M[2]`` (the scalar tail);
- ``ix = floor(sx)`` and ``alpha = sx - ix`` in float32 (no fixed point,
  no 1/32 quantisation); the bilinear blend is three float32 FMAs,
  ``fma(alpha, p01 - p00, p00)`` along x, then the same along y, with
  neighbours outside the image read as 0;
- an integer image rounds half to even and saturates; float32 stays float.

uint8, uint16 and float32 images with 1, 3 or 4 channels take that path in
cv2 and here; other forms raise ``ValueError``.  The FMA is computed in
float64 and rounded to float32, which equals a float32 FMA except when the
float64 sum itself rounds onto a float32 tie.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from instancesegmentation_tpu_torch.core.keys import key_decompose

F32 = np.float32
#: cv2's warp kernels run blocks of 2 x 8 float lanes (AVX2)
SIMD_BLOCK = 16
_INTEGER = {np.dtype(np.uint8): 255, np.dtype(np.uint16): 65535}


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the product is exact in
    float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _inverse(matrix) -> np.ndarray:
    """cv2's inversion of a forward 2x3 matrix: float32 in, float64 math,
    float32 out (the warp kernels' ``M``)."""
    m = np.asarray(matrix, F32).astype(np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.astype(F32)


def warp_affine(image: np.ndarray, matrix, out_hw) -> np.ndarray:
    """``cv2.warpAffine(image, matrix, (w, h), INTER_LINEAR,
    BORDER_CONSTANT, 0)`` bit for bit: ``image`` [H, W] or [H, W, C]
    (C in 1, 3, 4; uint8, uint16 or float32), ``matrix`` the forward 2x3
    map, ``out_hw`` (h, w).  An [H, W, 1] image gives [h, w], as cv2."""
    image = np.asarray(image)
    if image.dtype not in _INTEGER and image.dtype != F32:
        raise ValueError(f"warp_affine takes uint8, uint16 or float32 images, not {image.dtype}")
    if image.ndim not in (2, 3) or (image.ndim == 3 and image.shape[2] not in (1, 3, 4)):
        raise ValueError(f"warp_affine takes [H, W] or [H, W, 1|3|4] images, not {image.shape}")
    m = _inverse(matrix)
    oh, ow = (int(v) for v in out_hw)
    h, w = image.shape[:2]
    src = image.astype(F32).reshape(h, w, -1)

    ys = np.arange(oh, dtype=F32)[:, None]
    xs = np.arange(ow, dtype=F32)[None, :]
    simd = np.arange(ow)[None, :] < SIMD_BLOCK * (ow // SIMD_BLOCK)
    row_x = (ys * m[1]).astype(F32) + m[2]
    row_y = (ys * m[4]).astype(F32) + m[5]
    sx = np.where(simd, _fma(m[0], xs, row_x), _fma(xs, m[0], ys * m[1]) + m[2])
    sy = np.where(simd, _fma(m[3], xs, row_y), _fma(xs, m[3], ys * m[4]) + m[5])
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    # far outside the image every neighbour is the border value anyway
    ix = np.clip(fx, -2, w + 1).astype(np.int64)
    iy = np.clip(fy, -2, h + 1).astype(np.int64)

    def pixel(yy, xx):
        inside = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h))[..., None]
        return np.where(inside, src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], F32(0))

    def lerp(a, p, q):
        return _fma(a, q - p, p)

    top = lerp(ax, pixel(iy, ix), pixel(iy, ix + 1))
    bottom = lerp(ax, pixel(iy + 1, ix), pixel(iy + 1, ix + 1))
    out = lerp(ay, top, bottom)
    if image.dtype in _INTEGER:
        out = np.clip(np.rint(out), 0, _INTEGER[image.dtype]).astype(image.dtype)
    return out.reshape((oh, ow) + image.shape[2:]) if image.ndim == 3 and image.shape[2] > 1 \
        else out.reshape(oh, ow)


@dataclasses.dataclass(frozen=True)
class Affine:
    """2x3 affine ``dst(x, y) = M @ [x, y, 1]`` with an output size."""

    matrix: np.ndarray  # [2, 3] float64
    out_hw: tuple[int, int]

    @staticmethod
    def identity(out_hw) -> "Affine":
        return Affine(np.asarray([[1, 0, 0], [0, 1, 0]], np.float64), tuple(out_hw))

    @staticmethod
    def translate(tx: float, ty: float, out_hw) -> "Affine":
        """Shift by (tx, ty) on an unchanged canvas: content leaving it is
        cut, the vacated area black."""
        return Affine(np.asarray([[1, 0, tx], [0, 1, ty]], np.float64), tuple(out_hw))

    @staticmethod
    def crop_resize(window_xyxy, out_hw) -> "Affine":
        """Map the (possibly out-of-canvas) window onto the output
        rectangle: a crop or pad, then a resize."""
        x0, y0, x1, y1 = [float(v) for v in window_xyxy]
        oh, ow = out_hw
        sx = ow / (x1 - x0)
        sy = oh / (y1 - y0)
        return Affine(np.asarray([[sx, 0, -x0 * sx], [0, sy, -y0 * sy]], np.float64),
                      tuple(out_hw))

    @staticmethod
    def rotate(degrees: float, out_hw) -> "Affine":
        """Rotate about the image centre ``(w/2 - 0.5, h/2 - 0.5)`` on an
        unchanged canvas; positive angles use ``[[c, -s], [s, c]]`` on
        (x, y)."""
        oh, ow = out_hw
        th = math.radians(degrees)
        c, s = math.cos(th), math.sin(th)
        cx, cy = ow / 2.0 - 0.5, oh / 2.0 - 0.5
        return Affine(np.asarray([[c, -s, cx - c * cx + s * cy],
                                  [s, c, cy - s * cx - c * cy]], np.float64), tuple(out_hw))

    @staticmethod
    def hflip(out_hw) -> "Affine":
        oh, ow = out_hw
        return Affine(np.asarray([[-1, 0, ow], [0, 1, 0]], np.float64), tuple(out_hw))

    def then(self, other: "Affine") -> "Affine":
        """``self`` followed by ``other`` (matrix composition)."""
        a = np.vstack([self.matrix, [0, 0, 1]])
        b = np.vstack([other.matrix, [0, 0, 1]])
        return Affine((b @ a)[:2], other.out_hw)

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """Warp an image or mask (bilinear, black border; masks interpolate
        like the training pipeline's soft targets), as ``cv2.warpAffine``
        with the float32 matrix."""
        return warp_affine(image, self.matrix.astype(F32), self.out_hw)

    def apply_points(self, points_xy: np.ndarray) -> np.ndarray:
        pts = np.asarray(points_xy, np.float64).reshape(-1, 2)
        out = pts @ self.matrix[:, :2].T + self.matrix[:, 2]
        return out.reshape(np.shape(points_xy))

    def apply_box(self, box_xyxy) -> list[float]:
        x0, y0, x1, y1 = [float(v) for v in box_xyxy]
        corners = self.apply_points(np.asarray([[x0, y0], [x1, y0], [x0, y1], [x1, y1]]))
        return [float(corners[:, 0].min()), float(corners[:, 1].min()),
                float(corners[:, 0].max()), float(corners[:, 1].max())]


def common_aug(record: dict, affine: Affine) -> None:
    """Apply ``affine`` to every geometric leaf of ``record``, in place:
    ``*##image`` / ``*##mask`` arrays, ``*##box_xyxy`` boxes and
    ``*##point_xy`` keypoints, recursing through ``sub_list`` /
    ``sub_dict``.  Path-typed entries are left alone."""
    for key in list(record.keys()):
        _, key_type = key_decompose(key)
        value = record[key]
        if key_type in ("image", "mask"):
            record[key] = affine.apply_image(value)
        elif key_type == "box_xyxy":
            record[key] = affine.apply_box(value)
        elif key_type == "point_xy":
            record[key] = [float(v) for v in affine.apply_points(value)]
        elif key_type == "sub_list":
            for sub in value:
                if isinstance(sub, dict):
                    common_aug(sub, affine)
        elif key_type == "sub_dict":
            if isinstance(value, dict):
                common_aug(value, affine)
