"""WebP as ``cv2.imread`` and ``cv2.imdecode`` read it (cv2 5.0 and its
libwebp), bit for bit: the container here, the bit streams in
``ops/native/webp.cpp``.

``decode_webp(data, mode)`` gives RGB uint8 ``[H, W, 3]`` (``"color"``) or
``[H, W]`` (``"gray"``, cv2's ``cvtColor(BGR2GRAY)`` of the colour decode),
or raises ``ValueError`` where cv2 returns None.  What cv2 does, in order:

- it reads the first 32 bytes and asks libwebp for the features there:
  fewer bytes, or features that fail, give None;
- a still image is decoded whole (``WebPDecodeBGRInto`` / ``BGRAInto``):
  the RIFF size must fit the data; a ``VP8X`` chunk (exactly 10 bytes, its
  canvas equal to the image's sides) may be followed by any chunks before
  the ``VP8 `` or ``VP8L`` chunk, each within the RIFF size; the last
  ``ALPH`` among them is the lossy image's alpha, which is decoded (and
  then dropped) even for a colour read, so a bad one gives None; the bit
  stream is read from its chunk to the end of the data;
- an animation (``VP8X`` animation flag) goes through libwebp's demuxer and
  ``WebPAnimDecoder``: the first frame decoded at its offset on a canvas of
  zeros (the ``ANIM`` background and the frame's blend and dispose bits
  play no part in the first frame), alpha dropped; a file the demuxer
  refuses, or a first frame that does not decode, gives None;
- the EXIF orientation of the first ``EXIF`` chunk (its payload a TIFF
  block, without the ``Exif\\0\\0`` prefix) turns the image, where the
  ``VP8X`` EXIF flag is set and the demuxer accepts the whole file
  (``core/exif.py``); a file it refuses keeps its pixels unturned.

``imread`` and ``imdecode`` read WebP alike.

``encode_webp(image)`` writes what ``cv2.imwrite`` writes for ``.webp`` at
its default parameters: a lossless file (cv2 calls libwebp's
``WebPEncodeLosslessBGR`` / ``BGRA`` unless ``IMWRITE_WEBP_QUALITY`` <= 100
is passed).  libwebp chooses its transforms and codes by heuristics that
change between versions, so the port's stream (``ops/native/webp_enc.cpp``)
is not cv2's byte for byte: it decodes, in every reader, to the same
pixels.  The container is cv2's simple form, ``RIFF`` / ``WEBP`` /
``VP8L`` with the pad byte of an odd-sized chunk and no ``VP8X`` chunk.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import cvtcolor_gray
from instancesegmentation_tpu_torch.core.exif import apply_orientation, exif_orientation
from instancesegmentation_tpu_torch.core.pnm import check_size
from instancesegmentation_tpu_torch.ops.native.webp import decode_vp8, decode_vp8l, encode_vp8l

#: bytes cv2 reads for the features before it decodes
HEADER_SIZE = 32
_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_OK, _NOT_ENOUGH, _ERROR = 0, 1, 2
_ALPHA, _ANIMATION, _EXIF = 0x10, 0x02, 0x08
_VALID_FLAGS = 0x3E
#: the longest side libwebp writes (cv2's write of a longer one fails)
MAX_SIDE = 16383


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def _le24(b: bytes, o: int) -> int:
    return b[o] | (b[o + 1] << 8) | (b[o + 2] << 16)


def _le32(b: bytes, o: int) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _vp8_info(d: bytes, chunk_size: int):
    """libwebp's ``VP8GetInfo``: (w, h) of a VP8 key frame's header, or None."""
    if len(d) < 10 or d[3:6] != b"\x9d\x01\x2a":
        return None
    bits = d[0] | (d[1] << 8) | (d[2] << 16)
    w, h = (d[6] | (d[7] << 8)) & 0x3FFF, (d[8] | (d[9] << 8)) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size:
        return None
    return (w, h) if w and h else None


def _vp8l_info(d: bytes):
    """libwebp's ``VP8LGetInfo``: (w, h, alpha) of a VP8L header, or None."""
    if len(d) < 5 or d[0] != 0x2F or d[4] >> 5:
        return None
    v = int.from_bytes(d[1:5], "little")
    return 1 + (v & 0x3FFF), 1 + ((v >> 14) & 0x3FFF), bool((v >> 28) & 1)


def _headers(data: bytes, have_all_data: bool, headers: bool) -> tuple[int, dict]:
    """libwebp's ``ParseHeadersInternal``: (status, info) where info holds
    the sides, the animation flag and (``headers``) where the bit stream
    and the ALPH payload lie."""
    info = {"width": 0, "height": 0, "animation": False, "lossless": False, "offset": 0,
            "alpha": None}
    size = len(data)
    if size < 12:
        return _NOT_ENOUGH, info
    pos, riff_size = 0, 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            return _ERROR, info
        riff_size = _le32(data, 4)
        if riff_size < 12 or riff_size > _MAX_PAYLOAD:
            return _ERROR, info
        if have_all_data and riff_size > size - 8:
            return _NOT_ENOUGH, info
        pos = 12
    if size - pos < 8:
        return _NOT_ENOUGH, info
    found_vp8x = False
    if data[pos:pos + 4] == b"VP8X":
        if _le32(data, pos + 4) != 10:
            return _ERROR, info
        if size - pos < 18:
            return _NOT_ENOUGH, info
        flags = _le32(data, pos + 8)
        info["width"], info["height"] = 1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15)
        if info["width"] * info["height"] >= 1 << 32:
            return _ERROR, info
        pos += 18
        found_vp8x = True
        info["animation"] = bool(flags & _ANIMATION)
    if not riff_size and found_vp8x:
        return _ERROR, info
    canvas = info["width"], info["height"]

    def finish(status: int) -> tuple[int, dict]:
        if status == _NOT_ENOUGH and found_vp8x and not headers:
            status = _OK
        return status, info

    if found_vp8x and info["animation"] and not headers:
        return _OK, info
    if size - pos < 4:
        return finish(_NOT_ENOUGH)
    if (riff_size and found_vp8x) or (not riff_size and not found_vp8x
                                      and data[pos:pos + 4] == b"ALPH"):
        total = 22
        while True:
            if size - pos < 8:
                return finish(_NOT_ENOUGH)
            chunk = _le32(data, pos + 4)
            if chunk > _MAX_PAYLOAD:
                return finish(_ERROR)
            disk = (8 + chunk + 1) & ~1
            total = (total + disk) & 0xFFFFFFFF
            if riff_size and total > riff_size:
                return finish(_ERROR)
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if size - pos < disk:
                return finish(_NOT_ENOUGH)
            if data[pos:pos + 4] == b"ALPH":
                info["alpha"] = (pos + 8, chunk)
            pos += disk
    if size - pos < 8:
        return finish(_NOT_ENOUGH)
    tag = data[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        compressed = _le32(data, pos + 4)
        if riff_size >= 12 and compressed > riff_size - 12:
            return finish(_ERROR)
        if have_all_data and compressed > size - pos - 8:
            return finish(_NOT_ENOUGH)
        pos += 8
        lossless = tag == b"VP8L"
    else:
        lossless = _vp8l_info(data[pos:pos + 5]) is not None
        compressed = size - pos
    if compressed > _MAX_PAYLOAD:
        return _ERROR, info
    if not lossless:
        if size - pos < 10:
            return finish(_NOT_ENOUGH)
        sides = _vp8_info(data[pos:pos + 10], compressed)
    else:
        if size - pos < 5:
            return finish(_NOT_ENOUGH)
        sides = _vp8l_info(data[pos:pos + 5])
    if sides is None:
        return _ERROR, info
    if found_vp8x and canvas != tuple(sides[:2]):
        return _ERROR, info
    info.update(width=sides[0], height=sides[1], lossless=lossless, offset=pos)
    return _OK, info


def _decode_still(data: bytes, path: str) -> np.ndarray:
    """libwebp's ``DecodeInto`` of a whole still image (or an animation
    frame's chunks): RGB, or ``ValueError``."""
    status, info = _headers(data, True, True)
    if status != _OK or info["animation"]:
        raise ValueError(f"{path}: WebP headers refused (libwebp status {status})")
    stream = data[info["offset"]:]
    w, h = info["width"], info["height"]
    if info["lossless"]:
        return decode_vp8l(stream, w, h, path)
    alpha = info["alpha"]
    alph = data[alpha[0]:alpha[0] + alpha[1]] if alpha is not None else None
    return decode_vp8(stream, w, h, alph, path)


class _Demux:
    """libwebp's ``WebPDemux`` of complete data: the ``VP8X`` flags, the
    canvas, the frames and the stored chunks; ``ok`` False where it fails."""

    def __init__(self, data: bytes):
        self.data, self.ok = data, False
        self.frames: list[dict] = []
        self.chunks: list[tuple[bytes, int, int]] = []
        if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            return
        riff_size = _le32(data, 4)
        if riff_size < 8 or riff_size > _MAX_PAYLOAD:
            return
        self.riff_end = riff_size + 8
        if len(data) < self.riff_end:
            return  # partial data: the demuxer asks for it whole
        self.end, self.start = self.riff_end, 12
        if data[12:16] != b"VP8X":
            return  # a simple file: no flags, so no EXIF and no animation
        status, self.state_done = self._parse_vp8x(), False
        if status == _OK:
            self.state_done = True
            self.ok = self._valid()

    def avail(self) -> int:
        return self.end - self.start

    def size_invalid(self, size: int) -> bool:
        return size > self.riff_end - self.start

    def _parse_vp8x(self) -> int:
        d = self.data
        if self.avail() < 8:
            return _NOT_ENOUGH
        size = _le32(d, self.start + 4)
        self.start += 8
        if size > _MAX_PAYLOAD or size < 10:
            return _ERROR
        size += size & 1
        if self.size_invalid(size):
            return _ERROR
        if self.avail() < size:
            return _NOT_ENOUGH
        self.flags = d[self.start]
        self.canvas = 1 + _le24(d, self.start + 4), 1 + _le24(d, self.start + 7)
        if self.canvas[0] * self.canvas[1] >= 1 << 32:
            return _ERROR
        self.start += size
        if self.size_invalid(8):
            return _ERROR
        if self.avail() < 8:
            return _NOT_ENOUGH
        return self._parse_chunks()

    def _parse_chunks(self) -> int:
        d = self.data
        is_anim = bool(self.flags & _ANIMATION)
        anim_chunks, status = 0, _OK
        while True:
            chunk_start = self.start
            fourcc, size = d[self.start:self.start + 4], _le32(d, self.start + 4)
            self.start += 8
            if size > _MAX_PAYLOAD:
                return _ERROR
            padded = size + (size & 1)
            if self.size_invalid(padded):
                return _ERROR
            store = None
            if fourcc == b"VP8X":
                return _ERROR
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_anim:
                    return _ERROR
                self.start -= 8
                status = self._single_image()
            elif fourcc == b"ANIM":
                if padded < 6:
                    return _ERROR
                if self.avail() < padded:
                    status = _NOT_ENOUGH
                elif anim_chunks == 0:
                    anim_chunks = 1
                    self.start += padded
                else:
                    store = False
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    return _ERROR
                status = self._animation_frame(padded)
            else:
                flag = {b"ICCP": 0x20, b"EXIF": _EXIF, b"XMP ": 0x04}.get(fourcc)
                store = flag is None or bool(self.flags & flag)
            if store is not None:
                if padded <= self.avail():
                    if store:
                        self.chunks.append((fourcc, chunk_start + 8, size))
                    self.start += padded
                else:
                    status = _NOT_ENOUGH
            if self.start == self.riff_end:
                break
            if self.avail() < 8:
                status = _NOT_ENOUGH
            if status != _OK:
                break
        return status

    def _single_image(self) -> int:
        if self.frames or self.size_invalid(8):
            return _ERROR
        if self.avail() < 8:
            return _NOT_ENOUGH
        frame = {"x": 0, "y": 0, "num": 0, "alpha": None, "image": None, "complete": False,
                 "w": 0, "h": 0}
        status = self._store_frame(1, 0, frame)
        if status != _ERROR:
            if not self.flags & _ALPHA and frame["alpha"] is not None:
                frame["alpha"] = None
            if self.frames and not self.frames[-1]["complete"]:
                return _ERROR
            self.frames.append(frame)
        return status

    def _store_frame(self, frame_num: int, min_size: int, frame: dict) -> int:
        d = self.data
        if self.avail() < 8 or self.avail() < min_size:
            return _NOT_ENOUGH
        alpha_chunks = image_chunks = 0
        status, done = _OK, False
        while not done and status == _OK:
            chunk_start = self.start
            fourcc, size = d[self.start:self.start + 4], _le32(d, self.start + 4)
            self.start += 8
            if size > _MAX_PAYLOAD:
                return _ERROR
            padded = size + (size & 1)
            available = min(padded, self.avail())
            chunk_size = 8 + available
            if self.size_invalid(padded):
                return _ERROR
            if padded > self.avail():
                status = _NOT_ENOUGH
            if fourcc == b"VP8L" and alpha_chunks:
                return _ERROR  # VP8L carries its own alpha
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.update(alpha=(chunk_start, chunk_size), num=frame_num)
                self.start += available
            elif fourcc in (b"VP8 ", b"VP8L") and image_chunks == 0:
                st, feats = _headers(d[chunk_start:chunk_start + chunk_size], False, False)
                if status == _NOT_ENOUGH and st == _NOT_ENOUGH:
                    return _NOT_ENOUGH
                if st != _OK:
                    return _ERROR
                image_chunks = 1
                frame.update(image=(chunk_start, chunk_size), w=feats["width"], h=feats["height"],
                             num=frame_num, complete=status == _OK)
                self.start += available
            else:  # the frame ends before this chunk
                self.start -= 8
                done = True
            if self.start == self.riff_end:
                done = True
            elif self.avail() < 8:
                status = _NOT_ENOUGH
        return status

    def _animation_frame(self, padded: int) -> int:
        d = self.data
        payload = padded - 16
        if self.size_invalid(16) or padded < 16:
            return _ERROR
        if self.avail() < 16:
            return _NOT_ENOUGH
        s = self.start
        frame = {"x": 2 * _le24(d, s), "y": 2 * _le24(d, s + 3), "w": 1 + _le24(d, s + 6),
                 "h": 1 + _le24(d, s + 9), "num": 0, "alpha": None, "image": None,
                 "complete": False}
        self.start += 16
        if frame["w"] * frame["h"] >= 1 << 32:
            return _ERROR
        start = self.start
        status = self._store_frame(len(self.frames) + 1, payload, frame)
        if status != _ERROR and self.start - start > payload:
            status = _ERROR
        if status != _ERROR and self.flags & _ANIMATION and frame["num"] > 0:
            if self.frames and not self.frames[-1]["complete"]:
                return _ERROR
            self.frames.append(frame)
        return status

    def _valid(self) -> bool:
        is_anim = bool(self.flags & _ANIMATION)
        if not self.frames or self.flags & ~_VALID_FLAGS:
            return False
        cw, ch = self.canvas
        for f in self.frames:
            if not is_anim and f["num"] > 1:
                return False
            if not f["complete"]:
                return False  # no partial frame in complete data
            if f["alpha"] is not None and f["alpha"][0] > f["image"][0]:
                return False
            if f["w"] <= 0 or f["h"] <= 0:
                return False
            if is_anim:
                if f["x"] + f["w"] > cw or f["y"] + f["h"] > ch:
                    return False
            elif f["x"] or f["y"] or (f["w"], f["h"]) != (cw, ch):
                return False
        return True

    def exif(self) -> Optional[bytes]:
        for fourcc, off, size in self.chunks:
            if fourcc == b"EXIF":
                return self.data[off:off + size]
        return None

    def first_frame_payload(self) -> tuple[dict, bytes]:
        f = self.frames[0]
        start, size = f["image"]
        if f["alpha"] is not None:
            a_off, a_size = f["alpha"]
            size += a_size + (start - (a_off + a_size))
            start = a_off
        return f, self.data[start:start + size]


def decode_webp(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """WebP bytes -> RGB ``[H, W, 3]`` (``"color"``) or ``[H, W]``
    (``"gray"``), turned by its EXIF orientation, as cv2 reads them; raises
    ``ValueError`` where cv2 returns None (see the module's docstring)."""
    if mode not in ("color", "gray"):
        raise ValueError(f"unknown read mode {mode!r}")
    data = bytes(data)
    if len(data) < HEADER_SIZE:
        raise ValueError(f"{path}: WebP data shorter than cv2's {HEADER_SIZE}-byte header read")
    status, features = _headers(data[:HEADER_SIZE], False, False)
    if status != _OK:
        raise ValueError(f"{path}: WebP features refused (libwebp status {status})")
    demux = _Demux(data)
    if features["animation"] and not demux.ok:
        raise ValueError(f"{path}: the WebP demuxer refuses the animation")
    check_size(features["width"], features["height"], path)
    if features["animation"]:
        frame, payload = demux.first_frame_payload()
        rgb = _decode_still(payload, path)
        w, h = demux.canvas
        out = np.zeros((h, w, 3), np.uint8)
        out[frame["y"]:frame["y"] + rgb.shape[0], frame["x"]:frame["x"] + rgb.shape[1]] = rgb
    else:
        out = _decode_still(data, path)
    if mode == "gray":
        out = cvtcolor_gray(out[..., ::-1])
    exif = demux.exif() if demux.ok else None
    return apply_orientation(out, exif_orientation(exif))


def encode_webp(image: np.ndarray) -> Optional[bytes]:
    """The ``.webp`` bytes ``cv2.imwrite`` writes for the BGR(A) counterpart
    of uint8 RGB ``[H, W, 3]``, gray ``[H, W]`` / ``[H, W, 1]`` (written as
    three equal channels, cv2's ``GRAY2BGR``) or RGBA ``[H, W, 4]``, or None
    where cv2 refuses the image (a side above ``MAX_SIDE``).  The header's
    alpha hint is set only where some alpha is below 255, so an opaque RGBA
    image reads back with three channels, as cv2's file does; RGB under
    alpha 0 is written as 0 (libwebp's default, inexact mode lets it write
    any RGB there)."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_webp takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in (1, 3, 4) or 0 in a.shape:
        raise ValueError(f"encode_webp takes [H, W], [H, W, 1], [H, W, 3] or [H, W, 4], "
                         f"got {a.shape}")
    h, w, c = a.shape
    if h > MAX_SIDE or w > MAX_SIDE:
        return None
    u = a.astype(np.uint32)
    if c == 1:
        argb = (u[..., 0] * 0x010101) | 0xFF000000
        alpha = False
    else:
        argb = (u[..., 0] << 16) | (u[..., 1] << 8) | u[..., 2]
        alpha = c == 4 and bool((a[..., 3] < 255).any())
        argb |= (u[..., 3] << 24) if c == 4 else np.uint32(0xFF000000)
    stream = encode_vp8l(argb, w, h, alpha)
    chunk = b"VP8L" + struct.pack("<I", len(stream)) + stream + b"\0" * (len(stream) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
