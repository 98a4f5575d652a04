"""PNM (P1-P6), PAM (P7) and PFM (``PF`` / ``Pf``) decoding with numpy:
``cv2.imread`` / ``cv2.imdecode``'s ``grfmt_pxm``, ``grfmt_pam`` and
``grfmt_pfm`` codecs as this container's cv2 5.0 runs them.

Each ``decode_*(data, mode, path)`` gives what cv2 gives, converted as the
port's readers want it: ``"color"`` RGB uint8 ``[H, W, 3]``, ``"gray"``
uint8 ``[H, W]``.  A file cv2 refuses (a bad or cut header, data cut short)
raises plain ``ValueError``; a header whose size cv2's ``imread`` itself
raises on (not positive, wider or taller than 2^20, more than 2^30 pixels)
raises ``ImageSizeError``.

PNM, as cv2 reads it:

- header numbers are decimal digits after whitespace and ``#`` comments
  (to the end of the line); the byte after a number is consumed, so binary
  data starts one byte after the last header number;
- P1 / P4: 0 white, 1 black; P1 takes one digit per pixel;
- P2 / P3 (ASCII): values above maxval clip to it; at maxval < 256 each is
  scaled to ``v * 255 // maxval``; the last value needs a byte after it;
- P5 / P6 (binary): bytes as stored at maxval < 256 (not scaled);
- maxval 256-65535: 16-bit values (big-endian in binary files), reduced to
  8 bits as ``v >> 8`` (not scaled);
- gray from P3 / P6 through cv2's fixed-point weights, colour from P2 / P5
  replicated.

PAM, as cv2 5.0 reads it: ``KEY value`` lines up to ``ENDHDR`` (exactly one
byte after it is consumed), WIDTH, HEIGHT, DEPTH and MAXVAL each once,
comments and blank lines anywhere.  ``TUPLTYPE`` BLACKANDWHITE and
GRAYSCALE take depth 1, GRAYSCALE_ALPHA 2, RGB 3, RGB_ALPHA 4 (the last one
given counts); without one, depth 1 or 3 at maxval < 256 reads as GRAYSCALE
or RGB and anything else is refused.  Values are not scaled (maxval > 255:
``v >> 8``).  cv2's own quirks are followed:

- maxval 1 reads each row's first bytes as packed bits, 1 white;
- depth 3 read in colour is copied as stored, so the channels come out
  reversed (cv2 returns the file's RGB as its BGR);
- GRAYSCALE_ALPHA and RGB_ALPHA convert only the first ``ceil(W / depth)``
  pixels of a row (cv2's ``basic_conversion`` stops at ``W`` bytes): in
  colour the rest of cv2's row is memory it never wrote, which the port
  gives as 0; in gray cv2 writes 3 bytes per converted pixel, so gray pixel
  ``x`` is the first channel of pixel ``x // 3`` (0 where cv2 wrote
  nothing).

PFM: ``P``, ``f`` or ``F``, one ``\\n``, then width, height and scale, each
ended by exactly one whitespace byte (C's ``atoi`` / ``atof``); a negative
scale means little-endian floats, a positive one big-endian; rows bottom-up;
values times ``float32(1 / |scale|)`` and converted as cv2's ``convertTo``
(rounded half to even, saturated; NaN and values beyond int32 give 0).
``cv2.imread`` returns None where the file's channels differ from the
mode's (``PF`` read as gray, ``Pf`` read in colour) and ``cv2.imdecode``
returns the file's own channels: ``decode_pfm(..., imread=False)`` follows
the latter.
"""
from __future__ import annotations

import math
import re

import numpy as np

from instancesegmentation_tpu_torch.core.bmp import _bgr_to_gray
from instancesegmentation_tpu_torch.core.png import ImageSizeError

#: cv2's ``validateInputImageSize`` limits (``CV_IO_MAX_IMAGE_*``)
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30
_SPACE = b" \t\n\v\f\r"
#: one header or ASCII number as cv2's ``ReadNumber`` takes it: whitespace
#: and comments, the digits, and the byte after them
_NUMBER = re.compile(rb"(?:[ \t\n\v\f\r]|#[^\n\r]*[\n\r])*(\d+)(?s:.)")
_DIGIT = re.compile(rb"(?:[ \t\n\v\f\r]|#[^\n\r]*[\n\r])*(\d)")
_INT_MAX = 2 ** 31 - 1


def check_size(width: int, height: int, path: str) -> None:
    """Raise ``ImageSizeError`` where cv2's ``validateInputImageSize``
    raises (its ``imread`` and ``imdecode`` then raise, not return None)."""
    if not (0 < width <= MAX_SIDE and 0 < height <= MAX_SIDE and width * height <= MAX_PIXELS):
        raise ImageSizeError(f"{path}: image size {width} x {height} is outside what cv2 "
                             "reads (cv2 raises)")


def _numbers(data: bytes, pos: int, count: int, path: str, one_digit=False) -> tuple:
    """``count`` numbers from ``data[pos:]`` as cv2's ``ReadNumber`` reads
    them (whitespace and comments, the digits, then the byte after them;
    ``one_digit``: one digit each, nothing after): (int64 array, position
    after them)."""
    out = np.empty(count, np.int64)
    pattern = _DIGIT if one_digit else _NUMBER
    for i in range(count):
        m = pattern.match(data, pos)
        if m is None:
            raise ValueError(f"{path}: PNM number {i} missing, cut or malformed")
        value = int(m.group(1))
        if value > _INT_MAX:
            raise ValueError(f"{path}: PNM number too large")
        out[i], pos = value, m.end()
    return out, pos


def _ascii_values(data: bytes, pos: int, count: int, path: str) -> np.ndarray:
    """The ASCII pixel values: ``_numbers``, split in one call where no
    comment can interfere."""
    region = data[pos:]
    if b"#" not in region:
        tokens = region.split(None, count)
        body = tokens[:count]
        followed = len(tokens) > count or (len(region) > 0 and region[-1] in _SPACE)
        if (len(body) == count and followed and all(t.isdigit() and len(t) < 10 for t in body)):
            return np.array(body).astype(np.int64)
    return _numbers(data, pos, count, path)[0]


def _to_mode(rgb: np.ndarray | None, gray: np.ndarray | None, mode: str) -> np.ndarray:
    if mode == "gray":
        return gray if gray is not None else _bgr_to_gray(rgb[..., ::-1])
    return rgb if rgb is not None else np.repeat(gray[..., None], 3, axis=2)


def decode_pnm(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """P1-P6 bytes -> RGB ``[H, W, 3]`` (``"color"``) or ``[H, W]``
    (``"gray"``) uint8, as ``cv2.imread``."""
    kind = data[1] - ord("0")
    header, pos = _numbers(data, 2, 2 if kind in (1, 4) else 3, path)
    width, height = int(header[0]), int(header[1])
    maxval = 1 if kind in (1, 4) else int(header[2])
    if width <= 0 or height <= 0 or not 0 < maxval < 65536:
        raise ValueError(f"{path}: PNM header {width} x {height}, maxval {maxval}")
    check_size(width, height, path)
    channels = 3 if kind in (3, 6) else 1
    n = width * height * channels
    if kind in (1, 4):
        if kind == 1:
            bits, _ = _numbers(data, pos, width * height, path, one_digit=True)
            bits = bits.reshape(height, width) != 0
        else:
            pitch = -(-width // 8)
            rows = np.frombuffer(data, np.uint8, count=-1, offset=pos)[:pitch * height]
            if len(rows) < pitch * height:
                raise ValueError(f"{path}: PBM data cut short")
            bits = np.unpackbits(rows.reshape(height, pitch), axis=1)[:, :width] != 0
        return _to_mode(None, np.where(bits, 0, 255).astype(np.uint8), mode)
    if kind in (2, 3):
        values = np.minimum(_ascii_values(data, pos, n, path), maxval)
        if maxval < 256:
            values = values * 255 // maxval
        else:
            values = values >> 8
    else:
        size = 2 if maxval > 255 else 1
        raw = np.frombuffer(data, np.uint8, count=-1, offset=pos)[:n * size]
        if len(raw) < n * size:
            raise ValueError(f"{path}: PNM data cut short")
        values = raw.view(">u2") >> 8 if size == 2 else raw
    pixels = values.astype(np.uint8).reshape(height, width, channels)
    if channels == 3:
        return _to_mode(pixels, None, mode)
    return _to_mode(None, pixels[..., 0], mode)


# -- PAM ---------------------------------------------------------------------------------

#: TUPLTYPE -> the depth cv2 requires
_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
              b"RGB_ALPHA": 4}
_PAM_INT = re.compile(rb"-?\d+")
_EOL = re.compile(rb"[\n\r]")


def _pam_header(data: bytes, path: str) -> tuple:
    """(width, height, depth, maxval, tupltype or None, data offset)."""
    fields, tupltype, pos, n = {}, None, 2, len(data)
    while True:
        while pos < n and data[pos] in _SPACE:
            pos += 1
        if pos >= n:
            raise ValueError(f"{path}: PAM header cut short")
        if data[pos] == ord("#"):
            end = _EOL.search(data, pos)
            if end is None:
                raise ValueError(f"{path}: PAM header cut short")
            pos = end.end()
            continue
        start = pos
        while pos < n and data[pos] not in _SPACE:
            pos += 1
        if pos >= n:
            raise ValueError(f"{path}: PAM header cut short")
        key = data[start:pos]
        if key == b"ENDHDR":
            offset = pos + 1
            break
        while pos < n and data[pos] in _SPACE:
            pos += 1
        start = pos
        while pos < n and data[pos] not in b"\n\r":
            pos += 1
        if pos >= n:
            raise ValueError(f"{path}: PAM header cut short")
        value = data[start:pos].rstrip(_SPACE)
        pos += 1
        if key == b"TUPLTYPE":
            if value not in _TUPLTYPES:
                raise ValueError(f"{path}: PAM TUPLTYPE {value!r}")
            tupltype = value
        elif key in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL") and key not in fields:
            if not _PAM_INT.fullmatch(value) or abs(int(value)) > _INT_MAX:
                raise ValueError(f"{path}: PAM {key.decode()} {value!r}")
            fields[key] = int(value)
        else:
            raise ValueError(f"{path}: PAM header field {key!r}")
    if len(fields) < 4:
        raise ValueError(f"{path}: PAM header misses a field")
    width, height, depth, maxval = (fields[k] for k in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    if maxval > 65535 or depth <= 0 or width <= 0 or height <= 0:
        raise ValueError(f"{path}: PAM header {width} x {height} x {depth}, maxval {maxval}")
    if tupltype is None:
        if depth not in (1, 3) or maxval >= 256:
            raise ValueError(f"{path}: PAM without TUPLTYPE at depth {depth}, maxval {maxval}")
        tupltype = b"GRAYSCALE" if depth == 1 else b"RGB"
    if _TUPLTYPES[tupltype] != depth:
        raise ValueError(f"{path}: PAM TUPLTYPE {tupltype.decode()} at depth {depth}")
    return width, height, depth, maxval, tupltype, offset


def decode_pam(data: bytes, mode: str = "color", path: str = "<bytes>") -> np.ndarray:
    """P7 bytes -> RGB ``[H, W, 3]`` (``"color"``) or ``[H, W]``
    (``"gray"``) uint8, as ``cv2.imread`` (its quirks in the module's
    docstring)."""
    width, height, depth, maxval, tupltype, offset = _pam_header(data, path)
    check_size(width, height, path)
    size = 2 if maxval > 255 else 1
    n = width * depth * size * height
    raw = np.frombuffer(data, np.uint8, count=-1, offset=min(offset, len(data)))[:n]
    if len(raw) < n:
        raise ValueError(f"{path}: PAM data cut short")
    rows = raw.reshape(height, width * depth * size)
    if maxval == 1:  # packed bits from each row's first bytes
        pitch = -(-width // 8)
        bits = np.unpackbits(rows[:, :pitch], axis=1)[:, :width]
        gray = (bits * 255).astype(np.uint8)
        return _to_mode(None, gray, mode)
    s = (rows.view(">u2") >> 8).astype(np.uint8) if size == 2 else rows
    s = s.reshape(height, width, depth)
    target = 3 if mode == "color" else 1
    if depth == target:
        # copied as stored: in colour the file's RGB is cv2's BGR
        return s[..., ::-1].copy() if depth == 3 else s[..., 0].copy()
    if tupltype == b"RGB":  # gray: cv2's weights on the RGB pixels
        return _bgr_to_gray(s[..., ::-1])
    if tupltype == b"GRAYSCALE":
        return np.repeat(s, 3, axis=2)
    # the *_ALPHA forms: only the first ceil(W / depth) pixels are converted
    done = -(-width // depth)
    flat = s.reshape(height, -1)
    if mode == "color":
        out = np.zeros((height, width, 3), np.uint8)
        first = s[:, :done]
        out[:, :done] = first[..., [0, 0, 0]] if depth == 2 else first[..., :3]
        return out
    out = np.zeros((height, width), np.uint8)
    cols = np.arange(min(width, 3 * done))
    out[:, cols] = flat[:, (cols // 3) * depth]
    return out


# -- PFM ---------------------------------------------------------------------------------

_C_INT = re.compile(rb"[ \t\n\v\f\r]*([+-]?\d+)")
_C_FLOAT = re.compile(rb"[ \t\n\v\f\r]*([+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
                      rb"(?:[pP][+-]?\d+)?|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|"
                      rb"[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN]))")


def _atoi(token: bytes) -> int:
    m = _C_INT.match(token)
    if m is None:
        return 0
    # glibc: strtol saturates to 64 bits, then the cast keeps the low 32
    value = min(max(int(m.group(1)), -2 ** 63), 2 ** 63 - 1)
    return (value + 2 ** 31) % 2 ** 32 - 2 ** 31


def _atof(token: bytes) -> float:
    m = _C_FLOAT.match(token)
    if m is None:
        return 0.0
    text = m.group(1).decode()
    body = text.lstrip("+-")
    sign = -1.0 if text.startswith("-") else 1.0
    if body[:2] in ("0x", "0X"):
        body = body if "p" in body.lower() else body + "p0"
        return sign * float.fromhex(body)
    return sign * float(body)


def decode_pfm(data: bytes, mode: str = "color", path: str = "<bytes>",
               imread: bool = True) -> np.ndarray:
    """PF / Pf bytes -> uint8 as ``cv2.imread`` (``imread=True``: a file
    whose channels differ from ``mode``'s raises ``ValueError``) or as
    ``cv2.imdecode`` (``imread=False``: RGB ``[H, W, 3]`` for ``PF`` and
    ``[H, W]`` for ``Pf`` in either mode)."""
    if len(data) < 3 or data[2] != ord("\n"):
        raise ValueError(f"{path}: PFM header without its line break")
    channels = 3 if data[1] == ord("F") else 1
    tokens, pos = [], 3
    for _ in range(3):
        start = pos
        while pos < len(data) and data[pos] not in _SPACE:
            pos += 1
        if pos >= len(data) or data[start:pos].isascii() is False:
            raise ValueError(f"{path}: PFM header cut short or not ASCII")
        tokens.append(data[start:pos])
        pos += 1
    width, height, scale = _atoi(tokens[0]), _atoi(tokens[1]), _atof(tokens[2])
    check_size(width, height, path)
    if imread and channels != (3 if mode == "color" else 1):
        raise ValueError(f"{path}: a {channels}-channel PFM read in {mode} mode")
    n = width * height * channels
    raw = np.frombuffer(data, np.uint8, count=-1, offset=min(pos, len(data)))[:4 * n]
    if len(raw) < 4 * n:
        raise ValueError(f"{path}: PFM data cut short")
    if not abs(scale) > 0.0:
        raise ValueError(f"{path}: PFM scale {scale}")
    values = raw.view("<f4" if scale < 0 else ">f4").astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        factor = np.float32(1.0 / abs(scale)) if math.isfinite(scale) else np.float32(0.0)
        values = values * factor
        rounded = np.rint(values)
        ok = np.abs(rounded) < 2.0 ** 31  # cvRound: NaN and overflow give INT_MIN
        out = np.where(ok, np.clip(np.where(ok, rounded, 0), 0, 255), 0).astype(np.uint8)
    out = out.reshape(height, width, channels)[::-1]
    return np.ascontiguousarray(out[..., 0] if channels == 1 else out)


# ---- encoders: cv2 5.0's grfmt_pxm, grfmt_pam and grfmt_pfm writers ----
#
# Each takes uint8 ``[H, W, C]`` (C 1: gray, 3: RGB, as ``core/imwrite.py``
# passes it) and returns the bytes ``cv2.imencode`` gives for the BGR
# counterpart, or None where cv2's encoder refuses the image.


def encode_pbm(pixels: np.ndarray):
    """P4 (gray only): a set bit for each pixel that is 0, rows padded to
    whole bytes."""
    h, w, c = pixels.shape
    if c != 1:
        return None
    bits = np.packbits(pixels[..., 0] == 0, axis=1)
    return b"P4\n%d %d\n" % (w, h) + bits.tobytes()


def encode_pgm(pixels: np.ndarray):
    """P5 at maxval 255 (gray only)."""
    h, w, c = pixels.shape
    return b"P5\n%d %d\n255\n" % (w, h) + pixels.tobytes() if c == 1 else None


def encode_ppm(pixels: np.ndarray):
    """P6 at maxval 255, samples in RGB order (colour only)."""
    h, w, c = pixels.shape
    return b"P6\n%d %d\n255\n" % (w, h) + pixels.tobytes() if c == 3 else None


def encode_pnm(pixels: np.ndarray):
    """P5 for gray, P6 for colour."""
    return encode_pgm(pixels) if pixels.shape[2] == 1 else encode_ppm(pixels)


def encode_pam(pixels: np.ndarray) -> bytes:
    """P7 without a TUPLTYPE line; a colour image's samples in BGR order, as
    cv2 stores them (the mirror of the reader's channel quirk)."""
    h, w, c = pixels.shape
    body = pixels if c == 1 else pixels[..., ::-1]
    return (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL 255\nENDHDR\n" % (w, h, c)
            + np.ascontiguousarray(body).tobytes())


def encode_pfm(pixels: np.ndarray) -> bytes:
    """``Pf`` (gray) or ``PF`` (RGB) with scale -1: the raw 0-255 values as
    little-endian float32, rows bottom-up."""
    h, w, c = pixels.shape
    values = pixels[::-1].astype("<f4")
    return b"%s\n%d %d\n-1\n" % (b"Pf" if c == 1 else b"PF", w, h) + values.tobytes()
