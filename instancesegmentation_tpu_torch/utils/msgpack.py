"""The subset of MessagePack that flax's ``serialization.to_bytes`` writes,
packed and unpacked with ``struct`` alone.

Types: nil, bool, int (64-bit), float (written as float64), str, bin,
arrays (lists and tuples), maps with str keys, and numpy arrays as the
ext type 1 that flax uses, whose body is the packed list ``[shape,
dtype name, C-order bytes]``; 0-d arrays included.  Ext type 3 (a numpy
scalar, flax's ``npscalar``) unpacks to a 0-d array.  Each value is written
in its smallest encoding, as ``msgpack.packb`` does, so the bytes equal
flax's for the same tree.

The dtype name ``"bfloat16"``, which numpy does not know, is carried as
``torch.bfloat16``: ``unpackb`` returns such arrays as bfloat16 tensors
(read through a uint16 view), and ``packb`` takes bfloat16 tensors.
Arrays larger than flax's chunk limit (2**30 bytes) are refused: flax
splits them into ``__msgpack_chunked_array__`` maps, which this codec does
not write or read.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

#: flax's ``_MsgpackExtType``: ndarray and numpy scalar
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
#: flax chunks array leaves above this many bytes
MAX_CHUNK_SIZE = 2 ** 30


def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit in 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: list) -> None:
    """A length header: the fix form below ``fix_max`` when there is one,
    else 8/16/32-bit (or 16/32-bit when ``codes`` has two entries)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    fmts = (">B", ">H", ">I")[-len(codes):]
    for code, fmt in zip(codes, fmts):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} too large for msgpack")


def _array_body(value) -> bytes:
    """flax's ``_ndarray_to_bytes``: the packed ``(shape, dtype name,
    C-order bytes)``."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = tuple(t.shape), "bfloat16"
            data = t.view(torch.uint16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    else:
        a = np.asarray(value)
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise ValueError("object and structured dtypes cannot be packed")
        shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    if len(data) > MAX_CHUNK_SIZE:
        raise ValueError(f"array of {len(data)} bytes exceeds {MAX_CHUNK_SIZE}: "
                         "chunked arrays are not supported")
    return packb([list(shape), name, data])


def _pack(v, out: list) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _pack_int(v, out)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(b)
    elif isinstance(v, (list, tuple)):
        _pack_len(len(v), 0x90, 16, (0xDC, 0xDD), out)
        for x in v:
            _pack(x, out)
    elif isinstance(v, dict):
        _pack_len(len(v), 0x80, 16, (0xDE, 0xDF), out)
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            _pack(k, out)
            _pack(x, out)
    elif isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
        body = _array_body(v)
        n = len(body)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(bytes([fixext[n], EXT_NDARRAY]))
        else:
            _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
            out.append(bytes([EXT_NDARRAY]))
        out.append(body)
    else:
        raise TypeError(f"cannot pack {type(v).__name__}")


def packb(value) -> bytes:
    """MessagePack bytes of ``value`` (see the module docstring)."""
    out: list = []
    _pack(value, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _array_from_body(body: bytes):
    shape, name, data = unpackb(body)
    shape = tuple(shape)
    if name == "bfloat16":
        a = np.frombuffer(data, np.uint16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return np.frombuffer(data, np.dtype(name)).reshape(shape).copy()


def _unpack(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _unpack_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
    if b in sized:
        return bytes(r.take(r.unpack(sized[b])))
    ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in ext or b in fixext:
        n = r.unpack(ext[b]) if b in ext else fixext[b]
        code = r.unpack(">b")
        body = bytes(r.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        return _array_from_body(body)
    numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in numbers:
        return r.unpack(numbers[b])
    strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
    if b in strs:
        return str(r.take(r.unpack(strs[b])), "utf-8")
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_unpack(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _unpack_map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes):
    """The value packed in ``data``; trailing bytes raise ``ValueError``."""
    r = _Reader(data)
    value = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack value")
    return value
