"""A small msgpack codec for the trees flax's ``msgpack_serialize`` writes.

The JAX package stores checkpoints with ``flax.serialization``; the port
reads and writes the same bytes without flax or the msgpack package. The
subset covered:

  nil, bool, int / uint 8-64 (and fixints), float 32 / 64, str, bin,
  array and map of every width, and ext type 1: an ndarray, packed as the
  msgpack array (shape, dtype name, C-order bytes) (flax's
  ``_ndarray_to_bytes``).

Arrays decode to numpy arrays, except ``bfloat16``, which numpy lacks: it
decodes to a CPU ``torch.bfloat16`` tensor, and such a tensor encodes back
to ``bfloat16``. Anything else (another ext type, such as flax's complex
numbers and numpy scalars, a reserved byte, an object the encoder does not
know) raises.

The encoder writes what msgpack-python writes with ``use_bin_type=True``
(the smallest width that holds each value, floats as float 64) and sorts
the keys of every map, as flax's tree flattening does, so a tree of numpy
arrays encodes to the bytes flax writes for it.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1


class MsgpackError(ValueError):
    """Bytes this codec does not read, or an object it does not write."""


# ---- decoding -----------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width codes: byte -> (struct format of the value or of the length,
# kind)
_FIXED = {
    0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"),
    0xCF: (">Q", "int"), 0xD0: (">b", "int"), 0xD1: (">h", "int"),
    0xD2: (">i", "int"), 0xD3: (">q", "int"),
    0xCA: (">f", "float"), 0xCB: (">d", "float"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _read(r: _Reader, raw: bool = False) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _text(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b not in _FIXED:
        raise MsgpackError(f"msgpack byte 0x{b:02x} is not supported")
    fmt, kind = _FIXED[b]
    value = r.unpack(fmt)
    if kind in ("int", "float"):
        return value
    if kind == "str":
        return _text(r.take(value), raw)
    if kind == "bin":
        return r.take(value)
    if kind == "array":
        return [_read(r, raw) for _ in range(value)]
    if kind == "map":
        return _read_map(r, value, raw)
    code = r.unpack(">b")
    return _ext(code, r.take(value))


def _text(data: bytes, raw: bool):
    return data if raw else data.decode("utf-8")


def _read_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r, raw)
        out[k] = _read(r, raw)
    return out


def _ndarray(data: bytes):
    r = _Reader(data)
    shape, name, buf = _read(r, raw=True)
    if r.pos != len(data):
        raise MsgpackError("trailing bytes in an ndarray ext")
    name = name.decode("ascii")
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    raise MsgpackError(f"msgpack ext type {code} is not supported")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (``flax.serialization.msgpack_restore``)."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes after the object")
    return out


# ---- encoding -----------------------------------------------------------


def _len_head(out: bytearray, n: int, fix, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (8, 16, 32-bit; None where the type has no such width) that
    holds n."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} is too large for msgpack")


def _write_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"integer {v} is too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"integer {v} is too small for msgpack")


def _write_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _len_head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(a) -> bytes:
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            shape = tuple(a.shape)
            buf = a.contiguous().view(torch.int16).numpy().tobytes()
            return packb([list(shape), "bfloat16", buf])
        a = a.numpy()
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise MsgpackError(f"dtype {a.dtype} is not supported")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _write(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _write_int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _len_head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif type(obj) in (bytes, bytearray):
        _len_head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif type(obj) in (list, tuple):
        _len_head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _write(out, v)
    elif type(obj) is dict:
        _len_head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k in sorted(obj):
            _write(out, k)
            _write(out, obj[k])
    elif isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        _write_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    else:
        raise MsgpackError(f"cannot encode {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode a tree of dicts, lists, Python scalars, numpy arrays and
    tensors (``flax.serialization.msgpack_serialize`` of such a tree)."""
    out = bytearray()
    _write(out, obj)
    return bytes(out)
