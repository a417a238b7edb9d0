"""A codec of flax's msgpack checkpoint format, in pure Python on numpy.

flax writes a checkpoint with ``serialization.to_bytes`` and reads it with
``msgpack_restore``: a tree of msgpack maps with string keys whose array
leaves are ext type 1, with the payload ``packb((shape, dtype name, raw C
bytes))``; numpy scalars are ext type 3 (the same payload, shape ()) and
complex numbers ext type 2.  `packb` writes what ``msgpack.packb(tree,
use_bin_type=True, strict_types=True)`` writes, maps in their own key
order, or with ``sort_keys`` in the sorted order of a tree that came out of
``jax.jit`` (as the JAX trainer's variables and Adam state do); `unpackb`
reads it back: nil, bool, int, float, str, bin, array, map and those ext
types.

flax splits a leaf larger than ``MAX_CHUNK_SIZE`` bytes into chunks; this
codec raises on such a leaf in both directions (no leaf of a vits or vitl
checkpoint comes near 1 GiB).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["packb", "unpackb", "MAX_CHUNK_SIZE"]

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ pack

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's uint64")
    else:
        for code, fmt, bottom in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                  (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= bottom:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's int64")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    forms of ``codes`` (None where the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no msgpack array form")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(
            f"array of shape {arr.shape} ({arr.nbytes} bytes) is above flax's chunk limit "
            f"of {MAX_CHUNK_SIZE} bytes; chunked leaves are not supported by this codec")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is complex:
        _pack_ext(_EXT_COMPLEX, packb((obj.real, obj.imag)), out)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif type(obj) in (bytes, bytearray):
        _pack_len(len(obj), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack an object of type {type(obj).__name__}")


def _sorted_tree(obj):
    """Dicts with their keys sorted at every level: the order of a tree
    rebuilt by JAX's pytree unflattening."""
    if type(obj) is dict:
        return {k: _sorted_tree(obj[k]) for k in sorted(obj)}
    if type(obj) in (list, tuple):
        return type(obj)(_sorted_tree(v) for v in obj)
    return obj


def packb(obj, sort_keys: bool = False) -> bytes:
    """msgpack bytes of ``obj``; ``sort_keys`` writes every map with its keys
    sorted."""
    out = bytearray()
    _pack(_sorted_tree(obj) if sort_keys else obj, out)
    return bytes(out)


# ---------------------------------------------------------------- unpack

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {  # code -> (kind, length format)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ext(code: int, data: bytes):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype, raw = unpackb(data)
        if dtype == "bfloat16":
            raise ValueError("bfloat16 arrays need ml_dtypes, which the port does not use")
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"unknown msgpack ext type {code}")


def _read(r: _Reader):
    c = r.take(1)[0]
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif c in _SIZED:
        kind, fmt = _SIZED[c]
        n = r.unpack(fmt)
    elif c in _SCALARS:
        return r.unpack(_SCALARS[c])
    elif c in _FIXEXT:
        kind, n = "ext", _FIXEXT[c]
    elif c == 0xC0:
        return None
    elif c in (0xC2, 0xC3):
        return c == 0xC3
    else:
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "ext":
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if kind == "array":
        return [_read(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    if _CHUNKED in out:
        raise ValueError("chunked array leaves (above flax's 1 GiB chunk limit) are not "
                         "supported by this codec")
    return out


def unpackb(data: bytes):
    """The object that msgpack ``data`` holds: ext arrays as writable numpy
    arrays, arrays as lists, maps as dicts in their stored order."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of trailing data after the msgpack object")
    return obj
