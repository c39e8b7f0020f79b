"""A msgpack codec for checkpoints, byte-compatible with flax's
``serialization.msgpack_serialize`` and ``msgpack_restore``, written for the
port (the card's machine has no ``msgpack`` package).

What it writes is what ``msgpack.packb(tree, strict_types=True,
default=flax's ext pack)`` writes: nil, booleans, integers in the smallest
format, Python floats as float64, str (utf-8), bytes as bin, lists as
arrays, dicts as maps in their own key order; a numpy array is flax's ext
type 1 holding the packed (shape, dtype name, C-order bytes), a numpy
scalar ext type 3. Arrays above 2**30 bytes are split into flax's chunked
form. ``dumps_tree`` sorts every dict's keys first, as flax's tree copy
does, so a tree written here and one written by flax are the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int, codes) -> None:
    if n < fix_max and fix_base is not None:
        out.append(fix_base | n)
    elif n <= 0xFF and codes[0] is not None:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of {n} elements or bytes is too large")


def _pack_int(out: bytearray, d: int) -> None:
    if d < -(1 << 5):
        if d < -(1 << 15):
            if d < -(1 << 31):
                if d < -(1 << 63):
                    raise OverflowError(f"{d} does not fit msgpack's int64")
                out.append(0xD3)
                out += struct.pack(">q", d)
            else:
                out.append(0xD2)
                out += struct.pack(">i", d)
        elif d < -(1 << 7):
            out.append(0xD1)
            out += struct.pack(">h", d)
        else:
            out.append(0xD0)
            out += struct.pack(">b", d)
    elif d < (1 << 7):
        out += struct.pack(">b", d) if d < 0 else bytes((d,))
    elif d < (1 << 8):
        out += bytes((0xCC, d))
    elif d < (1 << 16):
        out.append(0xCD)
        out += struct.pack(">H", d)
    elif d < (1 << 32):
        out.append(0xCE)
        out += struct.pack(">I", d)
    elif d < (1 << 64):
        out.append(0xCF)
        out += struct.pack(">Q", d)
    else:
        raise OverflowError(f"{d} does not fit msgpack's uint64")


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj: Any) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif t in (list, tuple):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif t is dict:
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize {t.__name__}")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += bytes((0xC7, n))
    elif n <= 0xFFFF:
        out.append(0xC8)
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(0xC9)
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"ext payload of {n} bytes is too large")
    out += struct.pack(">b", code)
    out += data


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            return _array_from(data)[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                0xC9: ">I"}
        if c in lens:
            n = self.unpack(lens[c])
            if c <= 0xC6:
                return bytes(self.take(n))
            if c <= 0xC9:
                return self.ext(n)
            if c <= 0xDB:
                return self.str_(n)
            if c <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map_(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _array_from(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = _Reader(data, raw=True).read()
    if dtype_name == b"bfloat16":
        raise TypeError("bfloat16 arrays in a checkpoint are not supported by the port")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()), count=-1,
                         offset=0).reshape(shape, order="C")


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


# ---------------------------------------------------------------------------
# trees as flax writes and reads them
# ---------------------------------------------------------------------------


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _sorted_tree(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def dumps_tree(tree: Mapping[str, Any]) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``: dict keys sorted, big
    arrays chunked."""
    return packb(_sorted_tree(tree))


def loads_tree(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``."""
    return _unchunk(unpackb(data))
