"""Read flax's msgpack checkpoints without msgpack or flax.

The JAX package writes its ``.ckpt`` files with
``flax.serialization.msgpack_serialize``: one msgpack map of nested maps
whose leaves are numpy arrays, each packed as msgpack extension type 1
holding the msgpack array (shape, dtype name, C-order bytes). Arrays
above 1 GiB are split into a ``__msgpack_chunked_array__`` map.
``msgpack_restore`` here decodes that format in pure Python and returns
the same tree as ``flax.serialization.msgpack_restore``: dicts with str
keys, numpy arrays (read-only views of the file's bytes), Python
scalars, lists for msgpack arrays. A bfloat16 array, which numpy cannot
hold, comes back as a ``torch.bfloat16`` tensor.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A cursor over msgpack bytes (big-endian, as the format fixes)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = _FIXED.get(b)
        if fixed is not None:
            return fixed(self)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, n: int):
        code = self.unpack("b")
        return _ext(code, bytes(self.take(n)))


def _str(n_fmt):
    return lambda r: str(r.take(r.unpack(n_fmt)), "utf-8")


def _bin(n_fmt):
    return lambda r: bytes(r.take(r.unpack(n_fmt)))


def _num(fmt):
    return lambda r: r.unpack(fmt)


_FIXED = {
    0xC0: lambda r: None, 0xC2: lambda r: False, 0xC3: lambda r: True,
    0xC4: _bin("B"), 0xC5: _bin("H"), 0xC6: _bin("I"),
    0xC7: lambda r: r.ext(r.unpack("B")), 0xC8: lambda r: r.ext(r.unpack("H")),
    0xC9: lambda r: r.ext(r.unpack("I")),
    0xCA: _num("f"), 0xCB: _num("d"),
    0xCC: _num("B"), 0xCD: _num("H"), 0xCE: _num("I"), 0xCF: _num("Q"),
    0xD0: _num("b"), 0xD1: _num("h"), 0xD2: _num("i"), 0xD3: _num("q"),
    0xD4: lambda r: r.ext(1), 0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4), 0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: _str("B"), 0xDA: _str("H"), 0xDB: _str("I"),
    0xDC: lambda r: r.array(r.unpack("H")), 0xDD: lambda r: r.array(r.unpack("I")),
    0xDE: lambda r: r.map(r.unpack("H")), 0xDF: lambda r: r.map(r.unpack("I")),
}


def unpackb(data: bytes):
    """One msgpack value from ``data``, which it must fill exactly."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         "after the value")
    return out


def _ndarray(data: bytes):
    shape, dtype, buf = unpackb(data)
    if dtype == "bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                                ).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    raise ValueError(f"msgpack: unsupported extension type {code}")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore(data)`` returns."""
    return _unchunk(unpackb(data))


def is_msgpack_map(head: bytes) -> bool:
    """Whether bytes start a msgpack map (a flax checkpoint) rather than
    the zip archive ``torch.save`` writes (``PK``)."""
    return len(head) > 0 and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
