"""A standard-library reader of the msgpack that flax writes.

The JAX package keeps a checkpoint's params in ``params_cache.msgpack``,
written by ``flax.serialization.msgpack_serialize``: a tree of maps with str
keys and array leaves. The card's machine has no ``msgpack`` package, so
this module reads the subset flax writes, and nothing else:

- nil, bools, ints and floats of every width (big-endian), str and bin,
  arrays and maps;
- ext type 1, an ndarray: the msgpack triple (shape, dtype name, C-order
  buffer); ext type 3, a numpy scalar: the same triple at shape ();
- ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  maps, which flax writes for a leaf over its ``MAX_CHUNK_SIZE``: the shape
  and the flat chunks as maps from "0", "1", ... to their values.

Leaves come back as numpy arrays (numpy scalars for ext type 3), except
``bfloat16``, which numpy does not have: its buffer is read as uint16 and
viewed as a ``torch.bfloat16`` tensor. Anything else (another ext code, the
reserved byte 0xc1) raises ``ValueError`` naming the byte or the code.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

# Fixed-width scalars: type byte -> struct format.
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# Length-prefixed kinds: type byte -> (kind, struct format of the length).
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
# fixext 1, 2, 4, 8, 16: type byte -> data length.
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data ends at byte {len(self.data)}, "
                             f"{self.pos + n} needed")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        byte = self.unpack(">B")
        if byte <= 0x7f:
            return byte
        if byte >= 0xe0:
            return byte - 0x100
        if 0x80 <= byte <= 0x8f:
            return self.collection("map", byte & 0x0f)
        if 0x90 <= byte <= 0x9f:
            return self.collection("array", byte & 0x0f)
        if 0xa0 <= byte <= 0xbf:
            return str(self.take(byte & 0x1f), "utf-8")
        if byte in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[byte]
        if byte in _SCALARS:
            return self.unpack(_SCALARS[byte])
        if byte in _FIXEXT:
            return self.ext(_FIXEXT[byte])
        if byte in _SIZED:
            kind, fmt = _SIZED[byte]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "ext":
                return self.ext(n)
            return self.collection(kind, n)
        raise ValueError(f"msgpack type byte 0x{byte:02x} at offset {self.pos - 1} is not "
                         "one flax writes")

    def collection(self, kind: str, n: int):
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return _unchunk(out) if out.get(CHUNKED) is True else out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            leaf = _ndarray(data)
            return leaf if torch.is_tensor(leaf) else leaf[()]
        raise ValueError(f"msgpack ext code {code} is not one flax writes for params "
                         f"(ndarray {EXT_NDARRAY}, numpy scalar {EXT_NPSCALAR})")


def _ndarray(data: bytes):
    """An ndarray from flax's (shape, dtype name, C-order buffer) triple."""
    shape, name, buffer = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    shape: Tuple[int, ...] = tuple(shape)
    if name == "bfloat16":
        flat = np.frombuffer(buffer, dtype=np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree: dict):
    """The array of flax's chunked form: the flat chunks in order,
    concatenated, in the recorded shape."""
    shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
    chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
    if torch.is_tensor(chunks[0]):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpackb(data: bytes) -> Any:
    """The value that ``data`` holds, as the module docstring says; raises
    ``ValueError`` on anything outside flax's subset or on trailing bytes."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes follow the msgpack value")
    return out
