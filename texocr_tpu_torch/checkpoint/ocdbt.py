"""The OCDBT key-value store that orbax writes (tensorstore's "optionally
cooperative distributed B+tree"), read and written without tensorstore.

A store is a directory. Its root ``manifest.ocdbt`` holds the store's
configuration, a table of data files and the version tree; the newest
version names the root B-tree node. Nodes and values lie in data files
(``d/<hex>`` and, for orbax's per-process writes, ``ocdbt.process_N/d/<hex>``).

Every manifest and node is framed alike: a 4-byte big-endian magic
(``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), the framed length as a
little-endian u64, a varint format version (0), a varint compression
(0 none, 1 zstd), the payload, and the CRC-32C of all that as a
little-endian u32. Integers in a payload are LEB128 varints unless said
otherwise, and lists are stored column by column:

- data file table: count; for files 1.. the length of the path prefix shared
  with the previous path; every path's suffix length; every path's base
  length; the suffixes. A path is ``base + relative``, and the base is read
  below the base of the file the table came from.
- manifest: config (uuid 16 bytes; manifest kind; max inline value bytes;
  max decoded node bytes; version tree arity log2 as one byte; compression,
  with zstd's level as an i32), the data file table, the versions (count;
  generation, root height, file, offset, length, keys, tree bytes, indirect
  value bytes, each a column; commit times as u64), and the version tree
  nodes (count; generation, file, offset, length, generations, commit times
  as u64, height). The newest version is always in the manifest itself.
- B-tree node: height (one byte), the data file table, the entry count, the
  keys (prefix lengths for entries 1.., suffix lengths, then in an interior
  node each entry's subtree common prefix length, then the suffixes). An
  interior entry's key is the first key below it, and the keys of its
  subtree are stored without the entry's subtree common prefix. Interior
  entries go on with columns of file, offset, length, keys, tree bytes and
  indirect value bytes; leaf entries with value lengths, kinds (0 inline,
  1 in a data file), the file and the offset of each value in a data file,
  and the inline values one after another.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, List, Tuple

from texocr_tpu_torch.checkpoint import zstd

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE

#: orbax's store configuration, which ``write_store`` writes.
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
NODE_ZSTD_LEVEL = 0

_HEADER = 14  # magic, length, version and compression varints (one byte each)


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a payload."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.where}: payload ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.where}: {len(self.data) - self.pos} bytes after the payload")


def _varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _unframe(buf: bytes, magic: int, where: str) -> bytes:
    """The payload of one framed manifest or node, its checksum verified."""
    if len(buf) < _HEADER + 4:
        raise ValueError(f"{where}: {len(buf)} bytes is too short")
    if struct.unpack(">I", buf[:4])[0] != magic:
        raise ValueError(f"{where}: magic {buf[:4].hex()} is not {magic:08x}")
    if struct.unpack("<Q", buf[4:12])[0] != len(buf):
        raise ValueError(f"{where}: length {struct.unpack('<Q', buf[4:12])[0]} is not "
                         f"{len(buf)}")
    if crc32c(buf[:-4]) != struct.unpack("<I", buf[-4:])[0]:
        raise ValueError(f"{where}: checksum mismatch")
    head = _Reader(buf[12:-4], where)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{where}: format version {version}")
    body = buf[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress_stream(body)
    raise ValueError(f"{where}: compression {compression}")


def _frame(payload: bytes, magic: int) -> bytes:
    body = b"\x00\x01" + zstd.compress(payload, NODE_ZSTD_LEVEL)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(body) + 4)
    framed = head + body
    return framed + struct.pack("<I", crc32c(framed))


def _read_file_table(r: _Reader, transitive: str) -> List[Tuple[str, str]]:
    """The data file table: each file's (base path, relative path), the base
    below ``transitive``, the base of the file the table came from."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    files, previous = [], b""
    for i in range(n):
        path = previous[:prefix[i]] + r.take(suffix[i])
        files.append((transitive + path[:base[i]].decode(), path[base[i]:].decode()))
        previous = path
    return files


def _write_file_table(paths: List[Tuple[str, str]]) -> bytes:
    full = [(base + rel).encode() for base, rel in paths]
    prefix = [_common(a, b) for a, b in zip(full, full[1:])]
    return (_varint(len(full)) + _varints(prefix)
            + _varints(len(p) - n for p, n in zip(full, [0] + prefix))
            + _varints(len(base.encode()) for base, _ in paths)
            + b"".join(p[n:] for p, n in zip(full, [0] + prefix)))


def _common(a: bytes, b: bytes) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def _read_keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    subtree = r.varints(n) if interior else [0] * n
    keys, previous = [], b""
    for i in range(n):
        previous = previous[:prefix[i]] + r.take(suffix[i])
        keys.append(previous)
    return keys, subtree


class _Store:
    """Reads one store's files, each once."""

    def __init__(self, root: str):
        self.root = root
        self.files: Dict[str, bytes] = {}

    def file(self, base: str, rel: str) -> Tuple[str, bytes]:
        path = os.path.join(self.root, base, rel)
        if path not in self.files:
            with open(path, "rb") as f:
                self.files[path] = f.read()
        return path, self.files[path]

    def slice(self, ref: Tuple[str, str], offset: int, length: int) -> Tuple[str, bytes]:
        path, data = self.file(*ref)
        if offset + length > len(data):
            raise ValueError(f"{path}: [{offset}, {offset + length}) lies past its end")
        return path, data[offset:offset + length]

    def node(self, ref: Tuple[str, str], offset: int, length: int, height: int, prefix: bytes,
             out: Dict[bytes, bytes]) -> None:
        path, framed = self.slice(ref, offset, length)
        where = f"{path} at {offset}"
        r = _Reader(_unframe(framed, NODE_MAGIC, where), where)
        if r.byte() != height:
            raise ValueError(f"{where}: node height is not {height}")
        files = _read_file_table(r, ref[0])
        n = r.varint()
        keys, subtree = _read_keys(r, n, interior=height > 0)
        if height > 0:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # the subtrees' key, byte and indirect byte counts
            r.end()
            for i in range(n):
                self.node(files[fid[i]], off[i], ln[i], height - 1,
                          prefix + keys[i][:subtree[i]], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{where}: value kinds {sorted(set(kinds))}")
        indirect = [i for i in range(n) if kinds[i] == 1]
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        for i, f, o in zip(indirect, fid, off):
            out[prefix + keys[i]] = self.slice(files[f], o, lengths[i])[1]
        for i in range(n):
            if kinds[i] == 0:
                out[prefix + keys[i]] = r.take(lengths[i])
        r.end()


def read_store(directory: str) -> Dict[bytes, bytes]:
    """Every key and value of the newest version of the store in
    ``directory``. A checksum that does not match raises ``ValueError``
    naming the file."""
    store = _Store(directory)
    where = os.path.join(directory, MANIFEST)
    r = _Reader(_unframe(store.file("", MANIFEST)[1], MANIFEST_MAGIC, where), where)
    r.take(16)  # uuid
    kind = r.varint()
    if kind != 0:
        raise ValueError(f"{where}: manifest kind {kind} (numbered manifests are not read)")
    r.varint(), r.varint(), r.byte()  # max inline bytes, max node bytes, arity
    if r.varint() == 1:
        r.take(4)  # zstd level
    files = _read_file_table(r, "")
    n = r.varint()
    generation, height = r.varints(n), r.varints(n)
    fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
    r.varints(3 * n)
    r.take(8 * n)  # commit times
    m = r.varint()  # older versions, in the version tree's nodes
    r.varints(5 * m)
    r.take(8 * m)
    r.varints(m)
    r.end()
    out: Dict[bytes, bytes] = {}
    if n:
        newest = max(range(n), key=lambda i: generation[i])
        store.node(files[fid[newest]], off[newest], ln[newest], height[newest], b"", out)
    return out


def _leaf(entries: List[Tuple[bytes, bytes]], data_file: str) -> Tuple[bytes, List[bytes]]:
    """A leaf node's payload over sorted (key, value) entries, the values
    longer than the inline limit placed one after another in ``data_file``
    from offset 0; returns the payload and those values."""
    keys = [k for k, _ in entries]
    prefix = [_common(a, b) for a, b in zip(keys, keys[1:])]
    kinds = [int(len(v) > MAX_INLINE_VALUE_BYTES) for _, v in entries]
    outside = [v for (_, v), kind in zip(entries, kinds) if kind]
    offsets, at = [], 0
    for v in outside:
        offsets.append(at)
        at += len(v)
    payload = (b"\x00" + _write_file_table([("", data_file)]) + _varint(len(keys))
               + _varints(prefix) + _varints(len(k) - p for k, p in zip(keys, [0] + prefix))
               + b"".join(k[p:] for k, p in zip(keys, [0] + prefix))
               + _varints(len(v) for _, v in entries) + _varints(kinds)
               + _varints([0] * len(outside)) + _varints(offsets)
               + b"".join(v for (_, v), kind in zip(entries, kinds) if not kind))
    return payload, outside


def write_store(directory: str, items: Dict[bytes, bytes]) -> None:
    """Writes ``items`` as a new store in ``directory`` (one version, one
    leaf node, the values longer than orbax's inline limit in the same data
    file as the node), which tensorstore's ``ocdbt`` driver opens."""
    name = os.urandom(16).hex()
    entries = sorted((bytes(k), bytes(v)) for k, v in items.items())
    payload, outside = _leaf(entries, f"d/{name}")
    if len(payload) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"a leaf of {len(payload)} bytes is over the "
                         f"{MAX_DECODED_NODE_BYTES}-byte node limit")
    node = _frame(payload, NODE_MAGIC)
    indirect = sum(len(v) for v in outside)
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    with open(os.path.join(directory, "d", name), "wb") as f:
        for v in outside:
            f.write(v)
        f.write(node)
    manifest = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
                + _varint(1) + struct.pack("<i", NODE_ZSTD_LEVEL)
                + _write_file_table([("", f"d/{name}")])
                + _varint(1) + _varints([1, 0, 0, indirect, len(node), len(entries),
                                         len(node), indirect])
                + struct.pack("<Q", time.time_ns()) + _varint(0))
    tmp = os.path.join(directory, MANIFEST + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_frame(manifest, MANIFEST_MAGIC))
    os.replace(tmp, os.path.join(directory, MANIFEST))
