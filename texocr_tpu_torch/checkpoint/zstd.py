"""zstd through the system's ``libzstd.so.1``, bound with ctypes.

Orbax compresses every zarr chunk and every OCDBT node with zstd, and the
standard library has no zstd module. The library is loaded at the first call,
not on import, so the package imports where it is missing; a call then raises
``OSError`` naming it. Nothing falls back to another codec.

- ``decompress(data, size)``: one frame whose decompressed size is known
  (a zarr chunk: its shape times its item size). Orbax's frames do not
  carry their content size, so the caller gives it.
- ``decompress_stream(data)``: one frame of unknown decompressed size (an
  OCDBT node), through ``ZSTD_decompressStream``.
- ``compress(data, level=1)``: one frame, at orbax's level.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

LIBRARY = "libzstd.so.1"

_lib: Optional[ctypes.CDLL] = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _open(name: str) -> ctypes.CDLL:
    """``ctypes.CDLL(name)``; the seam the tests replace to hide the library."""
    return ctypes.CDLL(name)


def library() -> ctypes.CDLL:
    """The loaded library, with the signatures this module calls."""
    global _lib
    if _lib is None:
        try:
            lib = _open(LIBRARY)
        except OSError as e:
            raise OSError(f"{LIBRARY} could not be loaded ({e}): reading and writing orbax "
                          "checkpoints needs the system's zstd library") from e
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        for name, res, args in (
                ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
                ("ZSTD_compress", size_t, [vp, size_t, vp, size_t, ctypes.c_int]),
                ("ZSTD_compressBound", size_t, [size_t]),
                ("ZSTD_isError", ctypes.c_uint, [size_t]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                ("ZSTD_createDCtx", vp, []),
                ("ZSTD_freeDCtx", size_t, [vp]),
                ("ZSTD_DStreamOutSize", size_t, []),
                ("ZSTD_decompressStream", size_t,
                 [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib


class _DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", ctypes.c_void_p),
                ("dli_sname", ctypes.c_char_p), ("dli_saddr", ctypes.c_void_p)]


def library_path() -> str:
    """The file the loaded library's ``ZSTD_compress`` lies in (``dladdr``:
    another libzstd in the process, such as one a wheel bundles, does not
    count), or the library's name where that cannot be told."""
    lib = library()
    info = _DlInfo()
    dladdr = ctypes.CDLL(None).dladdr
    dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
    if dladdr(ctypes.cast(lib.ZSTD_compress, ctypes.c_void_p), ctypes.byref(info)):
        return os.path.realpath(info.dli_fname.decode())
    return LIBRARY


def _check(code: int, what: str) -> int:
    lib = library()
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def _address(data) -> int:
    return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value if data else 0


def decompress(data: bytes, size: int) -> bytearray:
    """The ``size`` bytes that the frames in ``data`` decompress to; any other
    size raises ``ValueError``."""
    data = bytes(data)
    out = bytearray(size)
    buf = (ctypes.c_char * size).from_buffer(out) if size else None
    n = _check(library().ZSTD_decompress(ctypes.addressof(buf) if size else None, size,
                                         _address(data), len(data)), "decompress")
    if n != size:
        raise ValueError(f"zstd frame gave {n} bytes, {size} expected")
    return out


def decompress_stream(data: bytes) -> bytes:
    """What the frames in ``data`` decompress to, of a size not known ahead."""
    lib = library()
    data = bytes(data)
    ctx = lib.ZSTD_createDCtx()
    if not ctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        step = lib.ZSTD_DStreamOutSize()
        chunk = ctypes.create_string_buffer(step)
        src = _InBuffer(_address(data), len(data), 0)
        parts = []
        while True:
            dst = _OutBuffer(ctypes.addressof(chunk), step, 0)
            left = _check(lib.ZSTD_decompressStream(ctx, ctypes.byref(dst), ctypes.byref(src)),
                          "stream decompress")
            parts.append(ctypes.string_at(chunk, dst.pos))
            if src.pos == src.size and dst.pos < step:
                if left:
                    raise ValueError("zstd stream ends inside a frame")
                return b"".join(parts)
    finally:
        lib.ZSTD_freeDCtx(ctx)


def compress(data, level: int = 1) -> bytes:
    """One zstd frame of ``data`` (bytes-like) at ``level``."""
    lib = library()
    data = bytes(data)
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = _check(lib.ZSTD_compress(out, bound, _address(data), len(data), level), "compress")
    return ctypes.string_at(out, n)
