"""ctypes binding of the native BPE merge loop (``csrc/bpe_encoder.cpp``).

The library builds with ``g++`` at its first use, into ``_build/`` under a
name that hashes the source and the flags (``ops/build.py``). Where it cannot
be built, ``native_available()`` is false, a ``RuntimeWarning`` says why
once, ``native_error()`` keeps the reason, and the tokenizer encodes in pure
Python, with the same ids. ``NativeBPEEncoder.calls`` counts the native
encode calls.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from texocr_tpu_torch.ops.build import build

SOURCE = "bpe_encoder.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build(SOURCE)[0]))
            except (RuntimeError, OSError) as e:  # no g++, a failed build, a bad library
                _error = f"{type(e).__name__}: {e}"
                warnings.warn(f"native BPE encoder unavailable, encoding in pure Python: {_error}",
                              RuntimeWarning, stacklevel=3)
                return None
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.bpe_create.restype = ctypes.c_void_p
            lib.bpe_create.argtypes = [i32p, i32p, i32p, ctypes.c_int32]
            lib.bpe_destroy.restype = None
            lib.bpe_destroy.argtypes = [ctypes.c_void_p]
            lib.bpe_encode_many.restype = ctypes.c_int32
            lib.bpe_encode_many.argtypes = [ctypes.c_void_p, i32p, i32p, ctypes.c_int32, i32p, i32p]
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library is built and loaded (building it now if
    needed)."""
    return _load_library() is not None


def native_error() -> Optional[str]:
    """Why the library could not be built or loaded; None if it was, or was
    not tried yet."""
    return _error


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeBPEEncoder:
    """A merge table in the native library; encodes pre-split byte strings
    as the Python merge loop does."""

    calls = 0  # encode_concat calls that ran the native loop, over all instances

    def __init__(self, merges: Dict[Tuple[int, int], int]):
        lib = _load_library()
        if lib is None:
            raise RuntimeError(f"native BPE encoder unavailable: {_error}")
        self._lib = lib
        n = len(merges)
        a = np.fromiter((p[0] for p in merges), dtype=np.int32, count=n)
        b = np.fromiter((p[1] for p in merges), dtype=np.int32, count=n)
        ids = np.fromiter(merges.values(), dtype=np.int32, count=n)
        self._handle = lib.bpe_create(_i32p(a), _i32p(b), _i32p(ids), n)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_destroy(self._handle)
            self._handle = None

    def encode_concat(self, splits: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
        """All splits in one native call -> (ids, offsets): the int32 ids of
        every split in turn, and the (n_splits + 1,) prefix offsets into them
        (split i's ids are ``ids[offsets[i]:offsets[i + 1]]``)."""
        if not splits:
            return np.zeros(0, np.int32), np.zeros(1, np.int32)
        offsets = np.zeros(len(splits) + 1, dtype=np.int32)
        np.cumsum(np.fromiter(map(len, splits), dtype=np.int32, count=len(splits)),
                  out=offsets[1:])
        # At least one element each: an all-empty input still passes valid pointers.
        ids_in = np.zeros(max(int(offsets[-1]), 1), np.int32)
        ids_in[: offsets[-1]] = np.frombuffer(b"".join(splits), dtype=np.uint8)
        ids_out = np.empty_like(ids_in)  # merging never lengthens a split
        out_offsets = np.empty_like(offsets)
        self._lib.bpe_encode_many(self._handle, _i32p(ids_in), _i32p(offsets), len(splits),
                                  _i32p(ids_out), _i32p(out_offsets))
        NativeBPEEncoder.calls += 1
        return ids_out, out_offsets
