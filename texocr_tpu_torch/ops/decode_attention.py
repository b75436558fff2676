"""Decode-step attention over cached K/V: the hand-written CUDA kernel and its
plain version.

Replaces no Pallas kernel. The JAX package leaves a decode step's attention
to XLA, as einsums on the compute type's values with float32 logits and float32
sums; the port's first version cast the whole cache to float32 every step (and
copied the cross cache's split-head views once more into contiguous tensors),
about 12 GB a step at batch 256 where the step needs one read of its 1.3 GB.
``csrc/decode_attention.cu`` reads each cached byte once in the type it is
stored in; the source says what bounds it and how.

It serves the three call sites of the cached decode step, and only those
(``models/attention.py``): the cross-attention over K/V computed once per
sequence (compute type, or int8 with per-(batch, head, dh) scales) and the
self-attention over positions 0..t of the step's cache (compute type, or the
int8 prefix [0, t0) with per-position scales plus positions [t0, t]). The
encoder, the teacher-forced forward and training keep
``attention_core``.

- ``cross_attention_plain``, ``self_attention_plain``: the same functions in
  plain PyTorch, the formulas the decode step used before the kernel
  (``math_attention`` and the int8 split's own).
- ``cross_attention``, ``self_attention``: the plain version for a CPU
  tensor; for a CUDA tensor the kernel, or ``ValueError`` for a call it does
  not take. The telemetry counter ``decode_attention.launches`` counts the
  kernel's launches (CUDA-graph replays add theirs, ``models/graphed.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.ops.attention_core import math_attention

SOURCE = "decode_attention.cu"
HEAD_DIM = 64
MAX_KEYS = 4096  # the flash gate's limit
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PLAIN, CROSS8, SPLIT = 0, 1, 2

_lib = None


def cross_attention_plain(q: torch.Tensor, kv: Dict[str, torch.Tensor], *, scale: float,
                          key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, R, dh), an image's R beam rows; ``kv``: {"k", "v"} or the
    int8 {"k8", "v8", "sk", "sv"}, each (B, H, Nk, .), scales (B, H, 1, dh):
    K's multiplies q in q's type before the dot, V's the output.
    ``key_mask``: (B, Nk) bool, False at padded keys. Returns (B, H, R, dh)."""
    allowed = None if key_mask is None else key_mask[:, None, None, :]
    if "k8" in kv:
        return math_attention(q * kv["sk"], kv["k8"].to(q.dtype), kv["v8"].to(q.dtype),
                              scale=scale, allowed=allowed) * kv["sv"]
    return math_attention(q, kv["k"], kv["v"], scale=scale, allowed=allowed)


def self_attention_plain(q: torch.Tensor, cache: Dict[str, torch.Tensor], t: int, t0: int, *,
                         scale: float) -> torch.Tensor:
    """q: (B, H, 1, dh) at position t against the cache's positions 0..t;
    with an int8 cache the prefix [0, t0) in int8 and [t0, t] in full
    precision with one float32 softmax (the JAX package's ``_attend_split``):
    K's per-position scales multiply the logits after the dot, V's the
    probabilities after their cast to the compute type. Returns (B, H, 1, dh)."""
    if "k8" not in cache:
        return math_attention(q, cache["k"][:, :, : t + 1], cache["v"][:, :, : t + 1],
                              scale=scale)
    dtype = q.dtype
    qf = q.float()
    s_hot = torch.matmul(qf, cache["k"][:, :, t0: t + 1].float().transpose(-1, -2)) * scale
    s_big = torch.matmul(qf, cache["k8"][:, :, :t0].to(dtype).float().transpose(-1, -2)) * scale
    s_big = s_big * cache["sk"][:, :, None, :t0].float()
    probs = torch.softmax(torch.cat([s_big, s_hot], dim=-1), dim=-1)
    p_big = probs[..., :t0].to(dtype) * cache["sv"][:, :, None, :t0]
    p_hot = probs[..., t0:].to(dtype)
    out = (torch.matmul(p_big.float(), cache["v8"][:, :, :t0].to(dtype).float())
           + torch.matmul(p_hot.float(), cache["v"][:, :, t0: t + 1].float()))
    return out.to(dtype)


def cross_attention(q: torch.Tensor, kv: Dict[str, torch.Tensor], *, scale: float,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cross_attention_plain`` for CPU tensors; the kernel for CUDA ones."""
    if q.device.type == "cpu":
        return cross_attention_plain(q, kv, scale=scale, key_mask=key_mask)
    return _launch(q, scale, cross_call(q, kv, key_mask))


def self_attention(q: torch.Tensor, cache: Dict[str, torch.Tensor], t: int, t0: int, *,
                   scale: float) -> torch.Tensor:
    """``self_attention_plain`` for CPU tensors; the kernel for CUDA ones."""
    if q.device.type == "cpu":
        return self_attention_plain(q, cache, t, t0, scale=scale)
    return _launch(q, scale, self_call(q, cache, t, t0))


def cross_call(q, kv, key_mask=None) -> dict:
    """The kernel's arguments for a cross-attention call, or ``ValueError``
    for one it does not take."""
    _check_q(q)
    b, h, _, _ = q.shape
    if "k8" in kv:
        nk = _check_rows(q, kv, ("k8", "v8"), torch.int8)
        _check_scales(q, kv, (b, h, 1, HEAD_DIM))
        call = dict(mode=CROSS8, n=nk, n8=nk, k8=kv["k8"], v8=kv["v8"], sk=kv["sk"],
                    sv=kv["sv"])
    else:
        nk = _check_rows(q, kv, ("k", "v"), q.dtype)
        call = dict(mode=PLAIN, n=nk, n8=0, k=kv["k"], v=kv["v"])
    if not 1 <= nk <= MAX_KEYS:
        raise ValueError(f"decode attention takes 1 to {MAX_KEYS} keys, got {nk}")
    if key_mask is not None:
        if (key_mask.dtype != torch.bool or key_mask.device != q.device
                or tuple(key_mask.shape) != (b, nk)):
            raise ValueError(f"key_mask must be ({b}, {nk}) bool on q's device, got "
                             f"{key_mask.dtype} {tuple(key_mask.shape)} on {key_mask.device}")
        call["mask"] = key_mask
    return call


def self_call(q, cache, t: int, t0: int) -> dict:
    """The kernel's arguments for a self-attention call at position ``t``
    (int8 prefix ``t0``), or ``ValueError`` for one it does not take."""
    _check_q(q)
    b, h, rows, _ = q.shape
    if rows != 1:
        raise ValueError(f"the self-attention step takes one query row, got {rows}")
    size = _check_rows(q, cache, ("k", "v"), q.dtype)
    if not 0 <= t < min(size, MAX_KEYS):
        raise ValueError(f"position {t} outside the cache's {min(size, MAX_KEYS)} keys")
    call = dict(mode=PLAIN, n=t + 1, n8=0, k=cache["k"], v=cache["v"])
    if "k8" not in cache:
        return call
    if _check_rows(q, cache, ("k8", "v8"), torch.int8) != size:
        raise ValueError("the int8 self cache must match the full-precision one")
    _check_scales(q, cache, (b, h, size))
    if not 0 <= t0 <= t:
        raise ValueError(f"int8 prefix length {t0} outside [0, {t}]")
    return dict(call, mode=SPLIT, n8=t0, k8=cache["k8"], v8=cache["v8"], sk=cache["sk"],
                sv=cache["sv"])


def _check_q(q: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"decode attention takes (B, H, R, {HEAD_DIM}) queries, got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode attention takes float32 or bfloat16, got {q.dtype}")
    if q.stride(-1) != 1:
        raise ValueError("decode attention needs a unit stride along dh")


def _check_rows(q, kv, names, dtype) -> int:
    """The key count of K and V (``names``): (B, H, N, 64) of ``dtype`` on
    q's device, one shape and one stride, rows on 16 bytes (8 in int8)."""
    k, v = (kv[name] for name in names)
    lead = tuple(q.shape[:2])
    align = 8 if dtype == torch.int8 else 16
    for name, x in zip(names, (k, v)):
        if x.dim() != 4 or tuple(x.shape[:2]) != lead or x.shape[-1] != HEAD_DIM:
            raise ValueError(f"{name} must be {lead + ('N', HEAD_DIM)}, got {tuple(x.shape)}")
        if x.dtype != dtype or x.device != q.device:
            raise ValueError(f"{name} must be {dtype} on {q.device}, got {x.dtype} on "
                             f"{x.device}")
        if (x.stride(-1) != 1 or x.data_ptr() % align
                or any(s * x.element_size() % align for s in x.stride()[:3])):
            raise ValueError(f"{name}'s rows must lie on {align} bytes with a unit stride")
    if k.shape != v.shape or k.stride() != v.stride():
        raise ValueError(f"{names[0]} and {names[1]} must have one shape and one stride")
    return k.shape[2]


def _check_scales(q, kv, shape) -> None:
    """K's and V's int8 scales: ``shape`` in q's type on q's device, one
    stride, unit along the last dim."""
    sk, sv = kv["sk"], kv["sv"]
    for name, s in (("sk", sk), ("sv", sv)):
        if (tuple(s.shape) != shape or s.dtype != q.dtype or s.device != q.device
                or s.stride(-1) != 1):
            raise ValueError(f"{name} must be {shape} {q.dtype} on q's device with a unit "
                             f"last stride, got {s.dtype} {tuple(s.shape)}")
    if sk.stride() != sv.stride():
        raise ValueError("sk and sv must have one stride")


def bind(path) -> ctypes.CDLL:
    """Loads a library built from ``csrc/decode_attention.cu`` and declares
    its signature."""
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn = lib.texocr_decode_attention
    fn.argtypes = ([ctypes.c_int] * 2 + [ptr] + [i64] * 3 + [ptr] + [i64] * 3
                   + [ptr] * 2 + [i64] * 3 + [ptr] * 2 + [i64] * 3 + [ptr] * 2 + [i64] * 2
                   + [ptr] + [i64] * 2 + [ctypes.c_int] * 6 + [ctypes.c_float, ptr])
    fn.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        from texocr_tpu_torch.ops.build import build

        _lib = bind(build(SOURCE)[0])
    return _lib


def _launch(q, scale, call: dict) -> torch.Tensor:
    """Launches the kernel for ``call`` (``cross_call``, ``self_call``) on the
    current stream into a new (B, R, H, dh) buffer, returned as its
    (B, H, R, dh) view: merging the heads back is then no copy."""
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on a CUDA device, got {q.device}")
    b, h, rows, dh = q.shape
    out = torch.empty((b, rows, h, dh), dtype=q.dtype, device=q.device)

    def ptrs(*names):
        return [call[n].data_ptr() if n in call else None for n in names]

    def strides(name, count):
        return call[name].stride()[:count] if name in call else (0,) * count

    err = _library().texocr_decode_attention(
        call["mode"], _DTYPES[q.dtype],
        q.data_ptr(), *q.stride()[:3],
        out.data_ptr(), out.stride(0), out.stride(2), out.stride(1),
        *ptrs("k", "v"), *strides("k", 3),
        *ptrs("k8", "v8"), *strides("k8", 3),
        *ptrs("sk", "sv"), *strides("sk", 2),
        *ptrs("mask"), *strides("mask", 2),
        b, h, rows, call["n"], call["n8"], dh, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA error {err}")
    telemetry.count("decode_attention.launches")
    return out.transpose(1, 2)
