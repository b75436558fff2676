"""Flash attention: the hand-written CUDA kernels and their plain versions.

The forward replaces the Pallas TPU kernel ``_fa_kernel`` of
``texocr_tpu/ops/flash_attention.py``, which runs the encoder's unmasked
self-attention: at the full (160, 1008) canvas, (B, 8, 631, 64) per layer.

What bounds it on the H100: per (batch, head) the work is 4 * Nq * Nk * dh
operations on (2 * Nq + 2 * Nk) * dh elements, about 160 operations per element
at N = 631, dh = 64, so a good kernel is bound by operations on the tensor
cores: about 0.82 us per image-layer in bfloat16 (989 TFLOP/s), 4.9 us in
float32, whose products each take three TF32 products (495 TFLOP/s). The TPU
kernel keeps a whole (batch, head) of K/V in VMEM; a Hopper block has at most
227 KB of shared memory, so ``csrc/flash_attention.cu`` walks K/V in 64-key
tiles with an online softmax and never writes the scores to device memory.
Both types run both products on the tensor cores (``wgmma``, 16-byte
``cp.async`` loads into swizzled shared memory, P fed back from registers).
float32 splits every operand into a TF32 big and small part and sums three
TF32 products (3xTF32), which keeps float32 accuracy and the float32 golden
tokens exact; one TF32 product would not. The source says more.

The bfloat16 backward (dh <= 64) is a kernel of the same source that replaces
no Pallas kernel (the JAX package takes XLA's VJP of the math path): from the
forward's saved base-2 row log-sum-exp it recomputes P tile by tile and forms
dQ, then dK and dV, in two launches of five tensor-core products' work
(10 * Nq * Nk * dh operations per (batch, head)), never materialising the
(Nq, Nk) scores.

- ``flash_attention_plain``: the same function in plain PyTorch.
- ``flash_attention``: the plain version for a CPU tensor; for a CUDA tensor
  it launches the kernel or raises. The telemetry counter
  ``flash_attention.launches`` counts the launches.
- ``flash_attention_backward_plain``: the math path's VJP, dq, dk and dv.
- ``flash_attention_backward``: the plain backward for a CPU tensor; for a
  CUDA tensor the backward kernel or an error. The telemetry counter
  ``flash_attention_backward.launches`` counts its calls.
- ``FlashAttentionFunction``: ``flash_attention`` under autograd, the port of
  ``flash_attention_diff``; the route of its backward is in its docstring.
- ``flash_attention_supported``: the calls ``attention_core`` routes here,
  the JAX package's gate; the kernel takes every bfloat16 or float32 call
  that passes it, whatever the alignment of its rows.
  ``flash_backward_supported``: the calls whose backward the kernel takes.
- ``bind``, ``launch`` and ``launch_backward``: load a library built from the
  source and launch its kernels (``flash_attention`` and
  ``flash_attention_backward`` do both for the current source).

Two edge cases the TPU kernel leaves loose are decided here, as the math path
(``attention_core.math_attention``) computes them: causal is accepted only with
Nq == Nk (the kernel's mask is top-left aligned, the math path's right-aligned,
and the two agree only then), and a row with ``kv_lens[b] == 0`` averages V
over all Nk keys.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.ops.attention_core import math_attention

MAX_HEAD_DIM = 128
MAX_KV = 4096  # the JAX gate's limit, kept so both packages route alike
BACKWARD_MAX_HEAD_DIM = 64  # the backward kernel's tiles are 64 wide
BLOCK = 64  # rows of a kernel tile: the row statistics are kept per tile
SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def flash_attention_supported(q, k, allowed=None, causal: bool = False) -> bool:
    """Whether ``attention_core`` sends this call to ``flash_attention``: the
    JAX package's gate (no dense mask, 4-D operands, dh <= 128, Nk <= 4096,
    Nq >= 2), a type the kernel takes, and causal only with Nq == Nk."""
    if allowed is not None:
        return False
    if q.dim() != 4 or k.dim() != 4 or q.dtype not in _DTYPES:
        return False
    if q.shape[-1] > MAX_HEAD_DIM or k.shape[2] > MAX_KV or q.shape[2] < 2:
        return False
    return not (causal and q.shape[2] != k.shape[2])


def flash_backward_supported(q) -> bool:
    """Whether the backward kernel takes a call that ``flash_attention``
    takes on the card: bfloat16 with dh <= 64. float32, and dh in (64, 128],
    keep the math path's VJP (``flash_attention_backward_plain``)."""
    return q.dtype == torch.bfloat16 and q.shape[-1] <= BACKWARD_MAX_HEAD_DIM


def lse_rows(nq: int) -> int:
    """Rows of a head's row statistics: Nq rounded up to the kernel's tile."""
    return -(-nq // BLOCK) * BLOCK


def _check(q, k, v, causal, kv_lens):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, N, dh) operands")
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, dh) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(b, h, nq, nk, dh) <= 0 or dh > MAX_HEAD_DIM:
        raise ValueError(f"unsupported shape {tuple(q.shape)} x {tuple(k.shape)}")
    if causal and nq != nk:
        raise ValueError("causal flash attention needs Nq == Nk; route through "
                         "attention_core for right-aligned causal masks")
    if kv_lens is not None and tuple(kv_lens.shape) != (b,):
        raise ValueError(f"kv_lens must be ({b},), got {tuple(kv_lens.shape)}")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the math path with the key
    mask ``col < kv_lens[b]`` and, for causal, ``col <= row``."""
    _check(q, k, v, causal, kv_lens)
    allowed = None
    if kv_lens is not None:
        cols = torch.arange(k.shape[2], device=k.device)
        allowed = (cols[None, :] < kv_lens.to(k.device)[:, None])[:, None, None, :]
    return math_attention(q, k, v, scale=scale, allowed=allowed, causal=causal)


def bind(path) -> ctypes.CDLL:
    """Loads a library built from ``csrc/flash_attention.cu`` (or an earlier
    version of it with the same C interface) and declares its signatures."""
    lib = ctypes.CDLL(str(path))
    strides = [ctypes.c_longlong] * 12
    fn = lib.texocr_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + strides
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if hasattr(lib, "texocr_flash_attention_fwd_lse"):  # the later ones: not in older sources
        fn = lib.texocr_flash_attention_fwd_lse
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + strides
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        fn = lib.texocr_flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 24
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    if hasattr(lib, "texocr_flash_attention_blocks_per_sm"):
        occupancy = lib.texocr_flash_attention_blocks_per_sm
        occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
        occupancy.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        from texocr_tpu_torch.ops.build import build

        _lib = bind(build(SOURCE)[0])
    return _lib


def _check_cuda(name, *tensors):
    q = tensors[0]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name} needs its operands on one CUDA device, got "
                         f"{', '.join(str(t.device) for t in tensors)}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name} takes float32 or bfloat16 operands of one type, got "
                         f"{', '.join(str(t.dtype) for t in tensors)}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{name} needs a unit stride along dh")


def _check_lse(q, lse):
    b, h, nq, _ = q.shape
    if not flash_backward_supported(q):
        raise ValueError("row statistics are kept only for bfloat16 calls with dh <= 64")
    if (lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous()
            or tuple(lse.shape) != (b, h, lse_rows(nq))):
        raise ValueError(f"lse must be a contiguous float32 ({b}, {h}, {lse_rows(nq)}) "
                         f"tensor on q's device")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, Nq, dh) x (B, H, Nk, dh)^2 -> (B, H, Nq, dh) in q's dtype.

    CPU tensors take ``flash_attention_plain``. CUDA tensors launch the kernel
    on the current stream; anything it does not take raises. ``kv_lens``:
    optional (B,) count of valid keys per batch row. ``lse``: a float32
    (B, H, ``lse_rows(Nq)``) tensor that the kernel fills with each row's
    base-2 log-sum-exp for ``flash_attention_backward`` (CUDA, bfloat16 and
    dh <= 64 only).
    """
    if q.device.type == "cpu":
        if lse is not None:
            raise ValueError("the plain version keeps no row statistics")
        return flash_attention_plain(q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)
    _check(q, k, v, causal, kv_lens)
    _check_cuda("flash_attention", q, k, v)
    if kv_lens is not None:
        if kv_lens.device != q.device or kv_lens.dtype != torch.int32:
            raise ValueError("kv_lens must be int32 on q's device")
    if lse is None:
        return launch(_library(), q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)
    _check_lse(q, lse)
    return launch(_library(), q, k, v, scale=scale, causal=causal, kv_lens=kv_lens, lse=lse)


def launch(lib, q, k, v, *, scale, causal=False, kv_lens=None, lse=None) -> torch.Tensor:
    """Launches ``lib``'s forward kernel (a library from ``bind``) on CUDA
    operands that ``flash_attention`` takes, on the current stream, and counts
    the launch in the counter ``flash_attention.launches``; with ``lse``, the
    instantiation that also writes the row statistics."""
    if kv_lens is not None:
        kv_lens = kv_lens.contiguous()
    b, h, nq, dh = q.shape
    # Same strides as q: for heads split from (B, N, H * dh) the output merges
    # back without a copy.
    out = torch.empty_like(q)
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_lens is None else kv_lens.data_ptr(),
        b, h, nq, k.shape[2], dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), int(causal), _DTYPES[q.dtype],
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if lse is None:
        err = lib.texocr_flash_attention_fwd(*args, stream)
    else:
        err = lib.texocr_flash_attention_fwd_lse(*args, lse.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    telemetry.count("flash_attention.launches")
    return out


def flash_attention_backward_plain(q, k, v, grad_out, *, scale: float, causal: bool = False):
    """The math path's VJP: (dq, dk, dv) of ``math_attention`` at (q, k, v)
    against ``grad_out``, as ``_fad_bwd`` returns XLA's. It materialises the
    (B, H, Nq, Nk) float32 scores."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        out = math_attention(q, k, v, scale=scale, causal=causal)
    return torch.autograd.grad(out, (q, k, v), grad_out)


def flash_attention_backward(q, k, v, out, lse, grad_out, *, scale: float,
                             causal: bool = False):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v), in their types and
    strides, from its output ``out``, the row statistics ``lse`` it wrote
    and the output gradient ``grad_out``. CPU tensors take
    ``flash_attention_backward_plain`` (``out`` and ``lse`` unread); CUDA
    tensors launch the backward kernel (bfloat16, dh <= 64, unit dh strides,
    no ``kv_lens``) or raise."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, grad_out, scale=scale, causal=causal)
    _check(q, k, v, causal, None)
    _check_cuda("flash_attention_backward", q, k, v, out, grad_out)
    if out.shape != q.shape or grad_out.shape != q.shape:
        raise ValueError(f"out and grad_out must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(grad_out.shape)}")
    _check_lse(q, lse)
    return launch_backward(_library(), q, k, v, out, lse, grad_out, scale=scale, causal=causal)


def launch_backward(lib, q, k, v, out, lse, grad_out, *, scale, causal=False):
    """Launches ``lib``'s backward (its two kernels, dQ then dK and dV) on
    operands that ``flash_attention_backward`` takes, on the current stream,
    and counts the call in the counter ``flash_attention_backward.launches``."""
    b, h, nq, dh = q.shape
    delta = torch.empty(b, h, lse_rows(nq), dtype=torch.float32, device=q.device)
    # Each gradient keeps its operand's strides, as the forward's output does.
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tensors = (q, k, v, out, grad_out, dq, dk, dv)
    err = lib.texocr_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, nq, k.shape[2], dh,
        *(st for t in tensors for st in t.stride()[:3]),
        float(scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA error {err}")
    telemetry.count("flash_attention_backward.launches")
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` under autograd: the port of the JAX package's
    ``flash_attention_diff`` (a ``custom_vjp``). The forward is the kernel (the
    plain version on the CPU). The backward's route is by type and shape,
    read from the inputs (``flash_backward_supported``):

    - a CUDA call in bfloat16 with dh <= 64 (the encoder's) takes the backward
      kernel: the forward then launches the instantiation that also writes
      each row's log-sum-exp, and saves q, k, v, its output and those
      statistics; ``flash_attention_backward`` forms dq, dk and dv from them;
    - float32, dh in (64, 128], and every CPU tensor recompute the math path,
      ``math_attention``, from the saved q, k and v and return its VJP
      (``flash_attention_backward_plain``), as ``_fad_bwd`` returns XLA's.

    Under ``no_grad`` or ``inference_mode``, or with no operand requiring a
    gradient, nothing is asked for beyond the output: the call is the
    forward kernel's alone, the instantiation without statistics.

    ``FlashAttentionFunction.apply(q, k, v, scale, causal)``; the output keeps
    q's strides, as ``launch`` makes it, and so do the gradients.
    """

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, grad: bool = False):
        ctx.scale, ctx.causal = scale, causal
        if grad and q.device.type != "cpu" and flash_backward_supported(q):
            b, h, nq, _ = q.shape
            lse = torch.empty(b, h, lse_rows(nq), dtype=torch.float32, device=q.device)
            out = flash_attention(q, k, v, scale=scale, causal=causal, lse=lse)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, scale=scale, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, *stats = ctx.saved_tensors
        if stats:
            if grad_out.stride(-1) != 1:
                grad_out = grad_out.contiguous()
            grads = flash_attention_backward(q, k, v, *stats, grad_out, scale=ctx.scale,
                                             causal=ctx.causal)
        else:
            grads = flash_attention_backward_plain(q, k, v, grad_out, scale=ctx.scale,
                                                   causal=ctx.causal)
        return (*grads, None, None, None)

    @classmethod
    def apply(cls, q, k, v, scale: float, causal: bool):
        # Inside ``forward`` autograd is always off, so whether the call will
        # be differentiated is read here and handed on.
        grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad)
        return super().apply(q, k, v, scale, causal, grad)
