"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``_fa_kernel`` of
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

- ``flash_attention_plain``: the same function in plain PyTorch.
- ``flash_attention``: the plain version for a CPU tensor; for a CUDA tensor
  it launches the kernel or raises. ``flash_attention.launches`` counts the
  launches.
- ``FlashAttentionFunction``: ``flash_attention`` under autograd, the port of
  ``flash_attention_diff``: the kernel forward, the math path's backward.
- ``flash_attention_supported``: the calls ``attention_core`` routes here,
  the JAX package's gate; the kernel takes every bfloat16 or float32 call
  that passes it, whatever the alignment of its rows.
- ``bind`` and ``launch``: load a library built from the source and launch
  its kernel (``flash_attention`` does both for the current source).

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

from texocr_tpu_torch.ops.attention_core import math_attention

MAX_HEAD_DIM = 128
MAX_KV = 4096  # the JAX gate's limit, kept so both packages route alike
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
    version of it with the same C interface) and declares its signature."""
    lib = ctypes.CDLL(str(path))
    fn = lib.texocr_flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    if hasattr(lib, "texocr_flash_attention_blocks_per_sm"):  # not in older sources
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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, Nq, dh) x (B, H, Nk, dh)^2 -> (B, H, Nq, dh) in q's dtype.

    CPU tensors take ``flash_attention_plain``. CUDA tensors launch the kernel
    on the current stream; anything it does not take raises. ``kv_lens``:
    optional (B,) count of valid keys per batch row.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)
    _check(q, k, v, causal, kv_lens)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 operands of one "
                         f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs a unit stride along dh")
    if kv_lens is not None:
        if kv_lens.device != q.device or kv_lens.dtype != torch.int32:
            raise ValueError("kv_lens must be int32 on q's device")
    return launch(_library(), q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)


def launch(lib, q, k, v, *, scale, causal=False, kv_lens=None) -> torch.Tensor:
    """Launches ``lib``'s kernel (a library from ``bind``) on CUDA operands
    that ``flash_attention`` takes, on the current stream, and counts the
    launch in ``flash_attention.launches``."""
    if kv_lens is not None:
        kv_lens = kv_lens.contiguous()
    b, h, nq, dh = q.shape
    # Same strides as q: for heads split from (B, N, H * dh) the output merges
    # back without a copy.
    out = torch.empty_like(q)
    err = lib.texocr_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_lens is None else kv_lens.data_ptr(),
        b, h, nq, k.shape[2], dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), int(causal), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` under autograd: the port of the JAX package's
    ``flash_attention_diff`` (a ``custom_vjp``). The forward is the kernel (the
    plain version on the CPU); the backward recomputes the math path,
    ``math_attention``, from the saved q, k and v and returns its VJP, as
    ``_fad_bwd`` returns XLA's. The JAX package has no backward kernel, so
    neither has the port: the backward materialises the (B, H, Nq, Nk)
    float32 scores. Under ``no_grad`` or ``inference_mode`` nothing is saved
    and the call is the kernel's alone.

    ``FlashAttentionFunction.apply(q, k, v, scale, causal)``; the output keeps
    q's strides, as ``launch`` makes it.
    """

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        ctx.scale, ctx.causal = scale, causal
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, scale=scale, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = math_attention(q, k, v, scale=ctx.scale, causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None
