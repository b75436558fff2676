"""Attention inner math: the plain path and the route to the flash kernel.

The math path materializes the (Nq, Nk) logits in float32 whatever the compute
type, fills (does not add) masked positions with -finfo(float32).max so a row
with no valid key softmaxes to uniform, casts the probabilities to q's type and
accumulates P @ V in float32. The causal mask is right-aligned: query i attends
keys j <= i + (Nk - Nq).

``attention_core(use_flash=True)`` sends the calls the flash kernel takes
(``flash_attention_supported``) to ``texocr_tpu_torch.ops.flash_attention``
through ``FlashAttentionFunction``: the kernel forward, and for its backward
the backward kernel where the call is bfloat16 with dh <= 64
(``flash_backward_supported``; the encoder's), else the math path's VJP
(float32, dh in (64, 128]). Every other call takes the math path. Those are
routes by type and shape, as in the JAX package, not fallbacks: a CUDA tensor
routed to a kernel gets the kernel, with or without gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

MASK_VALUE = -torch.finfo(torch.float32).max


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    allowed: Optional[torch.Tensor] = None,
    causal: bool = False,
    use_flash: bool = False,
) -> torch.Tensor:
    """Scaled dot-product attention.

    q: (B, H, Nq, dh); k, v: (B, H, Nk, dh). ``allowed``: optional bool mask
    broadcastable to (B, H, Nq, Nk), True where a key may be attended.
    Returns (B, H, Nq, dh) in q's dtype.
    """
    if use_flash:
        from texocr_tpu_torch.ops.flash_attention import (
            FlashAttentionFunction,
            flash_attention_supported,
        )

        if flash_attention_supported(q, k, allowed=allowed, causal=causal):
            return FlashAttentionFunction.apply(q, k, v, scale, causal)
    return math_attention(q, k, v, scale=scale, allowed=allowed, causal=causal)


def math_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    allowed: Optional[torch.Tensor] = None,
    causal: bool = False,
    return_probs: bool = False,
):
    """The plain path: float32 logits and softmax, P rounded to q's type, P @ V
    summed in float32 and returned in q's type. ``return_probs`` also returns
    the maps {"pre_softmax_attn": the scaled float32 energies, unmasked;
    "post_softmax_attn": the float32 probabilities}, each (B, H, Nq, Nk)."""
    raw = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = combined_mask(q.shape[-2], k.shape[-2], allowed=allowed, causal=causal,
                         device=q.device)
    logits = raw if mask is None else raw.masked_fill(~mask, MASK_VALUE)
    # Both products run in float32 on the compute type's values, so the sums are
    # float32 whatever reduced-precision settings the matmul backend has.
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), v.to(q.dtype).float()).to(q.dtype)
    if return_probs:
        return out, {"pre_softmax_attn": raw, "post_softmax_attn": probs}
    return out


def combined_mask(
    nq: int,
    nk: int,
    *,
    allowed: Optional[torch.Tensor] = None,
    causal: bool = False,
    device=None,
) -> Optional[torch.Tensor]:
    """Padding and right-aligned causal masks composed in boolean space, so the
    fill is applied exactly once (None when nothing is masked)."""
    mask = allowed
    if causal:
        rows = torch.arange(nq, device=device)[:, None]
        cols = torch.arange(nk, device=device)[None, :]
        causal_ok = (cols <= rows + (nk - nq))[None, None]
        mask = causal_ok if mask is None else (mask & causal_ok)
    return mask
