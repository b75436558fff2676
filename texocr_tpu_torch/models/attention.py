"""Multi-head attention and the shared-norm attention stack.

The reference's architecture, as the JAX package reproduces it:

- q/k/v projections without bias to heads * 64, then ``fc_out`` (Dense to
  2 * embed) and a GLU gate.
- ONE LayerNorm instance shared by every pre-norm and inter-layer norm of a
  stack, and a post-residual norm on every sub-layer but the last. The shared
  norm is registered at ``layers.{j}.0`` for every j, which gives the
  reference's state-dict keys.

Decode cache: the JAX package splits its self-attention cache into a merged
(B, H, dh, T) prefix and a per-chunk hot window because a per-step
``dynamic_update_slice`` on the TPU costs a pass over the whole buffer. On the
GPU an in-place write of one position is cheap, so the port keeps one plain
(B, H, T, dh) buffer per layer, writes position t in place, and attends over
positions 0..t. The numbers agree: the JAX softmax over ``[big | hot]`` with a
-f32max fill is a softmax over exactly those t + 1 positions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from texocr_tpu_torch.models.layers import MLP, TorchDense
from texocr_tpu_torch.ops.attention_core import attention_core, math_attention

#: Per-layer {"k", "v"} buffers, each (B, H, T, dh).
KVCache = List[Dict[str, torch.Tensor]]


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.view(b, n, heads, -1).transpose(1, 2)  # (B, H, N, dh), a view


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, heads: int = 8, dim_head: int = 64,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 causal: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.use_flash = use_flash
        self.causal = causal
        self.q = TorchDense(embed_dim, inner, bias=False, dtype=dtype)
        self.k = TorchDense(embed_dim, inner, bias=False, dtype=dtype)
        self.v = TorchDense(embed_dim, inner, bias=False, dtype=dtype)
        # nn.Sequential(Linear, GLU) in the reference: keys fc_out.0.*.
        self.fc_out = nn.Sequential(TorchDense(inner, embed_dim * 2, dtype=dtype))

    def project_kv(self, src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return _split_heads(self.k(src), self.heads), _split_heads(self.v(src), self.heads)

    def _finish(self, out_heads: torch.Tensor) -> torch.Tensor:
        return F.glu(self.fc_out(_merge_heads(out_heads)), dim=-1)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full (uncached) attention over (B, N, D): self-attention, or
        cross-attention over ``context``. ``mask``: (B, Nq) bool query-side
        padding mask; ``context_mask``: (B, Nk) bool key-side mask of the
        context. The mask is their q x k outer product; for self-attention the
        key mask is the query mask. A query row with every key masked
        softmaxes to a uniform average (the math path fills, in bool space)."""
        q = _split_heads(self.q(x), self.heads)
        src = x if context is None else context
        k, v = self.project_kv(src)
        allowed = None  # (B, 1, Nq, Nk) bool, True = may attend
        if mask is not None or context_mask is not None:
            q_mask = mask if mask is not None else torch.ones(
                x.shape[:2], dtype=torch.bool, device=x.device)
            if context is None:
                k_mask = q_mask
            else:
                k_mask = context_mask if context_mask is not None else torch.ones(
                    src.shape[:2], dtype=torch.bool, device=x.device)
            allowed = q_mask[:, None, :, None] & k_mask[:, None, None, :]
        out = attention_core(q, k, v, scale=self.scale, allowed=allowed, causal=self.causal,
                             use_flash=self.use_flash)
        return self._finish(out)

    def step(self, x_t: torch.Tensor, cache: Dict[str, torch.Tensor], t: int) -> torch.Tensor:
        """Cached self-attention for the token at position ``t``: writes its
        K/V into ``cache`` in place and attends over positions 0..t."""
        q = _split_heads(self.q(x_t), self.heads)  # (B, H, 1, dh)
        k, v = self.project_kv(x_t)
        cache["k"][:, :, t] = k[:, :, 0]
        cache["v"][:, :, t] = v[:, :, 0]
        out = math_attention(q, cache["k"][:, :, : t + 1], cache["v"][:, :, : t + 1],
                             scale=self.scale)
        return self._finish(out)

    def attend_cached_kv(self, x_t: torch.Tensor, kv: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Cross-attention step against K/V precomputed once per sequence."""
        q = _split_heads(self.q(x_t), self.heads)
        return self._finish(math_attention(q, kv["k"], kv["v"], scale=self.scale))


class AttentionStack(nn.Module):
    """(self[, cross], mlp) sub-layers with the shared LayerNorm and the
    double-norm residual stream."""

    def __init__(self, embed_dim: int, num_layers: int, heads: int = 8,
                 dim_head: int = 64, cross_attend: bool = False, causal: bool = False,
                 exp_factor: int = 4, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.heads = heads
        self.dim_head = dim_head
        self.num_layers = num_layers
        self.cross_attend = cross_attend
        self.remat = remat
        norm = nn.LayerNorm(embed_dim, eps=1e-5)
        blocks = []
        for _ in range(num_layers):
            blocks.append(MultiHeadAttention(embed_dim, heads, dim_head, dtype, use_flash,
                                             causal=causal))
            if cross_attend:
                blocks.append(MultiHeadAttention(embed_dim, heads, dim_head, dtype, use_flash))
            blocks.append(MLP(embed_dim, exp_factor, dtype))
        self.layers = nn.ModuleList([nn.ModuleList([norm, block]) for block in blocks])

    @property
    def shared_norm(self) -> nn.LayerNorm:
        return self.layers[0][0]

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.shared_norm(x.float()).to(self.dtype)

    def _sublayer(self, j: int, apply, x: torch.Tensor) -> torch.Tensor:
        """Sub-layer j: norm -> block -> + residual [-> norm]; ``apply(j,
        block, h)`` runs its block."""
        x = apply(j, self.layers[j][1], self._norm(x)) + x
        if j != len(self.layers) - 1:  # extra norm on all but the last sub-layer
            x = self._norm(x)
        return x

    def _run(self, x: torch.Tensor, apply) -> torch.Tensor:
        for j in range(len(self.layers)):
            x = self._sublayer(j, apply, x)
        return x

    def forward(self, x: torch.Tensor, enc: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full forward: the encoder's self-attention stack, or the
        teacher-forced decoder's (causal self, cross over ``enc``, MLP).
        ``mask``: (B, N) bool padding mask of ``x``; ``enc_mask``: (B, Nk) of
        ``enc``. With ``remat`` (and gradients on) each sub-layer runs under
        ``torch.utils.checkpoint``: the backward recomputes it instead of
        keeping its activations, as the JAX package's ``nn.remat`` does."""
        if self.cross_attend and enc is None:
            raise ValueError("Must provide enc if cross_attend is True.")
        per = self._per_layer()

        def apply(j, block, h):
            kind = j % per
            if kind == per - 1:
                return block(h)
            if kind == 1:
                return block(h, context=enc, mask=mask, context_mask=enc_mask)
            return block(h, mask=mask)

        if not (self.remat and torch.is_grad_enabled()):
            return self._run(x, apply)
        for j in range(len(self.layers)):
            x = checkpoint(self._sublayer, j, apply, x, use_reentrant=False)
        return x

    # -- cached decode ----------------------------------------------------------

    def _per_layer(self) -> int:
        return 3 if self.cross_attend else 2

    def init_cache(self, batch: int, max_len: int, device) -> KVCache:
        """Zeroed per-layer self-attention K/V, each (B, H, max_len, dh)."""
        shape = (batch, self.heads, max_len, self.dim_head)
        return [
            {"k": torch.zeros(shape, dtype=self.dtype, device=device),
             "v": torch.zeros(shape, dtype=self.dtype, device=device)}
            for _ in range(self.num_layers)
        ]

    def precompute_cross_kv(self, enc: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """Per-layer cross-attention K/V of the encoder output, each
        (B, H, Nk, dh), computed once per sequence."""
        per = self._per_layer()
        out = []
        for layer in range(self.num_layers):
            k, v = self.layers[layer * per + 1][1].project_kv(enc)
            out.append({"k": k, "v": v})
        return out

    def step(self, x_t: torch.Tensor, cache: KVCache, t: int,
             cross_kv: Optional[List[Dict[str, torch.Tensor]]]) -> torch.Tensor:
        """One decode step over the stack for (B, 1, D) input at position t."""
        per = self._per_layer()

        def apply(j, block, h):
            layer, kind = divmod(j, per)
            if kind == 0:
                return block.step(h, cache[layer], t)
            if kind == 1 and self.cross_attend:
                return block.attend_cached_kv(h, cross_kv[layer])
            return block(h)

        return self._run(x_t, apply)
