"""Multi-head latent attention (MLA), DeepSeek-V2/V3's and Kimi-VL-A3B's, with
RMSNorm and the rotary embedding it uses.

For a row x of the hidden width and each head h:

- q_h = W_q x, split into q_nope (``qk_nope_head_dim``) and q_pe
  (``qk_rope_head_dim``); no q LoRA.
- [c; k_pe] = W_kva x (``kv_a_proj_with_mqa``), c ``kv_lora_rank`` wide and
  RMS-normalised (``kv_a_layernorm``); k_pe, shared by every head, and q_pe
  take the rotary embedding at the token's position.
- [k_nope_h; v_h] = W_kvb c (``kv_b_proj``).
- softmax((q_nope . k_nope + q_pe . k_pe) / sqrt(nope + rope)), causal, over
  v_h; ``o_proj`` of the heads' outputs side by side.

The cache holds the latent [c; k_pe] of each position, rank + rope values a
token and layer in the compute type, in place of per-head K and V. The full
forward and the prefill compute the heads' K and V from it (the unabsorbed
form, float32 scores and probabilities); a decode step keeps the latent and
moves W_kvb to the query and output sides (the absorbed form): q_lat =
W_uk,h^T q_nope and out_h = W_uv,h (P . c), with the scores of [q_lat; q_pe]
against the cached latent. A step attends over two caches under one
softmax: the prefix's latent (the image tokens, filled once) and the
decoded positions' (``models/prefix_decoder.py``).

The rotary embedding is DeepSeek-V3's: inverse frequencies theta^(-2i/d), the
interleaved pairs of q_pe and k_pe gathered into halves, then x cos +
rotate_half(x) sin, in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from texocr_tpu_torch.config import MlaMoeConfig


class Linear(nn.Module):
    """y = x W^T without bias, W (out, in) held in ``param_dtype`` and used in
    the compute type ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight, in float32; returns float32."""

    def __init__(self, dim: int, eps: float, param_dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight.float()


def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (N, dim) float32, at the (N,) ``positions``: the
    frequencies theta^(-2i/dim) repeated over both halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, device=positions.device).float() / dim))
    freqs = torch.outer(positions.float(), inv_freq)
    angles = torch.cat([freqs, freqs], dim=-1)
    return angles.cos(), angles.sin()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The rotary embedding of ``x`` (..., dim), its interleaved pairs first
    gathered into halves; float32."""
    x = x.float().unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class LatentAttention(nn.Module):
    """MLA over (B, N, D) rows; the published checkpoint's ``self_attn.*``
    keys."""

    def __init__(self, cfg: MlaMoeConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.heads = cfg.num_attention_heads
        self.nope, self.rope, self.vdim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                                           cfg.v_head_dim)
        self.rank = cfg.kv_lora_rank
        self.scale = (self.nope + self.rope) ** -0.5
        d, h = cfg.hidden_size, self.heads
        self.q_proj = Linear(d, h * (self.nope + self.rope), dtype, param_dtype)
        self.kv_a_proj_with_mqa = Linear(d, self.rank + self.rope, dtype, param_dtype)
        self.kv_a_layernorm = RMSNorm(self.rank, cfg.rms_norm_eps, param_dtype)
        self.kv_b_proj = Linear(self.rank, h * (self.nope + self.vdim), dtype, param_dtype)
        self.o_proj = Linear(h * self.vdim, d, dtype, param_dtype)

    @property
    def latent_width(self) -> int:
        return self.rank + self.rope

    def latent(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """(B, N, D) -> (B, N, rank + rope): [RMSNorm(c); k_pe rotated], the
        cached latent, in the compute type."""
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], dim=-1)
        return torch.cat([self.kv_a_layernorm(c), rotate(k_pe, cos, sin)], -1).to(self.dtype)

    def _queries(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, D) -> (q_nope (B, N, H, nope), q_pe (B, N, H, rope) rotated),
        in the compute type."""
        q = self.q_proj(x).unflatten(-1, (self.heads, self.nope + self.rope))
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        return q_nope, rotate(q_pe, cos[:, None], sin[:, None]).to(self.dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Causal attention over (B, N, D) at the positions of (N, rope)
        ``cos``/``sin``, unabsorbed: (out (B, N, D), the latent (B, N,
        rank + rope) to cache)."""
        lat = self.latent(x, cos, sin)
        q_nope, q_pe = self._queries(x, cos, sin)
        c, k_pe = lat.split([self.rank, self.rope], dim=-1)
        k_nope, v = self.kv_b_proj(c).unflatten(-1, (self.heads, -1)).split(
            [self.nope, self.vdim], dim=-1)
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2).float()             # (B, H, N, 192)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, self.heads, -1)], -1)
        scores = torch.matmul(q, k.transpose(1, 2).float().transpose(-1, -2)) * self.scale
        n = x.shape[1]
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out = torch.matmul(probs, v.transpose(1, 2).float())                  # (B, H, N, vdim)
        return self.o_proj(out.transpose(1, 2).flatten(2)), lat

    def step(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, cache: torch.Tensor,
             t: int, prefix: torch.Tensor) -> torch.Tensor:
        """One decode row (B, 1, D) at the position of (1, rope) ``cos``/``sin``,
        absorbed: writes its latent at ``cache[:, t]`` and attends over
        ``prefix`` (B, P, rank + rope) and ``cache[:, : t + 1]`` under one
        softmax. Returns (B, 1, D)."""
        cache[:, t] = self.latent(x, cos, sin)[:, 0]
        q_nope, q_pe = self._queries(x, cos, sin)
        w = self.kv_b_proj.weight.to(self.dtype).view(self.heads, self.nope + self.vdim, self.rank)
        w_uk, w_uv = w[:, : self.nope], w[:, self.nope:]
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk).transpose(0, 1)  # (B, H, rank)
        q = torch.cat([q_lat, q_pe[:, 0]], -1)                                  # (B, H, 576)
        hot = cache[:, : t + 1]
        scores = torch.cat([torch.bmm(q, prefix.transpose(1, 2)),
                            torch.bmm(q, hot.transpose(1, 2))], -1)
        probs = torch.softmax(scores.float() * self.scale, dim=-1).to(self.dtype)
        p = prefix.shape[1]
        o_lat = torch.baddbmm(torch.bmm(probs[..., :p], prefix[..., : self.rank]),
                              probs[..., p:], hot[..., : self.rank])            # (B, H, rank)
        out = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2))            # (H, B, vdim)
        return self.o_proj(out.transpose(0, 1).flatten(1))[:, None]
