"""Causal cross-attending transformer decoder: the cached decode step.

Token embedding + learned absolute positional embedding -> shared-norm stack
(causal self + cross + MLP) -> final float32 LayerNorm -> logits. The
teacher-forced full forward waits for the training slice (ROADMAP).
"""

from __future__ import annotations

import torch
from torch import nn

from texocr_tpu_torch.config import DecoderConfig
from texocr_tpu_torch.models.attention import AttentionStack, KVCache
from texocr_tpu_torch.models.layers import TorchDense


class PositionalEmbedding(nn.Module):
    """Holds the table as ``embedding`` (the reference's key layout)."""

    def __init__(self, max_length: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(max_length, dim)


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.pos_embedding = PositionalEmbedding(cfg.max_length, cfg.embed_dim)
        # Decode steps have one query, which the flash kernel never takes.
        self.attn_layers = AttentionStack(cfg.embed_dim, cfg.num_layers, cfg.heads,
                                          cross_attend=True, exp_factor=cfg.exp_factor,
                                          dtype=dtype)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.to_logits = TorchDense(cfg.embed_dim, cfg.vocab_size, dtype=dtype)

    def step(self, token_t: torch.Tensor, t: int, cache: KVCache, cross_kv) -> torch.Tensor:
        """(B,) token ids at position ``t`` -> (B, V) next-token logits;
        writes position t of ``cache``."""
        x = (self.token_embedding(token_t).to(self.dtype)
             + self.pos_embedding.embedding.weight[t].to(self.dtype))[:, None, :]
        x = self.attn_layers.step(x, cache, t, cross_kv=cross_kv)
        x = self.norm(x.float()).to(self.dtype)
        return self.to_logits(x)[:, 0, :]
