"""Causal transformer decoder, cross-attending unless its config says not.

Token embedding + learned absolute positional embedding -> embed dropout ->
shared-norm stack (causal self + [cross +] MLP, GeGLU or dense + gelu by the
config's ``glu``) -> final float32 LayerNorm -> logits. Two paths:
``forward``, the teacher-forced full forward over (B, T) tokens (training, and
with ``return_embeddings`` / ``return_attn`` the hidden states and attention
maps), and ``step``, the cached decode step (serving: greedy, sampled and
beam), which needs the cross-attention layers.

Dropout draws its mask from an explicit ``torch.Generator``: the forward is
deterministic without one. The bits differ from the JAX package's (Philox,
not threefry); the rate and the scaling (kept values divided by 1 - rate) are
the same. Under data parallelism each rank draws the whole batch's mask and
keeps its own rows, so every rank drops what one process would.

Under tensor parallelism (``shard``) the token embedding and ``to_logits``
hold this rank's rows of the vocabulary: an id outside them looks up zeros
and the all-reduce sums the one row per id, and the local logits are
gathered whole on every model rank before ``to_logits``'s bias is added.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from texocr_tpu_torch.config import DecoderConfig
from texocr_tpu_torch.models.attention import AttentionStack, KVCache
from texocr_tpu_torch.models.layers import TorchDense
from texocr_tpu_torch.parallel.layers import vocab_parallel_embedding, vocab_parallel_logits
from texocr_tpu_torch.parallel.mesh import NO_AXIS, MeshAxis


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            data: MeshAxis = NO_AXIS) -> torch.Tensor:
    """Each element kept with probability 1 - rate and divided by it, else 0
    (flax's ``nn.Dropout``), the mask drawn from ``generator``. ``x`` holds
    data rank ``data.rank``'s block of rows: the mask is drawn for the
    whole batch and this block's rows kept."""
    if rate <= 0:
        return x
    shape = (x.shape[0] * data.size, *x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    if data.size > 1:
        keep = keep[data.rank * x.shape[0]: (data.rank + 1) * x.shape[0]]
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class PositionalEmbedding(nn.Module):
    """Holds the table as ``embedding`` (the reference's key layout)."""

    def __init__(self, max_length: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(max_length, dim)


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, remat: bool = False):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.data = NO_AXIS  # the data axis: which rows of the dropout mask are this rank's
        self.vocab_tp = NO_AXIS
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.pos_embedding = PositionalEmbedding(cfg.max_length, cfg.embed_dim)
        # Decode steps (one query) never reach the flash kernel, and neither
        # does a teacher-forced forward with a padding mask.
        self.attn_layers = AttentionStack(cfg.embed_dim, cfg.num_layers, cfg.heads,
                                          cross_attend=cfg.cross_attend, causal=True,
                                          glu=cfg.glu, exp_factor=cfg.exp_factor, dtype=dtype,
                                          use_flash=use_flash, remat=remat)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.to_logits = TorchDense(cfg.embed_dim, cfg.vocab_size, dtype=dtype)

    def shard(self, data: MeshAxis, tp: MeshAxis) -> None:
        """After the parameters were cut to this rank's slices: the stack's
        blocks take their tensor-parallel form, the vocabulary is split over
        ``tp`` where its rows are, and dropout keeps ``data``'s rows."""
        self.data = data
        self.attn_layers.shard(tp)
        if self.token_embedding.weight.shape[0] < self.config.vocab_size:
            self.vocab_tp = tp

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return vocab_parallel_embedding(tokens, self.token_embedding.weight,
                                        self.vocab_tp).to(self.dtype)

    def forward(self, tokens: torch.Tensor, enc: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, enc_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, return_embeddings: bool = False,
                return_attn: bool = False):
        """Teacher-forced logits for (B, T) token ids -> (B, T, V). ``mask``:
        (B, T) bool, False at PAD; ``enc_mask``: (B, Nk) bool over ``enc``
        (a decoder without cross-attention ignores both enc arguments).
        ``generator`` (on the model's device) draws the embed dropout mask;
        without one there is no dropout.

        ``return_embeddings``: the hidden states after the final norm,
        (B, T, D), in place of the logits. ``return_attn``: returns (out,
        maps), the float32 post-softmax map (B, H, T, Nk) of every attention
        sub-layer in order (self, [cross,] per layer), from the math path."""
        t = tokens.shape[1]
        if t > self.config.max_length:
            raise ValueError(
                f"sequence length {t} exceeds the positional table "
                f"(max_length={self.config.max_length})"
            )
        x = self._embed(tokens) + self.pos_embedding.embedding.weight[:t].to(self.dtype)[None]
        if generator is not None:
            x = dropout(x, self.config.dropout, generator, self.data)
        x = self.attn_layers(x, enc=enc, mask=mask, enc_mask=enc_mask, return_hidden=return_attn)
        if return_attn:
            x, intermediates = x
        x = self.norm(x.float()).to(self.dtype)
        out = x if return_embeddings else vocab_parallel_logits(self.to_logits, x, self.vocab_tp)
        if return_attn:
            return out, [m["post_softmax_attn"] for m in intermediates["attn_intermediates"]]
        return out

    def step(self, token_t: torch.Tensor, t: int, cache: KVCache, cross_kv,
             enc_mask: Optional[torch.Tensor] = None, t0: int = 0) -> torch.Tensor:
        """(B * beam,) token ids at position ``t`` -> (B * beam, V) next-token
        logits; writes position t of ``cache``. ``cross_kv`` and ``enc_mask``
        are per image, shared by its beam rows; ``t0``: the int8
        self-attention prefix's length."""
        x = (self._embed(token_t) + self.pos_embedding.embedding.weight[t].to(self.dtype))[:, None]
        x = self.attn_layers.step(x, cache, t, cross_kv, enc_mask=enc_mask, t0=t0)
        x = self.norm(x.float()).to(self.dtype)
        return vocab_parallel_logits(self.to_logits, x, self.vocab_tp)[:, 0, :]
