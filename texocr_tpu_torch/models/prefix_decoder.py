"""The ``mla_moe`` decoder: Kimi-VL-A3B's language model (DeepSeek-V3's
layers) reading the image as a prefix, and the projector that makes the
image tokens.

- ``Projector`` (``multi_modal_projector``, Kimi-VL's): the encoder's grid
  (CLS dropped), LayerNorm over its width (``pre_norm``), zero-padded to a
  multiple of ``merge``, pixel-shuffled (each merged token holds its
  ``merge`` block of patches in row-major order, as Kimi-VL's patch merger
  lays them), then linear, exact GELU, linear to the hidden width. The
  image's tokens are the language model's prefix.
- ``LanguageModel`` (``language_model``): token embedding, pre-norm residual
  layers of latent attention (``models/mla.py``) and a feed-forward layer
  (the gated MLP in the first ``first_k_dense_replace`` layers, the expert
  layer after, ``models/moe.py``), final RMSNorm and an untied head. The
  residual stream is float32; products run in the compute type.

Positions: the prefix takes 0..P-1; BOS at P is step 0's input, and step t
reads position P + t. A decode's context is the prefix's latent per layer
(``prefill``), filled once; its cache holds the decoded positions' latents
(``init_cache``). ``PrefixDecoding`` is the decode interface ``OCRModel``
delegates to. Keys follow the published checkpoint:
``language_model.model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight``,
``...mlp.experts.{e}.gate_proj.weight``, ``language_model.lm_head.weight``,
``multi_modal_projector.linear_1.weight``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from texocr_tpu_torch.config import MlaMoeConfig
from texocr_tpu_torch.models.mla import LatentAttention, Linear, RMSNorm, rope_angles
from texocr_tpu_torch.models.moe import GatedMLP, MoE

#: Per layer {"latent": (B, T, rank + rope)}.
LatentCache = List[Dict[str, torch.Tensor]]


class Projector(nn.Module):
    """(B, 1 + h * w, E) encoder output on an (h, w) grid -> (B, P, D) image
    tokens in the compute type."""

    def __init__(self, enc_dim: int, cfg: MlaMoeConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.merge, self.dtype = cfg.merge, dtype
        merged = enc_dim * cfg.merge[0] * cfg.merge[1]
        self.pre_norm = nn.LayerNorm(enc_dim, eps=1e-5, dtype=param_dtype)
        self.linear_1 = nn.Linear(merged, cfg.projector_hidden, dtype=param_dtype)
        self.linear_2 = nn.Linear(cfg.projector_hidden, cfg.hidden_size, dtype=param_dtype)

    def forward(self, enc: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        b, _, d = enc.shape
        h, w = grid
        mh, mw = self.merge
        x = F.layer_norm(enc[:, 1:].float(), (d,), self.pre_norm.weight.float(),
                         self.pre_norm.bias.float(), self.pre_norm.eps)
        x = F.pad(x.view(b, h, w, d), (0, 0, 0, -w % mw, 0, -h % mh))
        gh, gw = x.shape[1] // mh, x.shape[2] // mw
        x = x.view(b, gh, mh, gw, mw, d).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, -1)
        x = F.linear(x.to(self.dtype), self.linear_1.weight.to(self.dtype),
                     self.linear_1.bias.to(self.dtype))
        return F.linear(F.gelu(x), self.linear_2.weight.to(self.dtype),
                        self.linear_2.bias.to(self.dtype))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MlaMoeConfig, layer: int, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.dtype = dtype
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps, param_dtype)
        self.self_attn = LatentAttention(cfg, dtype, param_dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps, param_dtype)
        dense = layer < cfg.first_k_dense_replace
        self.mlp = (GatedMLP(cfg.hidden_size, cfg.intermediate_size, dtype, param_dtype) if dense
                    else MoE(cfg, layer - cfg.first_k_dense_replace, dtype, param_dtype))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, D) float32 -> (the next layer's input, this layer's latent)."""
        out, lat = self.self_attn(self.input_layernorm(x).to(self.dtype), cos, sin)
        x = x + out.float()
        return x + self.mlp(self.post_attention_layernorm(x)), lat

    def step(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, cache: torch.Tensor,
             t: int, prefix: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn.step(self.input_layernorm(x).to(self.dtype), cos, sin, cache, t,
                                    prefix).float()
        return x + self.mlp(self.post_attention_layernorm(x))


class LanguageModel(nn.Module):
    """The decoder stack and its head; ``model.*`` and ``lm_head.*`` keys."""

    def __init__(self, cfg: MlaMoeConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.config, self.dtype = cfg, dtype
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=param_dtype)
        self.model.layers = nn.ModuleList(DecoderLayer(cfg, i, dtype, param_dtype)
                                          for i in range(cfg.num_hidden_layers))
        self.model.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, param_dtype)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, dtype, param_dtype)

    def _rope(self, start: int, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        positions = torch.arange(start, start + n, device=device)
        return rope_angles(positions, self.config.qk_rope_head_dim, self.config.rope_theta)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(tokens).float()

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.model.norm(x).to(self.dtype))

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        """The full causal forward over (B, N, D) input rows (the image's
        tokens, then the text's embeddings) at positions 0..N-1 -> (B, N, V)
        logits in the compute type."""
        cos, sin = self._rope(0, embeds.shape[1], embeds.device)
        x = embeds.float()
        for layer in self.model.layers:
            x, _ = layer(x, cos, sin)
        return self._head(x)

    def prefill(self, embeds: torch.Tensor) -> LatentCache:
        """The prefix (B, P, D) at positions 0..P-1 -> each layer's latent
        (B, P, rank + rope): a decode's context. No logits: BOS, after the
        prefix, is step 0's input. Every layer runs whole, so each expert
        layer routes the P rows of each image."""
        cos, sin = self._rope(0, embeds.shape[1], embeds.device)
        x, out = embeds.float(), []
        for layer in self.model.layers:
            x, lat = layer(x, cos, sin)
            out.append({"latent": lat})
        return out

    def init_cache(self, batch: int, max_len: int, device) -> LatentCache:
        """Zeroed latents of ``max_len`` decoded positions per layer."""
        width = self.model.layers[0].self_attn.latent_width
        return [{"latent": torch.zeros(batch, max_len, width, dtype=self.dtype, device=device)}
                for _ in self.model.layers]

    def step(self, tokens: torch.Tensor, t: int, cache: LatentCache, prefix: LatentCache
             ) -> torch.Tensor:
        """(B,) token ids as step t's input, at position P + t -> (B, V)
        next-token logits in the compute type; writes position t of
        ``cache``."""
        start = prefix[0]["latent"].shape[1]
        cos, sin = self._rope(start + t, 1, tokens.device)
        x = self.embed(tokens)[:, None]
        for layer, own, pre in zip(self.model.layers, cache, prefix):
            x = layer.step(x, cos, sin, own["latent"], t, pre["latent"])
        return self._head(x)[:, 0]


class PrefixDecoding:
    """The ``mla_moe`` decoder's side of ``OCRModel``: the image's tokens
    are the projected encoder grid, a decode's context is each layer's
    prefilled latent, and BOS sits after the prefix. It decodes greedily
    and by sampling; beam search, a mesh and the TeXOCR stack (``net``,
    which training reads) raise ``NotImplementedError``."""

    def __init__(self, projector: Projector, language_model: LanguageModel, encoder):
        self.projector, self.lm, self.encoder = projector, language_model, encoder

    @property
    def net(self):
        raise NotImplementedError("the mla_moe decoder has no TeXOCR decoder stack: it "
                                  "decodes greedily or by sampling, and does not train")

    def check(self, mode: Optional[str] = None, mesh: bool = False) -> None:
        if mesh:
            raise NotImplementedError("the mla_moe decoder does not run on a mesh")
        if mode == "beam":
            raise NotImplementedError("the mla_moe decoder decodes greedily or by sampling; "
                                      "beam search over its latent caches is not implemented")

    def tokens(self, enc: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
        return self.projector(enc, self.encoder.feature_grid(*images.shape[1:3]))

    def forward(self, encode: Callable, images: torch.Tensor, targets: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        prefix = encode(images)
        logits = self.lm(torch.cat([prefix.float(), self.lm.embed(targets[:, :-1])], dim=1))
        return logits[:, prefix.shape[1]:], targets[:, 1:]

    def context(self, enc: torch.Tensor) -> LatentCache:
        return self.lm.prefill(enc)

    def init_cache(self, batch: int, max_len: int, device) -> LatentCache:
        return self.lm.init_cache(batch, max_len, device)

    def start(self, context: LatentCache) -> int:
        return context[0]["latent"].shape[1]

    def step(self, token_t: torch.Tensor, t: int, cache: LatentCache, context: LatentCache,
             enc_mask: Optional[torch.Tensor] = None, t0: int = 0) -> torch.Tensor:
        return self.lm.step(token_t, t, cache, context)


def init_weights(module: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Kimi-VL's initialisation, drawn in each parameter's own type on its
    device: normal(0, std) for weights and embeddings, ones for norms'
    weights, zeros for biases (the routers' correction bias included)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
