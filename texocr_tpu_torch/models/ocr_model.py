"""Top-level OCR model: hybrid ViT encoder + autoregressive decoder.

``state_dict()`` gives exactly the reference PyTorch model's keys
(``encoder.*`` and ``decoder.net.*``), so its checkpoints and the committed
goldens load with ``strict=True``.
"""

from __future__ import annotations

import torch
from torch import nn

from texocr_tpu_torch.config import ModelConfig, resolve_flash
from texocr_tpu_torch.models.decoder import TransformerDecoder
from texocr_tpu_torch.models.encoder import VisionEncoder
from texocr_tpu_torch.models.layers import init_torch_default

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class OCRModel(nn.Module):
    """The model on ``device`` (CUDA unless the caller asks otherwise), with
    weights drawn from a ``torch.Generator`` seeded with ``seed`` the way
    torch initialises the reference (load a state dict to replace them)."""

    def __init__(self, config: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        self.config = config
        dtype = DTYPES[config.dtype]
        use_flash = resolve_flash(config.use_flash_attention, device)
        self.encoder = VisionEncoder(config.encoder, dtype, use_flash)
        # The reference holds the decoder stack as ``decoder.net``.
        self.decoder = nn.ModuleDict({"net": TransformerDecoder(config.decoder, dtype)})
        generator = torch.Generator().manual_seed(seed)
        init_torch_default(self, generator)
        with torch.no_grad():
            for emb in (self.dec.token_embedding, self.dec.pos_embedding.embedding):
                emb.weight.normal_(0.0, 0.02, generator=generator)
        self.to(device)

    @property
    def dec(self) -> TransformerDecoder:
        return self.decoder["net"]

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) -> (B, N_patches + 1, D)."""
        return self.encoder(images)

    def decoder_init_cache(self, batch: int, max_len: int, device):
        return self.dec.attn_layers.init_cache(batch, max_len, device)

    def decoder_cross_kv(self, enc: torch.Tensor):
        return self.dec.attn_layers.precompute_cross_kv(enc)

    def decoder_step(self, token_t: torch.Tensor, t: int, cache, cross_kv) -> torch.Tensor:
        return self.dec.step(token_t, t, cache, cross_kv)
