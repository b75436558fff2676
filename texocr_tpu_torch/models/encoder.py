"""The ViT vision encoder: hybrid ResNet embed or plain patch embed.

``encoder.embed_layer``: ``hybrid`` is the ResNetV2 backbone -> 1x1 projection
(the reduced patch size is 1 with the /16 backbone); ``patch`` is a strided
patchify, kernel = stride = ``patch_size``, of the image cropped to whole
patches. Then CLS token first -> the top-left (h, w) block of the 2-D learned
positional table -> shared-norm attention stack -> final float32 LayerNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from texocr_tpu_torch.config import EncoderConfig
from texocr_tpu_torch.models.attention import AttentionStack
from texocr_tpu_torch.models.layers import PatchConv
from texocr_tpu_torch.models.resnet import ResNetV2


class HybridEmbed(nn.Module):
    """Backbone + pointwise projection: (B, H, W, 1) -> (B, h, w, D)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype, remat: bool = False):
        super().__init__()
        reduced = cfg.patch_size // (2 ** (len(cfg.resnet_depths) + 1))
        if reduced != 1:
            raise NotImplementedError(
                "only reduced patch size 1 (patch_size 16 with a 3-stage backbone) "
                "is supported, as in the reference factory"
            )
        self.backbone_net = ResNetV2(cfg.resnet_depths, cfg.resnet_channels,
                                     cfg.stem_channels, cfg.n_channels, dtype, remat)
        self.proj = PatchConv(cfg.resnet_channels[-1], cfg.embed_dim, 1, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.proj(self.backbone_net(images))


class PatchEmbedding(nn.Module):
    """Plain ViT patchify: (B, H, W, C) -> (B, H // p, W // p, D), the image
    cropped to whole patches first. Holds the reference's ``proj``
    (Conv2d(C, D, p, stride=p) keys)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.proj = PatchConv(cfg.n_channels, cfg.embed_dim, cfg.patch_size, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        h, w = images.shape[1] // p, images.shape[2] // p
        return self.proj(images[:, : h * p, : w * p])


class VisionEncoder(nn.Module):
    """(B, H, W, 1) image -> (B, h * w + 1, D) embeddings, CLS first."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, remat: bool = False):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.max_h = cfg.img_size[0] // cfg.patch_size
        self.max_w = cfg.img_size[1] // cfg.patch_size
        self.patch_embed = (HybridEmbed(cfg, dtype, remat) if cfg.embed_layer == "hybrid"
                            else PatchEmbedding(cfg, dtype))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.max_h * self.max_w + 1, cfg.embed_dim))
        # The reference factory passes no ff_kwargs to the encoder stack:
        # exp_factor 4.
        self.attn_layers = AttentionStack(cfg.embed_dim, cfg.num_layers, cfg.heads,
                                          exp_factor=4, dtype=dtype,
                                          use_flash=use_flash, remat=remat)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)

    def feature_grid(self, height: int, width: int) -> tuple:
        """The (h, w) token grid of an (height, width) image: the backbone's
        SAME-padded /16 (ceil division) or the patchify's whole patches."""
        cfg = self.config
        if cfg.embed_layer == "patch":
            return height // cfg.patch_size, width // cfg.patch_size
        stride = 4 * 2 ** (len(cfg.resnet_depths) - 1)
        return -(-height // stride), -(-width // stride)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images.to(self.dtype))
        b, h, w, d = x.shape
        if h > self.max_h or w > self.max_w:
            raise ValueError(f"feature grid {(h, w)} exceeds the positional table "
                             f"{(self.max_h, self.max_w)}")
        x = x.reshape(b, h * w, d)
        cls = self.cls_token.to(self.dtype).expand(b, 1, d)
        x = torch.cat([cls, x], dim=1)
        # Static 2-D slice of the table: smaller canvases use its top-left block.
        table = self.pos_embed[0]
        grid = table[1:].view(self.max_h, self.max_w, d)[:h, :w].reshape(h * w, d)
        x = x + torch.cat([table[:1], grid], dim=0).to(self.dtype)[None]
        x = self.attn_layers(x)
        return self.norm(x.float()).to(self.dtype)
