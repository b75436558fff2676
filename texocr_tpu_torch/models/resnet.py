"""ResNetV2-style CNN backbone of the hybrid embed.

Weight-standardized convs, GroupNorm(32) + ReLU, TF-SAME padding; stem 7x7/s2
plus a 3x3/s2 max pool, stage strides (1, 2, 2): output stride 16. The public
functions keep the JAX package's NHWC layout ((B, H, W, C) in and out) and run
NCHW inside. Submodule names reproduce the reference state dict's keys.

``remat``: each bottleneck runs under ``torch.utils.checkpoint`` when gradients
are on, so the backward keeps only the block-boundary activations and
recomputes the rest (the JAX package's per-bottleneck ``nn.remat``); the early
high-resolution feature maps dominate training memory at the full canvas.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from texocr_tpu_torch.models.layers import GroupNormAct, WSConv, max_pool_same


class DownSample(nn.Module):
    """1x1 WS-conv + GroupNorm without activation: the projection shortcut."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv = WSConv(in_ch, out_ch, 1, stride=stride, dtype=dtype)
        self.norm = GroupNormAct(out_ch, act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 WS-conv/GN bottleneck, ReLU after the
    residual add; bottle ratio 0.25."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, use_proj: bool,
                 dtype: torch.dtype):
        super().__init__()
        mid = out_ch // 4
        self.downsample = DownSample(in_ch, out_ch, stride, dtype) if use_proj else None
        self.block_list = nn.ModuleList([
            WSConv(in_ch, mid, 1, dtype=dtype),
            GroupNormAct(mid, dtype=dtype),
            WSConv(mid, mid, 3, stride=stride, dtype=dtype),
            GroupNormAct(mid, dtype=dtype),
            WSConv(mid, out_ch, 1, dtype=dtype),
            GroupNormAct(out_ch, act=False, dtype=dtype),
        ])
        # The reference registers the same layers a second time as
        # nn.Sequential ``block``; one object under both names gives its keys.
        self.block = self.block_list

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.downsample is None else self.downsample(x)
        h = x
        for layer in self.block_list:
            h = layer(h)
        return F.relu(h + res)


class Stage(nn.Module):
    """``depth`` bottlenecks; the first carries the stride and the projection."""

    def __init__(self, in_ch: int, out_ch: int, depth: int, stride: int,
                 dtype: torch.dtype, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.stage_blocks = nn.ModuleList([
            Bottleneck(in_ch if i == 0 else out_ch, out_ch, stride if i == 0 else 1,
                       use_proj=(i == 0), dtype=dtype)
            for i in range(depth)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for block in self.stage_blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return x


class ResNetV2(nn.Module):
    def __init__(self, depths: Sequence[int] = (2, 4, 6),
                 channels: Sequence[int] = (256, 512, 1024), stem_channels: int = 64,
                 in_channels: int = 1, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.stem = nn.ModuleList([
            WSConv(in_channels, stem_channels, 7, stride=2, dtype=dtype),
            GroupNormAct(stem_channels, dtype=dtype),
        ])
        stages = []
        in_ch, curr_stride = stem_channels, 4
        for i, (depth, ch) in enumerate(zip(depths, channels)):
            # Stages after the first halve the grid until output stride 32.
            stride = 1 if i == 0 or curr_stride >= 32 else 2
            stages.append(Stage(in_ch, ch, depth, stride, dtype, remat))
            in_ch, curr_stride = ch, curr_stride * stride
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) -> (B, H/16, W/16, channels[-1]) for 3 stages."""
        h = x.permute(0, 3, 1, 2)
        for layer in self.stem:
            h = layer(h)
        h = max_pool_same(h, window=3, stride=2)
        for stage in self.stages:
            h = stage(h)
        return h.permute(0, 2, 3, 1)
