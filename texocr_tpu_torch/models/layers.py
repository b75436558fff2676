"""Shared building blocks: dense and convolution layers, GroupNorm, the MLP.

Parameters stay float32 and are cast to the compute dtype where they are used,
as in the JAX package. Parameter names and shapes are the reference PyTorch
model's (Linear (out, in), Conv OIHW), so its state dicts load unchanged.
Convolutions take NCHW tensors; the backbone converts at its public edge.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from texocr_tpu_torch.parallel.layers import copy_to_model, row_parallel
from texocr_tpu_torch.parallel.mesh import NO_AXIS, MeshAxis
from texocr_tpu_torch.utils import same_pad_lo_hi


class TorchDense(nn.Module):
    """y = x W^T + b in the compute dtype; W is (out, in) float32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class WSConv(nn.Module):
    """Weight-standardized conv with TF-SAME padding.

    The kernel is standardized per output channel over (in, kh, kw) in float32
    (biased variance, eps inside the rsqrt), then cast to the compute dtype.
    torch refuses ``padding='same'`` at stride 2, so the SAME split is padded
    explicitly.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) * torch.rsqrt(var + self.eps)).to(self.dtype)
        kh, kw = w.shape[2:]
        top, bottom = same_pad_lo_hi(x.shape[2], kh, self.stride)
        left, right = same_pad_lo_hi(x.shape[3], kw, self.stride)
        x = x.to(self.dtype)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, stride=self.stride)


class GroupNormAct(nn.Module):
    """GroupNorm (32 groups, eps 1e-5) with an optional ReLU.

    One-pass float32 statistics, E[x^2] - E[x]^2 clamped at 0, folded with the
    affine into one multiply-add in the compute dtype, as the JAX package does.
    """

    def __init__(self, channels: int, num_groups: int = 32, act: bool = True,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.act = act
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        b, c = x.shape[:2]
        g = self.num_groups
        xf = x.float()
        s1 = xf.sum(dim=(2, 3)).view(b, g, c // g).sum(-1)
        s2 = (xf * xf).sum(dim=(2, 3)).view(b, g, c // g).sum(-1)
        n = x.shape[2] * x.shape[3] * (c // g)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        w = inv.repeat_interleave(c // g, dim=1) * self.weight[None]
        shift = self.bias[None] - mean.repeat_interleave(c // g, dim=1) * w
        y = x.to(self.dtype) * w.to(self.dtype)[:, :, None, None] + shift.to(
            self.dtype
        )[:, :, None, None]
        return F.relu(y) if self.act else y


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max pool over NCHW with TF-SAME padding filled with -inf."""
    top, bottom = same_pad_lo_hi(x.shape[2], window, stride)
    left, right = same_pad_lo_hi(x.shape[3], window, stride)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class GEGLU(nn.Module):
    """Dense to 2 * hidden, split into (value, gate), value * gelu(gate) with
    the exact erf gelu. Holds its dense layer as ``fc`` like the reference."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc = TorchDense(dim, hidden * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.fc(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class MLP(nn.Module):
    """Transformer FFN: GeGLU (``glu``, keys ``fc_in.fc.*``) or dense + exact
    erf gelu (held as the reference's ``nn.Sequential(Linear, GELU)``: keys
    ``fc_in.0.*``), then dense back to embed. Under tensor parallelism
    (``shard``) ``fc_in`` is column-parallel (GeGLU's value and gate halves
    each split, ``parallel/sharding.py``) and ``fc_out`` row-parallel, its
    bias added once after the sum."""

    def __init__(self, embed_dim: int, exp_factor: int = 4, glu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = embed_dim * exp_factor
        self.tp = NO_AXIS
        self.fc_in = (GEGLU(embed_dim, self.hidden, dtype) if glu
                      else nn.Sequential(TorchDense(embed_dim, self.hidden, dtype=dtype),
                                         nn.GELU()))
        self.fc_out = TorchDense(self.hidden, embed_dim, dtype=dtype)

    def shard(self, tp: MeshAxis) -> None:
        """After the parameters were cut to this rank's slices: reduces over
        ``tp`` where the hidden units are split."""
        if self.fc_out.weight.shape[1] < self.hidden:
            self.tp = tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_parallel(self.fc_out, self.fc_in(copy_to_model(x, self.tp)), self.tp)


class PatchConv(nn.Module):
    """The reference's ``Conv2d(c, D, p, stride=p)``: weight (D, c, p, p) and
    bias (D,), applied to a (B, h * p, w * p, c) image as one product of its
    (py, px, c)-ordered patches with the flattened weight -> (B, h, w, D), in
    the compute dtype (the JAX package's reshape and dot). With p = 1 it is
    the hybrid embed's pointwise projection."""

    def __init__(self, in_channels: int, out_channels: int, patch_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, patch_size, patch_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, height, width, c = x.shape
        p = self.patch_size
        h, w = height // p, width // p
        patches = (x.reshape(b, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
                   .reshape(b, h, w, p * p * c))
        kernel = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return F.linear(patches.to(self.dtype), kernel.to(self.dtype), self.bias.to(self.dtype))


def init_torch_default(module: nn.Module, generator: torch.Generator) -> None:
    """torch's default init for the layers above: U(-b, b), b = 1/sqrt(fan_in),
    for weights and biases alike. GroupNorm keeps ones and zeros."""
    for m in module.modules():
        if isinstance(m, (TorchDense, WSConv, PatchConv)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                for p in (m.weight, getattr(m, "bias", None)):
                    if p is not None:
                        p.uniform_(-bound, bound, generator=generator)
