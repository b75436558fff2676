"""The TeXOCR model in plain PyTorch, float32: the benchmark's yardstick.

A frozen copy of the model's mathematics, written from the reference
architecture (olibridge01/TeXOCR, ``config/config.yml``) and the state-dict
layout its checkpoints use. It imports nothing of the program under test:
parameters are a dict of tensors keyed as in those checkpoints, and every
layer is a function of that dict.

- Preprocess: a 2-D uint8 image centred on a white canvas whose height is
  a multiple of 16 and width of 64, capped at the largest canvas; the model
  input is ``1 - u8 / 255``.
- Encoder: ResNetV2 backbone (weight-standardised convs with TF-SAME
  padding, GroupNorm(32) + ReLU, stem 7x7/2 and max pool 3x3/2, bottleneck
  stages with strides (1, 2, 2)), a 1x1 projection, CLS token first, the
  top-left block of the 2-D positional table, then a stack of attention and
  GeGLU sub-layers that share one LayerNorm (pre-norm, and a norm after
  every residual but the last) and a final LayerNorm.
- Decoder: token + positional embedding, (causal self, cross, MLP) per
  layer with the same shared-norm stream, final LayerNorm and logits.
  Attention is softmax(q k^T / 8) v over 8 heads of 64, then a dense layer
  to twice the width and a GLU; masked logits are filled with the most
  negative float32, so a row with no valid key averages all of them.
- Caches quantised to ``bits`` (8 for the configuration's int8, 4 for the
  control): the cross-attention K/V with one scale per (batch, head, dh)
  over the keys; the self-attention K/V with one scale per position over dh,
  read quantised for the positions of the chunks (of 32) that precede the
  query's chunk and at full precision within it, as a cached decode merges
  a chunk when the next one starts.

``Precision`` sets how the products are computed: float32 with TF32 off
(the reference), or as fp8 training computes them (the lower-precision
control): both operands of every product rounded to float8 e4m3 under a
per-tensor scale, and in the backward each product's output gradient
rounded to e5m2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
MASK_VALUE = -torch.finfo(torch.float32).max
FP8_MAX = 448.0
E5M2_MAX = 57344.0
DIM_HEAD = 64
CHUNK = 32


@dataclasses.dataclass(frozen=True)
class Precision:
    """``fp8``: every product's operands rounded to e4m3 under a per-tensor
    scale. ``cache_bits``: quantise both decode caches to this many bits
    (None: as the configuration states)."""
    fp8: bool = False
    cache_bits: Optional[int] = None


FLOAT32 = Precision()


@contextlib.contextmanager
def float32_products():
    """float32 products in float32 within the block: TF32 off for matmuls
    and convolutions, the settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- model shape from the configuration --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Arch:
    img_size: Tuple[int, int]
    patch_size: int
    in_channels: int
    stem: int
    depths: Tuple[int, ...]
    channels: Tuple[int, ...]
    enc_dim: int
    enc_layers: int
    enc_heads: int
    dec_dim: int
    dec_layers: int
    dec_heads: int
    exp_factor: int
    vocab: int
    max_length: int
    bos: int
    eos: int
    pad: int
    dropout: float
    kv_bits: Optional[int]
    self_kv_bits: Optional[int]

    @staticmethod
    def from_config(cfg: dict) -> "Arch":
        enc, dec = cfg["encoder"], cfg["decoder"]
        bits = {"none": None, "int8": 8}
        if not cfg.get("glu", True) or enc.get("embed_layer", "hybrid") != "hybrid":
            raise ValueError("the reference covers the hybrid embed with GeGLU MLPs")
        if not dec.get("cross_attend", True):
            raise ValueError("the reference covers a cross-attending decoder")
        return Arch(
            img_size=tuple(cfg.get("img_size", (160, 1008))),
            patch_size=cfg["patch_size"],
            in_channels=enc["n_channels"],
            stem=enc.get("stem_channels", 64),
            depths=tuple(enc.get("resnet_depths", (2, 4, 6))),
            channels=tuple(enc.get("resnet_channels", (256, 512, 1024))),
            enc_dim=enc["embed_dim"], enc_layers=enc["num_layers"], enc_heads=enc["heads"],
            dec_dim=dec["embed_dim"], dec_layers=dec["num_layers"], dec_heads=dec["heads"],
            exp_factor=dec.get("exp_factor", 4),
            vocab=cfg["vocab_size"], max_length=cfg["max_length"],
            bos=cfg["bos_token"], eos=cfg["eos_token"], pad=cfg["trg_pad_idx"],
            dropout=float(dec.get("dropout", 0.0)),
            kv_bits=bits[cfg.get("kv_quant", "none")],
            self_kv_bits=bits[cfg.get("self_kv_quant", "none")],
        )

    @property
    def grid(self) -> Tuple[int, int]:
        return self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size


def param_spec(arch: Arch) -> Tuple[List[Tuple[str, tuple, str]], Dict[str, str]]:
    """([(key, shape, kind)] of the distinct parameters, {alias key: key}).

    ``kind``: ``dense`` or ``conv`` (uniform within 1/sqrt(fan in)), ``bias``
    (within the bound of the weight before it), ``norm_w`` / ``norm_b`` (a
    norm's affine), ``embed`` (normal). The checkpoints hold some tensors
    under two keys: each bottleneck's layers as ``block_list`` and
    ``block``, and a stack's one LayerNorm at ``layers.{j}.0`` for every j."""
    spec: List[Tuple[str, tuple, str]] = []
    alias: Dict[str, str] = {}

    def add(key, shape, kind):
        spec.append((key, tuple(shape), kind))

    def norm(prefix, c):
        add(prefix + ".weight", (c,), "norm_w")
        add(prefix + ".bias", (c,), "norm_b")

    bb = "encoder.patch_embed.backbone_net"
    add(bb + ".stem.0.weight", (arch.stem, arch.in_channels, 7, 7), "conv")
    norm(bb + ".stem.1", arch.stem)
    cin = arch.stem
    for i, (depth, cout) in enumerate(zip(arch.depths, arch.channels)):
        mid = cout // 4
        for j in range(depth):
            p = f"{bb}.stages.{i}.stage_blocks.{j}"
            c_in = cin if j == 0 else cout
            if j == 0:
                add(p + ".downsample.conv.weight", (cout, c_in, 1, 1), "conv")
                norm(p + ".downsample.norm", cout)
            layers = [(0, (mid, c_in, 1, 1)), (2, (mid, mid, 3, 3)), (4, (cout, mid, 1, 1))]
            for idx, shape in layers:
                add(f"{p}.block_list.{idx}.weight", shape, "conv")
                norm(f"{p}.block_list.{idx + 1}", shape[0])
            for idx in range(6):
                for leaf in ("weight", "bias"):
                    src = f"{p}.block_list.{idx}.{leaf}"
                    if idx % 2 == 0 and leaf == "bias":
                        continue
                    alias[f"{p}.block.{idx}.{leaf}"] = src
        cin = cout
    add("encoder.patch_embed.proj.weight", (arch.enc_dim, arch.channels[-1], 1, 1), "dense")
    add("encoder.patch_embed.proj.bias", (arch.enc_dim,), "bias")
    gh, gw = arch.grid
    add("encoder.cls_token", (1, 1, arch.enc_dim), "embed")
    add("encoder.pos_embed", (1, gh * gw + 1, arch.enc_dim), "embed")

    def stack(prefix, dim, heads, n_layers, cross, exp_factor):
        kinds = ["attn", "cross", "mlp"] if cross else ["attn", "mlp"]
        j = 0
        inner = heads * DIM_HEAD
        for _ in range(n_layers):
            for kind in kinds:
                p = f"{prefix}.layers.{j}"
                if j == 0:
                    norm(p + ".0", dim)
                else:
                    for leaf in ("weight", "bias"):
                        alias[f"{p}.0.{leaf}"] = f"{prefix}.layers.0.0.{leaf}"
                if kind == "mlp":
                    hidden = dim * exp_factor
                    add(p + ".1.fc_in.fc.weight", (2 * hidden, dim), "dense")
                    add(p + ".1.fc_in.fc.bias", (2 * hidden,), "bias")
                    add(p + ".1.fc_out.weight", (dim, hidden), "dense")
                    add(p + ".1.fc_out.bias", (dim,), "bias")
                else:
                    for name in ("q", "k", "v"):
                        add(f"{p}.1.{name}.weight", (inner, dim), "dense")
                    add(p + ".1.fc_out.0.weight", (2 * dim, inner), "dense")
                    add(p + ".1.fc_out.0.bias", (2 * dim,), "bias")
                j += 1

    stack("encoder.attn_layers", arch.enc_dim, arch.enc_heads, arch.enc_layers, False, 4)
    norm("encoder.norm", arch.enc_dim)
    add("decoder.net.token_embedding.weight", (arch.vocab, arch.dec_dim), "embed")
    add("decoder.net.pos_embedding.embedding.weight", (arch.max_length, arch.dec_dim), "embed")
    stack("decoder.net.attn_layers", arch.dec_dim, arch.dec_heads, arch.dec_layers, True,
          arch.exp_factor)
    norm("decoder.net.norm", arch.dec_dim)
    add("decoder.net.to_logits.weight", (arch.vocab, arch.dec_dim), "dense")
    add("decoder.net.to_logits.bias", (arch.vocab,), "bias")
    return spec, alias


def make_params(arch: Arch, seed: int, device, eos_logit: Optional[float] = None) -> Params:
    """Seeded weights on ``device``, float32, in two large draws from one
    ``torch.Generator`` (uniform and normal), cut into the tensors of
    ``param_spec`` and scaled by kind; alias keys share their tensor.
    ``eos_logit``: the logits' bias at EOS, which set far below the others
    makes every decode run to its length."""
    spec, alias = param_spec(arch)
    n_uniform = sum(math.prod(s) for _, s, kind in spec if kind != "embed")
    n_normal = sum(math.prod(s) for _, s, kind in spec if kind == "embed")
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)
    uniform = torch.rand(n_uniform, generator=gen, device=device).mul_(2).sub_(1)
    normal = torch.randn(n_normal, generator=gen, device=device).mul_(0.02)
    params: Params = {}
    iu = inorm = 0
    bound = 1.0
    for key, shape, kind in spec:
        size = math.prod(shape)
        if kind == "embed":
            params[key] = normal[inorm: inorm + size].view(shape)
            inorm += size
            continue
        t = uniform[iu: iu + size].view(shape)
        iu += size
        if kind in ("dense", "conv"):
            bound = 1.0 / math.sqrt(math.prod(shape[1:]))
            t.mul_(bound)
        elif kind == "bias":
            t.mul_(bound)
        elif kind == "norm_w":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1)
        params[key] = t
    if eos_logit is not None:
        params["decoder.net.to_logits.bias"][arch.eos] = eos_logit
    for key, src in alias.items():
        params[key] = params[src]
    return params


def leaves(arch: Arch) -> List[str]:
    """The keys of the distinct parameters, in ``param_spec`` order."""
    return [key for key, _, _ in param_spec(arch)[0]]


# -- preprocess --------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def canvas_shape(h: int, w: int, arch: Arch) -> Tuple[int, int]:
    max_h, max_w = arch.img_size
    return min(_round_up(max(h, 16), 16), max_h), min(_round_up(max(w, 64), 64), max_w)


def to_canvas(img: np.ndarray, arch: Arch) -> np.ndarray:
    """A 2-D uint8 image centred on its white canvas; larger than the
    largest canvas is refused (the benchmark's traffic never is)."""
    h, w = img.shape
    ch, cw = canvas_shape(h, w, arch)
    if h > ch or w > cw:
        raise ValueError(f"image {img.shape} exceeds the largest canvas {arch.img_size}")
    out = np.full((ch, cw), 255, np.uint8)
    top, left = (ch - h) // 2, (cw - w) // 2
    out[top: top + h, left: left + w] = img
    return out


def model_input(u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 canvases -> (B, H, W) float32 ink, 1 - u8 / 255."""
    return 1.0 - u8.float() / 255.0


# -- products ------------------------------------------------------------------------------


def _to_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 type under a per-tensor scale (amax -> top)."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _GradFP8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2, as fp8
    training feeds a product's output gradient to its backward products."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _to_fp8(grad, torch.float8_e5m2, E5M2_MAX)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448), as a
    float32 tensor; gradients pass straight through."""
    return x + (_to_fp8(x.detach(), torch.float8_e4m3fn, FP8_MAX) - x.detach())


def operand(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return fp8_round(x) if prec.fp8 else x


def product(y: torch.Tensor, prec: Precision) -> torch.Tensor:
    """A product's output; under fp8 its gradient is rounded to e5m2."""
    return _GradFP8.apply(y) if prec.fp8 and y.requires_grad else y


def dense(x, p: Params, key: str, prec: Precision, bias: bool = True):
    w = p[key + ".weight"]
    if w.dim() == 4:  # a 1x1 convolution used as a dense layer
        w = w[:, :, 0, 0]
    out = product(torch.matmul(operand(x, prec), operand(w, prec).t()), prec)
    return out + p[key + ".bias"] if bias else out


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def ws_conv(x, w, stride: int, prec: Precision, eps: float = 1e-6):
    """Weight-standardised convolution (per output channel, biased variance)
    with TF-SAME padding; x is NCHW."""
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    w = (w - mean) / torch.sqrt(var + eps)
    k = w.shape[-1]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return product(F.conv2d(operand(x, prec), operand(w, prec), stride=stride), prec)


def group_norm(x, p: Params, key: str, act: bool, groups: int = 32, eps: float = 1e-5):
    y = F.group_norm(x, groups, p[key + ".weight"], p[key + ".bias"], eps)
    return F.relu(y) if act else y


def layer_norm(x, p: Params, key: str):
    return F.layer_norm(x, x.shape[-1:], p[key + ".weight"], p[key + ".bias"], 1e-5)


# -- encoder -----------------------------------------------------------------------------


def backbone(x, p: Params, arch: Arch, prec: Precision):
    """(B, H, W) ink -> (B, h, w, C) features, output stride 16."""
    pre = "encoder.patch_embed.backbone_net"
    h = x[:, None]
    h = group_norm(ws_conv(h, p[pre + ".stem.0.weight"], 2, prec), p, pre + ".stem.1", True)
    top, bottom = _same_pad(h.shape[2], 3, 2)
    left, right = _same_pad(h.shape[3], 3, 2)
    h = F.max_pool2d(F.pad(h, (left, right, top, bottom), value=float("-inf")), 3, 2)
    stride_so_far = 4
    for i, depth in enumerate(arch.depths):
        stage_stride = 1 if i == 0 or stride_so_far >= 32 else 2
        stride_so_far *= stage_stride
        for j in range(depth):
            b = f"{pre}.stages.{i}.stage_blocks.{j}"
            s = stage_stride if j == 0 else 1
            if j == 0:
                res = group_norm(ws_conv(h, p[b + ".downsample.conv.weight"], s, prec), p,
                                 b + ".downsample.norm", False)
            else:
                res = h
            y = group_norm(ws_conv(h, p[b + ".block_list.0.weight"], 1, prec), p,
                           b + ".block_list.1", True)
            y = group_norm(ws_conv(y, p[b + ".block_list.2.weight"], s, prec), p,
                           b + ".block_list.3", True)
            y = group_norm(ws_conv(y, p[b + ".block_list.4.weight"], 1, prec), p,
                           b + ".block_list.5", False)
            h = F.relu(y + res)
    return h.permute(0, 2, 3, 1)


def attention(q, k, v, prec: Precision, allowed=None, causal: bool = False):
    """(B, H, Nq, dh) x (B, H, Nk, dh): softmax(q k^T / sqrt(dh)) v with the
    masked logits filled; causal is right-aligned."""
    logits = product(torch.matmul(operand(q, prec), operand(k, prec).transpose(-1, -2)), prec)
    logits = logits * q.shape[-1] ** -0.5
    mask = allowed
    if causal:
        nq, nk = q.shape[2], k.shape[2]
        rows = torch.arange(nq, device=q.device)[:, None]
        cols = torch.arange(nk, device=q.device)[None, :]
        c = cols <= rows + (nk - nq)
        mask = c if mask is None else mask & c
    if mask is not None:
        logits = logits.masked_fill(~mask, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return product(torch.matmul(operand(probs, prec), operand(v, prec)), prec)


def heads(x, n):
    b, t, _ = x.shape
    return x.view(b, t, n, -1).transpose(1, 2)


def merge(x):
    b, n, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, n * d)


def attn_out(o, p: Params, key: str, prec: Precision):
    return F.glu(dense(merge(o), p, key + ".fc_out.0", prec), dim=-1)


def mlp(x, p: Params, key: str, prec: Precision):
    value, gate = dense(x, p, key + ".fc_in.fc", prec).chunk(2, dim=-1)
    return dense(value * F.gelu(gate), p, key + ".fc_out", prec)


def encode(x, p: Params, arch: Arch, prec: Precision = FLOAT32):
    """(B, H, W) ink -> (B, h * w + 1, D) encoder output."""
    feats = backbone(x, p, arch, prec)
    b, h, w, c = feats.shape
    z = dense(feats.reshape(b, h * w, c), p, "encoder.patch_embed.proj", prec)
    d = z.shape[-1]
    gh, gw = arch.grid
    table = p["encoder.pos_embed"][0]
    grid = table[1:].view(gh, gw, d)[:h, :w].reshape(h * w, d)
    z = torch.cat([p["encoder.cls_token"].expand(b, 1, d), z], dim=1)
    z = z + torch.cat([table[:1], grid], dim=0)[None]
    pre = "encoder.attn_layers"
    n_sub = 2 * arch.enc_layers
    for j in range(n_sub):
        key = f"{pre}.layers.{j}.1"
        hn = layer_norm(z, p, f"{pre}.layers.0.0")
        if j % 2 == 0:
            q = heads(dense(hn, p, key + ".q", prec, bias=False), arch.enc_heads)
            k = heads(dense(hn, p, key + ".k", prec, bias=False), arch.enc_heads)
            v = heads(dense(hn, p, key + ".v", prec, bias=False), arch.enc_heads)
            out = attn_out(attention(q, k, v, prec), p, key, prec)
        else:
            out = mlp(hn, p, key, prec)
        z = out + z
        if j != n_sub - 1:
            z = layer_norm(z, p, f"{pre}.layers.0.0")
    return layer_norm(z, p, "encoder.norm")


# -- decoder -----------------------------------------------------------------------------


def quantize(x: torch.Tensor, dim: int, bits: int) -> torch.Tensor:
    """Symmetric quantisation with one scale per slice along ``dim``,
    max(amax, 1e-8) / qmax, round half to even, clipped; returned
    dequantised."""
    qmax = 2 ** (bits - 1) - 1
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / qmax
    return torch.round(x / scale).clamp(-qmax, qmax) * scale


def cached_self_attention(q, k, v, bits: int):
    """Causal self-attention over a cache quantised per position: query t
    reads keys before its chunk's start quantised, the rest of 0..t at full
    precision."""
    t = q.shape[2]
    kq, vq = quantize(k, -1, bits), quantize(v, -1, bits)
    rows = torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    old = cols < rows - rows % CHUNK
    scale = q.shape[-1] ** -0.5
    logits = torch.where(old, torch.matmul(q, kq.transpose(-1, -2)),
                         torch.matmul(q, k.transpose(-1, -2))) * scale
    logits = logits.masked_fill(~(cols <= rows), MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    zero = torch.zeros((), device=q.device)
    return (torch.matmul(torch.where(old, probs, zero), vq)
            + torch.matmul(torch.where(old, zero, probs), v))


def decode_logits(tokens, enc, p: Params, arch: Arch, prec: Precision = FLOAT32,
                  mask: Optional[torch.Tensor] = None,
                  keep: Optional[torch.Tensor] = None):
    """Teacher-forced logits (B, T, V) of the decoder over (B, T) tokens.

    ``mask``: (B, T) bool, False at PAD (training); without it every
    position is valid, as in a cached decode, whose caches ``arch`` and
    ``prec`` quantise. ``keep``: the embed dropout's keep mask (B, T, D)."""
    b, t = tokens.shape
    pre = "decoder.net"
    x = p[pre + ".token_embedding.weight"][tokens] + p[pre + ".pos_embedding.embedding.weight"][:t]
    if keep is not None:
        x = torch.where(keep, x / (1.0 - arch.dropout), torch.zeros((), device=x.device))
    kv_bits = prec.cache_bits if prec.cache_bits is not None else arch.kv_bits
    self_bits = prec.cache_bits if prec.cache_bits is not None else arch.self_kv_bits
    self_allowed = cross_allowed = None
    if mask is not None:
        self_allowed = mask[:, None, :, None] & mask[:, None, None, :]
        cross_allowed = mask[:, None, :, None]
    n_sub = 3 * arch.dec_layers
    stack = pre + ".attn_layers"
    nh = arch.dec_heads
    for j in range(n_sub):
        key = f"{stack}.layers.{j}.1"
        hn = layer_norm(x, p, f"{stack}.layers.0.0")
        kind = j % 3
        if kind == 0:
            q = heads(dense(hn, p, key + ".q", prec, bias=False), nh)
            k = heads(dense(hn, p, key + ".k", prec, bias=False), nh)
            v = heads(dense(hn, p, key + ".v", prec, bias=False), nh)
            if self_bits is not None and mask is None:
                o = cached_self_attention(q, k, v, self_bits)
            else:
                o = attention(q, k, v, prec, allowed=self_allowed, causal=True)
            out = attn_out(o, p, key, prec)
        elif kind == 1:
            q = heads(dense(hn, p, key + ".q", prec, bias=False), nh)
            k = heads(dense(enc, p, key + ".k", prec, bias=False), nh)
            v = heads(dense(enc, p, key + ".v", prec, bias=False), nh)
            if kv_bits is not None and mask is None:
                k, v = quantize(k, 2, kv_bits), quantize(v, 2, kv_bits)
            out = attn_out(attention(q, k, v, prec, allowed=cross_allowed), p, key, prec)
        else:
            out = mlp(hn, p, key, prec)
        x = out + x
        if j != n_sub - 1:
            x = layer_norm(x, p, f"{stack}.layers.0.0")
    x = layer_norm(x, p, pre + ".norm")
    return dense(x, p, pre + ".to_logits", prec)
