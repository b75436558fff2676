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
-f32max fill is a softmax over exactly those t + 1 positions. Both attentions
of a cached step (``MultiHeadAttention.step`` and ``attend_cached_kv``) go to
``ops/decode_attention``: a kernel that reads the cache in place on the card,
its plain version on the CPU. The full forward keeps ``attention_core``.

int8 caches copy the JAX package's numbers, not its layout:

- ``self_kv_quant="int8"``: beside the full-precision buffer, an int8 copy
  (B, H, T, dh) and per-position scales (B, H, T). The JAX package quantizes a
  chunk of ``DECODE_CHUNK`` positions when it merges the chunk's hot window
  into its prefix, so ``chunk_start`` quantizes positions [t0 - chunk, t0)
  before step t0 and a step attends over the int8 prefix [0, t0) and the
  full-precision positions [t0, t] with one softmax
  (``ops/decode_attention.self_attention``).
- ``kv_quant="int8"``: the cross-attention K/V quantized once per sequence,
  scales per (B, H, dh) over the keys; K's scale folds into q before the dot
  and V's multiplies the output.

A stack without cross-attention (a decoder with ``cross_attend: false``) runs
its full forward, and its cache set-up (``init_cache``,
``precompute_cross_kv``) raises ``ValueError``: the JAX package's decode of
such a stack fails on its missing ``cross_attns``.

Beam search keeps the cross-attention K/V at (B, ...) for all beams of an
image and reorders the self-attention rows by parent (``reorder_cache``)
where the JAX package selects rows through an ancestry one-hot.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.models.layers import MLP, TorchDense
from texocr_tpu_torch.ops import decode_attention
from texocr_tpu_torch.ops.attention_core import attention_core, math_attention
from texocr_tpu_torch.parallel.layers import copy_to_model, row_parallel
from texocr_tpu_torch.parallel.mesh import NO_AXIS, MeshAxis

#: Per-layer {"k", "v"} buffers, each (B, H, T, dh); with int8 self-KV also
#: {"k8", "v8"} (B, H, T, dh) int8 and {"sk", "sv"} (B, H, T) scales.
KVCache = List[Dict[str, torch.Tensor]]

#: Decode positions per chunk (the JAX package's ``DECODE_CHUNK``): the decode
#: loops check their done flags on the host once per chunk, and with int8
#: self-KV a chunk is quantized when the next one starts, so the chunk also
#: sets which positions a step reads in int8. min(DECODE_CHUNK, max_len) for a
#: decode of max_len steps, as in the JAX package.
DECODE_CHUNK = 32

QUANT_MODES = ("none", "int8")

NO_CROSS_DECODE = ("a decoder with cross_attend: false has no cached decode (greedy, sampled "
                   "or beam): it trains, and its teacher-forced forward runs")


def quantize_int8(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one scale per slice along ``dim``: the
    scale max(amax, 1e-8) / 127 in float32, values round-half-even(x / scale)
    clipped to [-127, 127]. Returns (int8 values, the scale cast to x's type,
    keepdim), as the JAX package stores and dequantizes it."""
    xf = x.float()
    scale = xf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.to(x.dtype)


def chunk_size(max_len: int, table: int) -> Tuple[int, int]:
    """(max_len clamped to the decoder's positional table of ``table`` rows,
    the chunk min(DECODE_CHUNK, that))."""
    max_len = min(max_len, table)
    return max_len, min(DECODE_CHUNK, max_len)


def chunk_start(cache: KVCache, t: int, chunk: int) -> int:
    """Before step ``t``: returns the int8 prefix length t0 (t rounded down
    to a chunk), and when t starts a chunk quantizes the chunk [t0 - chunk,
    t0) of every layer's full-precision K/V into its int8 copy, one scale per
    position over dh (the JAX package's ``merge_hot`` on an int8 cache; an
    unquantized cache is left as it is)."""
    t0 = t - t % chunk
    if t0 and t == t0:
        for layer in cache:
            if "k8" not in layer:
                continue
            for name in ("k", "v"):
                q, scale = quantize_int8(layer[name][:, :, t0 - chunk: t0], dim=-1)
                layer[name + "8"][:, :, t0 - chunk: t0] = q
                layer["s" + name][:, :, t0 - chunk: t0] = scale[..., 0]
    return t0


def decode_chunks(state, run_chunk: Callable[[int], None]) -> None:
    """Runs ``state``'s chunks 0, 1, ... through ``run_chunk(c)``, and stops
    once every row is done: the host reads the done flags between chunks
    only (the JAX package's ``while_loop`` condition). While a profile runs,
    each chunk is a ``decode.chunk`` span (with its device time) and each
    read of the flags a ``decode.check`` span; captures call ``run_chunk``
    themselves, so no span enters a captured region."""
    for c in range(state.n_chunks):
        with telemetry.span("decode.chunk", device=state.done):
            run_chunk(c)
        if c + 1 < state.n_chunks:
            with telemetry.span("decode.check"):
                done = bool(state.done.all())
            if done:
                break


def reorder_cache(cache: KVCache, rows: torch.Tensor, spare: KVCache) -> None:
    """Beam search: row i of every buffer (full precision, int8 and scales
    together) becomes row ``rows[i]``'s. The rows are gathered into
    ``spare``'s buffer of the same name and shape, which then trades places
    with the cache's: the cache only ever holds one of the same two buffers,
    so a CUDA graph of the steps replays on fixed addresses. Over an even
    number of steps each buffer is back where it started."""
    for layer, other in zip(cache, spare):
        for name, buf in layer.items():
            torch.index_select(buf, 0, rows, out=other[name])
            layer[name], other[name] = other[name], buf


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.view(b, n, heads, -1).transpose(1, 2)  # (B, H, N, dh), a view


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class MultiHeadAttention(nn.Module):
    """Under tensor parallelism (``shard``) the layer holds
    ``heads / model`` whole heads: q/k/v are column-parallel, ``fc_out``
    row-parallel (the partial products summed over the model group before
    the GLU, its bias added once after the sum), and the decode caches and
    cross-attention K/V hold the local heads."""

    def __init__(self, embed_dim: int, heads: int = 8, dim_head: int = 64,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 causal: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.tp = NO_AXIS
        self.scale = dim_head ** -0.5
        self.use_flash = use_flash
        self.causal = causal
        self.q = TorchDense(embed_dim, inner, bias=False, dtype=dtype)
        self.k = TorchDense(embed_dim, inner, bias=False, dtype=dtype)
        self.v = TorchDense(embed_dim, inner, bias=False, dtype=dtype)
        # nn.Sequential(Linear, GLU) in the reference: keys fc_out.0.*.
        self.fc_out = nn.Sequential(TorchDense(inner, embed_dim * 2, dtype=dtype))

    def shard(self, tp: MeshAxis) -> None:
        """After the parameters were cut to this rank's slices: takes the
        local head count from q's rows and, where the heads are split,
        reduces over ``tp``."""
        local = self.q.weight.shape[0] // self.dim_head
        if local < self.heads:
            self.heads, self.tp = local, tp

    def project_kv(self, src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._kv(copy_to_model(src, self.tp))

    def _kv(self, src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """K and V of ``src`` that has entered the model group."""
        return _split_heads(self.k(src), self.heads), _split_heads(self.v(src), self.heads)

    def _finish(self, out_heads: torch.Tensor) -> torch.Tensor:
        return F.glu(row_parallel(self.fc_out[0], _merge_heads(out_heads), self.tp), dim=-1)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None, return_maps: bool = False):
        """Full (uncached) attention over (B, N, D): self-attention, or
        cross-attention over ``context``. ``mask``: (B, Nq) bool query-side
        padding mask; ``context_mask``: (B, Nk) bool key-side mask of the
        context. The mask is their q x k outer product; for self-attention the
        key mask is the query mask. A query row with every key masked
        softmaxes to a uniform average (the math path fills, in bool space).
        ``return_maps``: returns (out, maps), the pre- and post-softmax maps
        of ``math_attention``, which it then always takes (the kernel keeps no
        maps)."""
        x = copy_to_model(x, self.tp)
        q = _split_heads(self.q(x), self.heads)
        k, v = self._kv(x) if context is None else self.project_kv(context)
        src = x if context is None else context
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
        if return_maps:
            out, maps = math_attention(q, k, v, scale=self.scale, allowed=allowed,
                                       causal=self.causal, return_probs=True)
            return self._finish(out), maps
        out = attention_core(q, k, v, scale=self.scale, allowed=allowed, causal=self.causal,
                             use_flash=self.use_flash)
        return self._finish(out)

    def step(self, x_t: torch.Tensor, cache: Dict[str, torch.Tensor], t: int,
             t0: int = 0) -> torch.Tensor:
        """Cached self-attention for the token at position ``t``: writes its
        K/V into ``cache`` in place and attends over positions 0..t; with an
        int8 cache, positions below ``t0`` (the merged chunks) in int8."""
        x_t = copy_to_model(x_t, self.tp)
        q = _split_heads(self.q(x_t), self.heads)  # (B, H, 1, dh)
        k, v = self._kv(x_t)
        cache["k"][:, :, t] = k[:, :, 0]
        cache["v"][:, :, t] = v[:, :, 0]
        return self._finish(decode_attention.self_attention(q, cache, t, t0, scale=self.scale))

    def attend_cached_kv(self, x_t: torch.Tensor, kv: Dict[str, torch.Tensor],
                         key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Cross-attention step against K/V precomputed once per sequence:
        {"k", "v"} or the int8 {"k8", "v8", "sk", "sv"}, each (B, H, Nk, .).
        ``key_mask``: (B, Nk) bool, False at padded keys. ``x_t`` holds
        beam rows per image, (B * beam, 1, D), all attending their image's
        unexpanded K/V."""
        # (B * beam, H, 1, dh)
        q = _split_heads(self.q(copy_to_model(x_t, self.tp)), self.heads)
        batch = kv["k8" if "k8" in kv else "k"].shape[0]
        beam = q.shape[0] // batch
        # (B, H, beam, dh): an image's beams are the queries of one attention.
        q = q.view(batch, beam, self.heads, -1).transpose(1, 2)
        out = decode_attention.cross_attention(q, kv, scale=self.scale, key_mask=key_mask)
        out = out.transpose(1, 2).reshape(batch * beam, self.heads, 1, -1)
        return self._finish(out)


class AttentionStack(nn.Module):
    """(self[, cross], mlp) sub-layers with the shared LayerNorm and the
    double-norm residual stream; the MLPs are GeGLU or, without ``glu``,
    dense + gelu."""

    def __init__(self, embed_dim: int, num_layers: int, heads: int = 8,
                 dim_head: int = 64, cross_attend: bool = False, causal: bool = False,
                 glu: bool = True, exp_factor: int = 4, dtype: torch.dtype = torch.float32,
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
            blocks.append(MLP(embed_dim, exp_factor, glu, dtype))
        self.layers = nn.ModuleList([nn.ModuleList([norm, block]) for block in blocks])

    def shard(self, tp: MeshAxis) -> None:
        """After the parameters were cut to this rank's slices: every
        attention and MLP block takes its tensor-parallel form, and the
        decode caches hold the local heads."""
        for _, block in self.layers:
            block.shard(tp)
        self.heads = self.layers[0][1].heads

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

    def _run(self, x: torch.Tensor, apply, hiddens: Optional[list] = None) -> torch.Tensor:
        """Every sub-layer in order; ``hiddens``, when given, collects the
        input of each self-attention sub-layer."""
        per = self._per_layer()
        for j in range(len(self.layers)):
            if hiddens is not None and j % per == 0:
                hiddens.append(x)
            x = self._sublayer(j, apply, x)
        return x

    def forward(self, x: torch.Tensor, enc: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                enc_mask: Optional[torch.Tensor] = None, return_hidden: bool = False):
        """Full forward: the encoder's self-attention stack, or the
        teacher-forced decoder's (causal self, [cross over ``enc``,] MLP).
        ``mask``: (B, N) bool padding mask of ``x``; ``enc_mask``: (B, Nk) of
        ``enc``. With ``remat`` (and gradients on) each sub-layer runs under
        ``torch.utils.checkpoint``: the backward recomputes it instead of
        keeping its activations, as the JAX package's ``nn.remat`` does.

        ``return_hidden``: returns (x, {"hiddens": the input of each
        self-attention sub-layer, "attn_intermediates": the maps dict of each
        attention sub-layer, in order}); the attention then takes the math
        path and ``remat`` is off."""
        if self.cross_attend and enc is None:
            raise ValueError("Must provide enc if cross_attend is True.")
        per = self._per_layer()
        maps = []

        def apply(j, block, h):
            kind = j % per
            if kind == per - 1:
                return block(h)
            if kind == 1:
                out = block(h, context=enc, mask=mask, context_mask=enc_mask,
                            return_maps=return_hidden)
            else:
                out = block(h, mask=mask, return_maps=return_hidden)
            if return_hidden:
                out, m = out
                maps.append(m)
            return out

        if return_hidden:
            hiddens = []
            x = self._run(x, apply, hiddens)
            return x, {"hiddens": hiddens, "attn_intermediates": maps}
        if not (self.remat and torch.is_grad_enabled()):
            return self._run(x, apply)
        for j in range(len(self.layers)):
            x = checkpoint(self._sublayer, j, apply, x, use_reentrant=False)
        return x

    # -- cached decode ----------------------------------------------------------

    def _per_layer(self) -> int:
        return 3 if self.cross_attend else 2

    def check_decodes(self) -> None:
        """The cached decode needs cross-attention layers: raises
        ``ValueError`` on a stack without them (the JAX package's decode
        fails there too, on the missing ``cross_attns``)."""
        if not self.cross_attend:
            raise ValueError(NO_CROSS_DECODE)

    def init_cache(self, batch: int, max_len: int, device, quant: str = "none") -> KVCache:
        """Zeroed per-layer self-attention K/V, each (B, H, max_len, dh); with
        ``quant="int8"`` also their int8 copies and per-position scales."""
        self.check_decodes()
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown self kv quant mode: {quant!r}")
        shape = (batch, self.heads, max_len, self.dim_head)
        cache = []
        for _ in range(self.num_layers):
            layer = {name: torch.zeros(shape, dtype=self.dtype, device=device)
                     for name in ("k", "v")}
            if quant == "int8":
                for name in ("k8", "v8"):
                    layer[name] = torch.zeros(shape, dtype=torch.int8, device=device)
                for name in ("sk", "sv"):
                    layer[name] = torch.zeros(shape[:3], dtype=self.dtype, device=device)
            cache.append(layer)
        return cache

    def precompute_cross_kv(self, enc: torch.Tensor,
                            quant: str = "none") -> List[Dict[str, torch.Tensor]]:
        """Per-layer cross-attention K/V of the encoder output, each
        (B, H, Nk, dh), computed once per sequence; with ``quant="int8"``
        {"k8", "v8"} and their (B, H, 1, dh) scales over Nk."""
        self.check_decodes()
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown kv quant mode: {quant!r}")
        per = self._per_layer()
        out = []
        for layer in range(self.num_layers):
            k, v = self.layers[layer * per + 1][1].project_kv(enc)
            if quant == "none":
                out.append({"k": k, "v": v})
                continue
            k8, sk = quantize_int8(k, dim=2)
            v8, sv = quantize_int8(v, dim=2)
            out.append({"k8": k8, "v8": v8, "sk": sk, "sv": sv})
        return out

    def step(self, x_t: torch.Tensor, cache: KVCache, t: int,
             cross_kv: Optional[List[Dict[str, torch.Tensor]]],
             enc_mask: Optional[torch.Tensor] = None, t0: int = 0) -> torch.Tensor:
        """One decode step over the stack for (B * beam, 1, D) input at
        position t. ``enc_mask``: (B, Nk) bool key mask of the cross-attention;
        ``t0``: the int8 prefix's length (an int8 cache only)."""
        per = self._per_layer()

        def apply(j, block, h):
            layer, kind = divmod(j, per)
            if kind == 0:
                return block.step(h, cache[layer], t, t0)
            if kind == 1:
                return block.attend_cached_kv(h, cross_kv[layer], key_mask=enc_mask)
            return block(h)

        return self._run(x_t, apply)
