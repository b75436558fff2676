"""Kimi-VL-A3B's language model and image projector in plain PyTorch, float32:
the benchmark's yardstick for the ``kimi-vl-a3b`` configuration.

A frozen copy of the mathematics, written from the published ``config.json``
(huggingface.co/moonshotai/Kimi-VL-A3B-Instruct) and the DeepSeek-V3 layers
its language model runs, beside the TeXOCR encoder of
``portbench/reference/model.py``. It imports nothing of the program under
test. Parameters are a dict keyed as in the published checkpoint
(``language_model.model.layers.{i}.self_attn.q_proj.weight``, ...), held on
the device in the configuration's ``param_dtype``; the reference lifts each
layer's weights to float32 as it reaches them (an expert at a time in the
expert layers), so it runs beside the bfloat16 weights once the program's
engine is freed.

- Image tokens: the encoder's output without CLS on its (h, w) grid,
  LayerNorm, zero-padded to a multiple of the 2 x 2 merge, each block's
  patches side by side (row-major), linear, exact GELU, linear.
- Latent attention, unabsorbed: q = W_q x split into nope and rope parts;
  [c; k_pe] = W_kva x, c RMS-normalised; [k_nope; v] = W_kvb c per head;
  q_pe and k_pe rotated (DeepSeek-V3's rotary embedding: the interleaved
  pairs gathered into halves, then x cos + rotate_half(x) sin, theta
  ``rope_theta``); causal softmax((q . k) / sqrt(nope + rope)) over v; W_o.
- Expert layers: s = sigmoid(W_g x); the top k of s + b; weights s / sum(s)
  x ``routed_scaling_factor``; the chosen experts' SwiGLU MLPs in a loop,
  weighted, plus the shared experts' MLP. Layer 0: the dense SwiGLU MLP.
- RMSNorm (eps ``rms_norm_eps``) before each sub-layer and at the end; the
  untied head.

``Precision`` (``reference/model.py``'s): float32 with TF32 off, or every
product's operands rounded to float8 e4m3 under a per-tensor scale (the
lower-precision control).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import model as ref

Params = Dict[str, torch.Tensor]
LM = "language_model."
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INIT_STD = 0.02
#: The encoder's bottlenecks' last GroupNorm weights, scaled (see make_params).
RESIDUAL_GAIN = 0.1
#: The routers' balancing: its updates and each update's shrinking.
BALANCE_STEPS = 400
BALANCE_DECAY = 0.99


@dataclasses.dataclass(frozen=True)
class Arch:
    """The configuration's shapes: the TeXOCR encoder's (``enc``) and the
    language model's published keys (``lm``)."""
    enc: ref.Arch
    lm: dict
    bos: int
    eos: int
    pad: int
    param_dtype: torch.dtype

    @staticmethod
    def from_config(cfg: dict) -> "Arch":
        dec = cfg["decoder"]
        if dec.get("kind") != "mla_moe":
            raise ValueError("the Kimi-VL reference covers the mla_moe decoder")
        # The encoder's reference shape; the decoder fields are unread.
        enc_cfg = dict(cfg, vocab_size=8, max_length=8, kv_quant="none", self_kv_quant="none",
                       decoder={"embed_dim": 8, "num_layers": 1, "heads": 1})
        return Arch(enc=ref.Arch.from_config(enc_cfg), lm=dict(dec), bos=cfg["bos_token"],
                    eos=cfg["eos_token"], pad=cfg["trg_pad_idx"],
                    param_dtype=DTYPES[cfg.get("param_dtype", "float32")])

    @property
    def moe_layers(self) -> int:
        return self.lm["num_hidden_layers"] - self.lm["first_k_dense_replace"]

    def grid(self, height: int, width: int) -> Tuple[int, int]:
        """The encoder's (h, w) grid of an (height, width) canvas (/16, ceil)."""
        return -(-height // 16), -(-width // 16)

    def prefix(self, height: int, width: int) -> int:
        """Image tokens of an (height, width) canvas."""
        (h, w), (mh, mw) = self.grid(height, width), self.lm["merge"]
        return -(-h // mh) * -(-w // mw)


def param_shapes(arch: Arch) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the language model and the projector under the
    published checkpoint's key, with its shape."""
    c = arch.lm
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vdim, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                              c["kv_lora_rank"])
    e, inter = c["n_routed_experts"], c["moe_intermediate_size"]
    enc = arch.enc.enc_dim
    merged = enc * c["merge"][0] * c["merge"][1]
    pj = "multi_modal_projector."
    out = {pj + "pre_norm.weight": (enc,), pj + "pre_norm.bias": (enc,),
           pj + "linear_1.weight": (c["projector_hidden"], merged),
           pj + "linear_1.bias": (c["projector_hidden"],),
           pj + "linear_2.weight": (d, c["projector_hidden"]), pj + "linear_2.bias": (d,),
           LM + "model.embed_tokens.weight": (c["vocab_size"], d),
           LM + "model.norm.weight": (d,), LM + "lm_head.weight": (c["vocab_size"], d)}

    def mlp(pre, width):
        out.update({pre + "gate_proj.weight": (width, d), pre + "up_proj.weight": (width, d),
                    pre + "down_proj.weight": (d, width)})

    for i in range(c["num_hidden_layers"]):
        pre = f"{LM}model.layers.{i}."
        out.update({pre + "input_layernorm.weight": (d,),
                    pre + "post_attention_layernorm.weight": (d,),
                    pre + "self_attn.q_proj.weight": (h * (nope + rope), d),
                    pre + "self_attn.kv_a_proj_with_mqa.weight": (rank + rope, d),
                    pre + "self_attn.kv_a_layernorm.weight": (rank,),
                    pre + "self_attn.kv_b_proj.weight": (h * (nope + vdim), rank),
                    pre + "self_attn.o_proj.weight": (d, h * vdim)})
        if i < c["first_k_dense_replace"]:
            mlp(pre + "mlp.", c["intermediate_size"])
            continue
        out.update({pre + "mlp.gate.weight": (e, d),
                    pre + "mlp.gate.e_score_correction_bias": (e,)})
        for j in range(e):
            mlp(f"{pre}mlp.experts.{j}.", inter)
        mlp(pre + "mlp.shared_experts.", inter * c["n_shared_experts"])
    return out


def make_params(arch: Arch, seed: int, device, eos_logit: Optional[float] = None) -> Params:
    """Seeded weights on ``device``: the encoder's as
    ``reference/model.make_params`` draws them (float32), each bottleneck's
    last GroupNorm weight times ``RESIDUAL_GAIN`` (ResNetV2 starts them at 0,
    timm's ``zero_init_last``: at their drawn ~1 the random backbone turns
    bfloat16 rounding into a 21% relative error of the image tokens, which
    27 layers of routing then follow apart; at 0.1, 1.7%); the language model's
    and the projector's drawn from one ``torch.Generator`` in the
    configuration's ``param_dtype``, normal(0, 0.02) for weights and
    embeddings, ones for norms' weights, zeros for the projector's biases and
    the routers' correction bias (``balance_routers`` sets it). Each expert layer's routed experts are drawn as one
    tensor per projection, (E, I, D) or (E, D, I), and keyed per expert as
    its consecutive slices. ``eos_logit``: 0 zeroes the head's EOS row, so
    EOS's logit is exactly 0 while the largest of the others lies near +4
    (the head has no bias to pin it lower), and every decode runs to its
    length."""
    enc = ref.make_params(arch.enc, seed, device)
    params: Params = {k: v for k, v in enc.items() if k.startswith("encoder.")}
    for key, t in params.items():
        if key.endswith("block_list.5.weight"):  # its alias ``block.5`` is the same tensor
            t.mul_(RESIDUAL_GAIN)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64 ^ 0x4B494D49)
    dtype = arch.param_dtype
    shapes = param_shapes(arch)
    experts: Dict[Tuple[str, str], list] = {}
    for key, shape in shapes.items():
        if ".experts." in key:
            layer, rest = key.split(".experts.")
            experts.setdefault((layer, rest.split(".", 1)[1]), []).append(key)
            continue
        t = torch.empty(shape, dtype=torch.float32 if key.endswith("correction_bias") else dtype,
                        device=device)
        if key.endswith("norm.weight"):
            t.fill_(1.0)
        elif key.endswith("bias"):
            t.zero_()
        else:
            t.normal_(0.0, INIT_STD, generator=gen)
        params[key] = t
    for (_, name), keys in experts.items():
        block = torch.empty((len(keys), *shapes[keys[0]]), dtype=dtype, device=device)
        block.normal_(0.0, INIT_STD, generator=gen)
        for i, key in enumerate(keys):
            params[key] = block[i]
    if eos_logit is not None:
        if eos_logit != 0:
            raise ValueError("the head has no bias: EOS's logit can be pinned at 0 only")
        params[LM + "lm_head.weight"][arch.eos].zero_()
    return params


# -- the model -----------------------------------------------------------------------------


def _w(p: Params, key: str) -> torch.Tensor:
    return p[key].float()


def dense(x, p: Params, key: str, prec: ref.Precision, bias: bool = False):
    out = ref.product(torch.matmul(ref.operand(x, prec), ref.operand(_w(p, key + ".weight"),
                                                                      prec).t()), prec)
    return out + _w(p, key + ".bias") if bias else out


def rms_norm(x, p: Params, key: str, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _w(p, key)


def rotary(x, positions, theta: float):
    """x (B, N, ..., d) rotated at the (N,) positions."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float() / d))
    freqs = torch.outer(positions.float(), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 3) + (d,)
    cos, sin = emb.cos().view(shape), emb.sin().view(shape)
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1) * sin


def attention(x, p: Params, pre: str, c: dict, prec: ref.Precision):
    """Causal latent attention over (B, N, D), unabsorbed."""
    b, n, _ = x.shape
    h = c["num_attention_heads"]
    nope, rope, vdim, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                              c["kv_lora_rank"])
    pos = torch.arange(n, device=x.device)
    q = dense(x, p, pre + "q_proj", prec).view(b, n, h, nope + rope)
    kv = dense(x, p, pre + "kv_a_proj_with_mqa", prec)
    lat = rms_norm(kv[..., :rank], p, pre + "kv_a_layernorm.weight", c["rms_norm_eps"])
    k_pe = rotary(kv[..., rank:][:, :, None], pos, c["rope_theta"])
    kvb = dense(lat, p, pre + "kv_b_proj", prec).view(b, n, h, nope + vdim)
    q = torch.cat([q[..., :nope], rotary(q[..., nope:], pos, c["rope_theta"])], -1)
    k = torch.cat([kvb[..., :nope], k_pe.expand(b, n, h, rope)], -1)
    v = kvb[..., nope:]
    scores = ref.product(torch.matmul(ref.operand(q.transpose(1, 2), prec),
                                      ref.operand(k.transpose(1, 2), prec).transpose(-1, -2)),
                         prec) * (nope + rope) ** -0.5
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = ref.product(torch.matmul(ref.operand(probs, prec), ref.operand(v.transpose(1, 2), prec)),
                      prec)
    return dense(out.transpose(1, 2).reshape(b, n, h * vdim), p, pre + "o_proj", prec)


def mlp(x, p: Params, pre: str, prec: ref.Precision):
    return dense(F.silu(dense(x, p, pre + "gate_proj", prec)) * dense(x, p, pre + "up_proj", prec),
                 p, pre + "down_proj", prec)


def route(x, p: Params, pre: str, c: dict):
    """(T, D) rows -> (chosen experts (T, k), their weights)."""
    scores = torch.sigmoid(x @ _w(p, pre + "gate.weight").t())
    ids = torch.topk(scores + _w(p, pre + "gate.e_score_correction_bias"),
                     c["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, ids)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return ids, w * c["routed_scaling_factor"]


def moe(x, p: Params, pre: str, c: dict, prec: ref.Precision):
    rows = x.reshape(-1, x.shape[-1])
    ids, w = route(rows, p, pre, c)
    out = torch.zeros_like(rows)
    for e in range(c["n_routed_experts"]):
        hit, slot = (ids == e).nonzero(as_tuple=True)
        if hit.numel():
            out[hit] += w[hit, slot][:, None] * mlp(rows[hit], p, f"{pre}experts.{e}.", prec)
    return (out + mlp(rows, p, pre + "shared_experts.", prec)).view(x.shape)


def image_tokens(enc, grid: Tuple[int, int], p: Params, arch: Arch, prec: ref.Precision):
    """(B, 1 + h * w, E) encoder output -> (B, P, D) image tokens."""
    b, _, d = enc.shape
    h, w = grid
    mh, mw = arch.lm["merge"]
    pj = "multi_modal_projector."
    x = F.layer_norm(enc[:, 1:], (d,), _w(p, pj + "pre_norm.weight"), _w(p, pj + "pre_norm.bias"),
                     1e-5)
    x = F.pad(x.view(b, h, w, d), (0, 0, 0, -w % mw, 0, -h % mh))
    gh, gw = x.shape[1] // mh, x.shape[2] // mw
    x = x.view(b, gh, mh, gw, mw, d).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, mh * mw * d)
    x = F.gelu(dense(x, p, pj + "linear_1", prec, bias=True))
    return dense(x, p, pj + "linear_2", prec, bias=True)


def text_logits(canvases: torch.Tensor, tokens: torch.Tensor, p: Params, arch: Arch,
                prec: ref.Precision = ref.FLOAT32) -> torch.Tensor:
    """(B, H, W) uint8 canvases and their (B, T) text tokens (BOS first) ->
    the (B, T, V) float32 logits at the text positions: encoder, image
    tokens, then the language model over [image tokens; text] at positions
    0.. from the first image token."""
    c = arch.lm
    eps = c["rms_norm_eps"]
    x_img = ref.model_input(canvases)
    enc = ref.encode(x_img, p, arch.enc, prec)
    prefix = image_tokens(enc, arch.grid(*canvases.shape[1:]), p, arch, prec)
    x = torch.cat([prefix, p[LM + "model.embed_tokens.weight"][tokens].float()], dim=1)
    for i in range(c["num_hidden_layers"]):
        pre = f"{LM}model.layers.{i}."
        x = x + attention(rms_norm(x, p, pre + "input_layernorm.weight", eps), p,
                          pre + "self_attn.", c, prec)
        hn = rms_norm(x, p, pre + "post_attention_layernorm.weight", eps)
        x = x + (mlp(hn, p, pre + "mlp.", prec) if i < c["first_k_dense_replace"]
                 else moe(hn, p, pre + "mlp.", c, prec))
    x = rms_norm(x[:, prefix.shape[1]:], p, LM + "model.norm.weight", eps)
    return dense(x, p, LM + "lm_head", prec)


def balanced_bias(scores: torch.Tensor, k: int, steps: int = BALANCE_STEPS) -> torch.Tensor:
    """A correction bias under which the top k of ``scores`` (T, E) + bias
    give every expert T * k / E rows, or near it: aux-loss-free balancing's
    update (each expert's bias moves against its excess load), repeated on
    fixed scores with a shrinking step."""
    t, e = scores.shape
    target = t * k / e
    bias = torch.zeros(e, device=scores.device)
    step = float(scores.std())
    for _ in range(steps):
        ids = torch.topk(scores + bias, k, dim=-1).indices.reshape(-1)
        load = torch.zeros(e, device=scores.device).index_add_(
            0, ids, torch.ones(ids.numel(), device=scores.device))
        bias -= step * (load - target) / target
        step *= BALANCE_DECAY
    return bias


def balance_routers(p: Params, arch: Arch, canvases: torch.Tensor, tokens: torch.Tensor) -> None:
    """Sets each expert layer's ``e_score_correction_bias`` in ``p`` in place,
    as aux-loss-free balancing sets it in training: layer by layer, from the
    reference's own routing of the text positions of (B, H, W) uint8
    ``canvases`` read with (B, T) ``tokens`` after their image tokens, so
    that the layer spreads the decode's rows evenly over its experts
    (``balanced_bias``) before the next layer sees them. Random router rows
    meet hidden states that share a large common part, so without it a few
    experts take most rows (one took 9 times its share), and how many
    experts a step reads, so its time, depends on the seed."""
    c = arch.lm
    eps = c["rms_norm_eps"]
    with ref.float32_products(), torch.no_grad():
        enc = ref.encode(ref.model_input(canvases), p, arch.enc)
        prefix = image_tokens(enc, arch.grid(*canvases.shape[1:]), p, arch, ref.FLOAT32)
        n = prefix.shape[1]
        x = torch.cat([prefix, p[LM + "model.embed_tokens.weight"][tokens].float()], dim=1)
        for i in range(c["num_hidden_layers"]):
            pre = f"{LM}model.layers.{i}."
            x = x + attention(rms_norm(x, p, pre + "input_layernorm.weight", eps), p,
                              pre + "self_attn.", c, ref.FLOAT32)
            hn = rms_norm(x, p, pre + "post_attention_layernorm.weight", eps)
            if i < c["first_k_dense_replace"]:
                x = x + mlp(hn, p, pre + "mlp.", ref.FLOAT32)
                continue
            rows = hn[:, n:].reshape(-1, hn.shape[-1])
            scores = torch.sigmoid(rows @ _w(p, pre + "mlp.gate.weight").t())
            p[pre + "mlp.gate.e_score_correction_bias"].copy_(
                balanced_bias(scores, c["num_experts_per_tok"]))
            x = x + moe(hn, p, pre + "mlp.", c, ref.FLOAT32)


def parameter_count(arch: Arch) -> int:
    """Parameters of the language model and the projector."""
    return sum(math.prod(s) for s in param_shapes(arch).values())
