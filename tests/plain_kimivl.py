"""Kimi-VL-A3B's language model and image projector in plain float32 PyTorch:
the CPU tests' yardstick for texocr_tpu_torch's ``mla_moe`` decoder.

Written from the published ``config.json``
(huggingface.co/moonshotai/Kimi-VL-A3B-Instruct) and the DeepSeek-V3 layers
its language model runs. It imports nothing of the port or of JAX, runs one
sequence at a time with no cache, computes latent attention in its
unabsorbed form (each head's K and V from the latent) and the experts in a
loop. Parameters are a dict keyed as in the published checkpoint.

- Attention: q = W_q x (nope | rope); [c; k_pe] = W_kva x, c RMS-normalised;
  [k_nope; v] = W_kvb c per head; q_pe and k_pe rotated (DeepSeek-V3's
  rotary embedding: interleaved pairs gathered into halves, then x cos +
  rotate_half(x) sin); causal softmax((q . k) / sqrt(nope + rope)) v; W_o.
- Expert layer: s = sigmoid(W_g x); the top k of s + b; weights s / sum(s)
  times ``routed_scaling_factor``; sum of the chosen experts' SwiGLU MLPs,
  each weighted, plus the shared experts' MLP.
- Projector: the encoder's grid without CLS, LayerNorm, zero-padded to the
  merge block, each block's patches side by side (row-major), linear, exact
  GELU, linear.

Departure from the published model: its vision tower (MoonViT) is not here;
the image tokens come from the port's own encoder output.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
LM = "language_model."


@contextlib.contextmanager
def float32_products():
    """float32 products in float32 within the block (TF32 off), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def param_shapes(cfg: dict, enc_dim: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the language model and the projector, under the
    published checkpoint's key, with its shape."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vdim, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                              cfg["v_head_dim"], cfg["kv_lora_rank"])
    e, inter = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    merged = enc_dim * cfg["merge"][0] * cfg["merge"][1]
    out = {"multi_modal_projector.pre_norm.weight": (enc_dim,),
           "multi_modal_projector.pre_norm.bias": (enc_dim,),
           "multi_modal_projector.linear_1.weight": (cfg["projector_hidden"], merged),
           "multi_modal_projector.linear_1.bias": (cfg["projector_hidden"],),
           "multi_modal_projector.linear_2.weight": (d, cfg["projector_hidden"]),
           "multi_modal_projector.linear_2.bias": (d,),
           LM + "model.embed_tokens.weight": (cfg["vocab_size"], d),
           LM + "model.norm.weight": (d,),
           LM + "lm_head.weight": (cfg["vocab_size"], d)}

    def mlp(pre, width):
        out.update({pre + "gate_proj.weight": (width, d), pre + "up_proj.weight": (width, d),
                    pre + "down_proj.weight": (d, width)})

    for i in range(cfg["num_hidden_layers"]):
        pre = f"{LM}model.layers.{i}."
        out.update({pre + "input_layernorm.weight": (d,),
                    pre + "post_attention_layernorm.weight": (d,),
                    pre + "self_attn.q_proj.weight": (h * (nope + rope), d),
                    pre + "self_attn.kv_a_proj_with_mqa.weight": (rank + rope, d),
                    pre + "self_attn.kv_a_layernorm.weight": (rank,),
                    pre + "self_attn.kv_b_proj.weight": (h * (nope + vdim), rank),
                    pre + "self_attn.o_proj.weight": (d, h * vdim)})
        if i < cfg["first_k_dense_replace"]:
            mlp(pre + "mlp.", cfg["intermediate_size"])
            continue
        out.update({pre + "mlp.gate.weight": (e, d),
                    pre + "mlp.gate.e_score_correction_bias": (e,)})
        for j in range(e):
            mlp(f"{pre}mlp.experts.{j}.", inter)
        mlp(pre + "mlp.shared_experts.", inter * cfg["n_shared_experts"])
    return out


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotary(x, positions, theta):
    """x (N, ..., d) rotated at the (N,) positions."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2).float() / d))
    freqs = torch.outer(positions.float(), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    cos, sin = emb.cos().view(shape), emb.sin().view(shape)
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rotated * sin


def attention(x, p: Params, pre: str, cfg: dict):
    """Causal latent attention over one sequence's (N, D) rows."""
    n = x.shape[0]
    h = cfg["num_attention_heads"]
    nope, rope, vdim, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                              cfg["v_head_dim"], cfg["kv_lora_rank"])
    pos = torch.arange(n)
    q = (x @ p[pre + "q_proj.weight"].t()).view(n, h, nope + rope)
    kv = x @ p[pre + "kv_a_proj_with_mqa.weight"].t()
    c = rms_norm(kv[:, :rank], p[pre + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_pe = rotary(kv[:, rank:][:, None], pos, cfg["rope_theta"])
    kvb = (c @ p[pre + "kv_b_proj.weight"].t()).view(n, h, nope + vdim)
    q = torch.cat([q[..., :nope], rotary(q[..., nope:], pos, cfg["rope_theta"])], -1)
    k = torch.cat([kvb[..., :nope], k_pe.expand(n, h, rope)], -1)
    scores = torch.einsum("nhd,mhd->hnm", q, k) * (nope + rope) ** -0.5
    scores = scores.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), float("-inf"))
    out = torch.einsum("hnm,mhd->nhd", torch.softmax(scores, -1), kvb[..., nope:])
    return out.reshape(n, h * vdim) @ p[pre + "o_proj.weight"].t()


def mlp(x, p: Params, pre: str):
    return (F.silu(x @ p[pre + "gate_proj.weight"].t()) * (x @ p[pre + "up_proj.weight"].t())
            ) @ p[pre + "down_proj.weight"].t()


def router(x, p: Params, pre: str, cfg: dict):
    """(N, D) rows -> (their chosen experts (N, k), the choices' weights)."""
    scores = torch.sigmoid(x @ p[pre + "gate.weight"].t())
    ids = torch.topk(scores + p[pre + "gate.e_score_correction_bias"],
                     cfg["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, ids)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return ids, w * cfg["routed_scaling_factor"]


def experts_loop(x, ids, weights, p: Params, pre: str, n_experts: int):
    """sum_i w_i E_i(x) over each row's choices, one expert at a time."""
    out = torch.zeros_like(x)
    for e in range(n_experts):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel():
            out[rows] += weights[rows, slot][:, None] * mlp(x[rows], p, f"{pre}experts.{e}.")
    return out


def moe(x, p: Params, pre: str, cfg: dict):
    ids, w = router(x, p, pre, cfg)
    return (experts_loop(x, ids, w, p, pre, cfg["n_routed_experts"])
            + mlp(x, p, pre + "shared_experts."))


def language_model(embeds, p: Params, cfg: dict):
    """One sequence's (N, D) input rows at positions 0..N-1 -> (N, V) logits."""
    x = embeds
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{LM}model.layers.{i}."
        x = x + attention(rms_norm(x, p[pre + "input_layernorm.weight"], eps), p,
                          pre + "self_attn.", cfg)
        h = rms_norm(x, p[pre + "post_attention_layernorm.weight"], eps)
        x = x + (mlp(h, p, pre + "mlp.") if i < cfg["first_k_dense_replace"]
                 else moe(h, p, pre + "mlp.", cfg))
    return rms_norm(x, p[LM + "model.norm.weight"], eps) @ p[LM + "lm_head.weight"].t()


def image_tokens(enc, grid: Tuple[int, int], p: Params, cfg: dict):
    """One image's encoder output (1 + h * w, E) on its (h, w) grid -> (P, D)."""
    h, w = grid
    mh, mw = cfg["merge"]
    pre = "multi_modal_projector."
    d = enc.shape[-1]
    x = F.layer_norm(enc[1:], (d,), p[pre + "pre_norm.weight"], p[pre + "pre_norm.bias"], 1e-5)
    x = F.pad(x.view(h, w, d), (0, 0, 0, -w % mw, 0, -h % mh))
    gh, gw = x.shape[0] // mh, x.shape[1] // mw
    x = x.view(gh, mh, gw, mw, d).permute(0, 2, 1, 3, 4).reshape(gh * gw, mh * mw * d)
    x = F.gelu(x @ p[pre + "linear_1.weight"].t() + p[pre + "linear_1.bias"])
    return x @ p[pre + "linear_2.weight"].t() + p[pre + "linear_2.bias"]


def text_logits(enc, grid, tokens, p: Params, cfg: dict):
    """One image's encoder output and its text ``tokens`` (T,) (BOS first)
    -> the (T, V) logits at the text positions."""
    with float32_products():
        prefix = image_tokens(enc.float(), grid, p, cfg)
        embeds = torch.cat([prefix, p[LM + "model.embed_tokens.weight"][tokens]], 0)
        return language_model(embeds, p, cfg)[prefix.shape[0]:]
