"""Model FLOPs of the ``mla_moe`` configuration from its shapes, the
``model_flops`` that ``mfu.batch`` reads in ``kimivl.batch``:
``portbench/flops.py``'s rules (dense products 2 * m * n * k,
attention 2 * (q . k width + v width) per head and causal pair; norms,
activations, the softmax and routing's sort not counted), of the model as
published, whatever the program computes: latent attention in its
unabsorbed form (K and V of each head from the latent, once a token), the
chosen experts and the shared ones at each token, the router's product, the
head at every decoded step (the prefill computes no logits).
"""

from __future__ import annotations

from portbench import flops
from portbench.reference.kimivl import Arch


def projector_flops(arch: Arch, tokens: int) -> float:
    c = arch.lm
    merged = arch.enc.enc_dim * c["merge"][0] * c["merge"][1]
    return 2.0 * tokens * (merged * c["projector_hidden"] + c["projector_hidden"] * c["hidden_size"])


def token_flops(arch: Arch) -> float:
    """The products of one token through every layer, attention's pairs
    left out."""
    c = arch.lm
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vdim, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                              c["kv_lora_rank"])
    attn = 2.0 * (d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + vdim)
                  + h * vdim * d)
    dense = 2.0 * 3 * d * c["intermediate_size"]
    expert = 2.0 * 3 * d * c["moe_intermediate_size"]
    moe = (2.0 * d * c["n_routed_experts"]
           + expert * (c["num_experts_per_tok"] + c["n_shared_experts"]))
    dense_layers = c["first_k_dense_replace"]
    return (c["num_hidden_layers"] * attn + dense_layers * dense
            + (c["num_hidden_layers"] - dense_layers) * moe)


def pair_flops(arch: Arch) -> float:
    """One causal (query, key) pair in every layer."""
    c = arch.lm
    return (c["num_hidden_layers"] * 2.0 * c["num_attention_heads"]
            * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"]))


def image_flops(arch: Arch, height: int, width: int, steps: int) -> float:
    """One image encoded, its prefix prefilled and ``steps`` tokens decoded
    greedily (BOS, at the prefix's end, is step 0's input)."""
    prefix = arch.prefix(height, width)
    n = prefix + steps
    return (flops.encoder_flops(arch.enc, height, width) + projector_flops(arch, prefix)
            + n * token_flops(arch) + n * (n + 1) / 2 * pair_flops(arch)
            + steps * 2.0 * arch.lm["hidden_size"] * arch.lm["vocab_size"])
