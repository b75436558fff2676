"""The ``mla_moe`` decoder (Kimi-VL-A3B's language model as a prefix decoder)
against its plain float32 reference (``tests/plain_kimivl.py``), at a tiny
size with every kind of layer present: hidden 64, 4 heads, latent rank 32,
8 routed experts (top 2) beside 1 shared, 1 dense and 3 expert layers,
vocabulary 257, on seeded weights, torch on one thread.

Tolerances: both sides compute in float32, the port on its own path (the
absorbed latent attention in decode, the routed product by blocks), so they
differ by float32 rounding in another order: 2e-5 of the largest |logit|
(about 100 float32 ulps of it). A bfloat16 compute type reads 1e-3 or more
there (``test_a_bfloat16_decoder_fails_the_tolerance``).
"""

import json

import pytest
import torch

from tests import plain_kimivl as plain
from texocr_tpu_torch import telemetry
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models.generate import (DecodeState, argmax, generate, greedy_decode,
                                              sampler)
from texocr_tpu_torch.models.moe import EXPERT_ROWS, Router, stack
from texocr_tpu_torch.models.ocr_model import OCRModel, create_model
from texocr_tpu_torch.ops import moe_experts

#: Relative to the largest |logit|: float32 rounding in another order.
TOL = 2e-5

DECODER = {
    "kind": "mla_moe", "vocab_size": 257, "max_position_embeddings": 64, "hidden_size": 64,
    "intermediate_size": 96, "moe_intermediate_size": 32, "num_hidden_layers": 4,
    "num_attention_heads": 4, "num_key_value_heads": 4, "n_shared_experts": 1,
    "n_routed_experts": 8, "ep_size": 1, "routed_scaling_factor": 2.446, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_rope_head_dim": 8, "v_head_dim": 16, "qk_nope_head_dim": 16,
    "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "num_experts_per_tok": 2,
    "moe_layer_freq": 1, "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "seq_aux": True, "hidden_act": "silu", "rms_norm_eps": 1e-5,
    "rope_theta": 800000, "rope_scaling": None, "attention_bias": False,
    "tie_word_embeddings": False, "projector_hidden": 64, "merge": [2, 2]}

CONFIG = {
    "img_size": [48, 128], "patch_size": 16, "bos_token": 254, "eos_token": 255,
    "trg_pad_idx": 256, "dtype": "float32", "param_dtype": "float32", "seed": 7,
    "tokenizer_path": "texocr_tpu_torch/tokenizer/vocab/tokenizer_clean_1k.txt",
    "encoder": {"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                "resnet_depths": [1, 1, 1], "resnet_channels": [128, 128, 256],
                "stem_channels": 32},
    "decoder": DECODER,
}
GRID = (3, 8)      # the encoder's grid of a (48, 128) canvas
PREFIX = 8         # (3, 8) padded to (4, 8), merged 2 x 2


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.reset()
    yield
    torch.set_num_threads(threads)


def seeded_params(seed: int = 0, cfg: dict = DECODER) -> dict:
    """The reference's parameters, drawn so that every layer's output is of
    order one: weights normal(0, 1 / sqrt(fan in)), embeddings normal(0, 1),
    norms 1 + normal(0, 0.1), biases normal(0, 0.1) (the routers' too).
    Each layer's routed experts are the slices of one tensor, as the
    benchmark makes them."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    stacked = {}
    for key, shape in plain.param_shapes(cfg, CONFIG["encoder"]["embed_dim"]).items():
        if ".experts." in key:
            layer, rest = key.split(".experts.")
            name = rest.split(".", 1)[1]
            group = stacked.setdefault((layer, name), [])
            group.append((key, shape))
            continue
        out[key] = draw(key, shape, gen)
    for (layer, name), items in stacked.items():
        block = draw(name, (len(items), *items[0][1]), gen)
        for i, (key, _) in enumerate(items):
            out[key] = block[i]
    return out


def draw(key, shape, gen):
    if key.endswith("norm.weight"):
        return 1.0 + 0.1 * torch.randn(shape, generator=gen)
    if key.endswith("bias"):
        return 0.1 * torch.randn(shape, generator=gen)
    if "embed_tokens" in key:
        return torch.randn(shape, generator=gen)
    return torch.randn(shape, generator=gen) / shape[-1] ** 0.5


def build(dtype="float32", seed=0):
    """(the port's model on the CPU with the seeded weights, the weights)."""
    model = create_model(dict(CONFIG, dtype=dtype), device="cpu", seed=3)
    params = seeded_params(seed)
    enc_keys = {k: v for k, v in model.state_dict().items() if k.startswith("encoder.")}
    model = create_model(dict(CONFIG, dtype=dtype), device="cpu", seed=3,
                         state_dict={**enc_keys, **params})
    return model.eval(), {**enc_keys, **params}


def images(n=3, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((n, 48, 128, 1), generator=gen)


def reference_logits(model, params, imgs, tokens):
    """The reference's logits at every text position of each row (the
    encoder is the port's: the reference starts from its output)."""
    with torch.no_grad():
        enc = model.encoder(imgs)
    return torch.stack([plain.text_logits(enc[i], GRID, tokens[i], params, DECODER)
                        for i in range(len(imgs))])


def gap(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def test_full_forward_logits_match_the_reference():
    model, params = build()
    imgs = images()
    targets = torch.randint(0, 254, (3, 11), generator=torch.Generator().manual_seed(2))
    targets[:, 0] = CONFIG["bos_token"]
    with torch.no_grad():
        logits, labels = model(imgs, targets)
    want = reference_logits(model, params, imgs, targets[:, :-1])
    assert logits.shape == (3, 10, 257) and torch.equal(labels, targets[:, 1:])
    assert gap(logits, want) < TOL


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_prefill_then_cached_decode_matches_the_full_forward(mode):
    model, params = build()
    imgs = images()
    with torch.no_grad():
        prefix = model.encode(imgs)
        assert prefix.shape == (3, PREFIX, 64)
        pick = argmax if mode == "greedy" else sampler(torch.Generator().manual_seed(5), 1.0)
        state = DecodeState(model, model.decoder_cross_kv(prefix), pick, bos_token=254,
                            eos_token=-1, pad_token=256, max_len=24, return_logits=True)
        for c in range(state.n_chunks):
            state.run_chunk(c)
        tokens, logits = state.result()
    inp = torch.cat([torch.full((3, 1), 254), tokens[:, :-1]], 1)
    want = reference_logits(model, params, imgs, inp)
    assert gap(logits, want) < TOL


def test_decode_state_starts_after_the_prefix():
    model, _ = build()
    with torch.no_grad():
        ctx = model.decoder_cross_kv(model.encode(images(2)))
    state = DecodeState(model, ctx, argmax, bos_token=254, eos_token=255, pad_token=256,
                        max_len=100)
    assert state.start == model.decoder_start(ctx) == PREFIX
    # The table holds 64 positions: the prefix's 8, then 56 decoded.
    assert state.max_len == 64 - PREFIX
    assert state.cache[0]["latent"].shape == (2, 64 - PREFIX, 32 + 8)
    assert len(state.cache) == DECODER["num_hidden_layers"]


def test_router_choices_and_weights_match_the_reference():
    _, params = build()
    cfg = ModelConfig.from_dict(CONFIG).decoder
    router = Router(cfg, torch.float32)
    pre = "language_model.model.layers.2.mlp."
    router.load_state_dict({"weight": params[pre + "gate.weight"],
                            "e_score_correction_bias": params[pre + "gate.e_score_correction_bias"]})
    x = torch.randn(200, 64, generator=torch.Generator().manual_seed(4))
    ids, w = router(x)
    want_ids, want_w = plain.router(x, params, pre, DECODER)
    assert torch.equal(ids.sort(-1).values, want_ids.sort(-1).values)
    order_a, order_b = ids.argsort(-1), want_ids.argsort(-1)
    assert torch.allclose(w.gather(1, order_a), want_w.gather(1, order_b), rtol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((200,), 2.446), rtol=1e-6)
    # The correction bias chooses but does not weigh: without it other
    # experts win for some rows, and the weights are the scores' either way.
    scores = torch.sigmoid(x @ params[pre + "gate.weight"].t())
    unbiased = torch.topk(scores, 2, dim=-1).indices
    assert (unbiased.sort(-1).values != ids.sort(-1).values).any()
    chosen = scores.gather(1, ids)
    assert torch.allclose(w, chosen / chosen.sum(-1, keepdim=True) * 2.446, rtol=1e-6)


@pytest.mark.parametrize("tokens", [40, 700])   # the decode tiles; the prefill tiles
def test_expert_product_plain_version_matches_the_expert_loop(tokens):
    _, params = build()
    pre = "language_model.model.layers.1.mlp."
    x = torch.randn(tokens, 64, generator=torch.Generator().manual_seed(6))
    ids, w = plain.router(x, params, pre, DECODER)
    weights = [torch.stack([params[f"{pre}experts.{e}.{n}.weight"] for e in range(8)])
               for n in ("gate_proj", "up_proj", "down_proj")]
    got, counts = moe_experts.routed(x, ids, w, *weights)
    want = plain.experts_loop(x, ids, w, params, pre, 8)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(counts, torch.bincount(ids.reshape(-1), minlength=8))
    block = moe_experts.tiles(tokens * 2, 8)["down"][0]
    assert block == (64 if tokens == 40 else 128)


def test_align_sorts_every_row_once_into_single_expert_blocks():
    ids = torch.randint(0, 8, (300, 2), generator=torch.Generator().manual_seed(8))
    block = 64
    sorted_ids, experts, padded, counts = moe_experts.align(ids, 8, block)
    n = ids.numel()
    assert sorted_ids.shape[0] == -(-(n + 8 * (block - 1)) // block) * block
    real = sorted_ids[sorted_ids < n].long()
    assert torch.equal(real.sort().values, torch.arange(n))       # each row once, none dropped
    flat = ids.reshape(-1)
    for b in range(int(padded) // block):
        rows = sorted_ids[b * block: (b + 1) * block].long()
        rows = rows[rows < n]
        assert (flat[rows] == experts[b]).all()                    # one expert a block
        assert torch.equal(rows, rows.sort().values)               # flat order kept
    assert int(padded) == int(((counts + block - 1) // block * block).sum())
    assert (sorted_ids[int(padded):] == n).all()


def test_the_kernels_refuse_what_they_do_not_take():
    x = torch.zeros(4, 64)
    ids = torch.zeros(4, 2, dtype=torch.int64)
    w = torch.zeros(4, 2)
    weights = (torch.zeros(8, 32, 64), torch.zeros(8, 32, 64), torch.zeros(8, 64, 32))
    with pytest.raises(ValueError, match="bfloat16"):
        moe_experts._check(x, ids, w, *weights)
    bf = [t.bfloat16() for t in weights]
    with pytest.raises(ValueError, match="shapes"):
        moe_experts._check(x.bfloat16(), ids, w, bf[0], bf[1], bf[0])
    with pytest.raises(ValueError, match="int64"):
        moe_experts._check(x.bfloat16(), ids.int(), w, *bf)


@pytest.mark.parametrize("tokens, ms, bound_by", [(256, 0.3372, "bytes"),
                                                  (256 * 160, 4.2996, "operations")])
def test_the_expert_bound_at_kimi_vl_widths(tokens, ms, bound_by):
    """One expert layer's least time at decode (every expert's weights read)
    and at prefill (the products), as phase 3c of ``chip_smoke.py`` prints it."""
    from texocr_tpu_torch.ops.bench import moe_bound_ms

    got, by = moe_bound_ms(tokens, 64, 1408, 2048, 6)
    assert by == bound_by and got == pytest.approx(ms, rel=1e-4)


@pytest.mark.parametrize("kind,key", [("texocr", "hidden_size"), ("mla_moe", "embed_dim")])
def test_a_decoder_key_the_kind_does_not_read_raises(kind, key):
    cfg = json.loads(json.dumps(CONFIG))
    if kind == "texocr":
        cfg.update(vocab_size=1000, max_length=64)
        cfg["decoder"] = {"embed_dim": 32, "num_layers": 1, "heads": 2}
    cfg["decoder"][key] = 1
    with pytest.raises(ValueError, match=f"not read by kind '{kind}'.*{key}"):
        ModelConfig.from_dict(cfg)


@pytest.mark.parametrize("key,value", [("q_lora_rank", 1536), ("n_group", 8),
                                       ("scoring_func", "softmax"), ("rope_scaling", {})])
def test_a_published_value_the_port_does_not_implement_raises(key, value):
    with pytest.raises(ValueError, match=key):
        ModelConfig.from_dict(dict(CONFIG, decoder=dict(DECODER, **{key: value})))


def test_the_published_keys_load_strictly_and_in_place():
    model, params = build()
    state = model.state_dict()
    want = plain.param_shapes(DECODER, 32)
    assert {k: tuple(v.shape) for k, v in state.items() if not k.startswith("encoder.")} == want
    assert "language_model.model.layers.3.mlp.experts.7.down_proj.weight" in state
    # The experts of a layer, consecutive slices of one tensor, are held
    # without a copy; the other weights are the state dict's own tensors.
    experts = model.language_model.model.layers[1].mlp.experts
    pre = "language_model.model.layers.1.mlp.experts."
    assert experts.gate_proj.data_ptr() == params[pre + "0.gate_proj.weight"].data_ptr()
    head = model.language_model.lm_head.weight
    assert head.data_ptr() == params["language_model.lm_head.weight"].data_ptr()
    # Separate tensors are stacked into one.
    copies = {k: v.clone() for k, v in params.items()}
    other = OCRModel(ModelConfig.from_dict(CONFIG), device="cpu", seed=3,
                     state_dict={**{k: v for k, v in state.items() if k.startswith("encoder.")},
                                 **copies})
    assert torch.equal(other.language_model.model.layers[1].mlp.experts.gate_proj,
                       experts.gate_proj)
    assert stack([torch.ones(2), torch.ones(2)]).shape == (2, 2)


def test_a_seeded_model_is_drawn_without_a_state_dict():
    a = create_model(CONFIG, device="cpu", seed=11)
    b = create_model(CONFIG, device="cpu", seed=11)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert not v.is_meta and torch.equal(v, w), k
    lm = a.language_model
    assert torch.equal(lm.model.norm.weight, torch.ones(64))
    assert float(lm.lm_head.weight.detach().std()) == pytest.approx(0.02, rel=0.1)


def test_expert_rows_count_every_routed_row():
    """(prefix + steps) rows an image, each routed to k experts in each
    expert layer: the count the benchmark holds its window to."""
    model, _ = build()
    steps, batch = 12, 3
    with torch.no_grad():
        greedy_decode(model, model.encode(images(batch)), bos_token=254, eos_token=-1,
                      pad_token=256, max_len=steps)
    rows = telemetry.device_counters()[EXPERT_ROWS]
    assert rows.shape == (3, 8)
    assert int(rows.sum()) == batch * (PREFIX + steps) * 2 * 3
    assert (rows.sum(1) == batch * (PREFIX + steps) * 2).all()
    assert telemetry.counters()["moe.layers"] == 3 * (1 + steps)


def test_beam_search_a_mesh_and_the_texocr_stack_raise():
    model, _ = build()
    with pytest.raises(NotImplementedError, match="beam"):
        generate(model, images(1), max_len=4, mode="beam")
    with pytest.raises(NotImplementedError, match="mesh"):
        OCRModel(ModelConfig.from_dict(CONFIG), device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="does not train"):
        model.dec


def test_the_wrapper_decodes_on_its_own_vocabulary():
    from texocr_tpu_torch.serving.wrapper import TexOCR

    model, params = build()
    engine = TexOCR(CONFIG, device="cpu", state_dict=params)
    assert engine.model.config.decoder.vocab_size == 257
    u8 = torch.randint(0, 256, (2, 48, 128, 1), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(9))
    tokens = engine.generate_batch(u8, max_len=6)
    with torch.no_grad():
        want = greedy_decode(model, model.encode(1.0 - u8.float() / 255.0), bos_token=254,
                             eos_token=255, pad_token=256, max_len=6)
    assert torch.equal(tokens, want)
    ptr = engine.model.language_model.lm_head.weight.data_ptr()
    assert ptr == params["language_model.lm_head.weight"].data_ptr()


def test_a_bfloat16_decoder_fails_the_tolerance():
    """The tolerance sees a lower precision: the same decode computed in
    bfloat16 (the weights as they are) lies far outside it."""
    model, params = build(dtype="bfloat16")
    imgs = images()
    with torch.no_grad():
        tokens, logits = greedy_decode(model, model.encode(imgs), bos_token=254, eos_token=-1,
                                       pad_token=256, max_len=8, return_logits=True)
    inp = torch.cat([torch.full((3, 1), 254), tokens[:, :-1]], 1)
    assert gap(logits, reference_logits(model, params, imgs, inp)) > 50 * TOL
