"""Attention maps, hidden states and embeddings against the JAX package, and
the attention-maps tool against the JAX tool (tools/attention_maps.py), at
the tiny config in float32, JAX-initialised weights carried across.

Tolerances: maps 1e-5 (rtol and atol); attention outputs, hidden states,
embeddings and logits 1e-4 (float32 sums taken in another order); the tool's
overlays within 2 grey levels of PIL's bilinear resize; PNGs exact.
"""

import importlib.util
import io
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.tiny import TINY_CONFIG
from texocr_tpu.config import ModelConfig as JaxModelConfig
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.models.attention import MultiHeadAttention as JaxMHA
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.models.attention import MultiHeadAttention
from texocr_tpu_torch.serving.image_io import decode_png, encode_png
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH
from texocr_tpu_torch.tools import attention_maps

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
BOS, EOS, PAD = 48, 47, 49
# The JAX tool's test config: the tiny widths on a (32, 128) canvas, vocab 1000.
TOOL_CONFIG = dict(TINY_CONFIG, img_size=(32, 128), vocab_size=1000, trg_pad_idx=999,
                   bos_token=998, eos_token=997, max_length=64)
SUMMARY_KEYS = ["grid", "latex", "per_token", "tokens"]  # the JAX tool's summary.json
PER_TOKEN_KEYS = ["cls_weight", "id", "peak_patch_yx", "t", "text"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_attention_maps", os.path.join(REPO, "tools", "attention_maps.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _t(x):
    return torch.from_numpy(np.array(x))


# -- MultiHeadAttention(return_maps) ------------------------------------------------

def _mha_pair(causal, seed=0):
    jax_mha = JaxMHA(embed_dim=32, heads=2, causal=causal)
    x = jnp.zeros((1, 5, 32))
    params = jax.tree.map(np.asarray, jax_mha.init(jax.random.PRNGKey(seed), x))["params"]
    port = MultiHeadAttention(32, heads=2, causal=causal)
    port.load_state_dict({
        "q.weight": _t(params["q"]["kernel"].T), "k.weight": _t(params["k"]["kernel"].T),
        "v.weight": _t(params["v"]["kernel"].T),
        "fc_out.0.weight": _t(params["fc_out"]["kernel"].T),
        "fc_out.0.bias": _t(params["fc_out"]["bias"]),
    }, strict=True)
    return jax_mha, {"params": params}, port


MAP_CASES = {
    "self": dict(causal=False, mask=False, cross=False),
    "self_mask": dict(causal=False, mask=True, cross=False),
    "causal": dict(causal=True, mask=False, cross=False),
    "causal_mask": dict(causal=True, mask=True, cross=False),
    "cross": dict(causal=False, mask=False, cross=True),
    "cross_masks": dict(causal=False, mask=True, cross=True),
}


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_return_maps_match_jax(case):
    """Pre-softmax (scaled, unmasked) and post-softmax maps, and the output,
    against JAX's; a padded query row (every key masked) is uniform in both."""
    spec = MAP_CASES[case]
    jax_mha, params, port = _mha_pair(spec["causal"])
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    context = rng.normal(size=(2, 9, 32)).astype(np.float32) if spec["cross"] else None
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    context_mask = np.ones((2, 9), bool)
    context_mask[0, 7:] = False
    kw = {}
    if spec["mask"]:
        kw["mask"] = mask
        if spec["cross"]:
            kw["context_mask"] = context_mask
    if spec["cross"]:
        kw["context"] = context
    want_out, want = jax_mha.apply(params, jnp.asarray(x),
                                   **{k: jnp.asarray(v) for k, v in kw.items()},
                                   return_maps=True)
    with torch.no_grad():
        out, got = port(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kw.items()},
                        return_maps=True)
    assert sorted(got) == ["post_softmax_attn", "pre_softmax_attn"]
    for name in got:
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **MAP_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got["post_softmax_attn"].sum(-1).numpy(), 1.0, rtol=1e-5)
    with torch.no_grad():  # the maps do not change the output
        plain = port(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)


# -- the model: hidden states, embeddings, attention maps ----------------------------

_PAIRS = {}


def _pair(name):
    """(JAX model, parameters, port) at the tiny config with remat on."""
    overrides = {"hybrid": {}, "no_cross": dict(decoder=dict(TINY_CONFIG["decoder"],
                                                              cross_attend=False))}[name]
    if name not in _PAIRS:
        cfg = dict(TINY_CONFIG, remat=True, **overrides)
        jax_model = JaxOCRModel(JaxModelConfig.from_dict(cfg))
        images = np.zeros((2, 32, 64, 1), np.float32)
        params = jax.jit(jax_model.init)(jax.random.PRNGKey(2), jnp.asarray(images),
                                         jnp.full((2, 8), PAD, jnp.int32))
        params = jax.tree.map(np.asarray, params)
        port = OCRModel(ModelConfig.from_dict(cfg), device="cpu")
        port.load_state_dict(state_dict_from_jax(params), strict=True)
        _PAIRS[name] = (jax_model, params, port)
    return _PAIRS[name]


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(2, 32, 64, 1)).astype(np.float32)
    tokens = rng.integers(0, 47, (2, 10)).astype(np.int32)
    tokens[:, 0] = BOS
    mask = np.ones((2, 10), bool)
    mask[0, 7:] = False
    return images, tokens, mask


@pytest.mark.parametrize("stack", ["decoder", "encoder"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_return_hidden_matches_jax_with_remat_on(stack, with_mask):
    """``hiddens`` (each self-attention sub-layer's input) and
    ``attn_intermediates`` (each attention sub-layer's maps) against JAX's;
    remat is on in both configs and gradients are on in the port."""
    jax_model, params, port = _pair("hybrid")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, 32)).astype(np.float32)
    enc = rng.normal(size=(2, 9, 32)).astype(np.float32)
    mask = _inputs()[2] if with_mask else None
    kw = {"enc": enc, "mask": mask} if stack == "decoder" else {"mask": mask}

    def run(m, x, **kw):
        layers = m.decoder.attn_layers if stack == "decoder" else m.encoder.attn_layers
        return layers(x, return_hidden=True, **kw)

    want_x, want = jax_model.apply(params, jnp.asarray(x), method=run,
                                   **{k: None if v is None else jnp.asarray(v)
                                      for k, v in kw.items()})
    layers = port.dec.attn_layers if stack == "decoder" else port.encoder.attn_layers
    assert layers.remat and torch.is_grad_enabled()
    got_x, got = layers(torch.from_numpy(x), return_hidden=True,
                        **{k: None if v is None else torch.from_numpy(v)
                           for k, v in kw.items()})
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x), **TOL)
    n_layers = TINY_CONFIG[stack]["num_layers"]
    per_layer = 2 if stack == "decoder" else 1
    assert len(got["hiddens"]) == len(want["hiddens"]) == n_layers
    assert len(got["attn_intermediates"]) == len(want["attn_intermediates"]) == (
        per_layer * n_layers)
    for a, b in zip(got["hiddens"], want["hiddens"]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for a, b in zip(got["attn_intermediates"], want["attn_intermediates"]):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_allclose(a[name].detach().numpy(), np.asarray(b[name]),
                                       **MAP_TOL, err_msg=name)


@pytest.mark.parametrize("embeddings, attn", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("name", ["hybrid", "no_cross"])
def test_decoder_return_embeddings_and_attn_match_jax(name, embeddings, attn):
    """The decoder's hidden states after the final norm in place of the
    logits, and the post-softmax maps of every attention sub-layer: (self,
    cross) per layer, or self alone without cross-attention."""
    jax_model, params, port = _pair(name)
    images, tokens, mask = _inputs()
    enc = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)

    def run(m, tokens, enc, mask):
        return m.decoder(tokens, enc=enc, mask=mask, return_embeddings=embeddings,
                         return_attn=attn)

    want = jax_model.apply(params, jnp.asarray(tokens), enc, jnp.asarray(mask), method=run)
    with torch.no_grad():
        got = port.dec(torch.from_numpy(tokens).long(), _t(enc), mask=torch.from_numpy(mask),
                       return_embeddings=embeddings, return_attn=attn)
    if attn:
        (got, got_maps), (want, want_maps) = got, want
        per_layer = 2 if name == "hybrid" else 1
        assert len(got_maps) == len(want_maps) == per_layer * TINY_CONFIG["decoder"]["num_layers"]
        for a, b in zip(got_maps, want_maps):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MAP_TOL)
    width = TINY_CONFIG["decoder"]["embed_dim"] if embeddings else TINY_CONFIG["vocab_size"]
    assert got.shape == (2, 10, width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the attention-maps tool ------------------------------------------------------------

def _tool_pair(embed_layer):
    cfg = dict(TOOL_CONFIG, encoder=dict(TOOL_CONFIG["encoder"], embed_layer=embed_layer))
    jax_model = JaxOCRModel(JaxModelConfig.from_dict(cfg))
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 128, 1)),
                                     jnp.full((1, 4), 999, jnp.int32))
    params = jax.tree.map(np.asarray, params)
    port = OCRModel(ModelConfig.from_dict(cfg), device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return (types.SimpleNamespace(model=jax_model, params=params),
            types.SimpleNamespace(model=port, device=torch.device("cpu")))


@pytest.mark.parametrize("embed_layer", ["hybrid", "patch"])
def test_cross_attention_maps_match_the_jax_tool(embed_layer):
    jax_engine, engine = _tool_pair(embed_layer)
    rng = np.random.default_rng(5)
    canvas = np.where(rng.random((1, 32, 128, 1)) < 0.2, 0, 255).astype(np.uint8)
    ids = [5, 17, 42, 7]
    want = _jax_tool().cross_attention_maps(jax_engine, canvas, ids)
    got = attention_maps.cross_attention_maps(engine, canvas, ids)
    gh, gw = engine.model.encoder.feature_grid(32, 128)
    assert (gh, gw) == (2, 8)
    assert got.dtype == np.float32
    assert got.shape == want.shape == (1, 2, len(ids) + 1, gh * gw + 1)
    np.testing.assert_allclose(got, want, **MAP_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_cross_attention_maps_need_cross_attention():
    cfg = dict(TOOL_CONFIG, decoder=dict(TOOL_CONFIG["decoder"], cross_attend=False))
    engine = types.SimpleNamespace(model=OCRModel(ModelConfig.from_dict(cfg), device="cpu"),
                                   device=torch.device("cpu"))
    with pytest.raises(ValueError, match="cross_attend"):
        attention_maps.cross_attention_maps(engine, np.zeros((1, 32, 128, 1), np.uint8), [5])


@pytest.mark.parametrize("canvas, grid", [((32, 128), (2, 8)), ((160, 1008), (10, 63)),
                                          ((48, 64), (3, 4))])
def test_heat_to_overlay_is_within_2_grey_levels_of_the_jax_tools(canvas, grid):
    rng = np.random.default_rng(6)
    base = rng.integers(0, 256, canvas).astype(np.uint8)
    heat = rng.random(grid).astype(np.float32)
    want = np.asarray(_jax_tool().heat_to_overlay(base, heat))
    got = attention_maps.heat_to_overlay(base, heat)
    assert got.dtype == np.uint8 and got.shape == (*canvas, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


def test_cli_writes_overlays_and_the_jax_tools_summary(tmp_path):
    """The CLI on the CPU with a .json config and an .npz checkpoint: one
    overlay PNG per token (up to --max_tokens) at canvas size, and a
    summary.json with the JAX tool's keys."""
    jax_engine, engine = _tool_pair("hybrid")
    state = {k: v.numpy() for k, v in engine.model.state_dict().items()}
    # Push EOS down so the decode runs to --max_len.
    state["decoder.net.to_logits.bias"][997] = -1e4
    np.savez(tmp_path / "model.npz", **state)
    cfg = dict(TOOL_CONFIG, tokenizer_path=DEFAULT_VOCAB_PATH)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(7)
    img = np.where(rng.random((30, 100)) < 0.2, 0, 255).astype(np.uint8)
    (tmp_path / "eq.png").write_bytes(encode_png(img))
    out = tmp_path / "maps"
    rc = attention_maps.main([str(tmp_path / "eq.png"), "--config", str(tmp_path / "cfg.json"),
                              "--checkpoint", str(tmp_path / "model.npz"), "--out", str(out),
                              "--max_len", "6", "--max_tokens", "4", "--layer", "0",
                              "--device", "cpu"])
    assert rc == 0
    summary = json.loads((out / "summary.json").read_text())
    assert sorted(summary) == SUMMARY_KEYS
    assert len(summary["tokens"]) == 6 and summary["grid"] == [2, 8]
    assert [sorted(p) for p in summary["per_token"]] == [PER_TOKEN_KEYS] * 4
    assert sorted(os.listdir(out)) == sorted([f"token_{t:03d}.png" for t in range(4)]
                                             + ["summary.json"])
    for t in range(4):
        grey = decode_png((out / f"token_{t:03d}.png").read_bytes())
        assert grey.shape == (32, 128)
        assert 0 <= summary["per_token"][t]["peak_patch_yx"][0] < 2
        assert 0.0 <= summary["per_token"][t]["cls_weight"] <= 1.0


@pytest.mark.parametrize("shape", [(7, 13), (32, 128, 3), (1, 1), (5, 300, 3)])
def test_encode_png_round_trips_through_decode_png_and_pil(shape):
    from PIL import Image

    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    data = encode_png(img)
    with Image.open(io.BytesIO(data)) as pil:
        assert pil.mode == ("L" if img.ndim == 2 else "RGB")
        np.testing.assert_array_equal(np.asarray(pil), img)
        grey = np.asarray(pil.convert("L"))
    got = decode_png(data)
    if img.ndim == 2:
        np.testing.assert_array_equal(got, img)
    else:  # read back as its luma, as PIL's convert("L")
        np.testing.assert_array_equal(got, grey)


def test_encode_png_refuses_other_arrays():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 4), np.uint8))
