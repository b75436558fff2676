"""The model variants against the JAX package at the tiny config, in float32:
the patch embed (``encoder.embed_layer: patch``), the dense + gelu decoder MLP
(``glu: false``), both together, and the decoder without cross-attention
(``decoder.cross_attend: false``). JAX-initialised parameters are carried
across with state_dict_from_jax and loaded with ``strict=True``.

Tolerances: 1e-4 (rtol and atol) on encodes, logits and step logits, float32
sums taken in another order; gradients 1e-4 relative and 1e-4 of the tensor's
largest; tokens exact. The JAX encode runs the Pallas kernel in interpret
mode, the port's the kernel's plain version (CPU tensors).
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.tiny import TINY_CONFIG
from texocr_tpu.config import ModelConfig as JaxModelConfig
from texocr_tpu.config import model_config_from_yaml as jax_model_config_from_yaml
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.models.beam import beam_decode as jax_beam_decode
from texocr_tpu.models.generate import greedy_decode as jax_greedy_decode
from texocr_tpu.training.losses import sequence_ce_loss as jax_loss
from texocr_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from texocr_tpu.training.train_step import create_train_state as jax_create_train_state
from texocr_tpu.training.train_step import make_train_step as jax_make_train_step
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.config import ModelConfig, model_config_from_yaml
from texocr_tpu_torch.models import (
    OCRModel,
    beam_decode,
    create_model,
    generate,
    greedy_decode,
    sampled_decode,
)
from texocr_tpu_torch.serving import TexOCR
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH
from texocr_tpu_torch.training.losses import sequence_ce_loss
from texocr_tpu_torch.training.optimizers import get_optimizer
from texocr_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
    step_generator,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
BOS, EOS, PAD = 48, 47, 49

VARIANTS = {
    "patch": dict(encoder=dict(TINY_CONFIG["encoder"], embed_layer="patch")),
    "glu_false": dict(glu=False),
    "patch_glu_false": dict(encoder=dict(TINY_CONFIG["encoder"], embed_layer="patch"),
                            glu=False),
    "no_cross": dict(decoder=dict(TINY_CONFIG["decoder"], cross_attend=False)),
}
DECODING = ["patch", "glu_false", "patch_glu_false"]


def _config(name, **extra):
    return dict(TINY_CONFIG, use_flash_attention=True, **VARIANTS[name], **extra)


def _batch(seed, b=2, t=12, hw=(32, 64)):
    """Images and BOS ... EOS targets with PAD tails of different lengths."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, *hw, 1)).astype(np.float32)
    targets = np.full((b, t), PAD, np.int32)
    for i in range(b):
        n = int(rng.integers(2, t - 2))
        targets[i, 0] = BOS
        targets[i, 1: n + 1] = rng.integers(0, 47, n)
        targets[i, n + 1] = EOS
    return images, targets


_PAIRS = {}


def _pair(name):
    """(JAX model, its parameters, the port loaded with them), built once per
    variant."""
    if name not in _PAIRS:
        jax_model = JaxOCRModel(JaxModelConfig.from_dict(_config(name)))
        images, targets = _batch(0)
        params = jax.jit(jax_model.init)(jax.random.PRNGKey(7), jnp.asarray(images),
                                         jnp.asarray(targets))
        params = jax.tree.map(np.asarray, params)
        port = OCRModel(ModelConfig.from_dict(_config(name)), device="cpu")
        port.load_state_dict(state_dict_from_jax(params), strict=True)
        _PAIRS[name] = (jax_model, params, port)
    return _PAIRS[name]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_teacher_forced_logits_match_jax(name):
    jax_model, params, port = _pair(name)
    images, targets = _batch(1)
    want, want_labels = jax_model.apply(params, jnp.asarray(images), jnp.asarray(targets))
    with torch.no_grad():
        got, labels = port(torch.from_numpy(images), torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))


@pytest.mark.parametrize("name", ["patch", "glu_false", "patch_glu_false"])
def test_encode_matches_jax_flash_interpret(name):
    jax_model, params, port = _pair(name)
    images, _ = _batch(2)
    want = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    with torch.no_grad():
        got = port.encode(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw", [(40, 72), (16, 48)])
def test_patch_embed_crops_to_whole_patches_as_jax(hw):
    """Canvases off the patch grid: both crop to (H // p) x (W // p) patches
    and use the positional table's top-left block."""
    jax_model, params, port = _pair("patch")
    images, _ = _batch(3, hw=hw)
    want = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    with torch.no_grad():
        got = port.encode(torch.from_numpy(images))
    assert got.shape[1] == (hw[0] // 16) * (hw[1] // 16) + 1
    assert port.encoder.feature_grid(*hw) == (hw[0] // 16, hw[1] // 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", DECODING)
@pytest.mark.parametrize("eos", [-1, EOS])
def test_greedy_tokens_match_jax(name, eos):
    jax_model, params, port = _pair(name)
    images, _ = _batch(4)
    enc = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    want_tokens, want_logits = jax_greedy_decode(
        jax_model, params, enc, bos_token=BOS, eos_token=eos, pad_token=PAD, max_len=20,
        return_logits=True)
    tokens, logits = greedy_decode(port, torch.from_numpy(np.array(enc)), bos_token=BOS,
                                   eos_token=eos, pad_token=PAD, max_len=20,
                                   return_logits=True)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)


@pytest.mark.parametrize("name", DECODING)
def test_generate_from_images_matches_jax_greedy(name):
    """``generate`` encodes through the port's own encoder: the tokens of the
    JAX encode and greedy decode."""
    jax_model, params, port = _pair(name)
    images, _ = _batch(5)
    enc = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    want = jax_greedy_decode(jax_model, params, enc, bos_token=BOS, eos_token=EOS,
                             pad_token=PAD, max_len=20)
    got = generate(port, torch.from_numpy(images), max_len=20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_beam_tokens_match_jax():
    jax_model, params, port = _pair("patch_glu_false")
    images, _ = _batch(6)
    enc = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    kw = dict(bos_token=BOS, eos_token=EOS, pad_token=PAD, max_len=20, beam_size=3,
              return_scores=True)
    want_tokens, want_scores = jax_beam_decode(jax_model, params, enc, **kw)
    tokens, scores = beam_decode(port, torch.from_numpy(np.array(enc)), **kw)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_state_dict_has_the_reference_keys(name):
    """The patch embed is the reference's Conv2d (D, c, p, p) under
    ``encoder.patch_embed.proj``; a dense + gelu MLP is ``fc_in.0``; a stack
    without cross-attention has two sub-layers per layer."""
    _, _, port = _pair(name)
    state = port.state_dict()
    cfg = VARIANTS[name]
    patch = cfg.get("encoder", {}).get("embed_layer") == "patch"
    assert state["encoder.patch_embed.proj.weight"].shape == ((32, 1, 16, 16) if patch
                                                            else (32, 128, 1, 1))
    assert any(k.startswith("encoder.patch_embed.backbone_net") for k in state) != patch
    glu = cfg.get("glu", True)
    per = 2 if name == "no_cross" else 3
    mlp = f"decoder.net.attn_layers.layers.{per - 1}.1.fc_in"
    assert state[f"{mlp}.{'fc' if glu else '0'}.weight"].shape == (32 * 4 * (2 if glu else 1),
                                                                   32)
    assert "encoder.attn_layers.layers.1.1.fc_in.fc.weight" in state  # encoder: GeGLU always
    n_sub = len({k.split(".")[4] for k in state if k.startswith("decoder.net.attn_layers")})
    assert n_sub == per


def test_no_cross_gradients_match_jax_grad():
    """The masked loss's gradient against ``jax.grad``'s. The port does not
    encode for a decoder that reads no encoder output: its encoder's
    gradients are None where JAX's are zero."""
    jax_model, params, _ = _pair("no_cross")
    images, targets = _batch(8)

    def loss_fn(p):
        logits, labels = jax_model.apply({"params": p}, jnp.asarray(images),
                                         jnp.asarray(targets))
        return jax_loss(logits, labels, pad_token=PAD, mask_pad=True)

    want = state_dict_from_jax(jax.jit(jax.grad(loss_fn))(params["params"]))
    model = OCRModel(ModelConfig.from_dict(_config("no_cross")), device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    logits, labels = model(torch.from_numpy(images), torch.from_numpy(targets))
    sequence_ce_loss(logits, labels, pad_token=PAD, mask_pad=True).backward()
    params_by_key = dict(model.named_parameters(remove_duplicate=False))
    assert sorted(params_by_key) == sorted(want)
    for key, p in params_by_key.items():
        expect = want[key].numpy()
        if key.startswith("encoder."):
            assert p.grad is None and not expect.any(), key
            continue
        atol = 1e-4 * max(np.abs(expect).max(), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), expect, rtol=1e-4, atol=atol, err_msg=key)


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_no_cross_weight_decay_leaves_the_encoder_where_jax_decays_it(name):
    """One train step with weight decay leaves the unread encoder where
    JAX's step puts it. JAX's gradients of the encoder are zeros and its
    optimizer decays them; the port's are None after the backward, and
    ``Optimizer.step`` makes them zeros, so its optimizer decays them too.
    The whole model, encoder included, agrees with JAX's step."""
    jax_model, params, _ = _pair("no_cross")
    images, targets = _batch(11)
    args = {"lr": 1e-3, "weight_decay": 0.1}
    tx = jax_get_optimizer(name, args)
    state = jax_create_train_state(jax_model, tx, jax.random.PRNGKey(5),
                                   jnp.asarray(images), jnp.asarray(targets))
    jparams = jax.tree.map(jnp.array, params["params"])
    state = state.replace(params=jparams, opt_state=tx.init(jparams))
    state, metrics = jax_make_train_step(jax_model, tx)(state, jnp.asarray(images),
                                                        jnp.asarray(targets))
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params))

    before = state_dict_from_jax(params)
    model = OCRModel(ModelConfig.from_dict(_config("no_cross")), device="cpu")
    model.load_state_dict(before, strict=True)
    port_state = create_train_state(model, get_optimizer(name, args, model.parameters()),
                                    seed=0)
    got = make_train_step()(port_state, torch.from_numpy(images), torch.from_numpy(targets))
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
    after = model.state_dict()
    moved = 0
    for key, value in after.items():
        # Adam's first step is lr * g / (|g| + eps): 5% of one step, as
        # gradients summed in another order move it.
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=0,
                                   atol=0.05 * args["lr"], err_msg=key)
        if key.startswith("encoder.") and not torch.equal(value, before[key]):
            moved += 1
    # Decay moved every encoder tensor that holds a nonzero value.
    assert moved == sum(1 for k, v in before.items()
                        if k.startswith("encoder.") and v.abs().max() > 0)


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_cross_attend_train_step_is_the_bare_optimizers_bit_for_bit(name):
    """The flagship path (``cross_attend: true``): every parameter has a
    gradient after the backward, so the zeros ``Optimizer.step`` gives a
    parameter without one change nothing. The step equals, bit for bit,
    the same loss's backward followed by ``torch.optim``'s own step."""
    images, targets = (torch.from_numpy(x) for x in _batch(12))
    args = {"lr": 1e-3, "weight_decay": 0.1}
    model = OCRModel(ModelConfig.from_dict(dict(TINY_CONFIG, use_flash_attention=True)),
                     device="cpu", seed=3)
    bare = copy.deepcopy(model)
    state = create_train_state(model, get_optimizer(name, args, model.parameters()), seed=0)
    make_train_step()(state, images, targets)

    logits, labels = bare(images, targets, generator=step_generator(0, 0, "cpu"))
    sequence_ce_loss(logits, labels, pad_token=PAD, mask_pad=True).backward()
    assert all(p.grad is not None for p in bare.parameters())
    optim = torch.optim.Adam if name == "Adam" else torch.optim.AdamW
    optim(bare.parameters(), **args).step()
    want = bare.state_dict()
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key


def test_jax_no_cross_decoder_cannot_decode():
    """The reference: a stack without ``cross_attns`` fails in its decode's
    cross-attention precompute with AttributeError."""
    jax_model, params, _ = _pair("no_cross")
    images, _ = _batch(9)
    enc = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    with pytest.raises(AttributeError, match="cross_attns"):
        jax_greedy_decode(jax_model, params, enc, bos_token=BOS, eos_token=EOS,
                          pad_token=PAD, max_len=8)


@pytest.mark.parametrize("entry", ["generate", "greedy_decode", "sampled_decode",
                                   "beam_decode", "generate_batch"])
def test_no_cross_decode_raises_value_error(entry):
    """The port's form of the reference's AttributeError: every decode entry
    point raises ValueError naming ``cross_attend: false``."""
    _, _, port = _pair("no_cross")
    images, _ = _batch(9)
    x = torch.from_numpy(images)
    enc = torch.zeros(2, 9, 32)
    common = dict(bos_token=BOS, eos_token=EOS, pad_token=PAD, max_len=8)
    calls = {
        "generate": lambda: generate(port, x, max_len=8),
        "greedy_decode": lambda: greedy_decode(port, enc, **common),
        "sampled_decode": lambda: sampled_decode(port, enc, torch.Generator(), **common),
        "beam_decode": lambda: beam_decode(port, enc, beam_size=2, **common),
        "generate_batch": lambda: TexOCR(
            dict(_config("no_cross"), tokenizer_path=DEFAULT_VOCAB_PATH, vocab_size=1000,
                 bos_token=998, eos_token=997, trg_pad_idx=999),
            device="cpu").generate_batch(np.full((1, 32, 64, 1), 255, np.uint8), max_len=4),
    }
    with pytest.raises(ValueError, match="cross_attend: false"):
        calls[entry]()


def test_model_config_from_yaml_matches_jax():
    """config/config.yml through both loaders, field by field; the one
    difference is ``use_flash_attention``, which the port keeps as "auto"
    until the device is known."""
    want = jax_model_config_from_yaml("config/config.yml", max_length=350, vocab_size=1000)
    got = model_config_from_yaml("config/config.yml", max_length=350, vocab_size=1000)
    assert dataclasses.asdict(got.encoder) == dataclasses.asdict(want.encoder)
    assert dataclasses.asdict(got.decoder) == dataclasses.asdict(want.decoder)
    for field in dataclasses.fields(got):
        if field.name in ("encoder", "decoder", "use_flash_attention"):
            continue
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.use_flash_attention == "auto"


def test_model_config_from_json_needs_no_yaml(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_config("patch_glu_false")))
    cfg = model_config_from_yaml(str(path), max_length=30)
    assert cfg.decoder.max_length == 30 and not cfg.decoder.glu
    assert cfg.encoder.embed_layer == "patch" and cfg.decoder.cross_attend


@pytest.mark.parametrize("name", list(VARIANTS))
def test_create_model(name):
    model = create_model(_config(name), device="cpu", seed=3)
    again = create_model(_config(name), device="cpu", seed=3)
    assert isinstance(model, OCRModel)
    for (key, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), key
    images, targets = _batch(10)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(images), torch.from_numpy(targets))
    assert logits.shape == (2, 11, TINY_CONFIG["vocab_size"])
    assert torch.isfinite(logits).all()


def test_unknown_embed_layer_raises():
    cfg = dict(TINY_CONFIG, encoder=dict(TINY_CONFIG["encoder"], embed_layer="conv"))
    with pytest.raises(ValueError, match="embed_layer"):
        ModelConfig.from_dict(cfg)


@pytest.mark.parametrize("channels, patch", [(1, 4), (3, 4), (64, 1)])
def test_patch_embed_is_the_reference_conv2d(channels, patch):
    """The patchify product equals ``F.conv2d`` with kernel = stride = p on
    the same (D, c, p, p) weight: the reference module's numbers (p = 1: the
    hybrid embed's pointwise projection)."""
    from texocr_tpu_torch.models.layers import PatchConv, init_torch_default

    conv = PatchConv(channels, 24, patch)
    init_torch_default(conv, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 12, 20, channels))
                         .astype(np.float32))
    with torch.no_grad():
        want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                                          stride=patch)
        got = conv(x)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(), rtol=1e-5,
                               atol=1e-5)
    bound = 1.0 / np.sqrt(channels * patch * patch)
    with torch.no_grad():
        assert float(conv.weight.abs().max()) <= bound and float(conv.bias.abs().max()) <= bound
