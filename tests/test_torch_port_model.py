"""The port's model against the JAX package at the tiny config, in float32:
JAX-initialised parameters carried across with state_dict_from_jax, the same
seeded inputs through both.

Tolerances: 1e-4 (rtol and atol) on activations and logits, float32 sums taken
in another order; greedy tokens must be identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.tiny import TINY_CONFIG, tiny_model_config
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.models.generate import greedy_decode as jax_greedy_decode
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models import OCRModel, greedy_decode

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    images = rng.normal(size=(2, 32, 64, 1)).astype(np.float32)
    jax_cfg = dataclasses.replace(tiny_model_config(), use_flash_attention=True)
    jax_model = JaxOCRModel(jax_cfg)
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(3), jnp.asarray(images),
                                     jnp.full((2, 8), 49, jnp.int32))
    # The port on the CPU with the flash route on: the plain version runs.
    port = OCRModel(ModelConfig.from_dict(dict(TINY_CONFIG, use_flash_attention=True)),
                    device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return jax_model, params, port, images


def test_backbone_matches_jax(pair):
    jax_model, params, port, images = pair
    want = jax_model.apply(params, jnp.asarray(images),
                           method=lambda m, im: m.encoder.backbone(im))
    with torch.no_grad():
        got = port.encoder.patch_embed.backbone_net(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches_jax_flash_interpret(pair):
    """JAX encode through the Pallas kernel (interpret mode on the CPU) against
    the port's encode through the kernel's plain version."""
    jax_model, params, port, images = pair
    want = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    with torch.no_grad():
        got = port.encode(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("eos", [-1, 47])
def test_greedy_decode_matches_jax(pair, eos):
    jax_model, params, port, images = pair
    enc = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    want_tokens, want_logits = jax_greedy_decode(
        jax_model, params, enc, bos_token=48, eos_token=eos, pad_token=49, max_len=20,
        return_logits=True,
    )
    with torch.no_grad():
        port_enc = port.encode(torch.from_numpy(images))
    tokens, logits = greedy_decode(port, port_enc, bos_token=48, eos_token=eos,
                                   pad_token=49, max_len=20, return_logits=True)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)


def test_max_len_is_clamped_to_the_positional_table(pair):
    _, _, port, images = pair
    with torch.no_grad():
        enc = port.encode(torch.from_numpy(images))
    tokens = greedy_decode(port, enc, bos_token=48, eos_token=-1, pad_token=49, max_len=100)
    assert tokens.shape == (2, TINY_CONFIG["max_length"])
    assert tokens.dtype == torch.int64
