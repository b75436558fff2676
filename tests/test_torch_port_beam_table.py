"""Where the port's beam search departs from the JAX package's on purpose:
JAX runs whole chunks of decode steps and reads positions past the decoder's
positional table, where flax's embedding lookup fills NaN, so its beam
scores turn NaN; the port stops at the table. Tokens agree, and the port's
scores stay finite."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.tiny import TINY_CONFIG, tiny_model_config
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.models.beam import beam_decode as jax_beam_decode
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models import OCRModel, beam_decode

torch.set_num_threads(1)
TABLE = 38  # positional rows: JAX's second chunk of 32 steps runs past them


def test_beam_scores_stay_finite_past_the_positional_table_where_jax_gives_nan():
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 32, 64, 1)).astype(np.float32)
    jax_model = JaxOCRModel(tiny_model_config(max_length=TABLE))
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(1), jnp.asarray(images),
                                     jnp.full((2, 8), 49, jnp.int32))
    enc = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    kw = dict(bos_token=48, eos_token=47, pad_token=49, max_len=TABLE, beam_size=3,
              return_scores=True)
    want_tokens, want_scores = jax_beam_decode(jax_model, params, enc, **kw)
    model = OCRModel(ModelConfig.from_dict(dict(TINY_CONFIG, max_length=TABLE)), device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    tokens, scores = beam_decode(model, torch.from_numpy(np.array(enc)), **kw)
    assert np.isnan(np.asarray(want_scores)).all()
    assert torch.isfinite(scores).all()
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
