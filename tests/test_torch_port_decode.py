"""The port's decode against the JAX package at the tiny float32 config:
int8 cross- and self-attention K/V, the encoder key mask, the top-k filter,
sampled decode and beam search. JAX-initialised parameters are carried across
with state_dict_from_jax and both packages decode the same encoder output.

Tolerances: tokens exact; step logits within 1e-5 (rtol and atol) and beam
scores within rtol 1e-5, float32 sums taken in another order. ``max_len`` is
DECODE_CHUNK + 6, so an int8 self-attention prefix is merged and read.
Sampling is held to JAX by its limits and its distribution, not its draws.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from tests.tiny import TINY_CONFIG, tiny_model_config
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.models.beam import beam_decode as jax_beam_decode
from texocr_tpu.models.generate import DECODE_CHUNK as JAX_DECODE_CHUNK
from texocr_tpu.models.generate import greedy_decode as jax_greedy_decode
from texocr_tpu.utils import topk_filter as jax_topk_filter
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models import OCRModel, beam_decode, greedy_decode, sampled_decode
from texocr_tpu_torch.models.attention import quantize_int8
from texocr_tpu_torch.models.beam import sequence_logprob
from texocr_tpu_torch.models.generate import DECODE_CHUNK
from texocr_tpu_torch.utils import topk_filter, topk_filter_size

torch.set_num_threads(1)
BOS, EOS, PAD = 48, 47, 49
MAX_LEN = DECODE_CHUNK + 6
TABLE = 2 * DECODE_CHUNK  # the positional table covers the JAX decode's whole last chunk
TOL = dict(rtol=1e-5, atol=1e-5)
QUANTS = [("int8", "none"), ("none", "int8"), ("int8", "int8")]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 32, 64, 1)).astype(np.float32)
    jax_model = JaxOCRModel(tiny_model_config(max_length=TABLE))
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(1), jnp.asarray(images),
                                     jnp.full((2, 8), PAD, jnp.int32))
    enc = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    return params, enc, state_dict_from_jax(params)


def _jax(kv_quant="none", self_kv_quant="none"):
    return JaxOCRModel(dataclasses.replace(tiny_model_config(max_length=TABLE),
                                           kv_quant=kv_quant, self_kv_quant=self_kv_quant))


def _port(state, kv_quant="none", self_kv_quant="none"):
    cfg = dict(TINY_CONFIG, max_length=TABLE, kv_quant=kv_quant, self_kv_quant=self_kv_quant)
    model = OCRModel(ModelConfig.from_dict(cfg), device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def _t(x):
    return torch.from_numpy(np.array(x))


def test_decode_chunk_is_the_jax_packages():
    assert DECODE_CHUNK == JAX_DECODE_CHUNK == 32


def test_int8_cross_kv_equals_jax(setup):
    """k8/v8/sk/sv of the port's precompute equal JAX's, transposed from JAX's
    (B, H, dh, Nk) to the port's (B, H, Nk, dh); the quantizer alone is exact
    on JAX's own K/V."""
    params, enc, state = setup
    want = _jax("int8").apply(params, enc, method=JaxOCRModel.decoder_cross_kv)
    full = _jax().apply(params, enc, method=JaxOCRModel.decoder_cross_kv)
    got = _port(state, "int8").decoder_cross_kv(_t(enc))
    for w, f, g in zip(want, full, got):
        for name in ("k", "v"):
            x = _t(f[name]).transpose(-1, -2)  # JAX's float K/V, (B, H, Nk, dh)
            q, scale = quantize_int8(x, dim=2)
            np.testing.assert_array_equal(q.numpy(), np.swapaxes(np.asarray(w[name + "8"]), -1, -2))
            np.testing.assert_array_equal(scale.numpy(), np.asarray(w["s" + name]))
            np.testing.assert_array_equal(g[name + "8"].numpy(), q.numpy())
            np.testing.assert_allclose(g["s" + name].detach().numpy(), scale.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kv_quant, self_kv_quant", QUANTS)
def test_int8_greedy_equals_jax(setup, kv_quant, self_kv_quant):
    params, enc, state = setup
    want_tokens, want_logits = jax_greedy_decode(
        _jax(kv_quant, self_kv_quant), params, enc, bos_token=BOS, eos_token=-1,
        pad_token=PAD, max_len=MAX_LEN, return_logits=True)
    tokens, logits = greedy_decode(_port(state, kv_quant, self_kv_quant), _t(enc),
                                   bos_token=BOS, eos_token=-1, pad_token=PAD,
                                   max_len=MAX_LEN, return_logits=True)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)


@pytest.mark.parametrize("kv_quant, self_kv_quant", QUANTS)
def test_int8_decode_close_to_unquantized(setup, kv_quant, self_kv_quant):
    """The int8 caches' step logits stay within the JAX package's int8 budget
    (max error / max |logit| < 0.05) of the unquantized cache's."""
    _, enc, state = setup
    kw = dict(bos_token=BOS, eos_token=-1, pad_token=PAD, max_len=MAX_LEN, return_logits=True)
    _, logits = greedy_decode(_port(state), _t(enc), **kw)
    _, logits8 = greedy_decode(_port(state, kv_quant, self_kv_quant), _t(enc), **kw)
    err = (logits8 - logits).abs().max().item()
    assert err / logits.abs().max().item() < 0.05


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_enc_mask_greedy_equals_jax(setup, kv_quant):
    """The encoder key mask reaches the cross-attention as in JAX."""
    params, enc, state = setup
    mask = np.ones(enc.shape[:2], bool)
    mask[0, 5:] = False
    mask[1, 1:3] = False
    want_tokens, want_logits = jax_greedy_decode(
        _jax(kv_quant), params, enc, bos_token=BOS, eos_token=EOS, pad_token=PAD, max_len=12,
        enc_mask=jnp.asarray(mask), return_logits=True)
    tokens, logits = greedy_decode(_port(state, kv_quant), _t(enc), bos_token=BOS,
                                   eos_token=EOS, pad_token=PAD, max_len=12,
                                   enc_mask=torch.from_numpy(mask), return_logits=True)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    unmasked = greedy_decode(_port(state, kv_quant), _t(enc), bos_token=BOS, eos_token=EOS,
                             pad_token=PAD, max_len=12, return_logits=True)[1]
    assert not torch.allclose(unmasked, logits)


def test_unknown_quant_mode_raises(setup):
    _, enc, state = setup
    with pytest.raises(ValueError, match="kv quant"):
        greedy_decode(_port(state, kv_quant="int4"), _t(enc), bos_token=BOS, eos_token=-1,
                      pad_token=PAD, max_len=2)
    with pytest.raises(ValueError, match="self kv quant"):
        greedy_decode(_port(state, self_kv_quant="fp8"), _t(enc), bos_token=BOS,
                      eos_token=-1, pad_token=PAD, max_len=2)


@pytest.mark.parametrize("vocab", [50, 1000])
def test_topk_filter_equals_jax(vocab):
    rng = np.random.default_rng(vocab)
    logits = rng.normal(size=(6, vocab)).astype(np.float32)
    logits[1] = np.round(logits[1])  # many ties, across the k-th value
    logits[2] = 0.0  # all tied: the lowest k indices survive
    want = np.asarray(jax_topk_filter(jnp.asarray(logits)))
    got = topk_filter(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    k = topk_filter_size(vocab)
    assert k == {50: 4, 1000: 99}[vocab]
    assert (np.isfinite(got).sum(axis=1) == k).all()
    assert np.isfinite(got[2, :k]).all()


def test_topk_filter_raises_at_k_zero():
    with pytest.raises(ValueError, match="keeps 0"):
        topk_filter(torch.zeros(2, 50), threshold=1.0)


def test_sampling_at_tiny_temperature_equals_jax_greedy(setup):
    params, enc, state = setup
    want = jax_greedy_decode(_jax(), params, enc, bos_token=BOS, eos_token=EOS,
                             pad_token=PAD, max_len=8)
    gen = torch.Generator().manual_seed(0)
    got = sampled_decode(_port(state), _t(enc), gen, bos_token=BOS, eos_token=EOS,
                         pad_token=PAD, max_len=8, temp=1e-4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_tokens_lie_in_the_topk(setup):
    """Every sampled step-0 token is among the top k = int((1 - 0.9) * 50) = 4
    of JAX's step-0 logits, over 8 seeds (``test_generate.py``'s check)."""
    params, enc, state = setup
    _, logits = jax_greedy_decode(_jax(), params, enc, bos_token=BOS, eos_token=-1,
                                  pad_token=PAD, max_len=1, return_logits=True)
    topk = np.argsort(np.asarray(logits)[:, 0], axis=-1)[:, -topk_filter_size(50):]
    port = _port(state)
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        s = sampled_decode(port, _t(enc), gen, bos_token=BOS, eos_token=-1, pad_token=PAD,
                           max_len=1, temp=0.7).numpy()
        for row in range(s.shape[0]):
            assert s[row, 0] in topk[row], (seed, row, s[row, 0], topk[row])


def test_sampled_distribution_chi_square(setup):
    """4000 step-0 draws for one image against softmax(topk_filter(logits) /
    temp) from JAX's logits: a chi-square test over the k kept tokens
    (p > 1e-3; the draws are seeded, so the test is deterministic)."""
    params, enc, state = setup
    temp, n = 0.7, 4000
    _, logits = jax_greedy_decode(_jax(), params, enc, bos_token=BOS, eos_token=-1,
                                  pad_token=PAD, max_len=1, return_logits=True)
    filtered = np.asarray(jax_topk_filter(logits[:, 0]))[0].astype(np.float64) / temp
    p = np.exp(filtered - filtered.max())
    p /= p.sum()
    gen = torch.Generator().manual_seed(1)
    draws = sampled_decode(_port(state), _t(enc)[:1].expand(n, -1, -1), gen, bos_token=BOS,
                           eos_token=-1, pad_token=PAD, max_len=1, temp=temp)[:, 0].numpy()
    kept = np.flatnonzero(p > 0)
    assert set(np.unique(draws)) <= set(kept)
    counts = np.array([(draws == i).sum() for i in kept])
    expected = n * p[kept] / p[kept].sum()
    assert stats.chisquare(counts, expected).pvalue > 1e-3


@pytest.mark.parametrize("self_kv_quant", ["none", "int8"])
@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
@pytest.mark.parametrize("beam_size", [1, 3, 5])
def test_beam_equals_jax(setup, beam_size, length_penalty, self_kv_quant):
    params, enc, state = setup
    kw = dict(bos_token=BOS, eos_token=EOS, pad_token=PAD, max_len=MAX_LEN,
              beam_size=beam_size, length_penalty=length_penalty, return_scores=True)
    want_tokens, want_scores = jax_beam_decode(_jax(self_kv_quant=self_kv_quant), params,
                                               enc, **kw)
    tokens, scores = beam_decode(_port(state, self_kv_quant=self_kv_quant), _t(enc), **kw)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5)


def test_beam_score_runs_to_the_chunk_end_as_jax(setup):
    """max_len inside a chunk: the JAX package's beams expand to the end of
    the chunk, so the score holds more steps than the returned tokens; the
    port's equals it, and differs from the teacher-forced log-prob."""
    params, enc, state = setup
    kw = dict(bos_token=BOS, eos_token=-1, pad_token=PAD, max_len=MAX_LEN, beam_size=3,
              return_scores=True)
    _, want = jax_beam_decode(_jax(), params, enc, **kw)
    port = _port(state)
    tokens, scores = beam_decode(port, _t(enc), **kw)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), rtol=1e-5)
    assert (scores < sequence_logprob(port, _t(enc), tokens, bos_token=BOS, eos_token=EOS)
            - 1.0).all()


def test_beam_1_equals_greedy_and_scores_are_teacher_forced(setup):
    """At two whole chunks: at a max_len inside a chunk the score also holds
    the steps to the chunk's end, which the JAX package runs and slices off."""
    _, enc, state = setup
    port = _port(state)
    kw = dict(bos_token=BOS, eos_token=EOS, pad_token=PAD, max_len=2 * DECODE_CHUNK)
    greedy = greedy_decode(port, _t(enc), **kw)
    np.testing.assert_array_equal(beam_decode(port, _t(enc), beam_size=1, **kw).numpy(),
                                  greedy.numpy())
    tokens, scores = beam_decode(port, _t(enc), beam_size=5, return_scores=True, **kw)
    want = sequence_logprob(port, _t(enc), tokens, bos_token=BOS, eos_token=EOS)
    np.testing.assert_allclose(scores.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("self_kv_quant", ["none", "int8"])
def test_beam_scores_are_the_cached_steps_logprob(setup, self_kv_quant):
    """sequence_logprob through the decode step's cache (int8 merges included)
    gives beam 5's scores at two whole chunks."""
    _, enc, state = setup
    port = _port(state, self_kv_quant=self_kv_quant)
    kw = dict(bos_token=BOS, eos_token=EOS)
    tokens, scores = beam_decode(port, _t(enc), pad_token=PAD, max_len=2 * DECODE_CHUNK,
                                 beam_size=5, return_scores=True, **kw)
    want = sequence_logprob(port, _t(enc), tokens, cached=True, **kw)
    np.testing.assert_allclose(scores.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
