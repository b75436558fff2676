"""The compiled decode's CPU side: the decode state and its chunks
(``DecodeState`` / ``BeamState``, ``run_chunk``), which the CUDA graphs of
``models.graphed`` capture and replay, held to the JAX package and to the
eager decode's results from before the state existed; the in-place beam
reorder; no host read inside a chunk; and the wrapper's per-key cache.

The graphs themselves need a CUDA device: ``chip_smoke.py``'s graphs phase
holds their tokens bit-equal to the eager path's on the card. Here
``make_graphed_generate`` must refuse a model on the CPU.

Tolerances: tokens exact; step logits within 1e-5 of JAX's (rtol and atol:
float32 sums in another order); beam scores within rtol 2e-4 of JAX's
(``test_beam_equals_jax``'s bound in ``chip_smoke.py``); against the frozen
eager results, bit for bit. ``max_len`` is DECODE_CHUNK + 6, so the chunks
cross a boundary and an int8 prefix is merged and read.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.tiny import TINY_CONFIG, tiny_model_config
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.models.beam import beam_decode as jax_beam_decode
from texocr_tpu.models.generate import greedy_decode as jax_greedy_decode
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models import (
    OCRModel,
    beam_decode,
    generate,
    greedy_decode,
    sampled_decode,
)
from texocr_tpu_torch.models.attention import DECODE_CHUNK, decode_chunks, reorder_cache
from texocr_tpu_torch.models.beam import BeamState
from texocr_tpu_torch.models.generate import DecodeState, argmax, sampler
from texocr_tpu_torch.models.graphed import make_graphed_generate
from texocr_tpu_torch.serving import TexOCR
from texocr_tpu_torch.serving import wrapper as wrapper_module
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

torch.set_num_threads(1)
BOS, EOS, PAD = 48, 47, 49
MAX_LEN = DECODE_CHUNK + 6
TABLE = 2 * DECODE_CHUNK
TOL = dict(rtol=1e-5, atol=1e-5)
QUANTS = {"none": {}, "int8": dict(kv_quant="int8", self_kv_quant="int8")}

# The eager decode's results before the decode became a state and its chunks
# (tokens as rows of ids, the float64 sum of the step logits and beam scores
# as float.hex): the tiny config with a 64-row table, weights from seed 7,
# ``images()``; no EOS (eos_token -1) but for "generate", 38 steps, beam 3,
# sampling at 0.7 from a generator seeded with 5.

FROZEN = {
    ('greedy', 'none'): (
        [
            '38 38 38 47 38 27 38 47 13 13 21 13 47 13 39 47 27 27 1 1 1 1 21 47 1 1 1 1 1 1 '
            '1 1 1 1 1 1 1 1',
            '38 38 38 47 27 27 38 47 27 27 47 13 21 38 47 27 27 47 27 27 1 1 21 27 1 1 1 1 47 '
            '47 47 1 1 1 1 47 1 1',
        ],
        '-0x1.82ea1d9d14000p+9',
    ),
    ('sample', 'none'): (
        [
            '27 38 23 8 20 21 38 47 41 13 21 39 47 13 21 42 15 27 6 45 42 29 27 39 1 21 6 37 '
            '47 6 1 1 47 21 47 29 1 47',
            '27 21 29 38 23 38 38 47 15 13 39 1 21 26 39 47 1 38 47 12 13 20 46 13 1 21 26 13 '
            '47 47 1 17 27 47 47 47 21 27',
        ],
        None,
    ),
    ('beam', 'none'): (
        [
            '27 38 23 27 38 21 38 47 27 38 47 13 47 27 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 '
            '1 1 45 1 1',
            '27 38 23 27 38 21 38 47 27 38 47 47 47 27 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 '
            '1 1 45 1 1',
        ],
        ['-0x1.54a21a0000000p+7', '-0x1.52e9ae0000000p+7'],
    ),
    ('generate', 'none'): (
        [
            '38 38 38 47 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 '
            '49 49 49 49 49 49 49 49 49 49 49',
            '38 38 38 47 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 '
            '49 49 49 49 49 49 49 49 49 49 49',
        ],
        None,
    ),
    ('greedy', 'int8'): (
        [
            '38 38 38 47 38 27 38 47 13 13 21 13 47 13 39 47 27 27 1 1 1 1 21 47 1 1 1 1 1 1 '
            '1 1 1 1 1 1 1 1',
            '38 38 38 47 27 27 38 47 27 27 47 13 21 38 47 27 27 47 27 27 1 1 21 27 1 1 1 1 47 '
            '47 47 1 1 1 1 47 1 1',
        ],
        '-0x1.82f3a36c7b000p+9',
    ),
    ('sample', 'int8'): (
        [
            '27 38 23 8 20 21 38 47 41 13 21 39 47 13 21 42 15 27 6 45 42 29 27 39 1 21 6 37 '
            '47 6 1 1 47 21 47 29 1 47',
            '27 21 29 38 23 38 38 47 15 13 39 1 21 26 39 47 1 38 47 12 13 20 46 13 1 21 26 13 '
            '47 47 1 17 27 47 47 47 21 27',
        ],
        None,
    ),
    ('beam', 'int8'): (
        [
            '27 38 23 27 38 21 38 47 27 38 47 13 47 27 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 '
            '1 1 45 1 1',
            '27 38 23 27 38 21 38 47 27 38 47 47 47 27 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 1 '
            '1 1 45 1 1',
        ],
        ['-0x1.54afdc0000000p+7', '-0x1.52f3ce0000000p+7'],
    ),
    ('generate', 'int8'): (
        [
            '38 38 38 47 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 '
            '49 49 49 49 49 49 49 49 49 49 49',
            '38 38 38 47 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 49 '
            '49 49 49 49 49 49 49 49 49 49 49',
        ],
        None,
    ),
}


@pytest.fixture(scope="module")
def jax_setup():
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 32, 64, 1)).astype(np.float32)
    jax_model = JaxOCRModel(tiny_model_config(max_length=TABLE))
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(1), jnp.asarray(images),
                                     jnp.full((2, 8), PAD, jnp.int32))
    enc = jax_model.apply(params, jnp.asarray(images), method=JaxOCRModel.encode)
    return params, enc, state_dict_from_jax(params)


def _jax(quant):
    return JaxOCRModel(dataclasses.replace(tiny_model_config(max_length=TABLE),
                                           **QUANTS[quant]))


def _port(state, quant="none"):
    model = OCRModel(ModelConfig.from_dict(dict(TINY_CONFIG, max_length=TABLE,
                                                **QUANTS[quant])), device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def _seeded(quant="none"):
    return OCRModel(ModelConfig.from_dict(dict(TINY_CONFIG, max_length=TABLE, **QUANTS[quant])),
                    device="cpu", seed=7)


def images():
    return torch.from_numpy(np.random.default_rng(11).random((2, 32, 64, 1)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _chunks(state):
    """Every chunk of ``state``, as a graph replay runs them, no early stop."""
    for c in range(state.n_chunks):
        state.run_chunk(c)
    return state


def _ids(rows):
    return [[int(x) for x in row.split()] for row in rows]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_chunked_greedy_equals_jax(jax_setup, quant):
    """The state and its chunks against JAX's greedy decode across a chunk
    boundary; with int8 self- and cross-attention K/V the second chunk reads
    the first in int8."""
    params, enc, state_dict = jax_setup
    want_tokens, want_logits = jax_greedy_decode(
        _jax(quant), params, enc, bos_token=BOS, eos_token=-1, pad_token=PAD, max_len=MAX_LEN,
        return_logits=True)
    port = _port(state_dict, quant)
    with torch.inference_mode():
        state = _chunks(DecodeState(port, port.decoder_cross_kv(_t(enc)), argmax, bos_token=BOS,
                                    eos_token=-1, pad_token=PAD, max_len=MAX_LEN,
                                    return_logits=True))
    assert state.n_chunks == 2
    tokens, logits = state.result()
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_chunked_beam_equals_jax(jax_setup, quant):
    params, enc, state_dict = jax_setup
    kw = dict(bos_token=BOS, eos_token=EOS, pad_token=PAD, max_len=MAX_LEN, beam_size=3)
    want_tokens, want_scores = jax_beam_decode(_jax(quant), params, enc, return_scores=True,
                                               **kw)
    port = _port(state_dict, quant)
    with torch.inference_mode():
        state = _chunks(BeamState(port, port.decoder_cross_kv(_t(enc)), **kw))
        tokens, scores = state.result(return_scores=True)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=2e-4)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["greedy", "sample", "beam", "generate"])
def test_bit_equal_to_the_eager_decode_before_the_state(mode, quant):
    model = _seeded(quant)
    rows, extra = FROZEN[mode, quant]
    common = dict(bos_token=BOS, eos_token=-1, pad_token=PAD, max_len=MAX_LEN)
    with torch.inference_mode():
        enc = model.encode(images())
    if mode == "greedy":
        tokens, logits = greedy_decode(model, enc, return_logits=True, **common)
        assert logits.double().sum().item().hex() == extra
    elif mode == "sample":
        tokens = sampled_decode(model, enc, torch.Generator().manual_seed(5), temp=0.7,
                                **common)
    elif mode == "beam":
        tokens, scores = beam_decode(model, enc, beam_size=3, return_scores=True, **common)
        assert [x.hex() for x in scores.tolist()] == extra
    else:
        tokens = generate(model, images(), max_len=MAX_LEN)
    assert tokens.tolist() == _ids(rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reorder_cache_equals_index_select_byte_for_byte(dtype):
    """Two reorders (full-precision, int8 and scale buffers): each equals
    ``index_select`` of what the cache held, bit for bit, and after the even
    count the cache holds its own buffers again."""
    gen = torch.Generator().manual_seed(0)

    def cache():
        layers = []
        for _ in range(2):
            layer = {name: torch.randn(6, 2, 8, 4, generator=gen).to(dtype) for name in "kv"}
            for name in "kv":
                layer[name + "8"] = torch.randint(-127, 128, (6, 2, 8, 4), generator=gen,
                                                  dtype=torch.int8)
                layer["s" + name] = torch.rand(6, 2, 8, generator=gen).to(dtype)
            layers.append(layer)
        return layers

    live, spare = cache(), cache()
    start = [{name: buf.data_ptr() for name, buf in layer.items()} for layer in live]
    for rows in (torch.tensor([2, 2, 0, 5, 1, 3]), torch.tensor([4, 0, 0, 1, 5, 5])):
        want = [{name: buf.index_select(0, rows).clone() for name, buf in layer.items()}
                for layer in live]
        reorder_cache(live, rows, spare)
        for got, expect in zip(live, want):
            for name, buf in got.items():
                assert buf.dtype == expect[name].dtype
                assert buf.view(torch.uint8).tolist() == expect[name].view(torch.uint8).tolist()
    assert [{name: buf.data_ptr() for name, buf in layer.items()} for layer in live] == start


HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist", "cpu", "numpy")


def _state(mode, quant, max_len=MAX_LEN):
    model = _seeded(quant)
    with torch.inference_mode():
        cross_kv = model.decoder_cross_kv(model.encode(images()))
    common = dict(bos_token=BOS, eos_token=-1, pad_token=PAD, max_len=max_len)
    if mode == "beam":
        return BeamState(model, cross_kv, beam_size=3, **common)
    pick = sampler(torch.Generator().manual_seed(5), 0.7) if mode == "sample" else argmax
    return DecodeState(model, cross_kv, pick, return_logits=True, **common)


@pytest.mark.parametrize("mode, quant", [("greedy", "none"), ("greedy", "int8"),
                                         ("sample", "int8"), ("beam", "int8")])
def test_no_host_read_inside_a_chunk(monkeypatch, mode, quant):
    """A chunk reads nothing back to the host (a capture would fail on it):
    every chunk runs with the tensor methods that read a value on the host
    patched to raise. An int8 chunk boundary and the beam reorder are among
    them. (ATen's own device syncs are for the capture on the card to find.)"""
    state = _state(mode, quant)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside a decode chunk")

    with torch.inference_mode(), monkeypatch.context() as patch:
        for name in HOST_READS:
            patch.setattr(torch.Tensor, name, refuse)
        with pytest.raises(AssertionError, match="host read"):
            bool(torch.ones(()))
        _chunks(state)
    assert state.n_chunks == 2 and state.tokens.shape[-1] >= MAX_LEN


def _buffers(state):
    tensors = [state.tokens, state.done, state.cur]
    tensors += [getattr(state, name) for name in ("logits_buf", "scores", "lengths")
                if getattr(state, name, None) is not None]
    caches = [state.cache] + ([state.spare] if hasattr(state, "spare") else [])
    return [t.data_ptr() for t in tensors] + [
        [{name: buf.data_ptr() for name, buf in layer.items()} for layer in cache]
        for cache in caches]


@pytest.mark.parametrize("mode, quant", [("greedy", "int8"), ("sample", "none"),
                                         ("beam", "int8")])
def test_chunks_rerun_on_the_same_buffers(mode, quant):
    """What a replay relies on: the chunks write only into the state's own
    buffers (the cache holds the same ones at every chunk boundary), and
    running them again from chunk 0 repeats the decode."""
    state = _state(mode, quant, max_len=TABLE)
    before = _buffers(state)
    runs = []
    with torch.inference_mode():
        for _ in range(2):
            if mode == "sample":
                state.pick = sampler(torch.Generator().manual_seed(5), 0.7)
            for c in range(state.n_chunks):
                state.run_chunk(c)
                assert _buffers(state) == before
            runs.append([t.clone() for t in (state.result(return_scores=True)
                                             if mode == "beam" else state.result())])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_decode_chunks_stops_between_chunks_once_every_row_is_done():
    class Fake:
        n_chunks = 4
        done = torch.zeros(2, dtype=torch.bool)

    state, ran = Fake(), []

    def run_chunk(c):
        ran.append(c)
        state.done[c] = True

    decode_chunks(state, run_chunk)
    assert ran == [0, 1]


def test_make_graphed_generate_refuses_a_cpu_model():
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        make_graphed_generate(_seeded(), 2, (32, 64), MAX_LEN, "greedy")


ENGINE_CONFIG = {
    "tokenizer_path": DEFAULT_VOCAB_PATH, "img_size": (32, 64), "patch_size": 16,
    "glu": True, "bos_token": 998, "eos_token": 997, "trg_pad_idx": 999, "dtype": "float32",
    "max_length": TABLE, "seed": 3,
    "encoder": {"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                "stem_channels": 32},
    "decoder": {"embed_dim": 32, "num_layers": 1, "heads": 2, "exp_factor": 4},
}


def _canvases(n=2):
    rng = np.random.default_rng(4)
    return np.where(rng.random((n, 32, 64, 1)) < 0.1, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", ["greedy", "sample", "beam"])
def test_cpu_engine_generate_batch_equals_eager_generate(mode):
    engine = TexOCR(ENGINE_CONFIG, device="cpu")
    u8 = _canvases()
    engine.generator.manual_seed(9)
    got = engine.generate_batch(u8, max_len=MAX_LEN, mode=mode, beam_size=3)
    want = generate(engine.model, 1.0 - torch.from_numpy(u8).float() / 255.0, max_len=MAX_LEN,
                    mode=mode, generator=torch.Generator().manual_seed(9), beam_size=3)
    assert torch.equal(got, want)
    assert engine._compiled == {}  # the CPU engine compiles nothing


def test_cuda_engine_decodes_through_one_graph_set_per_key(monkeypatch):
    """A CUDA engine's every batch goes through ``make_graphed_generate``,
    built once per (canvas, batch, max_len, mode, beam width if beam,
    temperature if sampled); the graphs are replaced here by a recorder
    that decodes eagerly on the CPU."""
    built = []

    def record(model, batch, canvas, max_len, mode, *, beam_size, generator, temp):
        built.append((canvas, batch, max_len, mode, beam_size, temp))

        def run(u8):
            assert u8.shape == (batch, *canvas, 1)
            return generate(model, 1.0 - u8.float() / 255.0, max_len=max_len, mode=mode,
                            generator=generator, temp=temp, beam_size=beam_size)

        return run

    monkeypatch.setattr(wrapper_module, "make_graphed_generate", record)
    engine = TexOCR(ENGINE_CONFIG, device="cpu")
    engine.device = torch.device("cuda")  # the model stays on the CPU
    u8 = _canvases()
    calls = [dict(mode="greedy"), dict(mode="greedy"), dict(mode="greedy", temp=0.5),
             dict(mode="greedy", beam_size=2), dict(mode="sample", temp=0.3),
             dict(mode="sample", temp=0.3, beam_size=2), dict(mode="sample", temp=0.5),
             dict(mode="beam", beam_size=3), dict(mode="beam", beam_size=3, temp=0.9),
             dict(mode="beam", beam_size=2)]
    for kw in calls:
        tokens = engine.generate_batch(u8, max_len=8, **kw)
        assert tokens.shape == (2, 8)
    engine.generate_batch(u8[:1], max_len=8)
    engine.generate_batch(u8, max_len=9)
    assert [(b[3], b[1], b[2]) for b in built] == [
        ("greedy", 2, 8), ("sample", 2, 8), ("sample", 2, 8), ("beam", 2, 8), ("beam", 2, 8),
        ("greedy", 1, 8), ("greedy", 2, 9)]
    assert [b[4] for b in built if b[3] == "beam"] == [3, 2]
    assert [b[5] for b in built if b[3] == "sample"] == [0.3, 0.5]
    assert len(engine._compiled) == len(built)
