"""The port's evaluation against the JAX package: the metric functions on
random arrays, ``clamp_to_pos_table``, ``test_model`` greedy and beam on one
pickled tiny test split (the same metrics), ``single_prediction``, and the
evaluation CLI on the CPU. Then ``test_model``'s engine cache, without a
device: a stub factory whose engines run the eager ``generate``, keyed per
batch shape, mode, beam width and max_len, and ``GraphCache``'s eviction.
Metrics are compared exactly."""

import gc
import json
import os
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.tiny import TINY_CONFIG
from texocr_tpu.config import ModelConfig as JaxModelConfig
from texocr_tpu.data.dataset import ImageDataset as JaxImageDataset
from texocr_tpu.evaluation import evaluate as jax_eval
from texocr_tpu.evaluation import metrics as jax_metrics
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.evaluation import cli as eval_cli
from texocr_tpu_torch.evaluation import evaluate as port_eval
from texocr_tpu_torch.evaluation import metrics
from texocr_tpu_torch.models import OCRModel

torch.set_num_threads(1)
MAX_LEN = 10


@pytest.mark.parametrize("seed", range(4))
def test_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 5))
    pred = rng.integers(0, 6, (b, int(rng.integers(1, 14))))
    target = rng.integers(0, 6, (b, int(rng.integers(1, 14))))
    pred[rng.random(pred.shape) < 0.3] = 999
    target[rng.random(target.shape) < 0.3] = 999
    if seed == 0:
        target[:, : pred.shape[1]] = pred[:, : target.shape[1]]  # some exact rows
    for name in ("batch_acc", "exact_match_rate", "edit_similarity"):
        want = getattr(jax_metrics, name)(pred, target, pad_token=999)
        assert getattr(metrics, name)(pred, target, pad_token=999) == pytest.approx(want, abs=0)


def test_clamp_to_pos_table(capsys):
    """As ``tests/test_metrics.py``: a budget past the positional table is
    clamped and config['max_length'] follows the table's rows."""
    state = {"decoder.net.pos_embedding.embedding.weight": torch.zeros(128, 16)}
    config = {"max_length": 512}
    assert port_eval.clamp_to_pos_table(state, config, 500) == 127
    assert config["max_length"] == 128
    assert "clamping" in capsys.readouterr().out
    config2 = {"max_length": 64}
    assert port_eval.clamp_to_pos_table(state, config2, 100) == 100
    assert config2["max_length"] == 128


def _config():
    cfg = dict(TINY_CONFIG, vocab_size=1000, bos_token=998, eos_token=997, trg_pad_idx=999,
               max_length=32, batch_size=2, seq_pad_multiple=4, seed=42)
    return cfg


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A pickled tiny test split: two batches of (32, 64) canvases and one of
    (16, 64); half the labels are the JAX model's own greedy tokens, so the
    metrics are not all zero. (A second batch of the second canvas makes the
    JAX package's jitted beam decode in ``test_model`` fail on XLA:CPU with
    "Execution supplied 79 buffers but compiled program expected 81".)"""
    root = tmp_path_factory.mktemp("eval_data")
    rng = np.random.default_rng(0)
    images = [np.where(rng.random(hw) < 0.1, 0, 255).astype(np.uint8)
              for hw in [(32, 64)] * 4 + [(16, 64)] * 2]
    cfg = _config()
    jax_model = JaxOCRModel(JaxModelConfig.from_dict(cfg))
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(5), jnp.zeros((1, 32, 64, 1)),
                                     jnp.full((1, 8), 999, jnp.int32))
    tokens = []
    for i, im in enumerate(images):
        if i % 2:
            tokens.append(rng.integers(0, 997, int(rng.integers(3, 9))).tolist())
            continue
        x = jnp.asarray(1.0 - im[None, ..., None].astype(np.float32) / 255.0)
        enc = jax_model.apply(params, x, method=JaxOCRModel.encode)
        from texocr_tpu.models.generate import greedy_decode

        pred = np.asarray(greedy_decode(jax_model, params, enc, bos_token=998, eos_token=997,
                                        pad_token=999, max_len=MAX_LEN))[0]
        tokens.append([int(t) for t in pred[: MAX_LEN - 2]])
    os.makedirs(root / "test")
    ImageDataset.from_arrays(images, tokens).save(str(root / "test" / "testset.pkl"))
    return root, cfg, jax_model, params


@pytest.mark.parametrize("decode_mode", ["greedy", "beam"])
def test_test_model_equals_jax_metrics(split, decode_mode, tmp_path):
    root, cfg, jax_model, params = split
    path = str(root / "test" / "testset.pkl")
    want = jax_eval.test_model(JaxImageDataset.load(path), jax_model, params, dict(cfg),
                               max_len=MAX_LEN, verbose=False, decode_mode=decode_mode,
                               beam_size=3)
    port = OCRModel(ModelConfig.from_dict(cfg), device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    metrics_out = str(tmp_path / "metrics.jsonl")
    got = port_eval.test_model(ImageDataset.load(path), port, dict(cfg), max_len=MAX_LEN,
                               verbose=False, decode_mode=decode_mode, beam_size=3,
                               metrics_out=metrics_out)
    assert got == want
    assert want["batches"] == 3 and 0 < want["token_acc"] < 1
    with open(metrics_out) as f:
        assert len(f.readlines()) == 3
    # A resumed run over the last batch, and a bound on the batches.
    resumed = port_eval.test_model(ImageDataset.load(path), port, dict(cfg), max_len=MAX_LEN,
                                   verbose=False, decode_mode=decode_mode, beam_size=3,
                                   skip_batches=2)
    first = port_eval.test_model(ImageDataset.load(path), port, dict(cfg), max_len=MAX_LEN,
                                 verbose=False, decode_mode=decode_mode, beam_size=3,
                                 max_batches=2)
    assert resumed["batches"] == 3 and first["batches"] == 2  # skipped batches count
    assert (resumed["token_acc"] + 2 * first["token_acc"]) / 3 == pytest.approx(got["token_acc"])


def test_single_prediction_equals_jax(split):
    root, cfg, jax_model, params = split
    path = str(root / "test" / "testset.pkl")
    want = jax_eval.single_prediction(JaxImageDataset.load(path), jax_model, params, cfg, 2)
    port = OCRModel(ModelConfig.from_dict(cfg), device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    assert port_eval.single_prediction(ImageDataset.load(path), port, 2) == want


def test_evaluation_cli_runs_on_the_cpu(split, tmp_path):
    """The CLI with a .json config and an .npz checkpoint gives test_model's
    metrics; unknown quant overrides are refused by argparse."""
    root, cfg, jax_model, params = split
    config = tmp_path / "config.json"
    config.write_text(json.dumps({k: v for k, v in cfg.items()
                                  if k not in ("max_length", "vocab_size")}))
    ckpt = tmp_path / "model.npz"
    np.savez(ckpt, **{k: v.numpy() for k, v in state_dict_from_jax(params).items()})
    args = eval_cli.parse_args(["-d", str(root), "--config", str(config), "--checkpoint",
                                str(ckpt), "--max_len", str(MAX_LEN), "--device", "cpu",
                                "--self_kv_quant", "none"])
    got = eval_cli.main(args)
    want = jax_eval.test_model(JaxImageDataset.load(str(root / "test" / "testset.pkl")),
                               jax_model, params, dict(cfg), max_len=MAX_LEN, verbose=False)
    assert got == want
    assert eval_cli.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        eval_cli.parse_args(["--kv_quant", "int4"])


class StubEngine:
    """A stand-in for a CUDA-graph engine: the eager decode of its key,
    checking the input's type and shape as ``GraphedGenerate`` does."""

    def __init__(self, model, batch, canvas, max_len, mode, beam_size):
        self.model, self.shape = model, (batch, *canvas, 1)
        self.args = dict(max_len=max_len, mode=mode, beam_size=beam_size)
        self.calls = 0

    def __call__(self, images):
        assert images.dtype == torch.float32 and tuple(images.shape) == self.shape
        self.calls += 1
        return port_eval.generate(self.model, images, **self.args)


@pytest.mark.parametrize("decode_mode", ["greedy", "beam"])
def test_test_model_keys_one_engine_per_batch_shape(decode_mode, tmp_path):
    """Two full batches and a smaller last one of (32, 64), and one of
    (16, 64): three keys, each built once, the same metrics and pairs as the
    eager decode, and no engine left once ``test_model`` returns."""
    rng = np.random.default_rng(3)
    images = [np.where(rng.random(hw) < 0.1, 0, 255).astype(np.uint8)
              for hw in [(32, 64)] * 5 + [(16, 64)] * 2]
    tokens = [rng.integers(0, 997, int(rng.integers(3, 9))).tolist() for _ in images]
    path = str(tmp_path / "testset.pkl")
    ImageDataset.from_arrays(images, tokens).save(path)
    cfg = dict(_config(), keep_small=True)
    model = OCRModel(ModelConfig.from_dict(cfg), device="cpu", seed=4)
    built = []

    def factory(batch, canvas, max_len, mode, beam_size):
        engine = StubEngine(model, batch, canvas, max_len, mode, beam_size)
        built.append(((batch, canvas, max_len, mode, beam_size), weakref.ref(engine)))
        return engine

    kw = dict(max_len=MAX_LEN, verbose=False, decode_mode=decode_mode, beam_size=3)
    pairs = [str(tmp_path / f"pairs_{i}.jsonl") for i in range(2)]
    got = port_eval.test_model(ImageDataset.load(path), model, dict(cfg), engine_factory=factory,
                               pairs_out=pairs[0], **kw)
    want = port_eval.test_model(ImageDataset.load(path), model, dict(cfg), pairs_out=pairs[1],
                                **kw)
    assert got == want and got["batches"] == 4
    with open(pairs[0]) as a, open(pairs[1]) as b:
        assert a.read() == b.read()
    assert sorted(key for key, _ in built) == [
        (1, (32, 64), MAX_LEN, decode_mode, 3), (2, (16, 64), MAX_LEN, decode_mode, 3),
        (2, (32, 64), MAX_LEN, decode_mode, 3)]
    gc.collect()
    assert all(ref() is None for _, ref in built)


def test_graph_cache_drops_the_least_recently_used_key():
    built = []

    def factory(batch, canvas, max_len, mode, beam_size):
        built.append(canvas)
        return lambda images: torch.zeros(batch, max_len, dtype=torch.int64)

    cache = port_eval.GraphCache(factory, max_keys=2)
    for h in (8, 16, 8, 24, 8, 16):
        tokens = cache(torch.zeros(2, h, 64, 1), max_len=5, mode="greedy", beam_size=5)
        assert tokens.shape == (2, 5)
    # 8 and 16 built; 8 replayed; 24 drops 16; 8 replayed; 16 drops 24.
    assert built == [(8, 64), (16, 64), (24, 64), (16, 64)]
    assert [k[0][1] for k in cache.engines] == [8, 16]
    assert [k[0][1] for k in cache.keys] == [8, 16, 24, 16]
    cache.close()
    assert not cache.engines


def test_verbose_test_model_takes_an_engine_without_capture_time(tmp_path, capsys):
    """A factory's engine need not be a ``GraphedGenerate``: the verbose
    line says it was built, without a capture time."""
    rng = np.random.default_rng(5)
    images = [np.where(rng.random((32, 64)) < 0.1, 0, 255).astype(np.uint8) for _ in range(3)]
    tokens = [rng.integers(0, 997, int(rng.integers(3, 9))).tolist() for _ in images]
    path = str(tmp_path / "testset.pkl")
    ImageDataset.from_arrays(images, tokens).save(path)
    cfg = dict(_config(), keep_small=True)
    model = OCRModel(ModelConfig.from_dict(cfg), device="cpu", seed=4)
    kw = dict(max_len=MAX_LEN, decode_mode="greedy", beam_size=3)
    got = port_eval.test_model(ImageDataset.load(path), model, dict(cfg), verbose=True,
                               engine_factory=lambda *key: StubEngine(model, *key), **kw)
    out = capsys.readouterr().out
    assert "graph key" in out and "captured in" not in out
    assert got == port_eval.test_model(ImageDataset.load(path), model, dict(cfg),
                                       verbose=False, **kw)
