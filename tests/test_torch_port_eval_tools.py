"""The port's evaluation tools on the CPU.

- ``tools.confusion_report`` against the JAX package's
  ``tools/confusion_report.py`` on one ``pairs_out`` file: the same report,
  character for character (ids named by each package's own tokenizer; ids
  past the vocabulary as ``<id N>``).
- ``tools.eval_full_split`` driving the evaluation CLI on a JAX training
  run's ``checkpoint_e*`` directory (its ``params_cache.msgpack``): a run
  whose first process dies after one batch and is restarted with
  ``--skip_batches`` writes the same metrics and pairs lines and the same
  FINAL summary as one whole run, and those metrics are JAX's
  ``test_model``'s on the same split and params; a process that dies before
  any batch ends the run after ``--max_retries`` restarts. The CLI runs in
  this process: ``subprocess.call`` is replaced by a call of
  ``evaluation.cli.main`` on the same arguments.

Metrics are compared exactly.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.tiny import TINY_CONFIG
from texocr_tpu.config import ModelConfig as JaxModelConfig
from texocr_tpu.data.dataset import ImageDataset as JaxImageDataset
from texocr_tpu.evaluation import evaluate as jax_eval
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.evaluation import cli as eval_cli
from texocr_tpu_torch.tools import confusion_report, eval_full_split
from tools import confusion_report as jax_report

torch.set_num_threads(1)
MAX_LEN = 10
CONFIG = dict(TINY_CONFIG, vocab_size=1000, bos_token=998, eos_token=997, trg_pad_idx=999,
              batch_size=2, seq_pad_multiple=4, seed=42)


def _pairs(path, rng):
    """Rows of skewed gold ids (some seen 100+ times) and predictions with
    substitutions, deletions and insertions, a few ids past the vocabulary."""
    with open(path, "w") as f:
        for _ in range(120):
            gold = [int(t) for t in rng.zipf(1.6, int(rng.integers(3, 12))) % 1003]
            pred = []
            for t in gold:
                r = rng.random()
                if r < 0.1:
                    continue
                pred.append(int(rng.integers(0, 1003)) if r < 0.25 else t)
                if rng.random() < 0.05:
                    pred.append(int(rng.integers(0, 40)))
            f.write(json.dumps({"pred": pred, "gold": gold}) + "\n")


def test_confusion_report_equals_the_jax_tool(tmp_path, capsys, monkeypatch):
    path = str(tmp_path / "pairs.jsonl")
    _pairs(path, np.random.default_rng(0))
    monkeypatch.setattr(sys, "argv", ["confusion_report.py", path, "--top", "400"])
    jax_report.main()
    want = capsys.readouterr().out
    assert confusion_report.main([path, "--top", "400"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "<id 100" in got and "per-token error rate" in got
    assert got.split("per-token error rate")[1].count("%") > 0  # ids seen 100+ times


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A test split of three batches and a JAX checkpoint directory holding
    the params cache, with the config as a .json file."""
    root = tmp_path_factory.mktemp("jax_run")
    rng = np.random.default_rng(1)
    images = [np.where(rng.random(hw) < 0.1, 0, 255).astype(np.uint8)
              for hw in [(32, 64)] * 4 + [(16, 64)] * 2]
    tokens = [rng.integers(0, 997, int(rng.integers(3, 9))).tolist() for _ in images]
    os.makedirs(root / "data" / "test")
    ImageDataset.from_arrays(images, tokens).save(str(root / "data" / "test" / "testset.pkl"))
    model = JaxOCRModel(JaxModelConfig.from_dict(CONFIG))
    params = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 64, 1)),
                                 jnp.full((1, 8), 999, jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    os.makedirs(root / "checkpoint_e7")
    (root / "checkpoint_e7" / "params_cache.msgpack").write_bytes(
        serialization.msgpack_serialize(params))
    (root / "config.json").write_text(json.dumps(
        {k: v for k, v in CONFIG.items() if k not in ("max_length", "vocab_size")}))
    return root, model, params


def _run_tool(root, out, monkeypatch, deaths=0, progress=True, retries=8):
    """eval_full_split with the CLI in process; its first ``deaths`` runs
    die (after one batch if ``progress``, else before any). Returns the
    tool's exit code and the CLI runs' argument lists."""
    calls = []

    def call(cmd):
        assert cmd[:3] == [sys.executable, "-m", "texocr_tpu_torch.evaluation.cli"]
        calls.append(cmd[3:])
        if len(calls) <= deaths:
            if progress:
                eval_cli.main(eval_cli.parse_args(cmd[3:] + ["--max_batches", "1"]))
            return 1
        eval_cli.main(eval_cli.parse_args(cmd[3:]))
        return 0

    monkeypatch.setattr(subprocess, "call", call)
    rc = eval_full_split.main([
        "-d", str(root / "data"), "--config", str(root / "config.json"),
        "--checkpoint", str(root / "checkpoint_e7"), "--max_len", str(MAX_LEN),
        "--metrics_out", str(out / "metrics.jsonl"), "--pairs_out", str(out / "pairs.jsonl"),
        "--device", "cpu", "--max_retries", str(retries)])
    return rc, calls


def test_eval_full_split_resumes_to_one_whole_run(jax_run, tmp_path, capsys, monkeypatch):
    root, model, params = jax_run
    whole, resumed = tmp_path / "whole", tmp_path / "resumed"
    os.makedirs(whole)
    os.makedirs(resumed)
    rc, calls = _run_tool(root, whole, monkeypatch)
    final = capsys.readouterr().out.split("FINAL ")[-1]
    assert rc == 0 and len(calls) == 1
    rc, calls = _run_tool(root, resumed, monkeypatch, deaths=1)
    out = capsys.readouterr().out
    assert rc == 0 and len(calls) == 2
    assert calls[0][calls[0].index("--skip_batches") + 1] == "0"
    assert calls[1][calls[1].index("--skip_batches") + 1] == "1"
    assert "died (rc=1); resuming" in out and out.split("FINAL ")[-1] == final
    for name in ("metrics.jsonl", "pairs.jsonl"):
        assert (resumed / name).read_text() == (whole / name).read_text(), name
    lines = [json.loads(line) for line in (whole / "metrics.jsonl").read_text().splitlines()]
    assert [line["batch"] for line in lines] == [1, 2, 3]

    want = jax_eval.test_model(JaxImageDataset.load(str(root / "data" / "test" / "testset.pkl")),
                               model, {"params": params}, dict(CONFIG), max_len=MAX_LEN,
                               verbose=False)
    assert float(np.mean([line["token_acc"] for line in lines])) == want["token_acc"]
    assert float(np.mean([line["edit_similarity"] for line in lines])) == want["edit_similarity"]


def test_eval_full_split_gives_up_without_progress(jax_run, tmp_path, capsys, monkeypatch):
    root, _, _ = jax_run
    rc, calls = _run_tool(root, tmp_path, monkeypatch, deaths=100, progress=False, retries=2)
    assert rc == 1 and len(calls) == 3
    assert "no progress after 3 retries" in capsys.readouterr().err
