"""The port's data-parallel training paths on spawned ranks (gloo, a
``file://`` store under ``tmp_path``, one torch thread each): the
device-resident chunk, mesh-independent checkpoints, the two-process
training CLI and ``dryrun_multichip``. The tiny config in float32 with the
decoder's dropout at 0.1, so the ranks' dropout rows are exercised.

Tolerances: the resident chunk's metrics within 1e-5 relative of the single
process's, its parameters as ``test_torch_port_parallel.py`` holds them;
epoch losses within 1e-5 relative.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_port_parallel_ranks as ranks
from tests.test_torch_port_parallel import RTOL, assert_weights_close
from tests.tiny import TINY_CONFIG
from texocr_tpu_torch.checkpoint.io import latest_checkpoint, load_checkpoint
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
from texocr_tpu_torch.training.device_data import DeviceResidentData
from texocr_tpu_torch.training.loop import train_model

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(TINY_CONFIG, vocab_size=1000, max_length=32, bos_token=998, eos_token=997,
             trg_pad_idx=999, decoder=dict(TINY_CONFIG["decoder"], dropout=0.1))
TRAIN = dict({k: v for k, v in MODEL.items() if k not in ("vocab_size", "max_length")},
             img_size=(32, 128), batch_size=4, optimizer="Adam",
             optimizer_args={"lr": 1e-3, "grad_clip": 0.5}, seq_pad_multiple=8, seed=3)
RESIDENT_BATCH = 4
RESIDENT_STEPS = 2  # from start 0 at batch 4 over 7 rows: the second step wraps


def dataset(n_per_size=8, seed=6):
    """Images of two canvases with labels of 3-11 tokens (the rows of a
    batch hold different numbers of pad tokens)."""
    rng = np.random.default_rng(seed)
    images, tokens = [], []
    for h, w in ((32, 64), (32, 128)):
        for _ in range(n_per_size):
            img = np.full((h, w), 255, np.uint8)
            img[rng.integers(0, h, 40), rng.integers(0, w, 40)] = 0
            images.append(img)
            tokens.append(rng.integers(0, 990, int(rng.integers(3, 12))).tolist())
    return ImageDataset.from_arrays(images, tokens)


def jax_permutation(n, rows):
    """The JAX package's permutation of a bucket's ``n`` real rows of
    ``rows`` (its keyed uniforms, argsorted), as
    ``test_torch_port_device_data.py`` rebuilds it."""
    tag = 32 * 4096 + 64
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(3), 0), tag), 0x5E1EC7)
    scores = jnp.where(jnp.arange(rows) < n, jax.random.uniform(key, (rows,)), jnp.inf)
    return np.asarray(jnp.argsort(scores))[:n].astype(np.int64)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks: the resident chunk under {data: 2}, and the
    checkpoint written under {model: 2} then resumed under {data: 2}."""
    root = tmp_path_factory.mktemp("runs")
    weights = OCRModel(ModelConfig.from_dict(MODEL), device="cpu", seed=0).state_dict()
    bucket = DeviceResidentData.from_dataset(dataset(7), device="cpu",
                                             seq_pad_multiple=8).buckets[(32, 64)]
    perm = jax_permutation(bucket.n, bucket.images.shape[0])
    chunk = (MODEL, weights, bucket, perm, RESIDENT_BATCH, RESIDENT_STEPS)
    ds = dataset()
    runs = [("resident_chunk", ({"data": 2}, *chunk)),
            ("checkpoint_then_resume", (ds, TRAIN, str(root / "first"), str(root / "resumed")))]
    results = spawn(ranks.world_program, 2, (runs,), store_dir=str(root))
    return {"root": root, "chunk": chunk, "ds": ds, "resident": results[0][0],
            "resident_ranks": [r[0] for r in results], "checkpoint": results[0][1]}


def test_resident_chunk_under_data_2_equals_the_single_process(two_ranks):
    """One call of two resident steps (augmentation on, dropout 0.1) fed
    JAX's permutation: the ranks' metrics and gathered weights against the
    single-process runner's on the same bucket."""
    single = ranks.resident_chunk(None, *two_ranks["chunk"])
    got = two_ranks["resident"]
    assert all(r["metrics"] == got["metrics"] for r in two_ranks["resident_ranks"])
    np.testing.assert_allclose(got["metrics"], single["metrics"], rtol=RTOL)
    assert_weights_close(got["weights"], single["weights"], "resident {data: 2}")


def test_checkpoint_from_model_2_loads_into_one_process_and_resumes_under_data_2(two_ranks):
    """The checkpoint a {model: 2} run wrote holds the full model and Adam
    moments: it loads strict into a single-process model, its first epoch
    equals the single process's, and a resume of it under {data: 2} trains
    the next epoch as the single-process resume does."""
    root, ds, got = two_ranks["root"], two_ranks["ds"], two_ranks["checkpoint"]
    path = latest_checkpoint(str(root / "first"))
    assert path.endswith("checkpoint_e0")
    restored = load_checkpoint(path)
    table = restored["model"]["decoder.net.pos_embedding.embedding.weight"].shape[0]
    model = OCRModel(ModelConfig.from_dict(dict(TRAIN, vocab_size=ds.tokenizer.vocab_size,
                                                max_length=table)), device="cpu")
    model.load_state_dict(restored["model"], strict=True)
    moments = restored["optimizer"]["optimizer"]["state"]
    shapes = [p.shape for p in model.parameters()]
    assert [moments[i]["exp_avg"].shape for i in range(len(shapes))] == shapes

    single_first = train_model(ds, None, dict(TRAIN, n_epochs=1, save_dir=str(root / "one")),
                               verbose=False, device="cpu")
    np.testing.assert_allclose(got["first"], single_first[2], rtol=RTOL)
    shutil.copytree(root / "first", root / "one_resume")
    single = train_model(ds, None, dict(TRAIN, n_epochs=2, resume=True,
                                        save_dir=str(root / "one_resume")),
                         verbose=False, device="cpu")
    assert got["step"] == single[1].step == 8
    np.testing.assert_allclose(got["resumed"], single[2], rtol=RTOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_trains_on_two_processes(tmp_path):
    """Two training CLIs joined through --coordinator train one epoch: both
    print the multi-host line; only rank 0 writes metrics and a checkpoint."""
    ds = dataset()
    for split in ("train", "val", "test"):
        (tmp_path / split).mkdir()
        ds.save(str(tmp_path / split / f"{split}set.pkl"))
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(2):
        config = tmp_path / f"config{rank}.json"
        config.write_text(json.dumps(dict(TRAIN, n_epochs=1,
                                          save_dir=str(tmp_path / f"ck{rank}"))))
        cmd = [sys.executable, "-m", "texocr_tpu_torch.training.cli", "-d", str(tmp_path),
               "--config", str(config), "--metrics", str(tmp_path / f"m{rank}.jsonl"),
               "--device", "cpu", "--coordinator", coordinator, "--num_processes", "2",
               "--process_id", str(rank)]
        procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      env=dict(os.environ, OMP_NUM_THREADS="1")))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"multi-host: process {rank}/2, 2 global devices" in out, out
    records = [json.loads(line) for line in (tmp_path / "m0.jsonl").read_text().splitlines()]
    assert [r["event"] for r in records] == ["train_epoch", "val"]
    assert records[0]["steps"] == 4 and np.isfinite(records[0]["loss"])
    assert latest_checkpoint(str(tmp_path / "ck0")).endswith("checkpoint_e0")
    assert not (tmp_path / "m1.jsonl").exists() and not (tmp_path / "ck1").exists()


def test_dryrun_multichip_on_four_ranks(tmp_path, capsys):
    result = dryrun_multichip(4, device="cpu", store_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh={'data': 2, 'model': 2}" in out
    assert "sharded greedy decode (4, 8) ok" in out
    assert result["step"] == 1 and np.isfinite(result["loss"])
