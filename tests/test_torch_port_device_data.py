"""The port's device-resident training path against the JAX package on the
CPU, at the tiny float32 config: one dataset (gray levels 0-255, canvases of
three sizes, one of odd width) written by the port and loaded by both; JAX
weights carried across with state_dict_from_jax.

Tolerances (tests/test_torch_port_training.py's): bucket bytes, gathers,
plans and call orders exact; losses and token accuracy of train steps within
rtol 1e-4, eval losses within rtol 1e-5; a resumed run against a straight
one rtol 1e-6; the resample within 1e-6 (float32 products summed in another
order).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import texocr_tpu.training.device_data as jax_dd
from tests.test_torch_port_imports import _BLOCKER, REPO
from tests.tiny import TINY_CONFIG, tiny_model_config
from texocr_tpu.data import ImageDataset as JaxImageDataset
from texocr_tpu.data.transforms import preprocess_jax
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.training.loop import train_model as jax_train_model
from texocr_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from texocr_tpu.training.train_step import create_train_state as jax_create_train_state
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.checkpoint.io import latest_checkpoint
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.data.dataset import BatchCollator, ImageDataset
from texocr_tpu_torch.data.transforms import preprocess
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.training import loop
from texocr_tpu_torch.training.device_data import (
    DeviceResidentData,
    augment_batch,
    epoch_permutation,
    gather_batch,
    make_chunk_eval_step,
    make_chunk_train_step,
    scale_translate,
)
from texocr_tpu_torch.training.loop import train_model
from texocr_tpu_torch.training.optimizers import get_optimizer
from texocr_tpu_torch.training.train_step import create_train_state, seeded_generator

torch.set_num_threads(1)
CANVASES = ((32, 64, 7), (32, 128, 6), (16, 63, 5))  # (h, w, rows)
PAD, BOS, EOS = 999, 998, 997
CONFIG = dict(
    {k: v for k, v in TINY_CONFIG.items() if k not in ("vocab_size", "max_length")},
    img_size=(32, 128), bos_token=BOS, eos_token=EOS, trg_pad_idx=PAD, batch_size=2,
    optimizer="Adam", optimizer_args={"lr": 1e-3}, seq_pad_multiple=8, seed=3,
    mesh={"data": 1}, device_data=True, device_data_steps_per_call=2,
    decoder=dict(TINY_CONFIG["decoder"], dropout=0.1),
)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(port dataset, JAX dataset) of the same pickle."""
    rng = np.random.default_rng(11)
    images, tokens = [], []
    for h, w, rows in CANVASES:
        for _ in range(rows):
            img = np.full((h, w), 255, np.uint8)
            ink = rng.random((h, w)) < 0.3
            img[ink] = rng.integers(0, 256, int(ink.sum()))
            img[rng.integers(0, h, 8), rng.integers(0, w, 8)] = 0
            images.append(img)
            tokens.append(rng.integers(0, 990, int(rng.integers(3, 12))).tolist())
    path = str(tmp_path_factory.mktemp("ddata") / "trainset.pkl")
    ImageDataset.from_arrays(images, tokens).save(path)
    return ImageDataset.load(path), JaxImageDataset.load(path)


def _both(datasets, **kwargs):
    """The port's buckets (on the CPU) and JAX's, with the stdout of each."""
    port_ds, jax_ds = datasets
    outs = []
    for build in (lambda: DeviceResidentData.from_dataset(port_ds, device="cpu", **kwargs),
                  lambda: jax_dd.DeviceResidentData.from_dataset(jax_ds, **kwargs)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            outs.append((build(), buf.getvalue()))
    return outs


@pytest.mark.parametrize("kwargs", [
    dict(pack_bits=8),
    dict(pack_bits=4),
    dict(pack_bits=8, size_round=8),
    dict(pack_bits=4, size_round=8, bucket_cap=4),
    dict(pack_bits=8, max_canvas=(32, 64)),
    dict(pack_bits=4, min_bucket_items=6),
], ids=["pack8", "pack4", "round8", "pack4-round8-cap4", "max_canvas", "min_items"])
def test_buckets_equal_jax(datasets, kwargs):
    """Keys (in order), row counts, widths, label lengths, and the bytes over
    the logical width and length, against JAX's lane-padded buckets."""
    (port, port_out), (want, want_out) = _both(datasets, seq_pad_multiple=8, **kwargs)
    assert port_out == want_out
    if "bucket_cap" in kwargs:
        assert "dropped, seeded subset" in port_out
    assert list(port.buckets) == list(want.buckets) and port.buckets
    for key, b in port.buckets.items():
        w = want.buckets[key]
        assert (b.n, b.true_w, b.seq_len, b.pack_bits) == (w.n, w.true_w, w.true_len,
                                                           w.pack_bits)
        assert b.shape == w.shape == key
        assert b.images.dtype == torch.uint8 and b.labels.dtype == torch.int32
        stored = b.images.shape[2]
        assert stored == (-(-key[1] // 2) if b.pack_bits == 4 else key[1])
        np.testing.assert_array_equal(b.images.numpy(), np.asarray(w.images)[:, :, :stored])
        np.testing.assert_array_equal(b.labels.numpy(), np.asarray(w.labels)[:, : b.seq_len])


@pytest.mark.parametrize("pack_bits", [8, 4])
def test_gather_equals_jax_and_the_host_collator(datasets, pack_bits):
    (port, _), (want, _) = _both(datasets, seq_pad_multiple=8, size_round=8,
                                 pack_bits=pack_bits)
    port_ds = datasets[0]
    for (h, w), b in port.buckets.items():
        rows = [0, b.n - 1, 2, b.images.shape[0] - 1, 2]  # a padding row and a repeat
        got_images, got_labels = gather_batch(b, torch.tensor(rows))
        jb = want.buckets[(h, w)]
        want_images, want_labels = jax_dd.gather_batch(
            jb.images, jb.labels, jnp.asarray(rows), jb.true_w, jb.true_len, jb.pack_bits)
        assert got_images.dtype == torch.float32 and got_images.shape == (5, h, w, 1)
        np.testing.assert_array_equal(got_images.numpy(), np.asarray(want_images))
        np.testing.assert_array_equal(got_labels.numpy(), np.asarray(want_labels))
        if pack_bits == 8:
            ids = port_ds.sizes[(w, h)]
            items = [port_ds[ids[r % b.n]] for r in rows]
            host_images, host_labels = BatchCollator(PAD, BOS, EOS, seq_pad_multiple=8)(items)
            np.testing.assert_array_equal(got_images.numpy(), host_images)
            width = host_labels.shape[1]
            np.testing.assert_array_equal(got_labels[:, :width].numpy(), host_labels)
            assert (got_labels[:, width:] == PAD).all()


@pytest.mark.parametrize("batch_size, steps_cap", [(2, 1), (2, 2), (4, 32)])
def test_plan_equals_jax(datasets, batch_size, steps_cap):
    (port, _), (want, _) = _both(datasets, seq_pad_multiple=8)
    got = port.plan(batch_size, steps_cap=steps_cap)
    assert got == want.plan(batch_size, steps_cap=steps_cap)
    for key, b in port.buckets.items():  # one pass per bucket, contiguous chunks
        chunks = [(start, steps) for k, steps, start in got if k == key]
        assert [c[0] for c in chunks] == list(np.cumsum([0] + [c[1] for c in chunks[:-1]]))
        assert sum(c[1] for c in chunks) == max(b.n // batch_size, 1)


def _recording_runs(monkeypatch):
    """Replaces both packages' chunk runners by recorders that leave the
    state as it is. Returns (port calls, JAX calls): (h, w, steps, start)
    per call, the port's with the permutation it was given."""
    port_calls, jax_calls = [], []

    def port_factory(batch_size, **_):
        def run(state, bucket, perm, n_steps, start):
            port_calls.append((*bucket.shape, n_steps, start, perm))
            return {"loss": torch.tensor(1.0), "token_acc": torch.tensor(0.5)}
        return run

    def jax_factory(model, tx, batch_size, **_):
        def run(state, images, labels, steps, n, start, epoch, tag, *rest):
            jax_calls.append((tag // 4096, tag % 4096, steps, start))
            return state, {"loss": jnp.float32(1.0), "token_acc": jnp.float32(0.5)}
        return run

    monkeypatch.setattr(loop, "make_chunk_train_step", port_factory)
    monkeypatch.setattr(jax_dd, "make_scan_train_step", jax_factory)
    return port_calls, jax_calls


def test_epoch_call_order_equals_jax_and_after_a_resume(datasets, tmp_path, monkeypatch):
    """Three shuffled epochs, then a resume for two more: the calls (bucket,
    steps, start) of every epoch come in JAX's order."""
    port_ds, jax_ds = datasets
    port_calls, jax_calls = _recording_runs(monkeypatch)
    for train, ds, name, kw in ((train_model, port_ds, "port", {"device": "cpu"}),
                                (jax_train_model, jax_ds, "jax", {})):
        config = dict(CONFIG, batch_shuffle=True, device_data_steps_per_call=1, val_freq=99,
                      save_dir=str(tmp_path / name))
        train(ds, None, dict(config, n_epochs=3), verbose=False, **kw)
        train(ds, None, dict(config, n_epochs=5, resume=True), verbose=False, **kw)
    assert [c[:4] for c in port_calls] == jax_calls
    assert len(jax_calls) == 5 * (3 + 3 + 2)
    per_epoch = [[c[:4] for c in port_calls[i: i + 8]] for i in range(0, 40, 8)]
    assert len({tuple(e) for e in per_epoch}) > 1  # the order moves between epochs


def test_permutation_covers_the_real_rows_once_per_epoch(datasets, tmp_path, monkeypatch):
    """Each bucket's calls in one epoch share one permutation of its real
    rows (never the size_round padding), so they read each row at most once;
    permutations differ between epochs and between buckets."""
    port_ds, _ = datasets
    port_calls, _ = _recording_runs(monkeypatch)
    train_model(port_ds, None, dict(CONFIG, n_epochs=2, device_data_steps_per_call=1,
                                    device_data_size_round=16, save_checkpoint=False,
                                    save_dir=str(tmp_path)), verbose=False, device="cpu")
    per_epoch = len(port_calls) // 2
    sizes = {(h, w): n for h, w, n in CANVASES}
    perms = {}
    for epoch in range(2):
        rows = {}
        for h, w, steps, start, perm in port_calls[epoch * per_epoch: (epoch + 1) * per_epoch]:
            n = sizes[(h, w)]
            assert sorted(perm.tolist()) == list(range(n))
            assert perms.setdefault((epoch, h, w), perm) is perm  # one per (epoch, bucket)
            for s in range(steps):
                rows.setdefault((h, w), []).extend(
                    perm[((start + s) * 2 + torch.arange(2)) % n].tolist())
        for (h, w), seen in rows.items():
            assert len(seen) == 2 * (sizes[(h, w)] // 2) == len(set(seen))
    assert not torch.equal(perms[0, 32, 64], perms[1, 32, 64])
    a, b = (epoch_permutation(7, 3, 0, tag, "cpu") for tag in (32 * 4096 + 64, 32 * 4096 + 128))
    assert sorted(a.tolist()) == sorted(b.tolist()) and not torch.equal(a, b)
    assert torch.equal(a, epoch_permutation(7, 3, 0, 32 * 4096 + 64, "cpu"))


@pytest.mark.parametrize("scale, dy, dx", [
    (0.85, 0.0, 0.0), (0.9, 1.37, -2.61), (1.0, -2.5, 7.25), (1.05, 2.9, -7.9)])
def test_scale_translate_equals_jax(scale, dy, dx):
    """Against jax.image.scale_and_translate (linear, antialiased) as the
    JAX package calls it, at fractional shifts and shifts that cross the
    border, on an image whose ink touches every edge."""
    rng = np.random.default_rng(int(scale * 100))
    images = rng.random((3, 32, 96, 1)).astype(np.float32)
    s = np.full(3, scale, np.float32)
    ty = np.array([dy, -dy, 0.5 * dy], np.float32)
    tx = np.array([dx, -dx, 0.0], np.float32)
    want = []
    for img, si, tyi, txi in zip(images, s, ty, tx):
        trans = jnp.stack([(1.0 - si) * 32 * 0.5 + tyi, (1.0 - si) * 96 * 0.5 + txi])
        want.append(np.asarray(jax.image.scale_and_translate(
            jnp.asarray(img), (32, 96, 1), (0, 1), jnp.stack([si, si]), trans,
            method="linear")))
    got = scale_translate(*(torch.from_numpy(x) for x in (images, s, ty, tx)))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0, atol=1e-6)


def test_augment_batch_properties():
    """Shape and range kept, corners stay background, the same generator
    seed gives the same batch, another seed and another sample differ."""
    rng = np.random.default_rng(0)
    images = np.zeros((4, 32, 64, 1), np.float32)
    images[:, 10:20, 20:40, 0] = rng.random((4, 10, 20))
    x = torch.from_numpy(images)
    a, b, c = (augment_batch(x, seeded_generator("cpu", 3, step, 0xA06)) for step in (7, 7, 8))
    assert a.shape == x.shape
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert a[:, :2, :2].abs().max() == 0.0
    same = augment_batch(x[:1].expand_as(x).contiguous(), seeded_generator("cpu", 9))
    assert not torch.equal(same[0], same[1])


@pytest.fixture(scope="module")
def carried(datasets):
    """A JAX train state, a maker of the port's model with the same weights,
    and both packages' (32, 64) buckets, packed to 4 bits."""
    port_ds, jax_ds = datasets
    cfg = dict(img_size=(32, 128), vocab_size=1000, trg_pad_idx=PAD, bos_token=BOS,
               eos_token=EOS, max_length=32)
    jax_model = JaxOCRModel(tiny_model_config(**cfg))
    want = jax_dd.DeviceResidentData.from_dataset(jax_ds, seq_pad_multiple=8, size_round=8,
                                                  pack_bits=4)
    got = DeviceResidentData.from_dataset(port_ds, seq_pad_multiple=8, size_round=8,
                                          pack_bits=4, device="cpu")
    jb = want.buckets[(32, 64)]
    images, labels = jax_dd.gather_batch(jb.images, jb.labels, jnp.arange(2), jb.true_w,
                                         jb.true_len, 4)
    tx = jax_get_optimizer("Adam", {"lr": 1e-3})
    state = jax_create_train_state(jax_model, tx, jax.random.PRNGKey(4), images, labels)
    weights = state_dict_from_jax({"params": state.params})

    def port_model():
        model = OCRModel(ModelConfig.from_dict(dict(TINY_CONFIG, **cfg)), device="cpu")
        model.load_state_dict(weights, strict=True)
        return model

    return jax_model, tx, state, jb, port_model, got.buckets[(32, 64)]


def test_train_chunk_equals_jax_scan_step(carried):
    """Two calls of two steps (starts 0 and 2, the second wrapping past the
    7 real rows at batch 3), dropout 0, no augmentation: the port's runner
    fed JAX's permutation, rebuilt as tests/test_device_data.py does."""
    jax_model, tx, state, jb, make_port_model, bucket = carried
    port_model = make_port_model()
    tag = 32 * 4096 + 64
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        state.dropout_rng, 0), tag), 0x5E1EC7)
    scores = jnp.where(jnp.arange(jb.images.shape[0]) < jb.n,
                       jax.random.uniform(key, (jb.images.shape[0],)), jnp.inf)
    perm = np.asarray(jnp.argsort(scores))[: jb.n]
    jax_run = jax_dd.make_scan_train_step(jax_model, tx, 3, steps_cap=2)
    jax_state = jax.tree.map(jnp.array, state)  # the scan step donates its state
    want = []
    for start in (0, 2):
        jax_state, m = jax_run(jax_state, jb.images, jb.labels, 2, jb.n, start, 0, tag,
                               jb.true_w, jb.true_len, 4)
        want.append((float(m["loss"]), float(m["token_acc"])))
    port_state = create_train_state(
        port_model, get_optimizer("Adam", {"lr": 1e-3}, port_model.parameters()), seed=0)
    run = make_chunk_train_step(3)
    got = []
    for start in (0, 2):
        m = run(port_state, bucket, torch.from_numpy(perm.astype(np.int64)), 2, start)
        got.append((float(m["loss"]), float(m["token_acc"])))
    assert port_state.step == int(jax_state.step) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_eval_chunk_equals_jax_scan_eval(carried):
    jax_model, _, state, jb, make_port_model, bucket = carried
    port_model = make_port_model()
    jax_run = jax_dd.make_scan_eval_step(jax_model, 3, steps_cap=4)
    run = make_chunk_eval_step(3)
    for n_steps, start in ((4, 0), (2, 3)):
        want = jax_run(state.params, jb.images, jb.labels, n_steps, start, jb.n, jb.true_w,
                       jb.true_len, 4)
        got = run(port_model, bucket, n_steps, start)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_loop_trains_checkpoints_and_resumes(datasets, tmp_path):
    """Two epochs with a resident val split: the loss falls and checkpoints
    are written; a resume to 3 epochs runs one epoch of steps more."""
    port_ds, _ = datasets
    config = dict(CONFIG, n_epochs=2, save_dir=str(tmp_path / "ck"), val_freq=1)
    metrics = tmp_path / "m.jsonl"
    _, state, history = train_model(port_ds, port_ds, config, verbose=False, device="cpu",
                                    metrics_path=str(metrics))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["event"] for r in records] == ["train_epoch", "val"] * 2
    assert records[0]["steps"] == 3 + 3 + 2 and records[0]["images_per_sec"] > 0
    assert len(history) == 2 and np.isfinite(history).all() and history[1] < history[0]
    assert latest_checkpoint(config["save_dir"]).endswith("checkpoint_e1")
    step1 = state.step
    _, state2, history2 = train_model(port_ds, None, dict(config, n_epochs=3, resume=True),
                                      verbose=False, device="cpu")
    assert state2.step == step1 + step1 // 2 and len(history2) == 1


def test_loop_streams_val_from_the_host(datasets, tmp_path):
    port_ds, _ = datasets
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, _, history = train_model(
            port_ds, port_ds, dict(CONFIG, n_epochs=2, save_checkpoint=False, keep_small=True,
                                   device_data_val=False, save_dir=str(tmp_path)),
            verbose=True, device="cpu")
    out = buf.getvalue()
    assert out.count('"val"') == 2 and np.isfinite(history).all()
    assert "bucket (16, 63): 5 images, seq_len 16, 1 MB on device" in out


def test_resume_continues_the_device_resident_trajectory(datasets, tmp_path):
    """Without the plan shuffle (whose generator restarts at seed + epoch on
    a resume, as in JAX), 2 epochs and a resume to 4 equal 4 straight
    epochs: permutations, dropout and augmentation are seeded by (seed,
    epoch) and (seed, step)."""
    port_ds, _ = datasets
    config = dict(CONFIG, batch_shuffle=False, device_data_augment=True,
                  device_data_pack_bits=4)
    full = train_model(port_ds, None, dict(config, n_epochs=4, save_dir=str(tmp_path / "a")),
                       verbose=False, device="cpu")
    cut = dict(config, n_epochs=2, save_dir=str(tmp_path / "b"))
    first = train_model(port_ds, None, cut, verbose=False, device="cpu")
    rest = train_model(port_ds, None, dict(cut, n_epochs=4, resume=True), verbose=False,
                       device="cpu")
    assert rest[1].step == full[1].step == 4 * 8
    np.testing.assert_allclose(first[2] + rest[2], full[2], rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 30, 97), (1, 17, 50, 1), (2, 33, 70, 3), (1, 16, 64, 4)],
                         ids=["grey", "grey-channel", "rgb", "rgba"])
def test_preprocess_equals_jax(shape):
    raw = np.random.default_rng(len(shape) + shape[-1]).integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(preprocess_jax(jnp.asarray(raw)))
    got = preprocess(torch.from_numpy(raw))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


_DEVICE_DATA_CHILD = _BLOCKER + textwrap.dedent(
    """
    import numpy as np
    from texocr_tpu_torch.data.dataset import ImageDataset
    from texocr_tpu_torch.training.loop import train_model

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (32, 64)).astype(np.uint8) for _ in range(4)]
    ds = ImageDataset.from_arrays(images, [list(rng.integers(0, 990, 5)) for _ in range(4)])
    config = {
        "img_size": (32, 64), "patch_size": 16, "glu": True, "bos_token": 998,
        "eos_token": 997, "trg_pad_idx": 999, "dtype": "float32", "batch_size": 2,
        "n_epochs": 1, "optimizer": "Adam", "optimizer_args": {"lr": 1e-3},
        "save_checkpoint": False, "seq_pad_multiple": 8, "device_data": True,
        "device_data_augment": True, "device_data_pack_bits": 4,
        "encoder": {"n_channels": 1, "embed_dim": 32, "num_layers": 1, "heads": 2,
                    "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                    "stem_channels": 32},
        "decoder": {"embed_dim": 32, "num_layers": 1, "heads": 2, "exp_factor": 4},
    }
    _, state, history = train_model(ds, ds, config, verbose=False, device="cpu")
    assert state.step == 2 and np.isfinite(history).all(), history

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("trained", state.step, "steps")
    """
)


def test_device_resident_training_with_jax_pil_yaml_and_regex_blocked():
    proc = subprocess.run([sys.executable, "-c", _DEVICE_DATA_CHILD], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "trained 2 steps" in proc.stdout
