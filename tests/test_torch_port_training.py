"""The port's training path against the JAX package on the CPU, at the tiny
config in float32: JAX-initialised weights carried across with
state_dict_from_jax, the same seeded batches (with PAD tails) through both.

Tolerances: the goldens' (tests/test_model_parity.py): rtol 1e-4 / atol 2e-4
on logits, rtol 1e-5 on the loss. Gradients: rtol 1e-4, atol 1e-4 of the
tensor's largest gradient (float32 sums taken in another order). Optimizers:
rtol and atol 1e-6 on the parameters after each of 20 updates from the same
gradients (a few float32 roundings of parameters of magnitude up to 3).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.tiny import TINY_CONFIG, tiny_model_config
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.ops.flash_attention import flash_attention_diff
from texocr_tpu.training.losses import sequence_ce_loss as jax_loss
from texocr_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from texocr_tpu.training.train_step import create_train_state as jax_create_train_state
from texocr_tpu.training.train_step import make_train_step as jax_make_train_step
from texocr_tpu_torch.checkpoint import load_state, state_dict_from_jax
from texocr_tpu_torch.checkpoint.io import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
    warm_start_params,
)
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.models.decoder import dropout
from texocr_tpu_torch.ops.flash_attention import FlashAttentionFunction
from texocr_tpu_torch.training.losses import sequence_ce_loss
from texocr_tpu_torch.training.optimizers import get_optimizer
from texocr_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    step_generator,
)

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens")
PAD = TINY_CONFIG["trg_pad_idx"]


def _batch(seed, b=4, t=12):
    """Images and BOS ... EOS targets with PAD tails of different lengths."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, 32, 64, 1)).astype(np.float32)
    targets = np.full((b, t), PAD, np.int32)
    for i in range(b):
        n = int(rng.integers(2, t - 2))
        targets[i, 0] = 48
        targets[i, 1: n + 1] = rng.integers(0, 47, n)
        targets[i, n + 1] = 47
    return images, targets


def _port_model(params, **overrides):
    cfg = ModelConfig.from_dict(dict(TINY_CONFIG, use_flash_attention=True, **overrides))
    model = OCRModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX model with the Pallas kernel (interpret mode on the CPU) and
    its initial parameters."""
    model = JaxOCRModel(dataclasses.replace(tiny_model_config(), use_flash_attention=True))
    images, targets = _batch(0)
    params = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.asarray(images), jnp.asarray(targets))
    # numpy copies: the JAX train step donates (deletes) the arrays it is given.
    return model, jax.tree.map(np.asarray, params)


def _assert_grads_close(got: torch.Tensor, want: np.ndarray, key: str):
    assert got is not None, key
    atol = 1e-4 * max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=atol, err_msg=key)


def test_dec_logits_and_loss_match_goldens():
    from tests.test_torch_port_goldens import CONFIG

    model = OCRModel(ModelConfig.from_dict(CONFIG), device="cpu")
    model.load_state_dict(load_state(os.path.join(GOLDEN, "model_state.npz")), strict=True)
    io = np.load(os.path.join(GOLDEN, "model_io.npz"))
    images = torch.from_numpy(io["images"]).permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        logits, labels = model(images, torch.from_numpy(io["targets"]))
    np.testing.assert_allclose(logits.numpy(), io["dec_logits"], rtol=1e-4, atol=2e-4)
    loss = sequence_ce_loss(logits, labels, pad_token=49, mask_pad=False)
    np.testing.assert_allclose(float(loss), float(io["loss"]), rtol=1e-5)


@pytest.mark.parametrize("mask_pad", [True, False])
def test_teacher_forced_logits_and_loss_match_jax(jax_pair, mask_pad):
    jax_model, params = jax_pair
    images, targets = _batch(1)
    want_logits, want_labels = jax.jit(jax_model.apply)(params, jnp.asarray(images),
                                                        jnp.asarray(targets))
    want_loss = jax_loss(want_logits, want_labels, pad_token=PAD, mask_pad=mask_pad)
    model = _port_model(params)
    with torch.no_grad():
        logits, labels = model(torch.from_numpy(images), torch.from_numpy(targets))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=2e-4)
    loss = sequence_ce_loss(logits, labels, pad_token=PAD, mask_pad=mask_pad)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize(
    "dtype, causal, shape",
    [("float32", False, (2, 3, 40, 40, 32)), ("float32", True, (2, 3, 40, 40, 32)),
     ("float32", False, (1, 2, 24, 70, 64)), ("bfloat16", False, (2, 3, 40, 40, 32)),
     ("bfloat16", True, (2, 3, 40, 40, 32))],
)
def test_flash_function_grads_match_jax_vjp(dtype, causal, shape):
    """FlashAttentionFunction (plain forward on the CPU, math-path backward)
    against jax.vjp of flash_attention_diff (the Pallas kernel in interpret
    mode, XLA's backward), on the same inputs and cotangent. float32: atol
    2e-5 on the output and 1e-4 relative to the largest gradient. bfloat16:
    both round q, k, v, P and the gradients to bfloat16 at their own places,
    so each result is held to 2^-6 of its largest value."""
    b, h, nq, nk, dh = shape
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(b, h, n, dh)).astype(np.float32) for n in (nq, nk, nk))
    g = rng.normal(size=(b, h, nq, dh)).astype(np.float32)
    scale = dh ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out, vjp = jax.vjp(lambda q_, k_, v_: flash_attention_diff(q_, k_, v_, scale, causal),
                       *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [np.asarray(x.astype(jnp.float32)) for x in (out, *vjp(jnp.asarray(g, jdt)))]
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    got_out = FlashAttentionFunction.apply(tq, tk, tv, scale, causal)
    assert got_out.grad_fn is not None and got_out.dtype == tdt
    got_out.backward(torch.from_numpy(g).to(tdt))
    got = [t.detach().float().numpy() for t in (got_out, tq.grad, tk.grad, tv.grad)]
    for name, gt, wt in zip(("out", "dq", "dk", "dv"), got, want):
        if dtype == "float32":
            atol = 2e-5 if name == "out" else 1e-4 * np.abs(wt).max()
            np.testing.assert_allclose(gt, wt, atol=atol, rtol=0, err_msg=name)
        else:
            assert np.abs(gt - wt).max() <= 2.0 ** -6 * np.abs(wt).max(), name
    with torch.inference_mode():
        assert FlashAttentionFunction.apply(tq, tk, tv, scale, causal).grad_fn is None


def test_flash_function_takes_a_strided_grad():
    """The output keeps q's strides (heads split from (B, N, H * dh)) and the
    backward takes a cotangent of any layout."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 30, 4 * 16)).astype(np.float32))
    q = x.view(2, 30, 4, 16).transpose(1, 2).clone().requires_grad_()
    out = FlashAttentionFunction.apply(q, q, q, 0.25, False)
    g = torch.from_numpy(rng.normal(size=(2, 30, 4, 16)).astype(np.float32)).transpose(1, 2)
    assert not g.is_contiguous()
    (dq,) = torch.autograd.grad(out, q, g)
    (want,) = torch.autograd.grad(FlashAttentionFunction.apply(q, q, q, 0.25, False), q,
                                  g.contiguous())
    torch.testing.assert_close(dq, want, rtol=0, atol=0)


def _jax_loss_fn(model, images, targets, mask_pad=True):
    def loss_fn(params):
        logits, labels = model.apply({"params": params}, images, targets)
        return jax_loss(logits, labels, pad_token=PAD, mask_pad=mask_pad)

    return loss_fn


@pytest.mark.parametrize("mask_pad", [True, False])
def test_one_steps_gradients_match_jax(jax_pair, mask_pad):
    jax_model, params = jax_pair
    images, targets = _batch(2)
    want = jax.jit(jax.grad(_jax_loss_fn(jax_model, jnp.asarray(images), jnp.asarray(targets),
                                         mask_pad)))(params["params"])
    want = state_dict_from_jax(want)
    model = _port_model(params)
    logits, labels = model(torch.from_numpy(images), torch.from_numpy(targets))
    sequence_ce_loss(logits, labels, pad_token=PAD, mask_pad=mask_pad).backward()
    params_by_key = dict(model.named_parameters(remove_duplicate=False))
    assert sorted(params_by_key) == sorted(want)
    for key, p in params_by_key.items():
        _assert_grads_close(p.grad, want[key].numpy(), key)


def test_three_steps_match_jax_make_train_step(jax_pair):
    """Losses and token accuracy of three Adam steps on three batches."""
    jax_model, params = jax_pair
    tx = jax_get_optimizer("Adam", {"lr": 1e-3})
    batches = [_batch(10 + i) for i in range(3)]
    state = jax_create_train_state(jax_model, tx, jax.random.PRNGKey(5),
                                   jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    jparams = jax.tree.map(jnp.array, params["params"])
    state = state.replace(params=jparams, opt_state=tx.init(jparams))
    step = jax_make_train_step(jax_model, tx)
    want = []
    for images, targets in batches:
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(targets))
        want.append((float(metrics["loss"]), float(metrics["token_acc"])))

    model = _port_model(params)
    port_state = create_train_state(model, get_optimizer("Adam", {"lr": 1e-3},
                                                         model.parameters()), seed=0)
    train_step = make_train_step()
    got = []
    for images, targets in batches:
        metrics = train_step(port_state, torch.from_numpy(images), torch.from_numpy(targets))
        got.append((float(metrics["loss"]), float(metrics["token_acc"])))
    assert port_state.step == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _optax_params(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize(
    "name, args",
    [
        ("Adam", {"lr": 1e-2, "weight_decay": 0.1}),
        ("AdamW", {"lr": 1e-2, "weight_decay": 0.05, "betas": (0.8, 0.99)}),
        ("SGD", {"lr": 5e-2, "momentum": 0.9}),
        ("SGD", {"lr": 5e-2, "weight_decay": 0.01}),
        ("Adam", {"lr": 1e-2, "lr_schedule": {"warmup_steps": 5, "decay_steps": 15,
                                              "end_value": 1e-3}}),
        ("Adam", {"lr": 1e-2, "lr_schedule": {"decay_steps": 12}, "grad_clip": 2.0}),
        ("SGD", {"lr": 5e-2, "momentum": 0.5, "grad_clip": 1.0}),
    ],
)
def test_optimizer_matches_optax(name, args):
    rng = np.random.default_rng(8)
    init = _optax_params(rng)
    grads = [{k: (rng.normal(size=v.shape) * rng.choice([0.1, 3.0])).astype(np.float32)
              for k, v in init.items()} for _ in range(20)]
    tx = jax_get_optimizer(name, args)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = get_optimizer(name, args, tp.values())
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in init:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_remat_matches_no_remat(jax_pair):
    _, params = jax_pair
    images, targets = (torch.from_numpy(x) for x in _batch(3))
    results = []
    for remat in (False, True):
        model = _port_model(params, remat=remat)
        logits, labels = model(images, targets)
        loss = sequence_ce_loss(logits, labels, pad_token=PAD)
        loss.backward()
        results.append((loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
    for key, grad in results[0][1].items():
        torch.testing.assert_close(results[1][1][key], grad, rtol=1e-5, atol=1e-7)


def test_dropout_rate_reproducibility_and_deterministic_eval(jax_pair):
    _, params = jax_pair
    x = torch.ones(64, 100, 32)
    y = dropout(x, 0.1, step_generator(42, 7, "cpu"))
    dropped = (y == 0).float().mean().item()
    sigma = (0.1 * 0.9 / x.numel()) ** 0.5
    assert abs(dropped - 0.1) <= 4 * sigma
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert torch.equal(y, dropout(x, 0.1, step_generator(42, 7, "cpu")))  # same (seed, step)
    assert not torch.equal(y, dropout(x, 0.1, step_generator(42, 8, "cpu")))
    assert not torch.equal(y, dropout(x, 0.1, step_generator(43, 7, "cpu")))

    model = _port_model(params, decoder=dict(TINY_CONFIG["decoder"], dropout=0.1))
    images, targets = (torch.from_numpy(a) for a in _batch(4))
    with torch.no_grad():
        eval_a = model(images, targets)[0]
        train_a = model(images, targets, generator=step_generator(0, 0, "cpu"))[0]
        train_b = model(images, targets, generator=step_generator(0, 0, "cpu"))[0]
    assert torch.equal(eval_a, model(images, targets)[0])
    assert torch.equal(train_a, train_b) and not torch.equal(train_a, eval_a)
    eval_step = make_eval_step()
    assert torch.equal(eval_step(model, images, targets), eval_step(model, images, targets))


def test_checkpoint_round_trip_and_warm_start_onto_a_longer_table(jax_pair, tmp_path):
    _, params = jax_pair
    model = _port_model(params)
    opt = get_optimizer("Adam", {"lr": 1e-3}, model.parameters())
    for epoch in (0, 3, 1):
        save_checkpoint(str(tmp_path), epoch, model.state_dict(), opt.state_dict(),
                        extra={"step": 10 * epoch})
    path = latest_checkpoint(str(tmp_path))
    assert path.endswith("checkpoint_e3") and latest_checkpoint(str(tmp_path / "none")) is None
    restored = load_checkpoint(path)
    assert restored["epoch"] == 3 and restored["step"] == 30
    for key, value in model.state_dict().items():
        assert torch.equal(restored["model"][key], value)

    longer = OCRModel(ModelConfig.from_dict(dict(TINY_CONFIG, max_length=40)), device="cpu",
                      seed=1)
    target = longer.state_dict()
    merged = warm_start_params(restored["model"], target)
    key = "decoder.net.pos_embedding.embedding.weight"
    n = TINY_CONFIG["max_length"]
    assert merged[key].shape == (40, 32)
    assert torch.equal(merged[key][:n], restored["model"][key])
    assert torch.equal(merged[key][n:], target[key][n:])
    for other, value in merged.items():
        if other != key:
            assert torch.equal(value, restored["model"][other]), other
    longer.load_state_dict(merged, strict=True)


def _dataset(n_per_size=6):
    rng = np.random.default_rng(6)
    images, tokens = [], []
    for h, w in ((32, 64), (32, 128)):
        for _ in range(n_per_size):
            img = np.full((h, w), 255, np.uint8)
            img[rng.integers(0, h, 40), rng.integers(0, w, 40)] = 0
            images.append(img)
            tokens.append(list(rng.integers(0, 990, int(rng.integers(3, 12)))))
    return ImageDataset.from_arrays(images, tokens)


TRAIN_CONFIG = dict(
    {k: v for k, v in TINY_CONFIG.items() if k not in ("vocab_size", "max_length")},
    img_size=(32, 128), bos_token=998, eos_token=997, trg_pad_idx=999, batch_size=3,
    optimizer="Adam", optimizer_args={"lr": 1e-3}, seq_pad_multiple=8, seed=3,
    decoder=dict(TINY_CONFIG["decoder"], dropout=0.1),
)


def test_resume_continues_the_loss_trajectory(tmp_path):
    from texocr_tpu_torch.training.loop import train_model

    ds = _dataset()
    full = train_model(ds, None, dict(TRAIN_CONFIG, n_epochs=4, save_dir=str(tmp_path / "a")),
                       verbose=False, device="cpu")
    cut = dict(TRAIN_CONFIG, n_epochs=2, save_dir=str(tmp_path / "b"))
    first = train_model(ds, None, cut, verbose=False, device="cpu")
    rest = train_model(ds, None, dict(cut, n_epochs=4, resume=True), verbose=False,
                       device="cpu")
    assert rest[1].step == full[1].step == 16
    np.testing.assert_allclose(first[2] + rest[2], full[2], rtol=1e-6)
    assert full[2][-1] < full[2][0]


def test_step_timer_and_metrics_logger(tmp_path, capsys):
    import json

    from texocr_tpu_torch.telemetry import MetricsLogger, step_timer

    timed = {}
    with step_timer(timed, sync=torch.zeros(1)):
        sum(range(1000))
    assert timed["seconds"] > 0
    path = tmp_path / "metrics.jsonl"
    logger = MetricsLogger(str(path))
    logger.log("train_epoch", loss=torch.tensor(1.5), steps=3, note="x")
    logger.close()
    record = json.loads(path.read_text())
    assert record["event"] == "train_epoch" and record["note"] == "x"
    assert record["loss"] == 1.5 and record["steps"] == 3.0
    assert json.loads(capsys.readouterr().out) == record


def test_cli_trains_two_epochs(tmp_path):
    import json

    from texocr_tpu_torch.training import cli

    ds = _dataset()
    for split in ("train", "val", "test"):
        (tmp_path / split).mkdir()
        ds.save(str(tmp_path / split / f"{split}set.pkl"))
    config = dict(TRAIN_CONFIG, n_epochs=2, save_dir=str(tmp_path / "ckpt"))
    config_path = tmp_path / "config.json"
    config_path.write_text(json.dumps(config))
    metrics = tmp_path / "metrics.jsonl"
    cli.main(cli.parse_args(["-d", str(tmp_path), "--config", str(config_path),
                             "--metrics", str(metrics), "--device", "cpu"]))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["event"] for r in records] == ["train_epoch", "val", "train_epoch", "val"]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert records[0]["steps"] == 4 and records[0]["images_per_sec"] > 0
    assert latest_checkpoint(str(tmp_path / "ckpt")).endswith("checkpoint_e1")

    # The device-resident path from the same CLI: the dataset on the device.
    config_path.write_text(json.dumps(dict(config, device_data=True, device_data_augment=True,
                                           save_dir=str(tmp_path / "resident"))))
    metrics = tmp_path / "resident.jsonl"
    cli.main(cli.parse_args(["-d", str(tmp_path), "--config", str(config_path),
                             "--metrics", str(metrics), "--device", "cpu"]))
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["event"] for r in records] == ["train_epoch", "val", "train_epoch", "val"]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert records[0]["steps"] == 4 and records[0]["images_per_sec"] > 0
    assert latest_checkpoint(str(tmp_path / "resident")).endswith("checkpoint_e1")
