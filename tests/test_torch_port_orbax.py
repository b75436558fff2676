"""The JAX package's orbax checkpoints read and written by the port
(``texocr_tpu_torch/checkpoint/{zstd,ocdbt,orbax}.py``), the conversions of
params and optimizer state (``checkpoint/convert.py``), and the entry points
that take a JAX checkpoint directory, against the JAX package, orbax and
tensorstore on the CPU.

- ``ocdbt.read_store`` gives every key and value tensorstore reads, byte for
  byte, from stores tensorstore wrote (one node; interior nodes and values
  in data files; a version tree of many generations); tensorstore reads
  what ``ocdbt.write_store`` writes. A corrupt checksum raises
  ``ValueError`` naming the file; a missing libzstd ``OSError`` naming it.
- ``orbax.load_checkpoint`` of what JAX's ``orbax_io.save_checkpoint``
  writes: the tiny model's params and the state of each optimizer the JAX
  package builds, a leaf sharded 2 x 2 over the test session's fake CPU
  devices (four chunks), bfloat16, int32, int64 and scalars; every leaf bit
  for bit what JAX restores, in JAX's nesting. JAX restores what
  ``orbax.save_checkpoint`` writes, with a template and without one.
- ``jax_from_state_dict`` against ``torch_shim.convert_torch_state_dict`` on
  the golden state, and both ways with ``state_dict_from_jax`` for the model
  variants; optimizer state from optax to the port and back, bit for bit.
- A JAX run of 2 Adam steps resumed by the port: step 3 agrees with JAX's
  within rtol 1e-5 (float32) without dropout, and leaves JAX's with it (the
  pinned divergence: the masks differ). ``train_model`` resumes and warm
  starts from a JAX save_dir; ``load_weights``, ``TexOCR(model_path=...)``
  and ``evaluation.cli`` take a JAX directory without ``params_cache.msgpack``.
- The committed fixture (``tests/goldens/jax_orbax_fixture``, which
  ``chip_smoke.py`` phase 18 reads on the card) is what JAX restores and what
  ``chip_smoke.orbax_fixture_tree`` builds from its seed.

Rewrite the fixture (JAX and orbax needed):
``python -m tests.test_torch_port_orbax``.
"""

import json
import os
import shutil
import sys

if __name__ == "__main__":  # the fixture's 2 x 2 mesh, as the test session's conftest gives
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import chip_smoke
from tests.tiny import TINY_CONFIG
from texocr_tpu.checkpoint import orbax_io
from texocr_tpu.checkpoint.torch_shim import convert_torch_state_dict
from texocr_tpu.config import ModelConfig as JaxModelConfig
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from texocr_tpu.training.train_step import TrainState as JaxTrainState
from texocr_tpu.training.train_step import make_train_step as jax_make_train_step
from texocr_tpu_torch.checkpoint import convert, io, ocdbt, orbax, zstd
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.evaluation import cli as eval_cli
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.parallel.mesh import create_mesh
from texocr_tpu_torch.parallel.sharding import shard_optimizer_state
from texocr_tpu_torch.serving import TexOCR
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH
from texocr_tpu_torch.training.optimizers import get_optimizer
from texocr_tpu_torch.training.train_step import create_train_state, make_train_step

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens")
# The tiny model at the shipped tokenizer's vocabulary, so TexOCR loads it.
CONFIG = dict(TINY_CONFIG, vocab_size=1000, bos_token=998, eos_token=997, trg_pad_idx=999)
RESUME_RTOL = 1e-5  # the port's step 3 after a JAX checkpoint against JAX's (float32)

OPTIMIZERS = [
    ("Adam", {"lr": 1e-3}),
    ("Adam", {"lr": 1e-3, "weight_decay": 0.01, "grad_clip": 1.0,
              "lr_schedule": {"warmup_steps": 2, "decay_steps": 10, "end_value": 1e-4}}),
    ("AdamW", {"lr": 1e-3, "weight_decay": 0.05, "grad_clip": 0.5}),
    ("SGD", {"lr": 0.05, "momentum": 0.9, "lr_schedule": {"decay_steps": 6}}),
    ("SGD", {"lr": 0.05, "weight_decay": 0.01}),
]


def _jax_shapes(config):
    """The JAX model's parameter tree as shapes (traced, not compiled)."""
    model = JaxOCRModel(JaxModelConfig.from_dict(config))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1)),
                          jnp.zeros((1, 8), jnp.int32))["params"]


def _filled(shapes, seed, count=1):
    """Seeded values in the layout of ``shapes``: floats of |normal| / 10
    (second moments must not be negative), ints ``count``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: np.abs(0.1 * rng.normal(size=s.shape)).astype(s.dtype)
                        if jnp.issubdtype(s.dtype, jnp.floating)
                        else np.full(s.shape, count, s.dtype), shapes)


@pytest.fixture(scope="module")
def jax_params():
    return _filled(_jax_shapes(CONFIG), 3)


def _plain(tree):
    """A JAX tree as the port's reader nests it: namedtuples as dicts of
    fields (``EmptyState`` as None), tuples as lists, arrays as numpy."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields} if tree._fields else None
    if isinstance(tree, (list, tuple)):
        return [_plain(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree if tree is None or isinstance(tree, (int, float)) else np.asarray(tree)


def _assert_same(got, want, path="tree"):
    """``got`` (the port's) holds ``want``'s leaves bit for bit, in its
    nesting: bfloat16 as a ``torch.bfloat16`` tensor of the same bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}.{i}")
    elif want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, (path, got, want)
    elif want.dtype.name == "bfloat16":
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), path
    else:
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (path, got.dtype)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path


def _stepped(tx, params, seed):
    """``tx``'s state in the layout it inits, with seeded moments and step
    counts of 3, as jax.Arrays."""
    return jax.tree.map(jnp.asarray, _filled(jax.eval_shape(tx.init, params), seed, count=3))


def _tensorstore(directory):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{directory}"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


# -- the key-value store ------------------------------------------------------


@pytest.mark.parametrize("config, txns, per_txn", [
    ({}, 1, 40),  # orbax's layout: one leaf node, values inline
    ({"max_decoded_node_bytes": 600, "max_inline_value_bytes": 40}, 3, 60),  # interior nodes
    ({"version_tree_arity_log2": 1}, 20, 2),  # a version tree of 20 generations
])
def test_read_store_equals_tensorstore(tmp_path, config, txns, per_txn):
    rng = np.random.default_rng(len(config) + txns)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": config}).result()
    for t in range(txns):
        txn = ts.Transaction()
        for i in range(per_txn):
            size = int(rng.choice([0, 5, 50, 2000]))
            kv.with_transaction(txn).write(f"k/{t:03d}/{i:04d}".encode(),
                                           rng.bytes(size)).result()
        txn.commit_async().result()
    want = _tensorstore(tmp_path)
    assert len(want) == txns * per_txn
    assert ocdbt.read_store(str(tmp_path)) == want


def test_tensorstore_reads_what_write_store_writes(tmp_path):
    rng = np.random.default_rng(1)
    items = {b"": b"empty key", b"a": b"", b"a/\x00\xff": rng.bytes(7),
             b"big/0.0": rng.bytes(5000), b"big/0.1": rng.bytes(ocdbt.MAX_INLINE_VALUE_BYTES + 1),
             **{f"key{i:05d}".encode(): rng.bytes(int(rng.integers(0, 300))) for i in range(300)}}
    ocdbt.write_store(str(tmp_path), items)
    assert _tensorstore(tmp_path) == items
    assert ocdbt.read_store(str(tmp_path)) == items


@pytest.mark.parametrize("target", ["manifest.ocdbt", "node"])
def test_a_bad_checksum_raises_value_error_naming_the_file(tmp_path, target):
    shutil.copytree(chip_smoke.ORBAX_FIXTURE, tmp_path / "fixture")
    ckpt = tmp_path / "fixture" / "checkpoint_e3"
    path = ckpt / target if target == "manifest.ocdbt" else next((ckpt / "d").iterdir())
    data = bytearray(path.read_bytes())
    data[-1] ^= 0x40  # the checksum's last byte
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"{path.name}.*checksum mismatch"):
        orbax.load_checkpoint(str(ckpt))


def test_a_missing_libzstd_raises_oserror_naming_it(monkeypatch):
    def missing(name):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "_open", missing)
    with pytest.raises(OSError, match="libzstd.so.1"):
        orbax.load_checkpoint(os.path.join(chip_smoke.ORBAX_FIXTURE, "checkpoint_e3"))


def test_zstd_round_trips_and_checks_sizes():
    path = zstd.library_path()
    assert os.path.isfile(path) and "libzstd" in os.path.basename(path), path
    rng = np.random.default_rng(2)
    for data in (b"", rng.bytes(10), np.zeros(300_000, np.uint8).tobytes(), rng.bytes(400_000)):
        frame = zstd.compress(data)
        assert zstd.decompress(frame, len(data)) == data
        assert zstd.decompress_stream(frame) == data
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(zstd.compress(b"abc"), 2)
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress_stream(zstd.compress(rng.bytes(1000))[:-3])


# -- orbax checkpoints --------------------------------------------------------


@pytest.mark.parametrize("name, args", OPTIMIZERS)
def test_port_reads_every_leaf_jax_writes(jax_params, tmp_path, name, args):
    params = jax.tree.map(jnp.asarray, jax_params)
    opt_state = _stepped(jax_get_optimizer(name, args), params, 4)
    orbax_io.save_checkpoint(str(tmp_path), 2, params, opt_state, extra={"step": 7})
    path = os.path.join(str(tmp_path), "checkpoint_e2")
    got = orbax.load_checkpoint(path)
    want = {"params": jax_params, "epoch": 2, "opt_state": _plain(opt_state), "step": 7}
    _assert_same(got, want)
    _assert_same(got, _plain(orbax_io.load_checkpoint(path)))  # JAX's own nesting


@pytest.mark.parametrize("name, args", OPTIMIZERS)
def test_optimizer_state_crosses_both_ways(jax_params, tmp_path, name, args):
    """optax -> the port's Optimizer -> optax, bit for bit, through a JAX
    checkpoint directory and ``io.load_checkpoint``."""
    params = jax.tree.map(jnp.asarray, jax_params)
    opt_state = _stepped(jax_get_optimizer(name, args), params, 5)
    orbax_io.save_checkpoint(str(tmp_path), 0, params, opt_state, extra={"step": 1})
    payload = io.load_checkpoint(os.path.join(str(tmp_path), "checkpoint_e0"))
    model = OCRModel(ModelConfig.from_dict(CONFIG), device="cpu")
    model.load_state_dict(payload["model"], strict=True)
    optimizer = get_optimizer(name, args, model.parameters())
    keys = model.parameter_keys()
    optimizer.load_state_dict(shard_optimizer_state(payload["optimizer"], keys, create_mesh()))
    back = convert.jax_opt_state(optimizer.state_dict(), keys, name, args)
    _assert_same(back, _plain(opt_state))
    if args.get("lr_schedule"):
        schedule = optax.warmup_cosine_decay_schedule(
            0.0, args["lr"], args["lr_schedule"].get("warmup_steps", 0),
            args["lr_schedule"]["decay_steps"], args["lr_schedule"].get("end_value", 0.0))
        assert optimizer.optimizer.param_groups[0]["lr"] == pytest.approx(float(schedule(3)))


def test_sharded_bf16_int_and_out_of_line_leaves(tmp_path):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    rng = np.random.default_rng(6)
    tree = {"sharded": rng.normal(size=(8, 16)).astype(np.float32),
            "sharded_bf16": rng.normal(size=(4, 6)).astype(jnp.bfloat16),
            "big": rng.normal(size=(512, 64)).astype(np.float32),
            "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
            "i64": rng.integers(-2 ** 40, 2 ** 40, (3,)),
            "scalar": np.asarray(2.5, np.float32)}
    placed = {k: jnp.asarray(v) for k, v in tree.items() if k != "i64"}
    for k in ("sharded", "sharded_bf16"):
        placed[k] = jax.device_put(tree[k], NamedSharding(mesh, P("x", "y")))
    placed["i64"] = tree["i64"]  # int64 stays numpy: JAX without x64 has none
    orbax_io.save_checkpoint(str(tmp_path), 1, placed, extra={"step": 3, "rate": 0.25})
    path = os.path.join(str(tmp_path), "checkpoint_e1")
    store = _tensorstore(path)
    assert sorted(k for k in store if k.startswith(b"params.sharded/")) == [
        b"params.sharded/.zarray", b"params.sharded/0.0", b"params.sharded/0.1",
        b"params.sharded/1.0", b"params.sharded/1.1"]
    assert len(store[b"params.big/0.0"]) > ocdbt.MAX_INLINE_VALUE_BYTES  # in a data file
    got = orbax.load_checkpoint(path)
    _assert_same(got, {"params": tree, "epoch": 1, "step": 3, "rate": 0.25})


@pytest.mark.parametrize("template", [False, True])
def test_jax_restores_what_the_port_writes(jax_params, tmp_path, template):
    name, args = OPTIMIZERS[1]
    tx = jax_get_optimizer(name, args)
    params = jax.tree.map(jnp.asarray, jax_params)
    opt_state = _stepped(tx, params, 7)
    extra = {"step": 9}
    if not template:  # leaves of every kind the writer takes
        extra["other"] = {"half": torch.randn(3, 4).bfloat16(), "i32": np.arange(6, dtype=np.int32),
                          "i64": torch.arange(-3, 3), "rate": 0.5, "none": None,
                          "seq": [np.float32(1.5), (np.zeros((2, 0), np.float32),)]}
    orbax.save_checkpoint(str(tmp_path), 4, jax_params, _plain(opt_state), extra=extra)
    path = os.path.join(str(tmp_path), "checkpoint_e4")
    if template:
        item = {"params": params, "opt_state": tx.init(params), "epoch": 0, "step": 0}
        restored = orbax_io.load_checkpoint(path, template=item)
        assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(item)
    else:
        restored = orbax_io.load_checkpoint(path)
    want = {"params": jax_params, "epoch": 4, "opt_state": _plain(opt_state), **extra}
    if not template:
        other = want["other"]
        want["other"] = {"half": other["half"].view(torch.int16).numpy().view(jnp.bfloat16),
                         "i32": other["i32"], "i64": other["i64"].numpy(), "rate": 0.5,
                         "none": None, "seq": [np.asarray(np.float32(1.5)),
                                               [np.zeros((2, 0), np.float32)]]}
    restored = _plain(restored)
    if not template:  # restored bfloat16 as the port's reader gives it, to compare alike
        restored["other"]["half"] = torch.from_numpy(
            np.asarray(restored["other"]["half"]).view(np.int16)).view(torch.bfloat16)
    _assert_same(restored, want)
    if not template:
        _assert_same(orbax.load_checkpoint(path), {**want, "other": {
            **want["other"], "half": want["other"]["half"]}})


def test_committed_fixture_is_what_jax_restores():
    path = os.path.join(chip_smoke.ORBAX_FIXTURE, "checkpoint_e3")
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    assert size < 200_000
    got = orbax.load_checkpoint(path)
    want = chip_smoke.orbax_fixture_tree()
    want["params"]["half"] = want["params"]["half"].view(jnp.bfloat16)
    _assert_same(got, want)
    _assert_same(got, _plain(orbax_io.load_checkpoint(path)))
    store = ocdbt.read_store(path)
    assert len([k for k in store if k.startswith(b"params.sharded/") and b"zarray" not in k]) == 4
    assert len(store[b"params.table/0.0"]) > ocdbt.MAX_INLINE_VALUE_BYTES


def write_fixture(save_dir=os.path.dirname(chip_smoke.ORBAX_FIXTURE)):
    """Writes ``chip_smoke.orbax_fixture_tree()`` with JAX's orbax writer to
    ``save_dir/jax_orbax_fixture/checkpoint_e3``."""
    tree = chip_smoke.orbax_fixture_tree()
    p = tree["params"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    params = {"dense": jax.tree.map(jnp.asarray, p["dense"]),
              "sharded": jax.device_put(p["sharded"], NamedSharding(mesh, P("x", "y"))),
              "table": jnp.asarray(p["table"]), "half": jnp.asarray(p["half"].view(jnp.bfloat16)),
              "ids": jnp.asarray(p["ids"]), "wide": p["wide"]}
    adam = tree["opt_state"][1]
    opt_state = (optax.EmptyState(),
                 optax.ScaleByAdamState(count=jnp.asarray(adam["count"]),
                                        mu=jax.tree.map(jnp.asarray, adam["mu"]),
                                        nu=jax.tree.map(jnp.asarray, adam["nu"])),
                 optax.ScaleByScheduleState(count=jnp.asarray(tree["opt_state"][2]["count"])))
    out = os.path.join(save_dir, "jax_orbax_fixture")
    shutil.rmtree(out, ignore_errors=True)
    orbax_io.save_checkpoint(out, tree["epoch"], params, opt_state, extra={"step": tree["step"]})
    return out


# -- conversions --------------------------------------------------------------


def test_jax_from_state_dict_equals_the_shim_on_the_golden():
    ref = dict(np.load(os.path.join(GOLDEN, "model_state.npz")))
    want = convert_torch_state_dict(ref, num_encoder_layers=2, num_decoder_layers=2,
                                    resnet_depths=(1, 1, 1), glu=True)
    got = convert.jax_from_state_dict(ref)
    _assert_same(got, want)
    back = convert.state_dict_from_jax(got)
    assert sorted(back) == sorted(ref)
    for key, value in ref.items():
        assert back[key].numpy().tobytes() == value.tobytes(), key
    # A second registration of a shared tensor that differs, and a stray key.
    bad = dict(ref)
    bad["encoder.attn_layers.layers.1.0.weight"] = ref["encoder.attn_layers.layers.1.0.weight"] + 1
    with pytest.raises(ValueError, match="layers.1.0.weight differs"):
        convert.jax_from_state_dict(bad)
    with pytest.raises(ValueError, match="no place.*stray"):
        convert.jax_from_state_dict(dict(ref, stray=np.zeros(1)))


@pytest.mark.parametrize("overrides", [
    {"encoder": dict(TINY_CONFIG["encoder"], embed_layer="patch")},
    {"glu": False},
    {"decoder": dict(TINY_CONFIG["decoder"], cross_attend=False)},
])
def test_jax_from_state_dict_inverts_state_dict_from_jax(overrides):
    cfg = dict(CONFIG, **overrides)
    model = OCRModel(ModelConfig.from_dict(cfg), device="cpu")
    state = model.state_dict()
    tree = convert.jax_from_state_dict(state)
    shapes = jax.eval_shape(JaxOCRModel(JaxModelConfig.from_dict(cfg)).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1)),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    assert jax.tree.map(lambda s: s.shape, shapes) == jax.tree.map(np.shape, tree)
    back = convert.state_dict_from_jax(tree)
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    # Named once, as the optimizer names them: the aliases may be missing.
    once = {k: state[k] for k in model.parameter_keys()}
    _assert_same(convert.jax_from_state_dict(once), tree)


def test_unmappable_optimizer_state_raises_naming_its_path(jax_params, tmp_path):
    params = jax.tree.map(jnp.asarray, jax_params)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.scale_by_rms())
    orbax_io.save_checkpoint(str(tmp_path), 0, params, _stepped(tx, params, 8))
    with pytest.raises(ValueError, match=r"opt_state\.1: optax state \['nu'\]"):
        io.load_checkpoint(os.path.join(str(tmp_path), "checkpoint_e0"))
    # The port's optimizer and the checkpoint disagree on a schedule.
    payload = convert.optimizer_state_from_jax(_plain(_stepped(
        jax_get_optimizer(*OPTIMIZERS[1]), params, 8)))
    model = OCRModel(ModelConfig.from_dict(CONFIG), device="cpu")
    optimizer = get_optimizer("Adam", {"lr": 1e-3}, model.parameters())
    with pytest.raises(ValueError, match="schedule"):
        optimizer.load_state_dict(shard_optimizer_state(payload, model.parameter_keys(),
                                                        create_mesh()))


# -- a JAX run continued by the port ------------------------------------------


def _batch(seed, b=4, t=12):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, 32, 64, 1)).astype(np.float32)
    targets = np.full((b, t), 999, np.int32)
    for i in range(b):
        n = int(rng.integers(2, t - 2))
        targets[i, 0] = 998
        targets[i, 1: n + 1] = rng.integers(0, 990, n)
        targets[i, n + 1] = 997
    return images, targets


def _resume(tmp_path, dropout):
    """JAX takes 2 steps and saves, then its step 3; the port resumes from the
    save and takes step 3 on the same batch. Returns both step-3 params as
    reference-keyed state dicts, and the JAX save_dir."""
    name, args = OPTIMIZERS[1]
    # The grey patch embed: the hybrid backbone's gradient takes JAX long to compile.
    cfg = dict(CONFIG, encoder=dict(CONFIG["encoder"], embed_layer="patch"),
               decoder=dict(CONFIG["decoder"], dropout=dropout))
    model = JaxOCRModel(JaxModelConfig.from_dict(cfg))
    tx = jax_get_optimizer(name, args)
    batches = [_batch(20 + i) for i in range(3)]
    init = OCRModel(ModelConfig.from_dict(cfg), device="cpu", seed=5).state_dict()
    params = jax.tree.map(jnp.asarray, convert.jax_from_state_dict(init))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), dropout_rng=jax.random.PRNGKey(5))
    step = jax_make_train_step(model, tx)
    for images, targets in batches[:2]:
        state, _ = step(state, jnp.asarray(images), jnp.asarray(targets))
    save_dir = str(tmp_path / "jax")
    orbax_io.save_checkpoint(save_dir, 0, state.params, state.opt_state,
                             extra={"step": int(state.step)})
    state, _ = step(state, jnp.asarray(batches[2][0]), jnp.asarray(batches[2][1]))
    want = convert.state_dict_from_jax(jax.tree.map(np.asarray, state.params))

    port = OCRModel(ModelConfig.from_dict(cfg), device="cpu")
    optimizer = get_optimizer(name, args, port.parameters())
    payload = io.load_checkpoint(io.latest_checkpoint(save_dir))
    port.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(shard_optimizer_state(payload["optimizer"],
                                                    port.parameter_keys(), create_mesh()))
    port_state = create_train_state(port, optimizer, seed=5)
    port_state.step = payload["step"]
    assert (payload["step"], payload["epoch"]) == (2, 0)
    make_train_step()(port_state, *map(torch.from_numpy, batches[2]))
    return port.state_dict(), want, save_dir


def test_port_resumes_a_jax_run_as_jax_continues(tmp_path):
    got, want, _ = _resume(tmp_path, dropout=0.0)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=RESUME_RTOL,
                                   atol=RESUME_RTOL * float(value.abs().max()), err_msg=key)


def test_dropout_masks_diverge_after_a_resume(tmp_path):
    """Pinned divergence: JAX draws step 3's masks from fold_in(dropout_rng,
    step), the port from its own generator, so with dropout the resumed step
    leaves JAX's (the numbers match only without dropout)."""
    got, want, _ = _resume(tmp_path, dropout=0.3)
    worst = max(float((got[k] - v).abs().max() / v.abs().max().clamp_min(1e-12))
                for k, v in want.items() if k.startswith("decoder.net.attn_layers"))
    assert worst > 100 * RESUME_RTOL


def _dataset(n=6):
    rng = np.random.default_rng(9)
    images = [np.where(rng.random((32, 64)) < 0.1, 0, 255).astype(np.uint8) for _ in range(n)]
    tokens = [list(rng.integers(0, 990, int(rng.integers(3, 10)))) for _ in range(n)]
    return ImageDataset.from_arrays(images, tokens)


def test_train_model_resumes_and_warm_starts_from_a_jax_save_dir(jax_params, tmp_path):
    from texocr_tpu_torch.training.loop import train_model

    name, args = OPTIMIZERS[1]
    params = jax.tree.map(jnp.asarray, jax_params)
    save_dir = str(tmp_path / "jax")
    orbax_io.save_checkpoint(save_dir, 0, params, _stepped(jax_get_optimizer(name, args),
                                                          params, 3), extra={"step": 1})
    ds = _dataset()
    config = dict(CONFIG, batch_size=3, seq_pad_multiple=8, optimizer=name, optimizer_args=args,
                  seed=3, n_epochs=2, save_dir=save_dir, resume=True)
    model, state, history = train_model(ds, None, config, verbose=False, device="cpu")
    assert len(history) == 1 and np.isfinite(history).all()  # epoch 1 only
    assert state.step == 1 + 2
    assert sorted(os.listdir(save_dir)) == ["checkpoint_e0", "checkpoint_e1"]
    assert os.path.exists(os.path.join(save_dir, "checkpoint_e1", io.STATE_FILE))
    adam = state.optimizer.state_dict()["optimizer"]["state"][0]
    assert float(adam["step"]) == 3.0 + 2  # the checkpoint's Adam count, then 2 steps

    warm = dict(config, resume=False, init_from=os.path.join(save_dir, "checkpoint_e0"),
                save_dir=str(tmp_path / "warm"), n_epochs=1, save_checkpoint=False)
    captured = {}
    original = OCRModel.load_state_dict

    def spy(self, state_dict, *a, **k):
        captured.update(state_dict)
        return original(self, state_dict, *a, **k)

    OCRModel.load_state_dict = spy
    try:
        train_model(ds, None, warm, verbose=False, device="cpu")
    finally:
        OCRModel.load_state_dict = original
    want = convert.state_dict_from_jax(jax_params)
    for key, value in want.items():
        assert torch.equal(captured[key], value), key


def test_weights_serving_and_eval_take_a_jax_dir_without_its_cache(jax_params, tmp_path):
    save_dir = str(tmp_path / "ckpts")
    orbax_io.save_checkpoint(save_dir, 5, jax.tree.map(jnp.asarray, jax_params))
    ckpt = os.path.join(save_dir, "checkpoint_e5")
    want = convert.state_dict_from_jax(jax_params)
    for path in (ckpt, save_dir):
        got = io.load_weights(path)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], v) for k, v in want.items())
    engine = TexOCR(dict(CONFIG, tokenizer_path=DEFAULT_VOCAB_PATH, model_path=ckpt),
                    device="cpu")
    assert all(torch.equal(engine.model.state_dict()[k], v) for k, v in want.items())

    rng = np.random.default_rng(4)
    images = [np.where(rng.random((32, 64)) < 0.1, 0, 255).astype(np.uint8) for _ in range(4)]
    tokens = [list(rng.integers(0, 990, 5)) for _ in range(4)]
    os.makedirs(tmp_path / "data" / "test")
    ImageDataset.from_arrays(images, tokens).save(str(tmp_path / "data" / "test" / "testset.pkl"))
    config = tmp_path / "config.json"
    config.write_text(json.dumps({**{k: v for k, v in CONFIG.items()
                                     if k not in ("max_length", "vocab_size")}, "batch_size": 2}))
    npz = tmp_path / "model.npz"
    np.savez(npz, **{k: v.numpy() for k, v in want.items()})
    metrics = []
    for checkpoint in (ckpt, npz):
        args = eval_cli.parse_args(["-d", str(tmp_path / "data"), "--config", str(config),
                                    "--checkpoint", str(checkpoint), "--max_len", "6",
                                    "--device", "cpu"])
        metrics.append(eval_cli.main(args))
    assert metrics[0] == metrics[1] and metrics[0]["batches"] >= 1
    assert not os.path.exists(os.path.join(ckpt, orbax.PARAMS_CACHE))  # the port writes none


if __name__ == "__main__":
    print("wrote", write_fixture())
    sys.exit(0)
