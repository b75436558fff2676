"""The port's parallelism (``texocr_tpu_torch/parallel/``) against the JAX
package's on the CPU, at the tiny config (``tests/tiny.py``: 2 heads, vocab
50, MLP hidden 128) in float32.

Ranks are spawned over gloo with a ``file://`` store under ``tmp_path``
(``parallel.dryrun.spawn``), one torch thread each; their programs are in
``test_torch_port_parallel_ranks.py``. Weights are JAX's initial parameters
carried across with ``state_dict_from_jax`` and cut with
``shard_state_dict``. The JAX steps run on its fake 8-device CPU mesh of the
same spec (``create_train_state(..., mesh=)`` and ``put_batch``, as
``tests/test_train.py``).

This file: the mesh's shapes and errors, the partition rules in process, and
three Adam steps (``grad_clip`` on, masked loss, data shards holding
different numbers of pad tokens) under ``{data: 2, model: 2}`` and
``{data: 4}``. ``test_torch_port_parallel_tp.py`` holds ``{model: 2}``,
``{model: 4}`` and decode; ``test_torch_port_parallel_runs.py`` the resident
data, checkpoints, the CLI and the dry run.

Tolerances: losses and token accuracy within 1e-5 relative of JAX's on the
same mesh and of the single-process port's (they agree to about 1e-7). The
gathered parameters after three steps: within 1e-5 relative plus 3e-5
absolute (1% of the most that three Adam steps at lr 1e-3 move a
parameter), except at most 0.1% of a tensor's elements, which stay within
two such moves. Those are elements of the weight-standardised
convolutions, whose gradients nearly cancel within each output channel:
Adam's normalised step (eps 1e-8) turns their float32 rounding, which
depends on the order of the sums, into steps of either sign. JAX's own
single-device and {data: 2, model: 2} runs differ there by 2.7e-6, the
port's {model: 2} and JAX's by up to 1.1e-4 at 4 of 9216 elements; every
other parameter agrees within 3e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_port_parallel_ranks as ranks
from tests.tiny import TINY_CONFIG, tiny_model_config
from texocr_tpu.config import ModelConfig as JaxModelConfig
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.parallel import create_mesh as jax_create_mesh
from texocr_tpu.parallel.sharding import param_partition_spec as jax_partition_spec
from texocr_tpu.parallel.sharding import shard_pytree
from texocr_tpu.training.optimizers import get_optimizer as jax_get_optimizer
from texocr_tpu.training.train_step import TrainState as JaxTrainState
from texocr_tpu.training.train_step import make_train_step as jax_make_train_step
from texocr_tpu.training.train_step import put_batch
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.config import FLAGSHIP
from texocr_tpu_torch.parallel.dryrun import spawn
from texocr_tpu_torch.parallel.mesh import create_mesh
from texocr_tpu_torch.parallel.sharding import (
    param_partition_spec,
    place_shard,
    shard_tensor,
    split_dim,
)
from texocr_tpu_torch.telemetry import profile_trace

torch.set_num_threads(1)
PAD, BOS, EOS = TINY_CONFIG["trg_pad_idx"], TINY_CONFIG["bos_token"], TINY_CONFIG["eos_token"]
OPT_ARGS = {"lr": 1e-3, "grad_clip": 0.1}
RTOL = 1e-5
MAX_MOVE = OPT_ARGS["lr"] * 3  # three Adam steps move a parameter at most about this
PARAM_ATOL = 0.01 * MAX_MOVE
OFF_SHARE = 1e-3
# Per row of a batch of 8, its token count: the 4 data shards of 2 rows
# hold 8, 17, 7 and 13 real labels, so different numbers of pad tokens.
LENGTHS = (2, 4, 9, 6, 5, 0, 10, 1)


def batches(n=3, t=14):
    """``n`` global batches of 8 images and BOS, tokens, EOS, PAD rows."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        images = rng.normal(size=(8, 32, 64, 1)).astype(np.float32)
        labels = np.full((8, t), PAD, np.int32)
        for row, n_tokens in enumerate(LENGTHS):
            labels[row, 0] = BOS
            labels[row, 1: n_tokens + 1] = rng.integers(0, 47, n_tokens)
            labels[row, n_tokens + 1] = EOS
        out.append((images, labels))
    return out


@pytest.fixture(scope="module")
def jax_init():
    """The JAX tiny model and its initial parameters as numpy arrays."""
    model = JaxOCRModel(tiny_model_config())
    images, labels = batches(1)[0]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                 jnp.asarray(labels))["params"]
    return model, jax.tree.map(np.asarray, params)


def jax_train(model, params, spec, data):
    """JAX's train step on its fake CPU mesh of ``spec``: each step's (loss,
    token accuracy) and the final parameters as a port state dict."""
    tx = jax_get_optimizer("Adam", OPT_ARGS)
    mesh = jax_create_mesh(spec)
    sharded = shard_pytree(jax.tree.map(jnp.array, params), mesh)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=sharded,
                          opt_state=jax.jit(tx.init)(sharded),
                          dropout_rng=jax.random.PRNGKey(1))
    step = jax_make_train_step(model, tx)
    metrics = []
    for images, labels in data:
        state, m = step(state, *put_batch(mesh, images, labels))
        metrics.append((float(m["loss"]), float(m["token_acc"])))
    return metrics, state_dict_from_jax(jax.tree.map(np.asarray, state.params))


def assert_weights_close(got, want, what):
    """The tolerances of the module docstring."""
    assert sorted(got) == sorted(want), what
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        err = np.abs(a - b)
        off = err > PARAM_ATOL + RTOL * np.abs(b)
        assert off.sum() <= OFF_SHARE * a.size, (what, key, off.sum(), err.max())
        assert (err <= 2 * MAX_MOVE).all(), (what, key, err.max())


FOUR_RANK_SPECS = [{"data": 2, "model": 2}, {"data": 4}, {"model": 4}]


def mesh_runs(jax_init, store_dir, specs, world):
    """The single-process port's three steps, and each of ``specs``' on
    ``world`` spawned ranks (one spawn): (single, [each rank's results])."""
    _, params = jax_init
    weights = state_dict_from_jax(params)
    data = batches()
    single = ranks.train_steps(None, TINY_CONFIG, weights, data, OPT_ARGS)
    runs = [("train_steps", (spec, TINY_CONFIG, weights, data, OPT_ARGS)) for spec in specs]
    return single, spawn(ranks.world_program, world, (runs,), store_dir=store_dir)


def check_mesh_run(jax_init, spec, single, per_rank):
    """Holds one mesh's run (``per_rank``: each rank's result) to JAX's on
    the same mesh and to the single-process port."""
    model, params = jax_init
    got = per_rank[0]
    want_metrics, want_weights = jax_train(model, params, spec, batches())
    assert got["round_trip"]  # gather_state_dict(shard_state_dict(x)) is x, bit for bit
    assert all(r["metrics"] == got["metrics"] for r in per_rank)  # global on every rank
    np.testing.assert_allclose(got["metrics"], want_metrics, rtol=RTOL)
    np.testing.assert_allclose(got["metrics"], single["metrics"], rtol=RTOL)
    assert_weights_close(got["weights"], want_weights, f"{spec} vs JAX")
    assert_weights_close(got["weights"], single["weights"], f"{spec} vs single process")


@pytest.fixture(scope="module")
def four_ranks(jax_init, tmp_path_factory):
    return mesh_runs(jax_init, str(tmp_path_factory.mktemp("store")), FOUR_RANK_SPECS, world=4)


@pytest.mark.parametrize("index", range(len(FOUR_RANK_SPECS)),
                         ids=["data2-model2", "data4", "model4"])
def test_train_on_four_ranks_matches_jax_and_single_process(jax_init, four_ranks, index):
    """Three Adam steps on {data: 2, model: 2}, {data: 4} and {model: 4}
    (2 heads over 4: attention replicated, the MLP and vocab split)."""
    single, results = four_ranks
    check_mesh_run(jax_init, FOUR_RANK_SPECS[index], single, [r[index] for r in results])


# -- the mesh ---------------------------------------------------------------------


@pytest.mark.parametrize("spec", [{"data": -1}, {"data": 2, "model": 2},
                                  {"data": -1, "model": 2}, {"model": 4}, None])
def test_create_mesh_matches_jax(spec):
    """Shapes over 8 processes as JAX's over its 8 fake devices, and rank
    d * model + m at (d, m), as JAX's row-major reshape of its devices."""
    want = jax_create_mesh(spec)
    got = create_mesh(spec, world=8)
    assert got.mesh_dim_names == ("data", "model") == want.axis_names
    assert tuple(got.mesh.shape) == want.devices.shape
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.mesh.numpy(), ids - ids.min())


@pytest.mark.parametrize("spec, world", [({"data": -1, "model": -1}, 8), ({"data": 16}, 8),
                                         ({"data": -1, "model": 3}, 8), ({"data": 2}, 1)])
def test_create_mesh_errors_match_jax(spec, world):
    """Two wildcards, too few ranks, fixed axes that do not divide: the same
    ValueError as JAX's ``create_mesh`` over as many devices."""
    with pytest.raises(ValueError) as jax_error:
        jax_create_mesh(spec, devices=jax.devices()[:world])
    with pytest.raises(ValueError) as port_error:
        create_mesh(spec, world=world)
    assert str(port_error.value) == str(jax_error.value)


def test_create_mesh_without_a_process_group_is_one_by_one():
    mesh = create_mesh({"data": -1, "model": 1})
    assert tuple(mesh.mesh.shape) == (1, 1)


# -- the partition rules ----------------------------------------------------------


def _jax_split_dims(config, model):
    """Each port key's (full shape, JAX's split dimension in torch's layout
    after JAX's divisibility fallback), from a JAX tree of tags converted
    with ``state_dict_from_jax``."""
    jax_model = JaxOCRModel(JaxModelConfig.from_dict(config))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 64, 1)), jnp.zeros((1, 4), jnp.int32))["params"]
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    dims = []
    for path, leaf in leaves:
        spec = jax_partition_spec(path, leaf)
        split = [d for d, ax in enumerate(spec) if ax == "model" and leaf.shape[d] % model == 0]
        dim = split[0] if split else None
        if dim is not None and len(leaf.shape) == 2 and path[-1].key == "kernel":
            dim = 1 - dim  # (in, out) -> torch's (out, in)
        dims.append(dim)
    tags = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.int32) for i, (_, leaf) in enumerate(leaves)])
    return {key: (tuple(t.shape), dims[int(t.reshape(-1)[0])])
            for key, t in state_dict_from_jax(tags).items()}


def _attention(key):
    parts = key.split(".")
    return parts[-1] == "weight" and (parts[-2] in ("q", "k", "v")
                                      or parts[-3:-1] == ["fc_out", "0"])


@pytest.mark.parametrize("name, model", [("flagship", 2), ("flagship", 4), ("tiny", 4)])
def test_partition_rules_split_jaxs_dimensions(name, model):
    """For every parameter, the port splits the dimension that JAX's rules
    split (``param_partition_spec`` and ``shard_pytree``'s fallback), but for
    the two documented exceptions: attention that 'model' does not divide by
    whole heads stays replicated (tiny: 2 heads over 4, where GSPMD splits
    inside a head), and GEGLU's fc_in splits each of its (value, gate)
    halves (the same dimension; its columns: the next test)."""
    config = dict(FLAGSHIP, img_size=(32, 64)) if name == "flagship" else TINY_CONFIG
    mesh = create_mesh({"model": model}, world=model)
    want = _jax_split_dims(config, model)
    differ = set()
    for key, (shape, dim) in want.items():
        spec = param_partition_spec(key, shape, mesh)
        if (spec.index("model") if spec else None) != dim:
            differ.add(key)
    replicated_heads = config["encoder"]["heads"] % model != 0
    assert differ == {k for k in want if replicated_heads and _attention(k)}, sorted(differ)
    assert sum(dim is not None for _, dim in want.values()) > 0


@pytest.mark.parametrize("model", [2, 4])
def test_glu_halves_and_round_trip(model):
    """GEGLU's fc_in: each rank holds the same columns of the value half as
    of the gate half, and the ranks' columns cover both halves once. Every
    key's slices placed back (``place_shard``, what ``gather_state_dict``
    all-reduces) sum to the full tensor bit for bit."""
    hidden = 2 * 4 * TINY_CONFIG["encoder"]["embed_dim"]
    key = "encoder.attn_layers.layers.1.1.fc_in.fc.weight"
    ids = torch.arange(hidden, dtype=torch.float32)[:, None].expand(hidden, 32)
    seen = []
    for rank in range(model):
        rows = shard_tensor(key, ids, model, rank)[:, 0].long()
        value, gate = rows[rows < hidden // 2], rows[rows >= hidden // 2] - hidden // 2
        assert torch.equal(value, gate) and len(value) == hidden // 2 // model
        seen.append(rows)
    assert torch.equal(torch.cat(seen).sort().values, torch.arange(hidden))

    rng = np.random.default_rng(3)
    for key, (shape, _) in _jax_split_dims(TINY_CONFIG, model).items():
        full = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        parts = [place_shard(key, shard_tensor(key, full, model, r), shape, model, r)
                 for r in range(model)]
        if split_dim(key, shape, model) is None:
            assert all(p is full for p in parts), key
        else:
            assert torch.equal(sum(parts[1:], parts[0]), full), key


def test_profile_trace_writes_the_blocks_ops(tmp_path):
    a = torch.ones(64, 64)
    with profile_trace(str(tmp_path), name="block"):
        torch.mm(a, a)
    path = tmp_path / "block.json"
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mm" in names
    assert os.path.getsize(path) > 0
