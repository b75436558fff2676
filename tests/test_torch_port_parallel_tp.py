"""The port's tensor parallelism on two ranks, and greedy decode under a
data x model mesh, against the JAX package on the CPU (the tiny config in
float32; see ``test_torch_port_parallel.py`` for the set-up and the
tolerances).

- ``{model: 2}``: three Adam steps, ``grad_clip`` on, masked loss, shards
  with different pad counts: losses and gathered parameters against JAX's
  step on its fake mesh of the same spec and against the single-process
  port.
- Greedy and beam 3 decode under ``{data: 2, model: 2}``
  (``mesh_generate``: rows over 'data', heads through the cached step over
  'model', an image's beams on its data rank): tokens equal to the
  single-process port's and to JAX's sharded decode
  (``tests/test_train.py::test_sharded_decode_matches_single_device``), on
  one spawn of four ranks.
- On one spawn of two ranks: sampled decode at 0.3 under ``{model: 2}`` and
  ``{data: 2}`` from the same seed, equal to the single-process port's
  tokens at that seed (JAX's draws differ by design: the port samples with
  Gumbel-max); greedy with int8 cross and self caches under ``{model: 2}``,
  equal to the single process's; ``make_graphed_generate`` under
  ``{model: 2}``, which raises ``NotImplementedError`` with its reason; and
  a batch of 3 under ``{data: 2}``, which ``batch_rows`` refuses with
  ``ValueError``.

Tokens are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_port_parallel_ranks as ranks
from tests.test_torch_port_parallel import batches, check_mesh_run, mesh_runs
from tests.tiny import TINY_CONFIG, tiny_model_config
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu.models.beam import beam_decode as jax_beam_decode
from texocr_tpu.models.generate import greedy_decode as jax_greedy_decode
from texocr_tpu.parallel import create_mesh as jax_create_mesh
from texocr_tpu.parallel.sharding import batch_sharding, shard_pytree
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.parallel.dryrun import spawn

torch.set_num_threads(1)
DECODE_LEN = 12
DECODE_SPEC = {"data": 2, "model": 2}
BEAM = 3
SAMPLE_SEED = 11
INT8 = dict(TINY_CONFIG, kv_quant="int8", self_kv_quant="int8")


@pytest.fixture(scope="module")
def jax_init():
    model = JaxOCRModel(tiny_model_config())
    images, labels = batches(1)[0]
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                 jnp.asarray(labels))["params"]
    return model, jax.tree.map(np.asarray, params)


def test_train_on_model_2_matches_jax_and_single_process(jax_init, tmp_path):
    single, results = mesh_runs(jax_init, str(tmp_path), [{"model": 2}], world=2)
    check_mesh_run(jax_init, {"model": 2}, single, [r[0] for r in results])


def _jax_decode(model, params, images, spec, mode):
    cfg = model.config
    kw = dict(bos_token=cfg.bos_token, eos_token=cfg.eos_token, pad_token=cfg.pad_token,
              max_len=DECODE_LEN)

    def decode(variables, images):
        enc = model.apply(variables, images, method=JaxOCRModel.encode)
        if mode == "beam":
            return jax_beam_decode(model, variables, enc, beam_size=BEAM, **kw)
        return jax_greedy_decode(model, variables, enc, **kw)

    mesh = jax_create_mesh(spec)
    variables = {"params": shard_pytree(jax.tree.map(jnp.array, params), mesh)}
    return np.asarray(jax.jit(decode)(variables,
                                      jax.device_put(jnp.asarray(images), batch_sharding(mesh))))


def _images(seed, n):
    return np.random.default_rng(seed).normal(size=(n, 32, 64, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def four_rank_decodes(jax_init, tmp_path_factory):
    """Greedy and beam on four ranks under DECODE_SPEC: each rank's tokens."""
    weights = state_dict_from_jax(jax_init[1])
    images = _images(7, 8)
    runs = [("greedy", (DECODE_SPEC, TINY_CONFIG, weights, images, DECODE_LEN)),
            ("decode", (DECODE_SPEC, TINY_CONFIG, weights, images, DECODE_LEN, "beam", 0, BEAM))]
    store = str(tmp_path_factory.mktemp("four_rank_decodes"))
    return images, spawn(ranks.world_program, 4, (runs,), store_dir=store)


def test_greedy_decode_under_data_and_model_matches_jax_and_single_process(jax_init,
                                                                            four_rank_decodes):
    model, params = jax_init
    weights = state_dict_from_jax(params)
    images, results = four_rank_decodes
    single = ranks.greedy(None, TINY_CONFIG, weights, images, DECODE_LEN)
    want = _jax_decode(model, params, images, DECODE_SPEC, "greedy")
    assert want.shape == (8, DECODE_LEN)
    np.testing.assert_array_equal(single, want)
    for rank in results:  # every rank holds the whole batch's tokens
        np.testing.assert_array_equal(rank[0], want)


def test_beam_decode_under_data_and_model_matches_jax_and_single_process(jax_init,
                                                                          four_rank_decodes):
    model, params = jax_init
    weights = state_dict_from_jax(params)
    images, results = four_rank_decodes
    single = ranks.decode(None, TINY_CONFIG, weights, images, DECODE_LEN, "beam", 0, BEAM)
    want = _jax_decode(model, params, images, DECODE_SPEC, "beam")
    assert want.shape == (8, DECODE_LEN)
    np.testing.assert_array_equal(single, want)
    for rank in results:
        np.testing.assert_array_equal(rank[1], want)


TWO_RANK_RUNS = {
    "sample model": ({"model": 2}, TINY_CONFIG, "sample"),
    "sample data": ({"data": 2}, TINY_CONFIG, "sample"),
    "int8 greedy model": ({"model": 2}, INT8, "greedy"),
}


@pytest.fixture(scope="module")
def two_rank_decodes(jax_init, tmp_path_factory):
    """TWO_RANK_RUNS on 4 images and the 3-image batch, on one spawn of two
    ranks: each rank's results, in that order."""
    weights = state_dict_from_jax(jax_init[1])
    runs = [("decode", (spec, config, weights, _images(8, 4), DECODE_LEN, mode, SAMPLE_SEED))
            for spec, config, mode in TWO_RANK_RUNS.values()]
    runs.append(("graphs", ({"model": 2}, TINY_CONFIG, weights)))
    runs.append(("decode", ({"data": 2}, TINY_CONFIG, weights, _images(9, 3), DECODE_LEN,
                            "greedy")))
    store = str(tmp_path_factory.mktemp("two_rank_decodes"))
    return weights, spawn(ranks.world_program, 2, (runs,), store_dir=store)


@pytest.mark.parametrize("name", list(TWO_RANK_RUNS))
def test_decode_on_two_ranks_matches_single_process(two_rank_decodes, name):
    weights, results = two_rank_decodes
    _, config, mode = TWO_RANK_RUNS[name]
    want = ranks.decode(None, config, weights, _images(8, 4), DECODE_LEN, mode, SAMPLE_SEED)
    assert want.shape == (4, DECODE_LEN)
    index = list(TWO_RANK_RUNS).index(name)
    for rank in results:
        np.testing.assert_array_equal(rank[index], want)


def test_sampled_decode_draws_other_tokens_from_another_seed(jax_init):
    """The single-process tokens the ranks are held to are draws: another
    seed gives other tokens."""
    weights = state_dict_from_jax(jax_init[1])
    images = _images(8, 4)
    a = ranks.decode(None, TINY_CONFIG, weights, images, DECODE_LEN, "sample", SAMPLE_SEED)
    b = ranks.decode(None, TINY_CONFIG, weights, images, DECODE_LEN, "sample", SAMPLE_SEED + 1)
    assert not np.array_equal(a, b)


def test_graphs_on_a_tensor_parallel_model_raise_with_the_reason(two_rank_decodes):
    _, results = two_rank_decodes
    for rank in results:
        kind, message = rank[-2]
        assert kind == "NotImplementedError"
        assert "cannot be captured" in message and "one GPU per rank" in message


def test_a_batch_the_data_axis_does_not_divide_raises(two_rank_decodes):
    _, results = two_rank_decodes
    for rank in results:
        assert "does not split over 2 data ranks" in rank[-1]
