"""The port's tensor parallelism on two ranks, and greedy decode under a
data x model mesh, against the JAX package on the CPU (the tiny config in
float32; see ``test_torch_port_parallel.py`` for the set-up and the
tolerances).

- ``{model: 2}``: three Adam steps, ``grad_clip`` on, masked loss, shards
  with different pad counts: losses and gathered parameters against JAX's
  step on its fake mesh of the same spec and against the single-process
  port.
- Greedy decode under ``{data: 2, model: 2}`` (``mesh_greedy_decode``: rows
  over 'data', heads through the cached step over 'model'): tokens equal to
  the single-process port's and to JAX's sharded decode
  (``tests/test_train.py::test_sharded_decode_matches_single_device``).
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
from texocr_tpu.models.generate import greedy_decode as jax_greedy_decode
from texocr_tpu.parallel import create_mesh as jax_create_mesh
from texocr_tpu.parallel.sharding import batch_sharding, shard_pytree
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.parallel.dryrun import spawn

torch.set_num_threads(1)
DECODE_LEN = 12
DECODE_SPEC = {"data": 2, "model": 2}


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


def _jax_greedy(model, params, images, spec):
    cfg = model.config

    def decode(variables, images):
        enc = model.apply(variables, images, method=JaxOCRModel.encode)
        return jax_greedy_decode(model, variables, enc, bos_token=cfg.bos_token,
                                 eos_token=cfg.eos_token, pad_token=cfg.pad_token,
                                 max_len=DECODE_LEN)

    mesh = jax_create_mesh(spec)
    variables = {"params": shard_pytree(jax.tree.map(jnp.array, params), mesh)}
    return np.asarray(jax.jit(decode)(variables,
                                      jax.device_put(jnp.asarray(images), batch_sharding(mesh))))


def test_greedy_decode_under_data_and_model_matches_jax_and_single_process(jax_init, tmp_path):
    model, params = jax_init
    weights = state_dict_from_jax(params)
    images = np.random.default_rng(7).normal(size=(8, 32, 64, 1)).astype(np.float32)
    single = ranks.greedy(None, TINY_CONFIG, weights, images, DECODE_LEN)
    runs = [("greedy", (DECODE_SPEC, TINY_CONFIG, weights, images, DECODE_LEN))]
    results = spawn(ranks.world_program, 4, (runs,), store_dir=str(tmp_path))
    want = _jax_greedy(model, params, images, DECODE_SPEC)
    assert want.shape == (8, DECODE_LEN)
    np.testing.assert_array_equal(single, want)
    for rank in results:  # every rank holds the whole batch's tokens
        np.testing.assert_array_equal(rank[0], want)
