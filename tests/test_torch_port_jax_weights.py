"""Weights of a JAX training run read by the port, and the reference's
public helpers in ``texocr_tpu_torch.utils``, against the JAX package on the
CPU.

- ``checkpoint.msgpack.unpackb`` against the ``msgpack`` package on every
  header flax's subset has (ints and floats of each width, big-endian; str
  against bin; fixext and ext 8/16/32), and its errors.
- ``load_jax_params`` of ``flax.serialization.msgpack_serialize`` output: the
  tiny model's JAX params, a bfloat16 tree, and a leaf chunked by patching
  flax's ``MAX_CHUNK_SIZE`` small (inside the test only); each equal, bit
  for bit, to ``state_dict_from_jax`` of the same params. A real orbax
  checkpoint directory: refused with the ``ValueError`` that names
  ``params_cache.msgpack`` until the JAX package's ``load_params_fast`` has
  written it, then read, directly, through its save_dir
  (``load_weights``) and by ``TexOCR``'s ``model_path``.
- ``count_parameters``, ``alphabetize_config`` and ``center_pad_image``
  against ``texocr_tpu.utils``: equal counts, files and arrays.

Every comparison is exact.
"""

import os
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from tests.tiny import TINY_CONFIG
from texocr_tpu import utils as jax_utils
from texocr_tpu.checkpoint.orbax_io import load_params_fast, save_checkpoint
from texocr_tpu.config import ModelConfig as JaxModelConfig
from texocr_tpu.models import OCRModel as JaxOCRModel
from texocr_tpu_torch import utils
from texocr_tpu_torch.checkpoint import load_jax_params, load_weights, state_dict_from_jax
from texocr_tpu_torch.checkpoint.msgpack import unpackb
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.serving import TexOCR
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

torch.set_num_threads(1)
# The tiny model at the shipped tokenizer's vocabulary, so TexOCR loads it.
CONFIG = dict(TINY_CONFIG, vocab_size=1000, bos_token=998, eos_token=997, trg_pad_idx=999)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxOCRModel(JaxModelConfig.from_dict(CONFIG))
    params = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 64, 1)),
                                 jnp.full((1, 8), 999, jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key


VALUES = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
          2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63, 1.5,
          -2.25e300, "", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é", b"", b"x" * 3,
          b"y" * 300, b"z" * 70000, list(range(16)), list(range(70000)),
          {str(i): i for i in range(16)}, {str(i): [i, {"k": b"v"}] for i in range(70000)}]


@pytest.mark.parametrize("index", range(len(VALUES)))
def test_unpackb_reads_what_msgpack_writes(index):
    value = VALUES[index]
    assert unpackb(msgpack.packb(value, use_bin_type=True)) == value
    if isinstance(value, float):
        assert unpackb(msgpack.packb(value, use_single_float=True)) == np.float32(value)


@pytest.mark.parametrize("length", [1, 2, 4, 8, 16, 3, 300, 70000])
def test_ndarray_ext_in_fixext_and_ext_headers(length):
    """The ndarray triple in fixext 1-16 and ext 8/16/32 headers alike."""
    triple = msgpack.packb(((length,), "uint8", bytes(range(256)) * (length // 256)
                            + bytes(range(length % 256))), use_bin_type=True)
    data = msgpack.packb(msgpack.ExtType(1, triple))
    want = np.frombuffer(bytes(range(256)) * (length // 256) + bytes(range(length % 256)),
                         np.uint8)
    np.testing.assert_array_equal(unpackb(data), want)


def test_numeric_leaves_and_scalars_of_every_width():
    tree = {"f64": np.linspace(-1, 1, 7), "i64": np.array([-2 ** 62, 5]),
            "u64": np.uint64(2 ** 63 + 5), "i8": np.arange(-4, 4, dtype=np.int8),
            "f16": np.arange(3, dtype=np.float16), "s": np.float32(3.5), "b": np.bool_(True)}
    got = unpackb(serialization.msgpack_serialize(tree))
    for key, value in tree.items():
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], value)
    assert isinstance(got["u64"], np.uint64) and got["u64"] == 2 ** 63 + 5


@pytest.mark.parametrize("data,match", [
    (msgpack.packb(msgpack.ExtType(5, b"abcd")), "ext code 5"),
    (msgpack.packb(msgpack.ExtType(2, b"complex!!")), "ext code 2"),
    (b"\xc1", "0xc1"),
    (msgpack.packb([1, 2])[:-1], "ends"),
    (msgpack.packb(1) + b"\x00", "follow"),
])
def test_unpackb_refuses_what_flax_does_not_write(data, match):
    with pytest.raises(ValueError, match=match):
        unpackb(data)


def test_load_jax_params_of_the_tiny_model(jax_params, tmp_path):
    path = tmp_path / "params_cache.msgpack"
    path.write_bytes(serialization.msgpack_serialize(jax_params))
    want = state_dict_from_jax(jax_params)
    _assert_bit_equal(load_jax_params(str(path)), want)
    model = OCRModel(ModelConfig.from_dict(CONFIG), device="cpu")
    model.load_state_dict(load_jax_params(str(path)), strict=True)


def test_load_jax_params_of_a_bfloat16_tree(jax_params, tmp_path):
    bf16 = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), jax_params)
    path = tmp_path / "params_cache.msgpack"
    path.write_bytes(serialization.msgpack_serialize(bf16))
    leaf = unpackb(path.read_bytes())["decoder"]["to_logits"]["kernel"]
    assert leaf.dtype == torch.bfloat16
    _assert_bit_equal(load_jax_params(str(path)), state_dict_from_jax(bf16))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_load_jax_params_of_chunked_leaves(jax_params, tmp_path, monkeypatch, dtype):
    """flax chunks every leaf over ``MAX_CHUNK_SIZE`` bytes; at 1000 bytes
    the tiny model's large kernels are written in chunks, the last one
    short."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    params = jax.tree.map(lambda x: jnp.asarray(x, dtype), jax_params)
    data = serialization.msgpack_serialize(params)
    raw = msgpack.unpackb(data, raw=False, ext_hook=lambda code, d: None)
    assert raw["decoder"]["to_logits"]["kernel"]["__msgpack_chunked_array__"] is True
    path = tmp_path / "params_cache.msgpack"
    path.write_bytes(data)
    _assert_bit_equal(load_jax_params(str(path)), state_dict_from_jax(params))


def test_jax_checkpoint_directory_needs_its_params_cache(jax_params, tmp_path):
    save_checkpoint(str(tmp_path), 4, jax.tree.map(jnp.asarray, jax_params))
    ckpt = str(tmp_path / "checkpoint_e4")
    for path in (ckpt, str(tmp_path)):  # the directory, and its save_dir
        with pytest.raises(ValueError, match="params_cache.msgpack.*load_params_fast"):
            load_weights(path)
    with pytest.raises(ValueError, match="params_cache.msgpack"):
        load_jax_params(ckpt)
    load_params_fast(ckpt)  # the JAX package writes the cache
    want = state_dict_from_jax(jax_params)
    _assert_bit_equal(load_jax_params(ckpt), want)
    _assert_bit_equal(load_weights(ckpt), want)
    _assert_bit_equal(load_weights(str(tmp_path)), want)
    _assert_bit_equal(load_weights(os.path.join(ckpt, "params_cache.msgpack")), want)
    engine = TexOCR(dict(CONFIG, tokenizer_path=DEFAULT_VOCAB_PATH, model_path=ckpt),
                    device="cpu")
    _assert_bit_equal({k: v for k, v in engine.model.state_dict().items()}, want)


def test_count_parameters_equals_jax(jax_params):
    model = OCRModel(ModelConfig.from_dict(CONFIG), device="cpu")
    want = jax_utils.count_parameters(jax_params)
    assert utils.count_parameters(model) == want
    state = state_dict_from_jax(jax_params)
    assert utils.count_parameters(state) == sum(v.numel() for v in state.values()) > want


def test_alphabetize_config_writes_the_same_file(tmp_path, monkeypatch):
    config = {"zeta": 1, "alpha": {"b": 2, "a": [1, 2]}, "mid": "x"}
    paths = [str(tmp_path / f"{name}.yml") for name in ("jax", "port")]
    assert utils.alphabetize_config(dict(config), paths[1]) == jax_utils.alphabetize_config(
        dict(config), paths[0])
    with open(paths[0]) as a, open(paths[1]) as b:
        assert a.read() == b.read()
    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML missing
    with pytest.raises(ImportError, match="PyYAML"):
        utils.alphabetize_config(config, str(tmp_path / "none.yml"))


@pytest.mark.parametrize("shape,target,fill", [((3, 5), (8, 9), 0.0), ((4, 4, 2), (7, 10), 1.0),
                                               ((5, 6), (5, 6), 0.5)])
def test_center_pad_image_equals_jax(shape, target, fill):
    img = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = utils.center_pad_image(img, *target, fill=fill)
    want = jax_utils.center_pad_image(img, *target, fill=fill)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
