"""The port's host data path against the JAX package: a payload pickle written
by the JAX ImageDataset loads into the port, and the sampler's batch order and
the collated arrays are equal over several epochs; the augmentation against
the PIL version at the same scale; the payload reader's limits."""

import pickle

import numpy as np
import pytest
import torch

from tests.tiny import synthetic_dataset_dir
from texocr_tpu.data import ImageDataset as JaxImageDataset
from texocr_tpu.data import create_dataloader as jax_create_dataloader
from texocr_tpu.data.transforms import affine_scale_aug as pil_affine_scale_aug
from texocr_tpu.data.transforms import to_model_array as jax_to_model_array
from texocr_tpu.tokenizer import DEFAULT_VOCAB_PATH as JAX_VOCAB_PATH
from texocr_tpu.tokenizer import load_default_tokenizer
from texocr_tpu_torch.data.dataset import ImageDataset, create_dataloader, load_datasets, prefetch
from texocr_tpu_torch.data.transforms import affine_scale_aug, scale_image, to_model_array
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX dataset built from a synthetic directory and the port's copy,
    loaded from the JAX dataset's pickle."""
    tmp = tmp_path_factory.mktemp("data")
    root = synthetic_dataset_dir(tmp, load_default_tokenizer(),
                                 sizes=((64, 32), (128, 32), (64, 48)), per_size=7)
    jax_ds = JaxImageDataset(str(root), JAX_VOCAB_PATH, dataset_size=100)
    path = tmp / "trainset.pkl"
    jax_ds.save(str(path))
    return jax_ds, ImageDataset.load(str(path)), path


def test_payload_loads_with_the_same_contents(pair):
    jax_ds, port_ds, _ = pair
    assert len(port_ds) == len(jax_ds) == 21
    assert dict(port_ds.sizes) == dict(jax_ds.sizes)
    assert port_ds.token_ids == jax_ds.token_ids
    assert port_ds.max_seq_len == jax_ds.max_seq_len
    assert port_ds.tokenizer.special_tokens == jax_ds.tokenizer.special_tokens
    for i in range(len(jax_ds)):
        np.testing.assert_array_equal(port_ds[i][0], jax_ds[i][0])
        assert port_ds[i][1] == jax_ds[i][1]


@pytest.mark.parametrize("seq_pad_multiple, keep_small", [(1, False), (8, True)])
def test_sampler_order_and_collated_arrays_equal_jax(pair, seq_pad_multiple, keep_small):
    jax_ds, port_ds, _ = pair
    config = {"batch_size": 3, "drop_last": True, "batch_shuffle": True, "id_shuffle": True,
              "keep_small": keep_small, "seed": 7, "seq_pad_multiple": seq_pad_multiple}
    for offset in (0, 2):
        want_loader = jax_create_dataloader(jax_ds, config, seed_offset=offset)
        got_loader = create_dataloader(port_ds, config, seed_offset=offset)
        assert len(got_loader) == len(want_loader)
        for _ in range(3):  # epochs: the seeds move on per pass
            want, got = list(want_loader), list(got_loader)
            assert len(got) == len(want) > 0
            for (wi, wl), (gi, gl) in zip(want, got):
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gl, wl)
                assert gi.dtype == wi.dtype and gl.dtype == wl.dtype


def test_prefetch_keeps_order_and_raises_the_workers_error():
    assert list(prefetch(iter(range(10)), size=2)) == list(range(10))

    def failing():
        yield 1
        raise KeyError("boom")

    got = prefetch(failing())
    assert next(got) == 1
    with pytest.raises(KeyError, match="boom"):
        next(got)


def test_load_datasets_and_the_vocabulary_fallback(pair, tmp_path):
    """A payload whose tokenizer file does not exist loads the port's copy of
    the shipped vocabulary."""
    _, _, path = pair
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["tokenizer_path"] = str(tmp_path / "missing.txt")
    for split in ("train", "val", "test"):
        (tmp_path / split).mkdir()
        with open(tmp_path / split / f"{split}set.pkl", "wb") as f:
            pickle.dump(payload, f)
    train, val, test = load_datasets(str(tmp_path))
    assert len(train) == len(val) == len(test) == 21
    assert train.tokenizer.vocab_size == 1000
    assert train.tokenizer.special_tokens["<PAD>"] == 999
    assert DEFAULT_VOCAB_PATH.endswith("tokenizer_clean_1k.txt")


def test_port_save_is_read_by_the_jax_package(tmp_path):
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (32, 64), dtype=np.uint8) for _ in range(4)]
    ds = ImageDataset.from_arrays(images, [[5, 6, 7], [8], [9, 10], [11, 12, 13, 14]])
    ds.save(str(tmp_path / "set.pkl"))
    jax_ds = JaxImageDataset.load(str(tmp_path / "set.pkl"))
    assert jax_ds.token_ids == ds.token_ids and jax_ds.max_seq_len == 6
    for i in range(4):
        np.testing.assert_array_equal(jax_ds[i][0], ds[i][0])


def test_payload_reader_admits_only_numpy_and_plain_objects(tmp_path):
    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump({"tokenizer_path": None, "labels": [], "hook": print}, f)
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        ImageDataset.load(str(path))


def test_directory_construction_needs_bpe_encode(tmp_path):
    """A directory builds through the port's BPE encode: the labels' ids are
    the JAX tokenizer's."""
    root = synthetic_dataset_dir(tmp_path, None)
    ds = ImageDataset(str(root), DEFAULT_VOCAB_PATH, dataset_size=4)
    jax_tok = load_default_tokenizer()
    assert len(ds) == 4
    assert ds.token_ids == [jax_tok.encode(label) for label in ds.labels]
    assert ds.max_seq_len == max(map(len, ds.token_ids)) + 2


@pytest.mark.parametrize("hw", [(32, 64), (31, 77), (160, 1008)])
def test_affine_scale_aug_against_pil(hw):
    """The same scale through PIL (the JAX package's version) and through
    grid_sample. Tolerance: at most 1 grey level, on at most 2.5% of the
    pixels. PIL steps its sample coordinates by repeated addition, so a
    bilinear value that lands on an integer in one version can land a
    rounding error below it in the other, and truncation to uint8 then
    differs by one."""
    from PIL import Image

    h, w = hw
    rng = np.random.default_rng(h * w)
    arr = np.full((h, w), 255, np.uint8)
    arr[rng.integers(0, h, h * w // 8), rng.integers(0, w, h * w // 8)] = rng.integers(
        0, 256, h * w // 8)
    for seed in range(4):
        want = np.asarray(pil_affine_scale_aug(Image.fromarray(arr), np.random.default_rng(seed)))
        got = affine_scale_aug(arr, np.random.default_rng(seed))
        diff = np.abs(want.astype(int) - got.astype(int))
        assert got.dtype == np.uint8 and got.shape == arr.shape
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.025
    np.testing.assert_array_equal(scale_image(arr, 1.0), arr)


def test_to_model_array_equals_jax():
    rng = np.random.default_rng(4)
    for shape in ((20, 30), (20, 30, 3), (20, 30, 4)):
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(to_model_array(arr), jax_to_model_array(arr))
