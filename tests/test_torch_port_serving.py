"""End to end: the JAX TexOCR and the port's TexOCR, built from one config
(float32, the shipped 1k vocabulary, tiny widths) with the JAX wrapper's
parameters carried across, give the same ids and the same LaTeX string for a
PIL image and for a uint8 array within the largest canvas. Also the host-side
helpers (process_output, tokenizer decode) against the JAX package's."""

import numpy as np
import pytest
import torch
from PIL import Image

from tests.tiny import TINY_CONFIG
from texocr_tpu.serving import TexOCR as JaxTexOCR
from texocr_tpu.tokenizer import DEFAULT_VOCAB_PATH as JAX_VOCAB_PATH
from texocr_tpu.tokenizer import RegexBPETokenizer as JaxTokenizer
from texocr_tpu.utils import pad_to_multiple as jax_pad_to_multiple
from texocr_tpu.utils import process_output as jax_process_output
from texocr_tpu.utils import same_pad_lo_hi as jax_same_pad_lo_hi
from texocr_tpu_torch.serving import TexOCR
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH, RegexBPETokenizer
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.utils import pad_to_multiple, process_output, same_pad_lo_hi

torch.set_num_threads(1)
MAX_LEN = 30


def _config():
    cfg = {k: v for k, v in TINY_CONFIG.items() if k not in ("vocab_size", "max_length")}
    cfg.update(tokenizer_path=DEFAULT_VOCAB_PATH, bos_token=998, eos_token=997,
               trg_pad_idx=999, dtype="float32", use_flash_attention=False)
    return cfg


@pytest.fixture(scope="module")
def engines():
    jax_engine = JaxTexOCR(_config())
    port = TexOCR(_config(), device="cpu",
                  state_dict=state_dict_from_jax(jax_engine.params))
    return jax_engine, port


def _ink(rng, h, w):
    img = np.full((h, w), 255, np.uint8)
    img[rng.integers(0, h, 60), rng.integers(0, w, 60)] = 0
    return img


@pytest.mark.parametrize("kind, hw", [("pil", (20, 50)), ("array", (14, 40))])
def test_same_ids_and_latex_as_jax(engines, kind, hw):
    jax_engine, port = engines
    arr = _ink(np.random.default_rng(hw[0]), *hw)
    jax_ids, jax_latex = jax_engine(Image.fromarray(arr), max_len=MAX_LEN)
    img = Image.fromarray(arr) if kind == "pil" else arr
    np.testing.assert_array_equal(port.preprocess(img), jax_engine.preprocess(Image.fromarray(arr)))
    ids, latex = port(img, max_len=MAX_LEN)
    assert ids == jax_ids
    assert latex == jax_latex


def test_oversized_array_fits_the_largest_canvas(engines):
    _, port = engines
    canvas = port.preprocess(np.zeros((100, 1000), np.uint8))
    h, w = canvas.shape[1:3]
    assert canvas.dtype == np.uint8 and h <= 32 and w <= 64
    assert h % 16 == 0 and canvas.shape[0] == 1 and canvas.shape[3] == 1


def test_canvas_capped_where_the_jax_wrapper_raises():
    """img_size (32, 112): a width that is a multiple of 16 but not of 64. An
    oversized image scaled down to 112 columns rounds up to a 128-wide canvas
    in the JAX wrapper; its 8 feature columns exceed the 7-column positional
    grid, numpy clips the grid slice to 7 columns, and the positional add
    fails to broadcast. The port caps the canvas at img_size and answers."""
    cfg = dict(_config(), img_size=(32, 112))
    jax_engine = JaxTexOCR(cfg)
    port = TexOCR(cfg, device="cpu", state_dict=state_dict_from_jax(jax_engine.params))
    img = Image.fromarray(_ink(np.random.default_rng(3), 20, 1000))
    assert jax_engine.preprocess(img).shape[2] == 128
    with pytest.raises((TypeError, ValueError), match="broadcast"):
        jax_engine(img, max_len=4)
    assert port.preprocess(img).shape[1:3] == (16, 112)
    ids, latex = port(img, max_len=4)
    assert len(ids) <= 4 and all(0 <= i < 1000 for i in ids) and isinstance(latex, str)


def test_unported_modes_raise(engines):
    """Every decode mode of the JAX wrapper is ported (greedy, sample, beam);
    any other mode raises."""
    _, port = engines
    batch = port.preprocess(np.full((16, 64), 255, np.uint8))
    for mode in ("sample", "beam"):
        assert port.generate_batch(batch, max_len=2, mode=mode).shape == (1, 2)
    with pytest.raises(ValueError, match="unknown decode mode"):
        port.generate_batch(batch, mode="nucleus")


def test_default_device_is_cuda():
    """No quiet CPU fallback: without a card the default device fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        TexOCR(_config())


def test_process_output_matches_jax():
    cases = [r"\int _ { 0 } ^ { 1 } x ^ 2 d x", r"\frac { a } { b }  \alpha \beta",
             "x\n +\ty", r"\sin x \cos 2", "", r"\left ( \right )"]
    for s in cases:
        assert process_output(s) == jax_process_output(s)
    for x, k, s in [(160, 7, 2), (80, 3, 2), (41, 3, 2), (10, 1, 2), (63, 3, 1)]:
        assert same_pad_lo_hi(x, k, s) == jax_same_pad_lo_hi(x, k, s)
    for x in (1, 16, 17, 1000):
        assert pad_to_multiple(x, 64) == jax_pad_to_multiple(x, 64)


def test_tokenizer_decode_matches_jax():
    ours = RegexBPETokenizer().load(DEFAULT_VOCAB_PATH)
    ref = JaxTokenizer()
    ref.load(JAX_VOCAB_PATH)
    assert ours.vocab_size == ref.vocab_size == 1000
    rng = np.random.default_rng(5)
    for _ in range(20):
        ids = rng.integers(0, 1000, size=int(rng.integers(0, 40))).tolist()
        assert ours.decode(ids) == ref.decode(ids)
        assert ours.decode_list(ids) == ref.decode_list(ids)
    with pytest.raises(ValueError, match="not found"):
        ours.decode([1000])
