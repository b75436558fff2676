"""The port's tokenizer against the JAX package's, which runs here: the
stdlib splitter against ``regex`` (goldens, every code point that the
running Python's Unicode assigns, hypothesis), encode and encode_batch
(native and pure Python), training, save, load_special_tokens and the CLI."""

import json
import os
import sys
import unicodedata
import warnings

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

import texocr_tpu.tokenizer as jax_tok
from tests.tiny import synthetic_dataset_dir
from texocr_tpu.tokenizer import cli as jax_cli
from texocr_tpu_torch.tokenizer import (
    DEFAULT_SPECIAL_TOKENS_PATH,
    DEFAULT_VOCAB_PATH,
    SPLIT_PATTERN,
    BPETokenizer,
    RegexBPETokenizer,
    load_default_tokenizer,
    load_special_tokens,
    native,
)
from texocr_tpu_torch.tokenizer import cli
from texocr_tpu_torch.tokenizer.split import split_re

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return json.load(f)


GOLDEN_TEXTS = [case["text"] for case in _golden("tokenizer_encode.json")]
JAX_SPLIT = regex.compile(jax_tok.SPLIT_PATTERN)


@pytest.fixture(scope="module")
def tokenizers():
    return load_default_tokenizer(), jax_tok.load_default_tokenizer()


@pytest.fixture(scope="module")
def tiny_labels(tmp_path_factory):
    root = synthetic_dataset_dir(tmp_path_factory.mktemp("tiny"), None)
    return (root / "labels.txt").read_text().splitlines()


def _golden_corpus():
    golden = _golden("tokenizer_train.json")
    return "\n".join(t for t in GOLDEN_TEXTS if t) * golden["corpus_repeats"], golden


# -- the splitter --------------------------------------------------------------

def test_split_pattern_is_the_jax_packages():
    assert SPLIT_PATTERN == jax_tok.SPLIT_PATTERN


@pytest.mark.parametrize("text", GOLDEN_TEXTS)
def test_splitter_equals_regex_on_the_goldens(text):
    assert split_re().findall(text) == JAX_SPLIT.findall(text)


def _assigned():
    return [chr(cp) for cp in range(sys.maxunicode + 1)
            if unicodedata.category(chr(cp)) not in ("Cn", "Cs")]


@pytest.mark.parametrize("context", ["{}", " {}a", "'{}1", "{}{} \n", "x{}'s\r"])
def test_splitter_equals_regex_on_every_assigned_code_point(context):
    """Each code point that this Python's unicodedata assigns, in a context
    that puts it after a space, before a letter or a number, after an
    apostrophe, doubled, and before line ends: one string of all of them."""
    text = "".join(context.format(c, c) for c in _assigned())
    assert split_re().findall(text) == JAX_SPLIT.findall(text)


@settings(max_examples=300, deadline=None, database=None)
@given(st.text(alphabet=st.characters(exclude_categories=("Cn", "Cs")), max_size=40))
def test_splitter_equals_regex_on_assigned_text(text):
    assert split_re().findall(text) == JAX_SPLIT.findall(text)


def test_pinned_divergence_on_a_code_point_unassigned_in_this_unicode():
    """U+088F is unassigned in Unicode 15.0 (Python 3.12's unicodedata) and
    a letter to a regex that knows a later Unicode: the port splits it off
    where regex keeps it with the letter before."""
    cp = "\u088f"
    assert unicodedata.unidata_version == "15.0.0"
    assert unicodedata.category(cp) == "Cn"
    assert regex.match(r"\p{L}", cp)
    assert JAX_SPLIT.findall("a" + cp) == ["a" + cp]
    assert split_re().findall("a" + cp) == ["a", cp]


# -- encode ----------------------------------------------------------------------

def test_goldens_encode_and_decode(tokenizers):
    port, _ = tokenizers
    for case in _golden("tokenizer_encode.json"):
        assert port.encode(case["text"]) == case["ids"], case["text"]
        assert port.decode(case["ids"]) == case["decoded"]
        assert port.decode_list(case["ids"]) == case["decoded_list"]


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("texts", ["goldens", "tiny"])
def test_encode_and_encode_batch_equal_jax(tokenizers, tiny_labels, monkeypatch, path, texts):
    port, jax_t = tokenizers
    labels = GOLDEN_TEXTS if texts == "goldens" else tiny_labels
    want = [jax_t.encode(t) for t in labels]
    assert [port.encode(t) for t in labels] == want
    if path == "python":
        monkeypatch.setattr(RegexBPETokenizer, "_native_encoder", lambda self: None)
        calls = native.NativeBPEEncoder.calls
        assert port.encode_batch(labels) == want
        assert native.NativeBPEEncoder.calls == calls
    else:
        assert native.native_available(), native.native_error()
        calls = native.NativeBPEEncoder.calls
        assert port.encode_batch(labels) == want == jax_t.encode_batch(labels)
        assert native.NativeBPEEncoder.calls == calls + 1  # one call for every text


def test_native_encoder_over_many_seeded_labels(tokenizers):
    """Random byte soup, specials and empty strings, native against Python."""
    port, jax_t = tokenizers
    rng = np.random.default_rng(0)
    alphabet = list("\\{}^_ abcxyz0123456789+-=()") + ["<EOS>", "é", "中", "\n"]
    texts = ["".join(rng.choice(alphabet, size=int(rng.integers(0, 40)))) for _ in range(300)]
    got = port.encode_batch(texts)
    assert got == [port.encode(t) for t in texts] == jax_t.encode_batch(texts)


def test_native_path_refused_when_a_merge_id_is_a_special_id(tokenizers):
    port, _ = tokenizers
    tok = RegexBPETokenizer().load(DEFAULT_VOCAB_PATH)
    tok.special_tokens = {"<X>": 300}
    assert tok._native_encoder() is None
    jax_t = jax_tok.RegexBPETokenizer().load(DEFAULT_VOCAB_PATH)
    jax_t.special_tokens = {"<X>": 300}
    texts = ["\\frac { a } { b }", "x <X> y"]
    assert tok.encode_batch(texts) == jax_t.encode_batch(texts) == [tok.encode(t) for t in texts]
    assert port._native_encoder() is not None


def test_failed_build_warns_why_and_encodes_in_python(monkeypatch, tokenizers):
    _, jax_t = tokenizers

    def no_compiler(source):
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "build", no_compiler)
    tok = RegexBPETokenizer().load(DEFAULT_VOCAB_PATH)
    with pytest.warns(RuntimeWarning, match="g\\+\\+ not found"):
        assert not native.native_available()
    assert "g++ not found" in native.native_error()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # said once, not again
        assert tok.encode_batch(GOLDEN_TEXTS) == [jax_t.encode(t) for t in GOLDEN_TEXTS]
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeBPEEncoder({(1, 2): 256})


# -- train, save, specials --------------------------------------------------------

def test_train_merges_equal_jax_and_the_golden():
    corpus, golden = _golden_corpus()
    specials = dict(golden["special_tokens"])
    port = RegexBPETokenizer(vocab_size=golden["vocab_size"], special_tokens=specials)
    port.train(corpus)
    jax_t = jax_tok.RegexBPETokenizer(vocab_size=golden["vocab_size"], special_tokens=specials)
    jax_t.train(corpus)
    assert port.bp_merges == jax_t.bp_merges == {tuple(k): v for k, v in golden["merges"]}
    assert len(port.bp_merges) == 41


def test_plain_bpe_train_and_encode_equal_jax():
    corpus, _ = _golden_corpus()
    port, jax_t = BPETokenizer(vocab_size=280), jax_tok.BPETokenizer(vocab_size=280)
    port.train(corpus)
    jax_t.train(corpus)
    assert port.bp_merges == jax_t.bp_merges
    for text in GOLDEN_TEXTS:
        assert port.encode(text) == jax_t.encode(text)
        if text.isascii():
            assert port.decode(port.encode(text)) == text


def test_save_bytes_equal_jax_and_the_shipped_vocabulary(tokenizers, tmp_path):
    port, jax_t = tokenizers
    port.save(str(tmp_path / "port.txt"))
    jax_t.save(str(tmp_path / "jax.txt"))
    with open(DEFAULT_VOCAB_PATH, "rb") as f:
        shipped = f.read()
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes() == shipped
    with open(jax_tok.DEFAULT_VOCAB_PATH, "rb") as f:
        assert f.read() == shipped
    reloaded = RegexBPETokenizer().load(str(tmp_path / "port.txt"))
    assert reloaded.bp_merges == port.bp_merges and reloaded.special_tokens == port.special_tokens


@pytest.mark.parametrize("vocab_size", [1000, 300])
def test_load_special_tokens_equal_jax(vocab_size):
    got = load_special_tokens(DEFAULT_SPECIAL_TOKENS_PATH, vocab_size)
    assert got == jax_tok.load_special_tokens(jax_tok.DEFAULT_SPECIAL_TOKENS_PATH, vocab_size)
    assert got == {"<PAD>": vocab_size - 1, "<BOS>": vocab_size - 2, "<EOS>": vocab_size - 3}


# -- the CLI --------------------------------------------------------------------

def _run(main, parse, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["cli", *argv])
    main(parse())
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", ["train", "encode"])
def test_cli_equals_the_jax_cli(tmp_path, monkeypatch, capsys, mode):
    corpus, golden = _golden_corpus()
    data = tmp_path / "corpus.txt"
    data.write_text(corpus)
    outs, saved = {}, {}
    for name, module in (("port", cli), ("jax", jax_cli)):
        if mode == "train":
            save = tmp_path / f"{name}.txt"
            argv = ["-t", "-v", str(golden["vocab_size"]), "-d", str(data), "-s", str(save),
                    "--special", DEFAULT_SPECIAL_TOKENS_PATH, "--verbose"]
        else:
            argv = ["-l", DEFAULT_VOCAB_PATH, "-v", "1000", "--test_str", r"\int _ { 0 } x d x"]
        outs[name] = _run(module.main, module.parse_args, argv, monkeypatch, capsys)
        if mode == "train":
            saved[name] = save.read_bytes()
    assert outs["port"] == outs["jax"] and outs["port"]
    assert saved.get("port") == saved.get("jax")
    assert cli.TRAIN_TEXT_CAP == jax_cli.TRAIN_TEXT_CAP == 5_000_000
