"""Host-side BPE tokenizer: encode, train, save, load and decode (see bpe.py)."""

import os

from texocr_tpu_torch.tokenizer.bpe import (  # noqa: F401
    BPETokenizer,
    RegexBPETokenizer,
    load_special_tokens,
)
from texocr_tpu_torch.tokenizer.split import SPLIT_PATTERN  # noqa: F401

_VOCAB_DIR = os.path.join(os.path.dirname(__file__), "vocab")

#: The shipped 1000-token LaTeX vocabulary (specials <PAD>=999, <BOS>=998,
#: <EOS>=997), a data file kept beside the port's code.
DEFAULT_VOCAB_PATH = os.path.join(_VOCAB_DIR, "tokenizer_clean_1k.txt")

#: The shipped special-token list (<PAD>, <BOS>, <EOS>), one per line.
DEFAULT_SPECIAL_TOKENS_PATH = os.path.join(_VOCAB_DIR, "special_tokens.txt")


def load_default_tokenizer() -> RegexBPETokenizer:
    """The shipped 1k-vocabulary tokenizer."""
    return RegexBPETokenizer().load(DEFAULT_VOCAB_PATH)
