"""Host-side BPE tokenizer (decode only; see bpe.py)."""

import os

from texocr_tpu_torch.tokenizer.bpe import RegexBPETokenizer  # noqa: F401

#: The shipped 1000-token LaTeX vocabulary (specials <PAD>=999, <BOS>=998,
#: <EOS>=997), a data file kept beside the port's code.
DEFAULT_VOCAB_PATH = os.path.join(os.path.dirname(__file__), "vocab", "tokenizer_clean_1k.txt")
