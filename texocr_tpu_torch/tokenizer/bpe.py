"""Byte-level regex BPE tokenizer: loading and decoding.

Reads the reference's 3-line vocabulary files (vocab size, special-token dict,
merges dict; parsed with ``ast.literal_eval``) and decodes exactly as
``texocr_tpu.tokenizer.bpe`` does: each token's bytes decode on their own with
``errors='replace'``, and an unknown id raises. Encoding and training are not
ported yet (ROADMAP); they need the ``regex`` module, which serving does not.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

Pair = Tuple[int, int]


class RegexBPETokenizer:
    def __init__(self):
        self.vocab_size = 0
        self.special_tokens: Dict[str, int] = {}
        self.bp_merges: Dict[Pair, int] = {}
        self._rebuild()

    def _rebuild(self) -> None:
        self.inv_special_tokens = {v: k for k, v in self.special_tokens.items()}
        vocab = {i: bytes([i]) for i in range(256)}
        for (a, b), tid in self.bp_merges.items():
            vocab[tid] = vocab[a] + vocab[b]
        for tok, tid in self.special_tokens.items():
            vocab[tid] = tok.encode("utf-8")
        self.vocab = vocab

    def load(self, path: str) -> "RegexBPETokenizer":
        with open(path, "r") as f:
            self.vocab_size = int(f.readline())
            self.special_tokens = ast.literal_eval(f.readline())
            self.bp_merges = ast.literal_eval(f.readline())
        self._rebuild()
        return self

    def decode_list(self, tokens: List[int]) -> List[str]:
        """Per-token decode with errors='replace'; raises on unknown ids."""
        pieces: List[bytes] = []
        for t in tokens:
            if t in self.inv_special_tokens:
                pieces.append(self.inv_special_tokens[t].encode("utf-8"))
            elif t in self.vocab:
                pieces.append(self.vocab[t])
            else:
                raise ValueError(f"Token {t} not found in vocabulary.")
        return [b.decode("utf-8", errors="replace") for b in pieces]

    def decode(self, tokens: List[int]) -> str:
        return "".join(self.decode_list(tokens))
