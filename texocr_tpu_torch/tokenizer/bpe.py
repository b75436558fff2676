"""Byte-level regex BPE tokenizer: encode, train, save, load and decode.

The JAX package's tokenizer with the standard library's ``re`` in place of
``regex`` (``tokenizer/split.py``), giving the same ids, merges and files:

- 256 byte ids; merges take ids 256, 257, ... in training order.
- Encoding applies the lowest-ranked (earliest-trained) merge present until
  none applies; pairs touching a special-token id are never counted.
- Text is first split by the pre-split pattern, and merges never cross a
  split; special tokens are split out first by an alternation of their
  escaped strings.
- Training combines each round's per-split pair counts with dict ``update``
  (overwrite, not sum), the reference's quirk, so a retrain reproduces the
  shipped vocabulary.
- ``encode_batch`` runs the merge loop of every split of every text in one
  call of the native encoder (``tokenizer/native.py``) where it is built and
  no merge id is a special id; texts holding special tokens take ``encode``.
- Each token's bytes decode on their own with ``errors='replace'``; an
  unknown id raises.
- Files are the reference's 3 lines (vocab size, special-token dict repr,
  merges dict repr), read with ``ast.literal_eval`` and written byte for
  byte as the JAX package writes them.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Tuple

from texocr_tpu_torch.tokenizer import native
from texocr_tpu_torch.tokenizer.split import split_re

Pair = Tuple[int, int]


def _pair_counts(ids: List[int], skip_ids: Iterable[int]) -> Dict[Pair, int]:
    """Adjacent id pairs and their counts, leaving out any pair that touches
    a special id."""
    skip = set(skip_ids)
    counts: Dict[Pair, int] = {}
    prev = None
    for cur in ids:
        if prev is not None and prev not in skip and cur not in skip:
            pair = (prev, cur)
            counts[pair] = counts.get(pair, 0) + 1
        prev = cur
    return counts


def _apply_merge(ids: List[int], pair: Pair, new_id: int) -> List[int]:
    """Every non-overlapping occurrence of ``pair``, left to right, replaced
    by ``new_id``."""
    out: List[int] = []
    i, n = 0, len(ids)
    first, second = pair
    while i < n:
        if i + 1 < n and ids[i] == first and ids[i + 1] == second:
            out.append(new_id)
            i += 2
        else:
            out.append(ids[i])
            i += 1
    return out


def _merge_until_done(ids: List[int], merges: Dict[Pair, int],
                      skip_ids: Iterable[int]) -> List[int]:
    """Applies the lowest-ranked merge present (rank = merge id) until none
    applies."""
    while len(ids) >= 2:
        counts = _pair_counts(ids, skip_ids)
        if not counts:
            break
        best = min(counts, key=lambda p: merges.get(p, float("inf")))
        if best not in merges:
            break
        ids = _apply_merge(ids, best, merges[best])
    return ids


class BPETokenizer:
    """Plain byte-level BPE, without the pre-split."""

    def __init__(self, vocab_size: int = 800):
        self.vocab_size = vocab_size
        self.special_tokens: Dict[str, int] = {}
        self.bp_merges: Dict[Pair, int] = {}
        self.vocab = self._build_vocab()

    def _build_vocab(self) -> Dict[int, bytes]:
        vocab = {i: bytes([i]) for i in range(256)}
        for (a, b), tid in self.bp_merges.items():
            vocab[tid] = vocab[a] + vocab[b]
        for tok, tid in self.special_tokens.items():
            vocab[tid] = tok.encode("utf-8")
        return vocab

    def encode(self, text: str) -> List[int]:
        return _merge_until_done(list(text.encode("utf-8")), self.bp_merges,
                                 self.special_tokens.values())

    def decode(self, tokens: List[int]) -> str:
        """All tokens' bytes joined, then decoded strictly."""
        return b"".join(self.vocab[t] for t in tokens).decode("utf-8")

    def decode_list(self, tokens: List[int]) -> List[str]:
        return [self.vocab[t].decode("utf-8") for t in tokens]

    def train(self, text: str, verbose: bool = False) -> None:
        """Greedy most-frequent-pair merges up to ``vocab_size`` ids."""
        base = 256
        ids = list(text.encode("utf-8"))
        n_merges = self.vocab_size - base - len(self.special_tokens)
        merges: Dict[Pair, int] = {}
        for step in range(n_merges):
            counts = _pair_counts(ids, self.special_tokens.values())
            if not counts:
                break
            best = max(counts, key=counts.get)
            new_id = base + step
            ids = _apply_merge(ids, best, new_id)
            merges[best] = new_id
            if verbose:
                print(f"Training merge {step + 1}/{n_merges}: {best} -> {new_id}")
        self.bp_merges = merges
        self.vocab = self._build_vocab()

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"{self.vocab_size}\n")
            f.write(f"{self.special_tokens}\n")
            f.write(f"{self.bp_merges}\n")

    def load(self, path: str) -> "BPETokenizer":
        with open(path, "r") as f:
            self.vocab_size = int(f.readline())
            self.special_tokens = ast.literal_eval(f.readline())
            self.bp_merges = ast.literal_eval(f.readline())
        self.inv_special_tokens = {v: k for k, v in self.special_tokens.items()}
        self.vocab = self._build_vocab()
        return self


class RegexBPETokenizer(BPETokenizer):
    """BPE with the pre-split and special tokens: the tokenizer the whole
    system uses."""

    def __init__(self, vocab_size: int = 800, special_tokens: Optional[Dict[str, int]] = None):
        super().__init__(vocab_size)
        self.special_tokens = dict(special_tokens or {})
        self.inv_special_tokens = {v: k for k, v in self.special_tokens.items()}
        self.vocab = self._build_vocab()

    # -- encode ----------------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        """Special tokens split out first, the rest BPE-encoded."""
        if not self.special_tokens:
            return self._encode_text(text)
        special = "(" + "|".join(re.escape(tok) for tok in self.special_tokens) + ")"
        ids: List[int] = []
        for chunk in re.split(special, text):
            if chunk in self.special_tokens:
                ids.append(self.special_tokens[chunk])
            else:
                ids.extend(self._encode_text(chunk))
        return ids

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for split in split_re().findall(text):
            ids.extend(_merge_until_done(list(split.encode("utf-8")), self.bp_merges,
                                         self.special_tokens.values()))
        return ids

    def encode_batch(self, texts: List[str]) -> List[List[int]]:
        """``[self.encode(t) for t in texts]``, with the merge loop of every
        split of every text in one native call when the native encoder
        serves this vocabulary (``_native_encoder``)."""
        encoder = self._native_encoder()
        if encoder is None:
            return [self.encode(t) for t in texts]

        pattern = split_re()
        all_splits: List[bytes] = []
        spans: List[Tuple[int, int]] = []  # each text's range of splits; (-1, -1): encode()
        for t in texts:
            if any(s in t for s in self.special_tokens):
                spans.append((-1, -1))
                continue
            start = len(all_splits)
            all_splits.extend(s.encode("utf-8") for s in pattern.findall(t))
            spans.append((start, len(all_splits)))

        ids_stream, offsets = encoder.encode_concat(all_splits)
        return [self.encode(t) if lo < 0 else ids_stream[offsets[lo]: offsets[hi]].tolist()
                for t, (lo, hi) in zip(texts, spans)]

    _native_cache = None
    _native_for_merges = None

    def _native_encoder(self):
        """The native encoder of ``bp_merges``, or None: where the library
        did not build (``native.native_available`` warns why) or where a
        merge id is also a special id, which the Python loop skips and the
        native one does not. The shipped vocabulary (merges 256..996,
        specials 997..999) has no such id."""
        if self._native_for_merges is id(self.bp_merges):
            return self._native_cache
        self._native_for_merges = id(self.bp_merges)
        self._native_cache = None
        if (native.native_available()
                and not set(self.bp_merges.values()) & set(self.special_tokens.values())):
            self._native_cache = native.NativeBPEEncoder(self.bp_merges)
        return self._native_cache

    # -- decode ------------------------------------------------------------------

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

    # -- training ----------------------------------------------------------------

    def train(self, text: str, verbose: bool = False) -> None:
        """Pre-split training; each round's per-split counts are combined
        with dict ``update`` (overwrite, not sum), as the reference does."""
        base = 256
        split_ids = [list(s.encode("utf-8")) for s in split_re().findall(text)]
        n_merges = self.vocab_size - base - len(self.special_tokens)
        merges: Dict[Pair, int] = {}
        skip = self.special_tokens.values()
        for step in range(n_merges):
            stats: Dict[Pair, int] = {}
            for ids in split_ids:
                stats.update(_pair_counts(ids, skip))
            if not stats:
                break
            best = max(stats, key=stats.get)
            new_id = base + step
            split_ids = [_apply_merge(ids, best, new_id) for ids in split_ids]
            merges[best] = new_id
            if verbose:
                print(f"Training merge {step + 1}/{n_merges}: {best} -> {new_id}")
        self.bp_merges = merges
        self.vocab = self._build_vocab()


def load_special_tokens(path: str, vocab_size: int) -> Dict[str, int]:
    """Special-token ids from ``vocab_size - 1`` down, in the file's line
    order (<PAD>=999, <BOS>=998, <EOS>=997 for the shipped 1k vocabulary)."""
    specials: Dict[str, int] = {}
    with open(path, "r") as f:
        for i, line in enumerate(f):
            tok = line.strip()
            if tok:
                specials[tok] = vocab_size - i - 1
    return specials
