"""Beam-search decoding with the KV cache.

Scoring is the sum of token log-probs. Beam 0 starts live and the others at
``NEG_INF``, so the first step fans out from one BOS per image; a finished
beam (it emitted EOS) continues with PAD at zero cost. Each step takes the top
``beam_size`` of the flattened (beam x V) candidates, a tie going to the lower
flat index as ``lax.top_k`` breaks it, and moves every beam's state to its
parent's. The self-attention cache rows move too (``reorder_cache``: the
full-precision buffers, the int8 copies and their scales together); the JAX
package leaves its rows in place and selects them through an ancestry one-hot,
which gives the same numbers. The cross-attention K/V stay at (B, ...), shared
by an image's beams.

On a tensor-parallel model the caches hold this rank's heads and
``reorder_cache`` moves their rows alike; the log-softmax and the top-k run
on the whole logits, identical on every model rank, so every rank picks the
same parents and its caches stay in step with the others'.

``sequence_logprob`` scores given tokens by the same rule, teacher-forced or
through the decode step's cache: a beam's score is its tokens' log-prob.

The JAX package runs its decode in whole chunks of min(DECODE_CHUNK, max_len)
steps and slices the tokens to ``max_len`` afterwards, so its beams keep
expanding to the end of the last chunk, and the ranking at that step picks the
returned beam. The port runs the same steps (within the positional table:
past it the JAX package's positional embedding reads NaN) so that it returns
the same beam.
"""

from __future__ import annotations

from typing import Optional

import torch

from texocr_tpu_torch.models.attention import (
    chunk_size,
    chunk_start,
    decode_chunks,
    reorder_cache,
)
from texocr_tpu_torch.models.ocr_model import OCRModel
from texocr_tpu_torch.utils import top_k_lower_index

NEG_INF = -1e30


class BeamState:
    """A beam decode over precomputed cross-attention K/V (B, ...):
    ``tokens`` (B, beam, steps), ``scores``, ``done``, ``cur`` and ``lengths``
    (B, beam), the self-attention cache of B * beam rows and the spare
    buffers ``reorder_cache`` gathers into, all allocated here once.
    ``run_chunk`` and ``result`` as ``generate.DecodeState``'s."""

    def __init__(self, model: OCRModel, cross_kv, *, bos_token: int, eos_token: int,
                 pad_token: int, max_len: int, beam_size: int = 5,
                 enc_mask: Optional[torch.Tensor] = None):
        kv = next(iter(cross_kv[0].values()))
        batch, device = kv.shape[0], kv.device
        table = model.config.decoder.max_length
        self.model, self.cross_kv, self.enc_mask, self.beam = model, cross_kv, enc_mask, beam_size
        self.bos_token, self.eos_token = bos_token, eos_token
        self.max_len, self.chunk = chunk_size(max_len, table)
        self.steps = min(-(-self.max_len // self.chunk) * self.chunk, table)
        self.n_chunks = -(-self.steps // self.chunk)
        self.vocab = model.config.decoder.vocab_size
        self.cache = model.decoder_init_cache(batch * beam_size, self.steps, device)
        self.spare = model.decoder_init_cache(batch * beam_size, self.steps, device)
        self.tokens = torch.empty((batch, beam_size, self.steps), dtype=torch.int64,
                                  device=device)
        self.scores = torch.empty((batch, beam_size), dtype=torch.float32, device=device)
        self.done = torch.empty((batch, beam_size), dtype=torch.bool, device=device)
        self.cur = torch.empty((batch, beam_size), dtype=torch.int64, device=device)
        self.lengths = torch.empty((batch, beam_size), dtype=torch.int64, device=device)
        self.pad_token = pad_token
        self.pad_only = torch.full((self.vocab,), NEG_INF, dtype=torch.float32, device=device)
        self.pad_only[pad_token] = 0.0
        self.first_row = torch.arange(batch, device=device)[:, None] * beam_size

    def run_chunk(self, c: int) -> None:
        """Steps c * chunk .. min((c + 1) * chunk, steps) - 1, in place.
        Chunk 0 first resets the state to one live BOS beam per image."""
        batch, beam, vocab = self.scores.shape[0], self.beam, self.vocab
        if c == 0:
            self.tokens.fill_(self.pad_token)
            self.scores.fill_(NEG_INF)
            self.scores[:, 0] = 0.0
            self.done.zero_()
            self.cur.fill_(self.bos_token)
            self.lengths.zero_()
        for t in range(c * self.chunk, min((c + 1) * self.chunk, self.steps)):
            t0 = chunk_start(self.cache, t, self.chunk)
            logits = self.model.decoder_step(self.cur.reshape(-1), t, self.cache, self.cross_kv,
                                             enc_mask=self.enc_mask, t0=t0)
            logp = torch.log_softmax(logits.float(), dim=-1).view(batch, beam, vocab)
            # Finished beams may only emit PAD, at zero cost.
            logp = torch.where(self.done[..., None], self.pad_only, logp)
            flat = (self.scores[..., None] + logp).view(batch, beam * vocab)
            scores, top = top_k_lower_index(flat, beam)
            parent, tok = top // vocab, top % vocab
            self.scores.copy_(scores)
            self.tokens.copy_(self.tokens.gather(1, parent[..., None].expand(-1, -1, self.steps)))
            self.tokens[:, :, t] = tok
            parent_done = self.done.gather(1, parent)
            self.lengths.copy_(torch.where(parent_done, self.lengths.gather(1, parent), t + 1))
            self.done.copy_(parent_done | (tok == self.eos_token))
            self.cur.copy_(tok)
            reorder_cache(self.cache, (self.first_row + parent).reshape(-1), self.spare)

    def result(self, length_penalty: float = 0.0, return_scores: bool = False):
        """The best beam's (B, max_len) tokens (with ``return_scores`` also
        its float32 log-prob sum), ranked by score / ((5 + len) / 6) **
        ``length_penalty`` (GNMT; 0 ranks by the raw sum). New tensors."""
        if length_penalty > 0.0:
            norm = ((5.0 + self.lengths.float()) / 6.0) ** length_penalty
            ranked = self.scores / norm.clamp_min(1e-6)
        else:
            ranked = self.scores
        best = ranked.argmax(dim=1)
        rows = torch.arange(best.shape[0], device=best.device)
        best_tokens = self.tokens[rows, best, :self.max_len]
        if return_scores:
            return best_tokens, self.scores[rows, best]
        return best_tokens


@torch.inference_mode()
def beam_decode(
    model: OCRModel,
    enc: torch.Tensor,
    *,
    bos_token: int,
    eos_token: int,
    pad_token: int,
    max_len: int,
    beam_size: int = 5,
    length_penalty: float = 0.0,
    enc_mask: Optional[torch.Tensor] = None,
    return_scores: bool = False,
):
    """(B, N_enc, D) encoder output -> (B, max_len) int64 best-beam tokens,
    PAD after EOS (with ``return_scores`` also the best beam's float32
    log-prob sum). ``length_penalty`` alpha ranks beams by
    score / ((5 + len) / 6) ** alpha (GNMT); 0 ranks by the raw sum.
    ``enc_mask``: (B, Nk) bool, False at padded encoder positions."""
    state = BeamState(model, model.decoder_cross_kv(enc), bos_token=bos_token,
                      eos_token=eos_token, pad_token=pad_token, max_len=max_len,
                      beam_size=beam_size, enc_mask=enc_mask)
    decode_chunks(state, state.run_chunk)
    return state.result(length_penalty, return_scores)


@torch.inference_mode()
def sequence_logprob(
    model: OCRModel,
    enc: torch.Tensor,
    tokens: torch.Tensor,
    *,
    bos_token: int,
    eos_token: int,
    cached: bool = False,
) -> torch.Tensor:
    """(B,) float32 sum of the log-probs of ``tokens`` (B, L) after BOS, up to
    and including each row's first EOS: the score ``beam_decode`` gives the
    beam that emitted them. Teacher-forced (one forward, no cache), or with
    ``cached`` through ``decoder_step`` and the model's own cache, int8 chunk
    merges included, as ``beam_decode`` runs them."""
    batch, length = tokens.shape
    bos = torch.full((batch, 1), bos_token, dtype=tokens.dtype, device=tokens.device)
    inputs = torch.cat([bos, tokens[:, :-1]], 1)
    if cached:
        _, chunk = chunk_size(length, model.config.decoder.max_length)
        cache = model.decoder_init_cache(batch, length, enc.device)
        cross_kv = model.decoder_cross_kv(enc)
        logits = torch.stack([
            model.decoder_step(inputs[:, t], t, cache, cross_kv, t0=chunk_start(cache, t, chunk))
            for t in range(length)], 1)
    else:
        logits = model.dec(inputs, enc)
    picked = torch.log_softmax(logits.float(), -1).gather(-1, tokens[..., None])[..., 0]
    # A token counts while no EOS came before it.
    eos_before = torch.cat([torch.zeros_like(bos, dtype=torch.bool),
                            tokens[:, :-1] == eos_token], 1)
    return torch.where(eos_before.long().cumsum(1) == 0, picked, 0.0).sum(1)
