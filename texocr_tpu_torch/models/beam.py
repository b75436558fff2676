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

from texocr_tpu_torch.models.attention import chunk_size, chunk_start, reorder_cache
from texocr_tpu_torch.models.ocr_model import OCRModel
from texocr_tpu_torch.utils import top_k_lower_index

NEG_INF = -1e30


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
    batch, device = enc.shape[0], enc.device
    max_len, chunk = chunk_size(max_len, model.config.decoder.max_length)
    steps = min(-(-max_len // chunk) * chunk, model.config.decoder.max_length)
    vocab = model.config.decoder.vocab_size
    cross_kv = model.decoder_cross_kv(enc)
    cache = model.decoder_init_cache(batch * beam_size, steps, device)

    tokens = torch.full((batch, beam_size, steps), pad_token, dtype=torch.int64, device=device)
    scores = torch.full((batch, beam_size), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    done = torch.zeros(batch, beam_size, dtype=torch.bool, device=device)
    cur = torch.full((batch, beam_size), bos_token, dtype=torch.int64, device=device)
    lengths = torch.zeros(batch, beam_size, dtype=torch.int64, device=device)
    pad_only = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=device)
    pad_only[pad_token] = 0.0
    first_row = torch.arange(batch, device=device)[:, None] * beam_size

    for t in range(steps):
        t0 = chunk_start(cache, t, chunk)
        logits = model.decoder_step(cur.reshape(-1), t, cache, cross_kv, enc_mask=enc_mask,
                                    t0=t0)
        logp = torch.log_softmax(logits.float(), dim=-1).view(batch, beam_size, vocab)
        # Finished beams may only emit PAD, at zero cost.
        logp = torch.where(done[..., None], pad_only, logp)
        flat = (scores[..., None] + logp).view(batch, beam_size * vocab)
        scores, top = top_k_lower_index(flat, beam_size)
        parent, tok = top // vocab, top % vocab
        tokens = tokens.gather(1, parent[..., None].expand(-1, -1, steps))
        tokens[:, :, t] = tok
        parent_done = done.gather(1, parent)
        lengths = torch.where(parent_done, lengths.gather(1, parent), t + 1)
        done = parent_done | (tok == eos_token)
        cur = tok
        reorder_cache(cache, (first_row + parent).reshape(-1))
        if (t + 1) % chunk == 0 and bool(done.all()):
            break

    if length_penalty > 0.0:
        norm = ((5.0 + lengths.float()) / 6.0) ** length_penalty
        ranked = scores / norm.clamp_min(1e-6)
    else:
        ranked = scores
    best = ranked.argmax(dim=1)
    rows = torch.arange(batch, device=device)
    best_tokens = tokens[rows, best, :max_len]
    if return_scores:
        return best_tokens, scores[rows, best]
    return best_tokens


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
