"""KV-cached greedy decoding.

Encode once, project the cross-attention K/V once, then one decoder step per
position: argmax, a PAD for every row already done, and a per-row done flag set
by EOS. The loop stops once every row is done, checking the flags on the host
only every ``DECODE_CHUNK`` steps so the device is not synchronised each step
(the tokens are the same either way: a done row emits PAD). Runs on the device
of ``enc``.
"""

from __future__ import annotations

import torch

from texocr_tpu_torch.models.ocr_model import OCRModel

#: Steps between host checks of the done flags.
DECODE_CHUNK = 32


@torch.inference_mode()
def greedy_decode(
    model: OCRModel,
    enc: torch.Tensor,
    *,
    bos_token: int,
    eos_token: int,
    pad_token: int,
    max_len: int,
    return_logits: bool = False,
):
    """Argmax decode from BOS. Returns (B, max_len) int64, PAD-filled after
    EOS, and with ``return_logits`` also the (B, max_len, V) float32 step
    logits (zeros for steps not run). ``max_len`` is clamped to the decoder's
    positional table."""
    batch, device = enc.shape[0], enc.device
    max_len = min(max_len, model.config.decoder.max_length)
    cache = model.decoder_init_cache(batch, max_len, device)
    cross_kv = model.decoder_cross_kv(enc)
    tokens = torch.full((batch, max_len), pad_token, dtype=torch.int64, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    cur = torch.full((batch,), bos_token, dtype=torch.int64, device=device)
    logits_buf = None
    if return_logits:
        vocab = model.config.decoder.vocab_size
        logits_buf = torch.zeros(batch, max_len, vocab, dtype=torch.float32, device=device)
    for t in range(max_len):
        logits = model.decoder_step(cur, t, cache, cross_kv).float()
        if return_logits:
            logits_buf[:, t] = logits
        nxt = torch.where(done, pad_token, logits.argmax(dim=-1))
        tokens[:, t] = nxt
        done |= nxt == eos_token
        cur = nxt
        if (t + 1) % DECODE_CHUNK == 0 and bool(done.all()):
            break
    if return_logits:
        return tokens, logits_buf
    return tokens
