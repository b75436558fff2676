"""KV-cached greedy and sampled decoding, and ``generate`` (encode and decode
in one call, in any of the three modes).

Encode once, project the cross-attention K/V once, then one decoder step per
position: the next token (argmax, or a draw from the top-k filtered softmax at
a temperature), a PAD for every row already done, and a per-row done flag set
by EOS. The loop stops once every row is done, checking the flags on the host
only every ``DECODE_CHUNK`` steps so the device is not synchronised each step
(the tokens are the same either way: a done row emits PAD). With int8
self-KV, each chunk is quantized into the int8 prefix when the next chunk
starts (``chunk_start``), as the JAX package merges it. Runs on the device of
``enc``.

Sampling draws with the Gumbel-max trick (argmax of logits / temp plus Gumbel
noise from the caller's ``torch.Generator``): a draw from the same
categorical distribution as ``jax.random.categorical``, not the same draws.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from texocr_tpu_torch.models.attention import DECODE_CHUNK, chunk_size, chunk_start
from texocr_tpu_torch.models.beam import beam_decode
from texocr_tpu_torch.models.ocr_model import OCRModel
from texocr_tpu_torch.utils import topk_filter

__all__ = ["DECODE_CHUNK", "greedy_decode", "sampled_decode", "generate"]

DECODE_MODES = ("greedy", "sample", "beam")


def _decode_loop(model: OCRModel, enc: torch.Tensor, pick: Callable, *, bos_token: int,
                 eos_token: int, pad_token: int, max_len: int,
                 enc_mask: Optional[torch.Tensor], return_logits: bool):
    batch, device = enc.shape[0], enc.device
    max_len, chunk = chunk_size(max_len, model.config.decoder.max_length)
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
        t0 = chunk_start(cache, t, chunk)
        logits = model.decoder_step(cur, t, cache, cross_kv, enc_mask=enc_mask, t0=t0).float()
        if return_logits:
            logits_buf[:, t] = logits
        nxt = torch.where(done, pad_token, pick(logits))
        tokens[:, t] = nxt
        done |= nxt == eos_token
        cur = nxt
        if (t + 1) % chunk == 0 and bool(done.all()):
            break
    if return_logits:
        return tokens, logits_buf
    return tokens


@torch.inference_mode()
def greedy_decode(
    model: OCRModel,
    enc: torch.Tensor,
    *,
    bos_token: int,
    eos_token: int,
    pad_token: int,
    max_len: int,
    enc_mask: Optional[torch.Tensor] = None,
    return_logits: bool = False,
):
    """Argmax decode from BOS. Returns (B, max_len) int64, PAD-filled after
    EOS, and with ``return_logits`` also the (B, max_len, V) float32 step
    logits (zeros for steps not run). ``max_len`` is clamped to the decoder's
    positional table. ``enc_mask``: (B, Nk) bool, False at padded encoder
    positions."""
    return _decode_loop(model, enc, lambda logits: logits.argmax(dim=-1),
                        bos_token=bos_token, eos_token=eos_token, pad_token=pad_token,
                        max_len=max_len, enc_mask=enc_mask, return_logits=return_logits)


@torch.inference_mode()
def sampled_decode(
    model: OCRModel,
    enc: torch.Tensor,
    generator: torch.Generator,
    *,
    bos_token: int,
    eos_token: int,
    pad_token: int,
    max_len: int,
    temp: float = 0.3,
    topk_threshold: float = 0.9,
    enc_mask: Optional[torch.Tensor] = None,
    return_logits: bool = False,
):
    """The reference's sampling: ``topk_filter`` (k = 99 of 1000), then a
    categorical draw at ``temp``, its noise from ``generator`` (on ``enc``'s
    device). Returns what ``greedy_decode`` returns."""
    tiny = torch.finfo(torch.float32).tiny

    def pick(logits):
        u = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_min(tiny)
        gumbel = -torch.log(-torch.log(u))
        return (topk_filter(logits, topk_threshold) / temp + gumbel).argmax(dim=-1)

    return _decode_loop(model, enc, pick, bos_token=bos_token, eos_token=eos_token,
                        pad_token=pad_token, max_len=max_len, enc_mask=enc_mask,
                        return_logits=return_logits)


@torch.inference_mode()
def generate(model: OCRModel, images: torch.Tensor, *, max_len: int, mode: str = "greedy",
             generator: Optional[torch.Generator] = None, temp: float = 0.3,
             beam_size: int = 5) -> torch.Tensor:
    """Encode + decode in one call: (B, H, W, 1) preprocessed images ->
    (B, max_len) token ids. ``mode``: "greedy", "sample" (at ``temp``, which
    needs ``generator``) or "beam" (``beam_size`` wide, no length penalty)."""
    if mode not in DECODE_MODES:
        raise ValueError(f"unknown decode mode: {mode!r}")
    if mode == "sample" and generator is None:
        raise ValueError("mode='sample' requires a generator")
    enc = model.encode(images)
    cfg = model.config
    common = dict(bos_token=cfg.bos_token, eos_token=cfg.eos_token, pad_token=cfg.pad_token,
                  max_len=max_len)
    if mode == "beam":
        return beam_decode(model, enc, beam_size=beam_size, **common)
    if mode == "sample":
        return sampled_decode(model, enc, generator, temp=temp, **common)
    return greedy_decode(model, enc, **common)
