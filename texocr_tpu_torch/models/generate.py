"""KV-cached greedy and sampled decoding, and ``generate`` (encode and decode
in one call, in any of the three modes).

Encode once, project the cross-attention K/V once, then one decoder step per
position: the next token (argmax, or a draw from the top-k filtered softmax at
a temperature), a PAD for every row already done, and a per-row done flag set
by EOS. The loop stops once every row is done, checking the flags on the host
only between chunks of ``DECODE_CHUNK`` steps so the device is not
synchronised each step (the tokens are the same either way: a done row emits
PAD). With int8 self-KV, each chunk is quantized into the int8 prefix when the
next chunk starts (``chunk_start``), as the JAX package merges it. Runs on the
device of ``enc``.

A decode is a ``DecodeState`` (``beam.BeamState`` for beam search): its
tensors are allocated once, and ``run_chunk(c)`` runs chunk c's steps with the
step index a Python int, updating them only in place and reading nothing back
to the host. ``decode_chunks`` is the loop between chunks. The eager entry
points below run the chunks as they are; ``graphed.make_graphed_generate``
captures each chunk in a CUDA graph and replays it.

Under a mesh (a model built with ``mesh=``) every decode runs on the
model's local heads, its cached step reducing over the model group; the
logits come out whole and identical on every model rank, so the picks (an
argmax, a draw, beam's top-k) and the done flags are the same there and the
model ranks step together. A decode entry point takes this data rank's rows
of the batch, as training does. ``mesh_generate`` splits a whole batch's
rows over the data group and gathers the tokens back, in any mode. Only the
CUDA-graph engine refuses a tensor-parallel model (``graphed.py``).

Sampling draws with the Gumbel-max trick (argmax of logits / temp plus Gumbel
noise from the caller's ``torch.Generator``): a draw from the same
categorical distribution as ``jax.random.categorical``, not the same draws.
Each step draws the noise of the global batch, data rank after data rank,
and takes this rank's rows: with the same generator seed on every rank, a
sampled decode under any mesh gives one process's tokens (JAX's draws do not
depend on the sharding either). Without a data group that noise is the
whole batch's, as it always was.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from texocr_tpu_torch.models.attention import (
    DECODE_CHUNK,
    chunk_size,
    chunk_start,
    decode_chunks,
)
from texocr_tpu_torch.models.beam import BeamState
from texocr_tpu_torch.models.ocr_model import OCRModel
from texocr_tpu_torch.parallel.layers import gather_rows
from texocr_tpu_torch.parallel.mesh import NO_AXIS, MeshAxis
from texocr_tpu_torch.parallel.sharding import batch_rows
from texocr_tpu_torch.utils import topk_filter

__all__ = ["DECODE_CHUNK", "DecodeState", "decode_state", "greedy_decode",
           "mesh_generate", "mesh_greedy_decode", "sampled_decode", "generate"]

DECODE_MODES = ("greedy", "sample", "beam")


class DecodeState:
    """A greedy or sampled decode over precomputed cross-attention K/V:
    ``tokens`` (B, max_len), ``done`` and ``cur`` (B,), the self-attention
    cache and, with ``return_logits``, ``logits_buf`` (B, max_len, V), all
    allocated here once. ``pick(logits)`` chooses each step's tokens.
    ``enc_mask``: (B, Nk) bool, False at padded encoder positions. With a
    prefix decoder ``cross_kv`` is the prefix's filled latent cache, and the
    decode ``start``s after it: BOS, step 0's input, at the prefix's length,
    so the positional table leaves ``max_length - start`` steps."""

    def __init__(self, model: OCRModel, cross_kv, pick: Callable, *, bos_token: int,
                 eos_token: int, pad_token: int, max_len: int,
                 enc_mask: Optional[torch.Tensor] = None, return_logits: bool = False):
        kv = next(iter(cross_kv[0].values()))
        batch, device = kv.shape[0], kv.device
        self.model, self.cross_kv, self.pick, self.enc_mask = model, cross_kv, pick, enc_mask
        self.bos_token, self.eos_token, self.pad_token = bos_token, eos_token, pad_token
        self.start = model.decoder_start(cross_kv)
        self.max_len, self.chunk = chunk_size(max_len,
                                              model.config.decoder.max_length - self.start)
        self.n_chunks = -(-self.max_len // self.chunk)
        self.cache = model.decoder_init_cache(batch, self.max_len, device)
        self.tokens = torch.empty((batch, self.max_len), dtype=torch.int64, device=device)
        self.done = torch.empty(batch, dtype=torch.bool, device=device)
        self.cur = torch.empty(batch, dtype=torch.int64, device=device)
        self.logits_buf = None
        if return_logits:
            vocab = model.config.decoder.vocab_size
            self.logits_buf = torch.empty(batch, self.max_len, vocab, dtype=torch.float32,
                                          device=device)

    def run_chunk(self, c: int) -> None:
        """Steps c * chunk .. min((c + 1) * chunk, max_len) - 1, in place.
        Chunk 0 first resets the state to BOS, so running the chunks again
        repeats the decode."""
        if c == 0:
            self.tokens.fill_(self.pad_token)
            self.done.zero_()
            self.cur.fill_(self.bos_token)
            if self.logits_buf is not None:
                self.logits_buf.zero_()
        for t in range(c * self.chunk, min((c + 1) * self.chunk, self.max_len)):
            t0 = chunk_start(self.cache, t, self.chunk)
            logits = self.model.decoder_step(self.cur, t, self.cache, self.cross_kv,
                                             enc_mask=self.enc_mask, t0=t0).float()
            if self.logits_buf is not None:
                self.logits_buf[:, t] = logits
            self.cur.copy_(torch.where(self.done, self.pad_token, self.pick(logits)))
            self.tokens[:, t] = self.cur
            self.done |= self.cur == self.eos_token

    def result(self):
        """(B, max_len) int64 tokens, PAD after EOS, and with
        ``return_logits`` also the (B, max_len, V) float32 step logits (zeros
        for steps not run): the state's own buffers."""
        if self.logits_buf is not None:
            return self.tokens, self.logits_buf
        return self.tokens


def _run(state):
    decode_chunks(state, state.run_chunk)
    return state.result()


def argmax(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1)


def sampler(generator: torch.Generator, temp: float, topk_threshold: float = 0.9,
            data: MeshAxis = NO_AXIS) -> Callable:
    """The reference's sampling: ``topk_filter`` (k = 99 of 1000), then a
    categorical draw at ``temp``, its noise from ``generator``. The logits
    hold data rank ``data.rank``'s block of rows: the noise is drawn for the
    whole batch and this block's rows kept."""
    tiny = torch.finfo(torch.float32).tiny

    def pick(logits):
        rows, vocab = logits.shape
        u = torch.rand((rows * data.size, vocab), generator=generator, device=logits.device)
        if data.size > 1:
            u = u[data.rank * rows: (data.rank + 1) * rows]
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return (topk_filter(logits, topk_threshold) / temp + gumbel).argmax(dim=-1)

    return pick


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
    return _run(DecodeState(model, model.decoder_cross_kv(enc), argmax, bos_token=bos_token,
                            eos_token=eos_token, pad_token=pad_token, max_len=max_len,
                            enc_mask=enc_mask, return_logits=return_logits))


@torch.inference_mode()
def mesh_generate(model: OCRModel, images: torch.Tensor, mesh, *, max_len: int,
                  mode: str = "greedy", generator: Optional[torch.Generator] = None,
                  temp: float = 0.3, beam_size: int = 5) -> torch.Tensor:
    """``generate`` of a whole batch under ``model``'s mesh, the counterpart
    of the JAX package's jitted decode on a batch sharded over 'data' and
    parameters over 'model': this data rank encodes and decodes its rows of
    ``images`` (B, H, W, 1) with its model group, and every rank returns all
    B rows of tokens (B, max_len). Beam search keeps an image's
    ``beam_size`` rows on the rank that holds the image. ``generator``
    (sampling) must be seeded alike on every rank; the tokens then equal one
    process's. A batch the data axis does not divide raises ``ValueError``,
    as ``batch_rows`` does."""
    check_mode(model, mode, generator, mesh=True)
    rows = batch_rows(images.shape[0], mesh)
    cross_kv = model.decoder_cross_kv(model.encode(images[rows]))
    tokens = _run(decode_state(model, cross_kv, max_len=max_len, mode=mode, generator=generator,
                               temp=temp, beam_size=beam_size))
    return gather_rows(tokens, model.data)


def mesh_greedy_decode(model: OCRModel, images: torch.Tensor, mesh, *, max_len: int
                       ) -> torch.Tensor:
    """``mesh_generate``'s greedy case."""
    return mesh_generate(model, images, mesh, max_len=max_len)


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
    """The reference's sampling (``sampler``), its noise from ``generator``
    (on ``enc``'s device). Returns what ``greedy_decode`` returns."""
    return _run(DecodeState(model, model.decoder_cross_kv(enc),
                            sampler(generator, temp, topk_threshold, model.data),
                            bos_token=bos_token, eos_token=eos_token, pad_token=pad_token,
                            max_len=max_len, enc_mask=enc_mask, return_logits=return_logits))


def check_mode(model: OCRModel, mode: str, generator: Optional[torch.Generator],
               mesh: bool = False) -> None:
    """Raises ``ValueError`` for a decode that cannot run: an unknown mode,
    sampling without a generator, or a decoder without cross-attention; and
    ``NotImplementedError`` for a mode or a ``mesh`` decode the model's
    decoder kind does not run (``OCRModel.check_decodes``)."""
    model.check_decodes(mode, mesh)
    if mode not in DECODE_MODES:
        raise ValueError(f"unknown decode mode: {mode!r}")
    if mode == "sample" and generator is None:
        raise ValueError("mode='sample' requires a generator")


def decode_state(model: OCRModel, cross_kv, *, max_len: int, mode: str = "greedy",
                 generator: Optional[torch.Generator] = None, temp: float = 0.3,
                 beam_size: int = 5):
    """``generate``'s decode in ``mode`` over precomputed cross-attention
    K/V, with the config's BOS, EOS and PAD: a ``DecodeState`` or, for
    beam, a ``BeamState``."""
    cfg = model.config
    common = dict(bos_token=cfg.bos_token, eos_token=cfg.eos_token, pad_token=cfg.pad_token,
                  max_len=max_len)
    if mode == "beam":
        return BeamState(model, cross_kv, beam_size=beam_size, **common)
    pick = sampler(generator, temp, data=model.data) if mode == "sample" else argmax
    return DecodeState(model, cross_kv, pick, **common)


@torch.inference_mode()
def generate(model: OCRModel, images: torch.Tensor, *, max_len: int, mode: str = "greedy",
             generator: Optional[torch.Generator] = None, temp: float = 0.3,
             beam_size: int = 5) -> torch.Tensor:
    """Encode + decode in one call: (B, H, W, 1) preprocessed images ->
    (B, max_len) token ids. ``mode``: "greedy", "sample" (at ``temp``, which
    needs ``generator``) or "beam" (``beam_size`` wide, no length penalty)."""
    check_mode(model, mode, generator)
    cross_kv = model.decoder_cross_kv(model.encode(images))
    return _run(decode_state(model, cross_kv, max_len=max_len, mode=mode, generator=generator,
                             temp=temp, beam_size=beam_size))
