"""The compiled decode: ``make_graphed_generate``, the port of the JAX
package's ``make_jitted_generate`` and of its serving wrapper's per-shape jit
cache, as CUDA graphs.

The JAX package compiles one XLA program per (canvas, max_len, mode): the
uint8 to float conversion, the encode, the cross-attention K/V and a
``lax.while_loop`` over ``lax.scan`` chunks of ``DECODE_CHUNK`` steps. The port
captures the same work once per key and replays it:

- an encode graph: ``1 - u8 / 255``, ``OCRModel.encode`` (its flash kernel
  launches included) and the cross-attention K/V, into the graph's own
  output buffers. With ``float_input`` the engine takes the model's input
  itself, (B, H, W, 1) float32 as the data loader collates it, and encodes
  it as it is: evaluation's engine, whose tokens equal ``generate`` on the
  loader's batch;
- one graph per chunk (``DecodeState.run_chunk`` / ``BeamState.run_chunk``,
  chunk 0 resetting the state to BOS). The step index t and the int8 prefix
  length t0 stay Python ints, as in the eager loop, so every graph runs the
  eager path's kernels on the eager path's shapes and its tokens equal the
  eager path's bit for bit. (One graph of a step with t on the device would
  read the self-attention cache at a fixed width under a mask: other
  reduction lengths, other numbers.)

Between chunk replays the host reads the done flags (``decode_chunks``), as
the eager loop does and as the JAX ``while_loop``'s condition. While a profile
runs, the encode replay is a ``decode.encode`` span with its device time, as
each chunk's replay is a ``decode.chunk`` span; every key adds its warm-up and
capture seconds to the counter ``graphs.capture_s`` (and to ``capture_s``),
and 1 to ``graphs.keys``. A replay
launches the kernels without passing through their wrappers, so each graph
is captured inside ``telemetry.deferred()``: the host counts its capture
made (the kernels' launches, ``moe.layers``) are kept with the graph and
added once per replay, and a capture itself counts nothing. The device
counter ``moe.expert_rows`` needs no such help: its adds are captured and
replayed.

Capture follows ``torch.cuda.graphs``' rules: every region runs once
eagerly on a side stream first (cuDNN's and cuBLAS's first calls at a shape,
and the flash library's build at its first launch), all graphs of a key
share one memory pool and replay in the order they were captured, and one
lock per key keeps its replays from overlapping. A sampled key registers its
generator with every graph (graph-safe RNG): a replay draws what the eager
decode draws from the generator's state at that moment, and advances it as
the eager decode would.

A tensor-parallel model raises ``NotImplementedError`` (``OCRModel.
check_unsharded`` says why): its step's collectives would have to be
captured, which gloo's cannot be, and NCCL needs a GPU per rank.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import torch

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.models.attention import decode_chunks
from texocr_tpu_torch.models.generate import check_mode, decode_state
from texocr_tpu_torch.models.ocr_model import OCRModel

# CUDA allows one stream capture at a time in a process.
_CAPTURE_LOCK = threading.Lock()


class GraphedGenerate:
    """``(B, H, W, 1) uint8 canvases -> (B, max_len) int64 tokens`` on the
    model's CUDA device, or with ``float_input`` float32 model inputs, from
    graphs captured at construction (see ``make_graphed_generate``).
    ``encode()`` and ``decode()`` replay the two halves on the input last
    copied in, for timing them apart."""

    def __init__(self, model: OCRModel, batch: int, canvas: Tuple[int, int], max_len: int,
                 mode: str, *, beam_size: int = 5, generator: Optional[torch.Generator] = None,
                 temp: float = 0.3, float_input: bool = False):
        model.check_unsharded("the CUDA-graph decode")
        device = next(model.parameters()).device
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device; the model is on {device}")
        check_mode(model, mode, generator)
        self.model = model
        self.generator = generator if mode == "sample" else None
        self.decode_args = dict(max_len=max_len, mode=mode, generator=generator, temp=temp,
                                beam_size=beam_size)
        self.float_input = float_input
        self.images = self._input_buffer(batch, canvas, device)
        self.lock = threading.Lock()
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        with _CAPTURE_LOCK, torch.inference_mode():
            t0 = time.perf_counter()
            self._warm_up()
            self._encode_graph, self.cross_kv = self._capture(self._encode)
            self.state = decode_state(model, self.cross_kv, **self.decode_args)
            self._chunk_graphs = [self._capture(lambda c=c: self.state.run_chunk(c))[0]
                                  for c in range(self.state.n_chunks)]
            #: Seconds of this key's eager warm-up and captures.
            self.capture_s = time.perf_counter() - t0
            telemetry.count("graphs.capture_s", self.capture_s)
            telemetry.count("graphs.keys")

    def _input_buffer(self, batch: int, canvas: Tuple[int, int], device) -> torch.Tensor:
        """The static input: white uint8 canvases, or their float32 model
        input (zeros)."""
        if self.float_input:
            return torch.zeros((batch, *canvas, 1), dtype=torch.float32, device=device)
        return torch.full((batch, *canvas, 1), 255, dtype=torch.uint8, device=device)

    def _encode(self):
        """The encode graph's work: the input as the model takes it, the
        encoder, the cross-attention K/V."""
        x = self.images if self.float_input else 1.0 - self.images.float() / 255.0
        return self.model.decoder_cross_kv(self.model.encode(x))

    def _warm_up(self) -> None:
        """Every region once, eagerly, on the capture stream; the generator
        is left as it was."""
        rng = None if self.generator is None else self.generator.get_state()
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            state = decode_state(self.model, self._encode(), **self.decode_args)
            for c in range(state.n_chunks):
                state.run_chunk(c)
        torch.cuda.current_stream().wait_stream(self._stream)
        torch.cuda.synchronize()
        if rng is not None:
            self.generator.set_state(rng)

    def _capture(self, fn):
        """(a graph of ``fn()`` with the counts its capture held back, what
        ``fn`` returned: tensors of the graph's pool that every replay
        rewrites)."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with telemetry.deferred() as counts, torch.cuda.graph(
                graph, pool=self._pool, stream=self._stream, capture_error_mode="thread_local"):
            out = fn()
        return (graph, counts), out

    @staticmethod
    def _replay(entry) -> None:
        graph, counts = entry
        graph.replay()
        for name, n in counts.items():
            telemetry.count(name, n)

    def encode(self) -> None:
        with telemetry.span("decode.encode", device=self.images):
            self._replay(self._encode_graph)

    def decode(self) -> None:
        decode_chunks(self.state, lambda c: self._replay(self._chunk_graphs[c]))

    def __call__(self, images) -> torch.Tensor:
        images = torch.as_tensor(images)
        if images.shape != self.images.shape or images.dtype != self.images.dtype:
            raise ValueError(f"expected {self.images.dtype} inputs of shape "
                             f"{tuple(self.images.shape)}, got {images.dtype} "
                             f"{tuple(images.shape)}")
        with self.lock, torch.inference_mode():
            self.images.copy_(images)
            self.encode()
            self.decode()
            # A copy: the next call rewrites the state's buffers.
            return self.state.result().clone()


def make_graphed_generate(model: OCRModel, batch: int, canvas: Tuple[int, int], max_len: int,
                          mode: str = "greedy", *, beam_size: int = 5,
                          generator: Optional[torch.Generator] = None,
                          temp: float = 0.3, float_input: bool = False) -> GraphedGenerate:
    """``generate`` compiled for one shape: ``batch`` canvases of ``canvas``
    (H, W) as uint8 (with ``float_input``, the float32 model input),
    decoded to ``max_len`` tokens in ``mode`` ("greedy", "sample" at
    ``temp`` with ``generator``, or "beam" ``beam_size`` wide; int8 caches as
    the model's config sets them). Captures the encode graph and one graph
    per chunk now, and returns the callable that replays them; its tokens
    equal ``generate``'s on ``1 - u8 / 255`` (on the float input itself). A
    model on the CPU raises ``ValueError``: CUDA graphs need a CUDA device,
    and nothing falls back."""
    return GraphedGenerate(model, batch, canvas, max_len, mode, beam_size=beam_size,
                           generator=generator, temp=temp, float_input=float_input)
