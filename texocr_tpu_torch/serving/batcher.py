"""Micro-batching serving loop.

Collects concurrent requests, groups them by bucket canvas (the preprocess
pads every image onto a small set of canvas shapes), pads each group with
zero canvases to one of a few batch sizes, runs the engine's encode and
decode on the batch, and resolves each request's future.

Usage:
    engine = TexOCR(config)
    batcher = ServingBatcher(engine, max_batch=16)
    fut = batcher.submit(image)          # concurrent callers
    tokens, latex = fut.result()
    batcher.shutdown()

The JAX package's ``prefix_tiers`` option is left out: it sets how many
compiled variants of the TPU decode read the self-attention prefix, and the
port's CUDA graphs read the prefix at its true length at every step. The
fixed batch sizes stay: on a CUDA engine each (canvas, batch size) is one set
of CUDA graphs, captured on its first batch, as the JAX package compiles one
program per shape; ``warmup`` captures them all before the first request.

Counters (``telemetry.count``), added once a group's last future is set:
``batcher.groups``; ``batcher.rows``, its requests (zero canvases left
out); ``batcher.wait_s``, their time from ``submit`` to the group's engine
call, summed; ``batcher.service_s``, from that call to the last future set.
``warmup`` counts nothing.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np

from texocr_tpu_torch import telemetry


class ServingBatcher:
    def __init__(
        self,
        engine,
        max_batch: int = 16,
        max_wait_ms: float = 5.0,
        max_len: int = 350,
        mode: str = "greedy",
        batch_sizes: Optional[Tuple[int, ...]] = None,
        request_timeout_s: Optional[float] = None,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.max_len = max_len
        self.mode = mode
        # A request older than this when its batch forms fails with
        # TimeoutError instead of occupying the card.
        self.request_timeout_s = request_timeout_s
        # Flipped by warmup() / the first successful batch; the HTTP front
        # end reports it on /healthz and can 503 until warm.
        self.warm = False
        # Solo requests and full batches by default: few shapes, all warmable.
        self.batch_sizes = tuple(sorted(batch_sizes or (1, max_batch)))
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _padded_size(self, n: int) -> int:
        for s in self.batch_sizes:
            if n <= s:
                return s
        return self.batch_sizes[-1]

    def warmup(self, canvas_shapes) -> None:
        """Run every (canvas, batch size) pair once up front, so no request
        pays for a first run at its shape (on a CUDA engine, the capture of its
        graphs). ``canvas_shapes``: (H, W) pairs."""
        for h, w in canvas_shapes:
            for n in self.batch_sizes:
                canvases = np.full((n, h, w, 1), 255, np.uint8)
                # .cpu() waits for the device.
                self.engine.generate_batch(canvases, max_len=self.max_len, mode=self.mode).cpu()
        self.warm = True

    def submit(self, img) -> Future:
        """Enqueue an image (what the engine's ``preprocess`` takes: a PIL
        image or a 2-D uint8 array); the future resolves to (tokens, latex).

        Raises RuntimeError once shutdown() has been called: there is no
        worker left to resolve the future."""
        if self._stop.is_set():
            raise RuntimeError("ServingBatcher is shut down")
        fut: Future = Future()
        canvas = self.engine.preprocess(img)  # (1, H, W, 1) on a bucket canvas
        self._q.put((canvas, fut, time.monotonic()))
        return fut

    def __call__(self, img) -> Tuple[list, str]:
        return self.submit(img).result()

    def shutdown(self):
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=5)
        # Fail anything that raced into the queue around the sentinel so no
        # caller blocks forever on an orphaned future.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("ServingBatcher shut down before decode"))

    # -- worker ----------------------------------------------------------------

    def _drain(self):
        """Block for one request, then take up to max_batch more within the
        wait window."""
        first = self._q.get()
        if first is None:
            return None
        items = [first]
        t0 = time.monotonic()
        while len(items) < self.max_batch:
            remaining = self.max_wait - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                return items  # shutdown after this batch
            items.append(item)
        return items

    def _expire(self, items):
        """Fail requests that have already waited past request_timeout_s."""
        if self.request_timeout_s is None:
            return items
        now = time.monotonic()
        live = []
        for canvas, fut, t_in in items:
            if now - t_in > self.request_timeout_s:
                fut.set_exception(TimeoutError(
                    f"request waited {now - t_in:.1f}s (> {self.request_timeout_s}s) "
                    "before decode"))
            else:
                live.append((canvas, fut, t_in))
        return live

    def _run(self):
        while not self._stop.is_set():
            items = self._drain()
            if items is None:
                return
            items = self._expire(items)
            # Group by canvas shape: same-bucket requests batch together.
            groups = {}
            for canvas, fut, t_in in items:
                groups.setdefault(canvas.shape[1:3], []).append((canvas, fut, t_in))
            for group in groups.values():
                canvases = np.concatenate([c for c, _, _ in group], axis=0)
                n = canvases.shape[0]
                padded_n = self._padded_size(n)
                if padded_n > n:
                    filler = np.zeros((padded_n - n,) + canvases.shape[1:], canvases.dtype)
                    canvases = np.concatenate([canvases, filler])
                t_call = time.monotonic()
                try:
                    tokens = self.engine.generate_batch(canvases, max_len=self.max_len,
                                                        mode=self.mode).cpu().numpy()
                    self.warm = True
                    for row, (_, fut, _) in zip(tokens[:n], group):
                        fut.set_result(self.engine.postprocess(row))
                except Exception as e:  # the worker keeps serving; every waiter gets the error
                    for _, fut, _ in group:
                        if not fut.done():
                            fut.set_exception(e)
                telemetry.count("batcher.service_s", time.monotonic() - t_call)
                telemetry.count("batcher.wait_s", sum(t_call - t_in for _, _, t_in in group))
                telemetry.count("batcher.rows", n)
                telemetry.count("batcher.groups")
