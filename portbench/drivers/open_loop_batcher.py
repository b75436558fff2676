"""Open-loop requests into the micro-batcher: the web users' path.

Set-up: the engine (``serving.wrapper.TexOCR``) on the seed's weights, the
mix's ``ServingBatcher``, every (canvas, batch size) graph key captured and
replayed once. Window: each request of the mix is submitted at its send
time from this thread, whatever the batcher is doing; its latency runs from
that due time to its future's resolution (tokens and LaTeX, after
``postprocess``). Requests due in the window are awaited after it closes, a
minute at most; one that fails or never resolves counts as infinitely late
and as failed.

Counters for the readers: rows of each batch the engine decoded that are
not the batcher's zero filler canvases, and the host time of each engine
call outside the profiled slice (it ends in the copy of its tokens to the
host).
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Optional

import numpy as np
import torch

from portbench import checks, traffic
from portbench.harness import Run, percentile
from portbench.reference import model as ref
from portbench.trace import Slice

#: How long after the window closes requests are awaited.
GRACE_S = 60.0


def canvases(engine, classes) -> list:
    """The canvas of every class's smallest and largest image."""
    shapes = set()
    for c in classes:
        for h in c["height"]:
            for w in c["width"]:
                shapes.add(engine.preprocess(np.zeros((h, w), np.uint8)).shape[1:3])
    return sorted(shapes)


def instrument(engine, run: Run, trace: Optional[Slice], trace_at: list) -> None:
    """Wraps the engine's batch call: counts real rows and times the call.
    With ``trace``, the profiled slice starts at the first call past
    ``trace_at[0]`` and stops at the first call ``trace_at[1]`` seconds
    after it started: on the thread that launches every kernel, between two
    calls, while nothing else runs on the device."""
    inner = engine.generate_batch
    fills, calls = [], []
    run.counters.update(fills=fills, call_s=calls)

    def generate_batch(images, **kw):
        if trace is not None and trace_at:
            now = time.perf_counter()
            if not trace.started and now >= trace_at[0]:
                trace.start()
            elif trace.running and now >= trace.t_start + trace_at[1]:
                trace.stop()
        with torch.profiler.record_function("portbench.generate_batch"):
            t0 = time.perf_counter()
            out = inner(images, **kw).cpu()
            if trace is None or not trace.running:  # a profiled call runs slower
                calls.append(time.perf_counter() - t0)
        fills.append(int((np.asarray(images).reshape(len(images), -1).max(axis=1) > 0).sum()))
        fault = run.faults.get("tokens")
        return fault(out) if fault else out

    engine.generate_batch = generate_batch


def run(run: Run) -> None:
    from texocr_tpu_torch.serving.batcher import ServingBatcher
    from texocr_tpu_torch.serving.wrapper import TexOCR

    mix, cfg = run.cell.mix, run.model_config
    arch = ref.Arch.from_config(cfg)
    params = ref.make_params(arch, run.seed, run.device, mix["eos_logit"])
    engine = TexOCR(cfg, device=run.device, state_dict=params)
    requests = traffic.open_loop(mix, run.seed, run.seconds)
    b = mix["batcher"]
    batcher = ServingBatcher(engine, max_batch=b["max_batch"], max_wait_ms=b["max_wait_ms"],
                             max_len=b["max_len"], mode=b["mode"],
                             batch_sizes=tuple(b["batch_sizes"]))
    shapes = canvases(engine, mix["classes"])
    batcher.warmup(shapes)   # captures every key
    batcher.warmup(shapes)   # and replays it once
    trace = Slice(sync=True) if run.trace else None
    trace_at = []
    instrument(engine, run, trace, trace_at)
    if trace is not None:
        Slice.prime()

    n = len(requests)
    done = [math.inf] * n
    futures = []
    lateness = []
    try:
        run.setup_done()
        t0 = time.perf_counter()
        if trace is not None:
            trace_at += [t0 + mix["trace"]["start"] * run.seconds, mix["trace"]["seconds"]]
        for i, r in enumerate(requests):
            due = t0 + r["t"]
            while True:
                now = time.perf_counter()
                if now >= due:
                    break
                time.sleep(min(due - now, 0.002))
            lateness.append(time.perf_counter() - due)
            fut = batcher.submit(r["image"])
            fut.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))
            futures.append(fut)
        while time.perf_counter() < t0 + run.seconds:
            time.sleep(0.002)
        answers = []
        deadline = t0 + run.seconds + GRACE_S
        for fut in futures:
            try:
                answers.append(fut.result(timeout=max(0.0, deadline - time.perf_counter())))
            except Exception:  # a failed or unresolved request: late forever
                answers.append(None)
    finally:
        batcher.shutdown()
    if trace is not None and (trace.running or not trace.started):
        raise RuntimeError("no engine call came to close the traced slice")
    run.slice = trace
    run.read_memory_peak()

    latency = [done[i] - (t0 + r["t"]) if answers[i] is not None else math.inf
               for i, r in enumerate(requests)]
    run.attempted = n
    run.failed = sum(a is None for a in answers)
    # A tail among the requests that never came reads as the whole wait.
    waited = run.seconds + GRACE_S
    run.e2e["latency_p50_s"] = min(percentile(latency, 50), waited)
    run.e2e["latency_p95_s"] = min(percentile(latency, 95), waited)
    run.counters["lateness_s"] = lateness
    third = max(1, n // 3)
    if not run.failed:
        run.counters["drift_s"] = (statistics.mean(latency[-third:]) -
                                   statistics.mean(latency[:third]))
    run.counters["completed_per_s"] = sum(d <= t0 + run.seconds for d in done) / run.seconds

    del engine, batcher, futures
    if run.device == "cuda":
        torch.cuda.empty_cache()
    served = [(r["image"], a[0]) for r, a in zip(requests, answers) if a is not None]
    acc = checks.served_gaps(served, params, arch, max_len=b["max_len"],
                             sample=mix["check"]["sample"], seed=run.seed, controls=run.controls)
    run.counters["gaps"] = acc.numbers()
    run.counters["compared"] = {"rows": acc.rows, "tokens": acc.tokens}
    run.judge(run.counters["gaps"])
