"""Requests in bursts into the micro-batcher: ``open_loop_batcher``'s path
with its own send times.

The mix's ``burst`` ({"on_s", "off_s", "on_rate_per_s"}) alternates an on
phase, Poisson arrivals at ``on_rate_per_s``, with an off phase that sends
nothing; ``rate_per_s`` is the mean over a cycle, and has to agree. The
cycle's phase is drawn from the mix's ``schedule_seed``, and so are the
send times and the order of the classes: every run meets the same bursts.
The traced slice starts with the first on phase that begins after the
mix's ``trace.start`` share of the window, so it holds a burst and the
drain after it. Everything else (the engine, the batcher, every graph key
warmed, latency from each request's due time, the check) is
``open_loop_batcher``'s.
"""

from __future__ import annotations

import math
from typing import Dict, List
from unittest import mock

import numpy as np

from portbench import traffic
from portbench.drivers import open_loop_batcher
from portbench.harness import Run


def cycle(mix: dict) -> tuple:
    """(on_s, period_s, on_rate) of the mix's bursts, its mean rate checked."""
    b = mix["burst"]
    period = b["on_s"] + b["off_s"]
    mean = b["on_rate_per_s"] * b["on_s"] / period
    if not math.isclose(mean, mix["rate_per_s"], rel_tol=1e-9):
        raise ValueError(f"bursts of {b} average {mean} requests/s, not the mix's "
                         f"rate_per_s {mix['rate_per_s']}")
    return b["on_s"], period, b["on_rate_per_s"]


def on_phases(mix: dict, seconds: float) -> List[tuple]:
    """The (start, end) of each on phase within [0, seconds), the cycle's
    phase drawn from ``schedule_seed``."""
    on, period, _ = cycle(mix)
    phase = traffic.rng(mix["schedule_seed"], 2).uniform(0.0, period)
    out = []
    start = -phase
    while start < seconds:
        a, b = max(start, 0.0), min(start + on, seconds)
        if b > a:
            out.append((a, b))
        start += period
    return out


def send_times(mix: dict, seconds: float, gen: np.random.Generator) -> np.ndarray:
    """Send times in [0, seconds): the on phases' Poisson arrivals
    (``traffic.arrival_offsets`` over the on phases' time laid end to end)."""
    _, _, rate = cycle(mix)
    phases = on_phases(mix, seconds)
    lengths = np.array([b - a for a, b in phases])
    ends = np.cumsum(lengths)
    on_clock = traffic.arrival_offsets(rate, float(ends[-1]), gen)
    i = np.searchsorted(ends, on_clock, side="right").clip(max=len(phases) - 1)
    starts = np.array([a for a, _ in phases])
    return starts[i] + on_clock - (ends[i] - lengths[i])


def requests(mix: dict, seed: int, seconds: float) -> List[Dict]:
    """``traffic.open_loop``'s requests at the bursts' send times."""
    schedule = traffic.rng(mix["schedule_seed"], 1)
    times = send_times(mix, seconds, schedule)
    classes = mix["classes"]
    order = [i for i, count in enumerate(traffic.class_counts(classes, len(times)))
             for _ in range(count)]
    order = [order[j] for j in schedule.permutation(len(order))]
    gen = traffic.rng(seed, 1)
    out = []
    for t, i in zip(times, order):
        (h0, h1), (w0, w1) = classes[i]["height"], classes[i]["width"]
        h, w = int(gen.integers(h0, h1 + 1)), int(gen.integers(w0, w1 + 1))
        out.append({"t": float(t), "image": traffic.ink_image(h, w, mix["ink"], gen)})
    return out


def traced_start(mix: dict, seconds: float) -> float:
    """The share of the window at which the traced slice starts: the first
    on phase from ``trace.start`` on (the last one if none begins later)."""
    phases = on_phases(mix, seconds)
    later = [a for a, _ in phases if a >= mix["trace"]["start"] * seconds]
    return (later[0] if later else phases[-1][0]) / seconds


def run(run: Run) -> None:
    mix = run.cell.mix
    if run.trace:
        run.cell.mix = dict(mix, trace=dict(mix["trace"], start=traced_start(mix, run.seconds)))
    with mock.patch.object(traffic, "open_loop", requests):
        open_loop_batcher.run(run)
