"""The readers of the program's own spans and counters (``portbench/spans.py``
and the metrics that use it) on synthetic slices and records with known
gaps, device times and counts."""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

from portbench.trace import Slice
from texocr_tpu_torch import telemetry

PB = Path(__file__).parents[1]

IDLE_METRICS = ("idle.launch.serve", "idle.check.serve", "idle.between_calls.serve")
SPAN_METRICS = IDLE_METRICS + (
    "decode.encode_ms.batch", "decode.step_ms.batch", "train.forward_ms.train",
    "train.backward_ms.train", "train.optimizer_ms.train")
COUNTER_METRICS = ("batcher.wait_s.serve", "batcher.service_s.serve",
                   "batcher.rows_per_call.serve", "graphs.capture_s")


def reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  PB / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def span(name, device_ms=None, counters=None):
    events = None if device_ms is None else (_Event(0.0), _Event(device_ms))
    s = telemetry.Span(name, events)
    s.counters = counters or {}
    return s


def make_run(busy, window_ns, counters=None, host=()):
    """A run whose traced slice has device operations ``busy`` and host
    events ``host``: (name, start, end)."""
    sl = Slice(sync=False)
    sl.device = [("kernel", a, b) for a, b in busy]
    sl.host = list(host)
    sl.window_s = window_ns * 1e-9
    return types.SimpleNamespace(slice=sl, counters=counters or {})


@pytest.fixture
def record(monkeypatch):
    """Sets what the program's record holds: ``record(spans, counters)``."""

    def put(spans=(), counters=None):
        monkeypatch.setattr(telemetry, "spans", lambda: list(spans))
        monkeypatch.setattr(telemetry, "counters", lambda: dict(counters or {}))

    return put


def test_idle_shares_split_the_gaps_by_the_span_under_their_midpoint():
    # Gaps (100, 200) mid 150 in a chunk; (300, 350) mid 325 in a check;
    # (400, 600) mid 500 in the call but no chunk or check; (700, 900) mid
    # 800 between calls. The harness's own event is no span of the program's.
    run = make_run([(0, 100), (200, 300), (350, 400), (600, 700), (900, 1000)], 1200,
                   host=[("portbench.generate_batch", 0, 1200), ("engine.call", 50, 650),
                         ("decode.encode", 60, 90), ("decode.chunk", 120, 180),
                         ("decode.check", 310, 340), ("engine.call", 950, 1100)])
    got = {m: reader(m)(run) for m in IDLE_METRICS}
    assert got["idle.launch.serve"] == pytest.approx(100 * 100 / 1200)
    assert got["idle.check.serve"] == pytest.approx(100 * 50 / 1200)
    assert got["idle.between_calls.serve"] == pytest.approx(100 * 200 / 1200)
    idle = reader("idle.serve")(run)
    assert idle == pytest.approx(100 * (1 - 450 / 1200))
    assert sum(got.values()) <= idle


def test_a_gap_in_a_check_is_never_a_launch():
    run = make_run([(0, 100), (200, 300)], 400,
                   host=[("engine.call", 0, 300), ("decode.chunk", 0, 300),
                         ("decode.check", 140, 160)])
    assert reader("idle.launch.serve")(run) == 0
    assert reader("idle.check.serve")(run) == pytest.approx(25.0)
    assert reader("idle.between_calls.serve")(run) == 0


@pytest.mark.parametrize("seed", range(5))
def test_the_three_idle_shares_add_up_to_at_most_idle_serve(seed):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.choice(np.arange(1, 100_000), 80, replace=False))
    busy = list(zip(edges[0::2].tolist(), edges[1::2].tolist()))
    host, t = [], 0
    while t < 100_000:  # calls of chunks and checks, with gaps between calls
        call_end = t + int(rng.integers(2_000, 20_000))
        host.append(("engine.call", t, call_end))
        u = t
        while u < call_end:
            step = int(rng.integers(100, 2_000))
            kind = "decode.chunk" if rng.random() < 0.6 else "decode.check"
            host.append((kind, u, min(u + step, call_end)))
            u += step + int(rng.integers(0, 300))
        t = call_end + int(rng.integers(0, 5_000))
    run = make_run(busy, 100_000, host=host)
    shares = [reader(m)(run) for m in IDLE_METRICS]
    assert all(s is not None and s >= 0 for s in shares)
    assert sum(shares) <= reader("idle.serve")(run) + 1e-9


def test_device_time_readers(record):
    run = make_run([(0, 1)], 10, counters={"decode_steps": 64})
    record([span("decode.encode", 12.5)]
           + [span("decode.chunk", 3.0 + i) for i in range(2)]
           + [span(f"train.{p}", ms) for _ in range(2)
              for p, ms in (("forward", 100.0), ("backward", 200.0), ("optimizer", 30.0))]
           + [span("decode.check")])
    assert reader("decode.encode_ms.batch")(run) == 12.5
    assert reader("decode.step_ms.batch")(run) == pytest.approx((3.0 + 4.0) / 64)
    assert reader("train.forward_ms.train")(run) == 100.0
    assert reader("train.backward_ms.train")(run) == 200.0
    assert reader("train.optimizer_ms.train")(run) == 30.0


def test_batcher_readers_take_the_counts_from_before_the_profile(record):
    # The profile's first span found 4 groups of 10 requests that waited 3 s
    # and were served in 1.2 s; the run's counters went on to the backlog.
    before = {"batcher.groups": 4, "batcher.rows": 10, "batcher.wait_s": 3.0,
              "batcher.service_s": 1.2}
    later = {"batcher.groups": 4, "batcher.rows": 12, "batcher.wait_s": 3.5,
             "batcher.service_s": 1.6}
    run = make_run([(0, 1)], 10)
    record([span("engine.call", counters=before), span("decode.chunk", counters=later)],
           counters={"batcher.groups": 40, "batcher.rows": 400, "batcher.wait_s": 3000.0,
                     "batcher.service_s": 20.0})
    assert reader("batcher.wait_s.serve")(run) == pytest.approx(0.3)
    assert reader("batcher.rows_per_call.serve")(run) == pytest.approx(2.5)
    assert reader("batcher.service_s.serve")(run) == pytest.approx(0.3)
    # No group served before the profile: nothing to read.
    record([span("engine.call")], counters={"batcher.groups": 40, "batcher.rows": 400})
    assert reader("batcher.rows_per_call.serve")(run) is None


def test_graphs_capture_reader(record):
    record(counters={"graphs.capture_s": 9.0, "graphs.keys": 4})
    assert reader("graphs.capture_s")(make_run([(0, 1)], 10)) == 2.25


@pytest.mark.parametrize("name", SPAN_METRICS + COUNTER_METRICS)
def test_nothing_to_read_gives_none(record, monkeypatch, name):
    run = make_run([(0, 1), (5, 6)], 10, counters={"decode_steps": 8})
    record(counters={"batcher.groups": 0, "graphs.keys": 0})
    assert reader(name)(run) is None
    # A program without spans and counters (a checkout from before they were added).
    monkeypatch.delattr(telemetry, "spans")
    assert reader(name)(run) is None
