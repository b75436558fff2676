"""What the per-layer metrics read of the program's own record
(``texocr_tpu_torch.telemetry``): its spans, recorded while a profile runs,
so in the traced slice alone, with their device times and the counters as
they stood when each opened; their ``record_function`` twins among the
slice's host events, on the device trace's clock; and its counters, kept
over the whole run.

A program without that record (a checkout older than its spans) gives
nothing here: every function returns None, and so do the readers.
"""

from __future__ import annotations

import bisect
from typing import Callable, Iterable, List, Optional, Tuple


def _telemetry():
    from texocr_tpu_torch import telemetry

    return telemetry if hasattr(telemetry, "spans") else None


def named(*names: str) -> Optional[list]:
    """The spans named ``names``, in the order they opened; None when there
    are none."""
    tel = _telemetry()
    if tel is None:
        return None
    found = [s for s in tel.spans() if s.name in names]
    return found or None


def counter(name: str) -> Optional[float]:
    tel = _telemetry()
    return None if tel is None else tel.counters().get(name)


def ratio(num: str, den: str, counts: Optional[dict] = None) -> Optional[float]:
    """Counter ``num`` over counter ``den``, in ``counts`` or else over the
    whole run; None when either is missing or the denominator is 0."""
    if counts is None:
        a, b = counter(num), counter(den)
    else:
        a, b = counts.get(num), counts.get(den)
    return a / b if a is not None and b else None


def before_profile() -> Optional[dict]:
    """The counters as they stood when the profile's first span opened: the
    counts of the run before the traced slice, untouched by the profile and
    by what its stop leaves behind; None without a recorded span."""
    tel = _telemetry()
    recorded = tel.spans() if tel is not None else []
    return recorded[0].counters if recorded else None


def device_ms(*names: str) -> Optional[List[float]]:
    """The device milliseconds of each span named ``names`` that timed its
    device work; None when there are none."""
    found = named(*names) or []
    ms = [s.device_ms for s in found]
    ms = [m for m in ms if m is not None]
    return ms or None


def host(run, *names: str) -> Optional[List[Tuple[int, int]]]:
    """The (start, end) of each of the traced slice's host events named
    ``names`` (the spans' ``record_function`` twins, as the profiler
    recorded them); None when there are none."""
    if run.slice is None:
        return None
    found = [(a, b) for name, a, b in run.slice.host if name in names]
    return found or None


def inside(intervals: Iterable[Tuple[int, int]]) -> Callable[[int], bool]:
    """Whether a time (ns, the profiler's clock) lies in any of ``intervals``."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]

    def test(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= merged[i][1]

    return test


def idle_gaps(run) -> List[Tuple[int, int]]:
    """The traced slice's idle gaps: the intervals between its busy
    intervals (``Slice.busy_intervals``, those ``idle.*`` reads)."""
    busy = run.slice.busy_intervals()
    return [(end, start) for (_, end), (start, _) in zip(busy, busy[1:])]


def idle_share(run, where: Callable[[int], bool]) -> Optional[float]:
    """Per cent of the traced slice in idle gaps whose midpoint ``where``
    accepts."""
    if run.slice is None or not run.slice.window_s:
        return None
    ns = sum(b - a for a, b in idle_gaps(run) if where((a + b) // 2))
    return 100.0 * ns * 1e-9 / run.slice.window_s
