"""Median host time of an engine call (encode, decode, tokens to the host)
in the window, the calls of the profiled slice left out."""

import statistics


def read(run):
    calls = run.counters.get("call_s")
    return statistics.median(calls) if calls else None
