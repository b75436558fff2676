"""Seconds of a graph key's eager warm-up and captures in the set-up: the
program's counters ``graphs.capture_s`` over ``graphs.keys``."""

from portbench import spans


def read(run):
    return spans.ratio("graphs.capture_s", "graphs.keys")
