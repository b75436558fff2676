"""Requests a batch: the rows of each engine call in the window that are not
the batcher's zero filler canvases, over the calls."""


def read(run):
    fills = run.counters.get("fills")
    return sum(fills) / len(fills) if fills else None
