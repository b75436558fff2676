"""Requests an engine call, over the groups served before the traced slice
began (the program's counters ``batcher.rows`` over ``batcher.groups`` as
the slice's first span found them); the inside twin of
``batcher.fill.serve``, which the harness counts over every call of the
run, the backlog after the slice's stop included."""

from portbench import spans


def read(run):
    return spans.ratio("batcher.rows", "batcher.groups", spans.before_profile() or {})
