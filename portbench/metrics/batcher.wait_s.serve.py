"""Mean wait of a request in the batcher, from ``submit`` to the start of
its group's engine call, over the groups served before the traced slice
began (the program's counters ``batcher.wait_s`` over ``batcher.rows`` as
the slice's first span found them): the untraced part of the run, before
the backlog the slice's stop leaves."""

from portbench import spans


def read(run):
    return spans.ratio("batcher.wait_s", "batcher.rows", spans.before_profile() or {})
