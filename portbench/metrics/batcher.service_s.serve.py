"""Mean service time of a batcher group, from its engine call's start to
its last future set (tokens on the host, ``postprocess`` done), over the
groups served before the traced slice began (the program's counters
``batcher.service_s`` over ``batcher.groups`` as the slice's first span
found them); the inside twin of ``decode.call_s.serve``, which also times
the calls after the slice."""

from portbench import spans


def read(run):
    return spans.ratio("batcher.service_s", "batcher.groups", spans.before_profile() or {})
