"""Device milliseconds a traced step spends in ``train.optimizer``
(the gradient all-reduce and the optimizer's step): the spans' device time over their count."""

from portbench import spans


def read(run):
    ms = spans.device_ms("train.optimizer")
    return None if ms is None else sum(ms) / len(ms)
