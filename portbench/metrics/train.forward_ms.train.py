"""Device milliseconds a traced step spends in ``train.forward``
(the batch's gather, the forward and the loss): the spans' device time over their count."""

from portbench import spans


def read(run):
    ms = spans.device_ms("train.forward")
    return None if ms is None else sum(ms) / len(ms)
