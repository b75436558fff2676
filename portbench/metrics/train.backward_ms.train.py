"""Device milliseconds a traced step spends in ``train.backward``
(``loss.backward()``): the spans' device time over their count."""

from portbench import spans


def read(run):
    ms = spans.device_ms("train.backward")
    return None if ms is None else sum(ms) / len(ms)
