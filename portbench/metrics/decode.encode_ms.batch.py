"""Device milliseconds of the traced batch's encode (its ``decode.encode``
span: the encode graph's replay, from one CUDA event to the next)."""

from portbench import spans


def read(run):
    ms = spans.device_ms("decode.encode")
    return None if ms is None else sum(ms)
