"""Device milliseconds a decode step in the traced batch: its
``decode.chunk`` spans' device time (each chunk graph's replay) over the
steps they ran (every step of the mix's ``max_len``: its EOS is pinned)."""

from portbench import spans


def read(run):
    ms, steps = spans.device_ms("decode.chunk"), run.counters.get("decode_steps")
    return None if ms is None or not steps else sum(ms) / steps
