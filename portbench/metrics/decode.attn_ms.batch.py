"""Device milliseconds a decode step spends in the decode-attention kernel:
the device time of the traced batch's kernels whose name contains
``decode_attention``, over its decode steps. Nothing where no such kernel
ran (a program without it)."""


def read(run):
    steps = run.counters.get("decode_steps")
    if run.slice is None or not steps:
        return None
    kernels = run.slice.kernels("decode_attention")
    if not kernels:
        return None
    return sum(b - a for _, a, b in kernels) * 1e-6 / steps
