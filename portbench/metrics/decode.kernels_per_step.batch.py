"""Device kernels of the batch traced after the window (its encode
included) over its decode steps: a count, which repeats exactly."""


def read(run):
    if run.slice is None or not run.counters.get("decode_steps"):
        return None
    return len(run.slice.kernels()) / run.counters["decode_steps"]
