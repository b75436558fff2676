"""Peak device memory allocated during the window (the peak statistics reset
at its start), in GB."""


def read(run):
    peak = run.counters.get("window_peak_bytes")
    return peak / 1e9 if peak else None
