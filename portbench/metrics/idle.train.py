"""Share of the traced steps (the largest bucket's, after the window) in
which no operation ran on the device."""


def read(run):
    return run.slice.idle_percent() if run.slice is not None else None
