"""Share of the traced slice in which no operation ran on the device."""


def read(run):
    return run.slice.idle_percent() if run.slice is not None else None
