"""Per cent of the traced slice in idle gaps (those of ``idle.serve``)
whose midpoint lies inside a ``decode.chunk`` or ``decode.encode`` span,
the host launching a graph replay, and in no ``decode.check`` span."""

from portbench import spans


def read(run):
    launch = spans.host(run, "decode.chunk", "decode.encode")
    if launch is None:
        return None
    in_launch, in_check = spans.inside(launch), spans.inside(spans.host(run, "decode.check") or [])
    return spans.idle_share(run, lambda t: in_launch(t) and not in_check(t))
