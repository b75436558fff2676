"""Per cent of the traced slice in idle gaps (those of ``idle.serve``)
whose midpoint lies inside a ``decode.check`` span: the host reading the
done flags between two chunk replays."""

from portbench import spans


def read(run):
    check = spans.host(run, "decode.check")
    return None if check is None else spans.idle_share(run, spans.inside(check))
