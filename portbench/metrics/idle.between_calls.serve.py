"""Per cent of the traced slice in idle gaps (those of ``idle.serve``)
whose midpoint lies in no ``engine.call`` span: the batcher between two
engine calls (the drain window, the tokens' copy, ``postprocess``)."""

from portbench import spans


def read(run):
    calls = spans.host(run, "engine.call")
    if calls is None:
        return None
    in_call = spans.inside(calls)
    return spans.idle_share(run, lambda t: not in_call(t))
