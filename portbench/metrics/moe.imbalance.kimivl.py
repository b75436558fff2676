"""How unevenly the router spreads the window's rows: the largest over the
expert layers of (the busiest expert's rows / the mean expert's rows), from
the program's device counter ``moe.expert_rows`` over the window."""


def read(run):
    rows = run.counters.get("expert_rows")
    if not rows:
        return None
    return max(max(layer) * len(layer) / sum(layer) for layer in rows if sum(layer))
