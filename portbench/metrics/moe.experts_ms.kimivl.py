"""Device milliseconds a decode step spends in the routed-expert kernels:
the traced batch's kernels whose name starts ``moe_expert``, in time order,
the prefill's (the first two a expert layer) left out, over the decode
steps. Nothing where no such kernel ran (a program without it), or where
they are not two a layer for the prefill and every step."""

from portbench.reference.kimivl import Arch


def read(run):
    steps = run.counters.get("decode_steps")
    if run.slice is None or not steps:
        return None
    kernels = sorted((k for k in run.slice.kernels("moe_expert") if k[0].startswith("moe_expert")),
                     key=lambda k: k[1])
    per_launch = 2 * Arch.from_config(run.model_config).moe_layers
    if not kernels or len(kernels) != per_launch * (1 + steps):
        return None
    return sum(b - a for _, a, b in kernels[per_launch:]) * 1e-6 / steps
