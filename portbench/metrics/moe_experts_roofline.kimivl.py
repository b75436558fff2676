"""The routed-expert kernels' share of their roofline in the traced batch:
their least time (``portbench/roofline_kimivl.py``: each launch's bytes at
3.35 TB/s or operations at 989 TFLOP/s, whichever is longer, for the
prefill and every step, counted from the configuration, the mix and the
batch's ``moe.expert_launches``) over the device time of the kernels whose name
starts ``moe_expert``. Nothing unless they number 2 x expert layers x
(1 + steps)."""

from portbench import roofline_kimivl
from portbench.reference.kimivl import Arch


def read(run):
    steps, launched = run.counters.get("decode_steps"), run.counters.get("traced_launches")
    if run.slice is None or not steps or launched is None:
        return None
    arch = Arch.from_config(run.model_config)
    kernels = [k for k in run.slice.kernels("moe_expert") if k[0].startswith("moe_expert")]
    if not kernels or len(kernels) != 2 * arch.moe_layers * (1 + steps):
        return None
    mix = run.cell.mix
    least_ms = roofline_kimivl.batch_ms(arch, mix["batch"], arch.prefix(*mix["canvas"]), steps,
                                        [sum(layer) for layer in launched])
    return 100.0 * least_ms / (sum(b - a for _, a, b in kernels) * 1e-6)
