"""Model FLOPs of the window's work (portbench/flops.py) per second of the
window, as a share of one H100's dense bfloat16 peak. A traced run profiles
only after its window closes, so the window is the untraced one."""

from portbench.roofline import H100_BF16_FLOPS


def read(run):
    flops, window = run.counters.get("model_flops"), run.counters.get("window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / window / H100_BF16_FLOPS
