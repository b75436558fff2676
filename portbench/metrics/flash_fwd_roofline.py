"""The flash kernel's share of its roofline in the traced steps, those of
the training set's largest bucket ((160, 1008) in base.train): the least
time of every launch (portbench/roofline.py, from its shape and valid keys)
over the device time of the kernels named flash_fwd. Nothing when the
launches and the kernels do not pair up."""

from portbench.roofline import attention_bound_ms


def read(run):
    if run.slice is None or not run.slice.launches:
        return None
    kernels = run.slice.kernels("flash_fwd")
    if len(kernels) != len(run.slice.launches):
        return None
    bound_ms = sum(attention_bound_ms(q, nk, bf16, kv)[0] for q, nk, bf16, kv in run.slice.launches)
    device_ms = sum(b - a for _, a, b in kernels) * 1e-6
    return 100.0 * bound_ms / device_ms
