"""The flash backward kernel's share of its roofline in the traced steps,
those of the training set's largest bucket ((160, 1008) in base.train): the
least time of the backward of every recorded forward launch over the device
time of the kernels named flash_bwd.

Each recorded launch (``run.slice.launches``: q's shape, Nk, bf16, valid keys)
is a forward that the step differentiates, and its backward does five
products of 2 * Nq * n * dh per (batch, head) (S for P, dP, dV, dQ, dK) over
the n valid keys of its row: 10 * H * Nq * n * dh operations at 989 TFLOP/s
in bfloat16, whatever a design recomputes. The bytes (q, o, dO and dq over
Nq rows, k, v, dk and dv over n, in bf16, and the float32 row statistics)
at 3.35 TB/s bound it where they take longer; at (128, 8, 631, 64) the
operations do. The kernel runs in two launches (dQ, then dK and dV), so the
flash_bwd kernels number exactly 2 a recorded launch; otherwise (a parent
without the kernel, a float32 or dh > 64 call that the math path
differentiates) nothing is read."""

from portbench.roofline import H100_BF16_FLOPS, H100_BYTES_PER_S

KERNELS_PER_LAUNCH = 2


def backward_bound_ms(q_shape, nk, kv_lens=None) -> float:
    b, h, nq, dh = q_shape
    keys = list(kv_lens) if kv_lens is not None else [nk] * b
    flops = sum(10.0 * h * nq * n * dh for n in keys)
    moved = sum(((4 * nq + 4 * n) * dh * 2 + 4 * nq) * h for n in keys)
    return max(flops / H100_BF16_FLOPS, moved / H100_BYTES_PER_S) * 1e3


def read(run):
    if run.slice is None or not run.slice.launches:
        return None
    if not all(bf16 and q[3] <= 64 for q, _, bf16, _ in run.slice.launches):
        return None
    kernels = run.slice.kernels("flash_bwd")
    if len(kernels) != KERNELS_PER_LAUNCH * len(run.slice.launches):
        return None
    bound_ms = sum(backward_bound_ms(q, nk, kv) for q, nk, _, kv in run.slice.launches)
    device_ms = sum(b - a for _, a, b in kernels) * 1e-6
    return 100.0 * bound_ms / device_ms
