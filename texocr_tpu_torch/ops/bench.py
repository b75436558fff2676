"""Timing helpers for the port's kernels on a CUDA device.

Used by ``chip_smoke.py`` and ``tools/flash_kernel_ab.py``; the serving path
never imports this module.
"""

from __future__ import annotations

import torch

# (B, H, N, dh) of the encoder's self-attention on the serving path: a batch of
# 8 full (160, 1008) canvases, then single requests at the three buckets.
SERVING_SHAPES = [(8, 8, 631, 64), (1, 8, 631, 64), (1, 8, 193, 64), (1, 8, 17, 64)]
L2_FLUSH_BYTES = 128 << 20  # written between launches for L2-cold timings (L2: 50 MB)

# H100 SXM data sheet: dense tensor-core peaks and memory rate.
H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
H100_BYTES_PER_S = 3.35e12


def attention_bound_ms(q, k) -> tuple:
    """Least time for one unmasked attention call on an H100 SXM, and what
    sets it: q, k, v and o each moved once at 3.35 TB/s, against
    4 * Nq * Nk * dh operations per (batch, head) on the tensor cores,
    bfloat16 at 989 TFLOP/s or float32 as three TF32 products (3xTF32) at
    495 TFLOP/s."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    flops = 4.0 * b * h * nq * nk * dh
    if q.dtype == torch.bfloat16:
        t_ops = flops / H100_BF16_FLOPS * 1e3
    else:
        t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
    t_bytes = (2 * nq + 2 * nk) * b * h * dh * q.element_size() / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_f64(q, k, v, scale) -> torch.Tensor:
    """Unmasked attention in float64: the yardstick of the float32 kernel's
    and the plain float32 version's errors."""
    q, k, v = (t.double() for t in (q, k, v))
    return torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1) @ v


def device_kernel_names(fn) -> list:
    """Names of the device kernels one call of ``fn`` runs (torch.profiler):
    which backend a library call took."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def split_heads(gen, b, h, n, dh, dtype):
    """(B, H, N, dh) views of a (B, N, H * dh) tensor, as the encoder hands
    q, k and v to the kernel: strides (N * H * dh, dh, H * dh, 1)."""
    return (torch.randn(b, n, h * dh, device="cuda", generator=gen).to(dtype)
            .view(b, n, h, dh).transpose(1, 2))


def time_ms(fn, iters=30, cold=False, capture_error_mode="global") -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed between two CUDA events, so the host's launch cost (tens
    of microseconds per call through Python) stays out of the number. Warm:
    the calls run back to back and the inputs stay L2-resident. Cold: each
    call follows a write of a buffer larger than the L2 cache, and a graph of
    the writes alone is timed too and subtracted. ``capture_error_mode`` is
    ``torch.cuda.graph``'s: the default fails a call that makes a host-side
    CUDA call the capture does not allow."""
    fn()  # first call outside the capture: builds, allocates, sets attributes
    torch.cuda.synchronize()

    def replay_ms(body) -> float:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode=capture_error_mode):
            for _ in range(iters):
                body()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    if not cold:
        return replay_ms(fn)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.fill_(1)
        fn()

    return replay_ms(flushed) - replay_ms(lambda: flush.fill_(1))
