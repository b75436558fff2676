"""Timing helpers for the port's kernels on a CUDA device, their least times
on an H100, and the decode attention's inputs as its call sites make them.

Used by ``chip_smoke.py``, ``tools/flash_kernel_ab.py`` and the tests; the
serving path never imports this module.
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


def attention_backward_bound_ms(q, k) -> tuple:
    """Least time for one unmasked bfloat16 attention backward on an H100
    SXM, and what sets it: five products of 2 * Nq * Nk * dh per (batch,
    head) (S for P, dP, dV, dQ, dK) at 989 TFLOP/s, however many a design
    recomputes, against q, o, dO and dq (Nq rows), k, v, dk and dv (Nk rows)
    moved once in bf16 and the float32 row statistics read, at 3.35 TB/s."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    t_ops = 10.0 * b * h * nq * nk * dh / H100_BF16_FLOPS * 1e3
    t_bytes = ((4 * nq + 4 * nk) * dh * 2 + 4 * nq) * b * h / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


#: How far the backward kernel's bf16 gradients may lie from the float32
#: VJP of the same bf16 operands (each gradient's largest gap over its
#: largest |value|): at most BACKWARD_FACTOR times as far as the plain bf16
#: VJP's, or BACKWARD_FLOOR. The two round in different places: the kernel
#: rounds dS = P o (dP - D) to bf16 as the operand of dQ and dK, the plain
#: version rounds dP to bf16 (the cast of its probabilities back to float32);
#: both round P for dV and the gradients themselves to bf16. The floor is two
#: bf16 units of roundoff (u = 2^-8 each): one from the rounded operand (dS,
#: or P for dV), one from the gradient's own rounding.
BACKWARD_FACTOR = 2.0
BACKWARD_FLOOR = 2 ** -7


def backward_gaps(got, plain, ref) -> dict:
    """The backward kernel's (dq, dk, dv) ``got`` and the plain bf16 version's
    ``plain`` against the float32 VJP ``ref``, under the limits above: per
    gradient the kernel's and the plain version's gap (largest |difference|
    over largest |ref|), the kernel's gap from the plain version's, its
    limit, and ``ok``."""
    def gap(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))

    out, ok = {}, True
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        kernel, base = gap(g, r), gap(p, r)
        limit = max(BACKWARD_FACTOR * base, BACKWARD_FLOOR)
        good = bool(torch.isfinite(g.float()).all()) and kernel <= limit
        out[name] = {"kernel": kernel, "plain": base, "kernel_vs_plain": gap(g, p),
                     "limit": limit, "ok": good}
        ok = ok and good
    out["ok"] = ok
    return out


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


def decode_cross_inputs(gen, b, nk, beam=1, int8=False, dtype=torch.bfloat16, mask=False,
                        heads=8, dh=64):
    """A cross-attention decode call as ``attend_cached_kv`` makes it, on
    ``gen``'s device: q
    (B, H, beam, dh), a view of (B, beam, H, dh); K/V the (B, H, Nk, dh)
    split-head views of (B, Nk, H * dh) projections, or their int8
    quantization with (B, H, 1, dh) scales; with ``mask`` a (B, Nk) key mask,
    about 80% True, with row 0 all masked. Returns (q, kv, key_mask)."""
    from texocr_tpu_torch.models.attention import quantize_int8

    device = gen.device

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    q = randn(b, beam, heads, dh).transpose(1, 2)
    k, v = (randn(b, nk, heads * dh).view(b, nk, heads, dh).transpose(1, 2) for _ in "kv")
    if int8:
        (k8, sk), (v8, sv) = quantize_int8(k, dim=2), quantize_int8(v, dim=2)
        kv = {"k8": k8, "v8": v8, "sk": sk, "sv": sv}
    else:
        kv = {"k": k, "v": v}
    key_mask = None
    if mask:
        key_mask = torch.rand(b, nk, generator=gen, device=device) < 0.8
        key_mask[0] = False
    return q, kv, key_mask


def decode_self_inputs(gen, rows, t, t0=None, dtype=torch.bfloat16, size=None, heads=8, dh=64):
    """A self-attention decode call at position ``t`` as
    ``MultiHeadAttention.step`` makes it, on ``gen``'s device: q (rows, H, 1, dh), a view of
    (rows, 1, H * dh), and a (rows, H, size, dh) cache (size t + 8 unless
    given); with ``t0`` its int8 copy of positions [0, t0) and their scales,
    as ``chunk_start`` writes them. Returns (q, cache)."""
    from texocr_tpu_torch.models.attention import quantize_int8

    device, size = gen.device, size or t + 8

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    q = randn(rows, 1, heads * dh).view(rows, 1, heads, dh).transpose(1, 2)
    cache = {"k": randn(rows, heads, size, dh), "v": randn(rows, heads, size, dh)}
    if t0 is not None:
        for name in ("k", "v"):
            q8, s = quantize_int8(cache[name][:, :, :t0], dim=-1)
            cache[name + "8"] = torch.zeros(cache[name].shape, dtype=torch.int8, device=device)
            cache["s" + name] = torch.zeros(cache[name].shape[:3], dtype=dtype, device=device)
            cache[name + "8"][:, :, :t0] = q8
            cache["s" + name][:, :, :t0] = s[..., 0]
    return q, cache


#: The decode step's attention calls on the main path, as (kind, arguments of
#: ``decode_cross_inputs`` or ``decode_self_inputs``, whose ``rows`` and ``t``
#: ``decode_case`` passes first): the batch cells' step at 256 full canvases,
#: the served batch of 16 at both canvases, beam 5, a key mask, float32.
DECODE_CASES = {
    "cross (256, 8, 631) bf16": ("cross", dict(b=256, nk=631)),
    "cross (256, 8, 631) int8": ("cross", dict(b=256, nk=631, int8=True)),
    "self (256, 8) t 255": ("self", dict(rows=256, t=255, size=256)),
    "self (256, 8) t 255 split 224": ("self", dict(rows=256, t=255, t0=224, size=256)),
    "cross (16, 8, 631) bf16": ("cross", dict(b=16, nk=631)),
    "cross (16, 8, 631) int8": ("cross", dict(b=16, nk=631, int8=True)),
    "cross (16, 8, 129) bf16": ("cross", dict(b=16, nk=129)),
    "cross (16, 8, 129) int8": ("cross", dict(b=16, nk=129, int8=True)),
    "self (16, 8) t 349 split 320": ("self", dict(rows=16, t=349, t0=320, size=350)),
    "cross beam 5 over (8, 8, 631) bf16": ("cross", dict(b=8, nk=631, beam=5)),
    "cross beam 5 over (8, 8, 631) int8": ("cross", dict(b=8, nk=631, beam=5, int8=True)),
    "cross masked (16, 8, 631) bf16": ("cross", dict(b=16, nk=631, mask=True)),
    "cross (16, 8, 631) float32": ("cross", dict(b=16, nk=631, dtype=torch.float32)),
    "self (16, 8) t 100 split 96 float32": ("self", dict(rows=16, t=100, t0=96,
                                                         dtype=torch.float32)),
}

#: How far the kernel may lie from its plain version. The two differ only in
#: the order of their float32 sums (the dot products, the softmax's sum and
#: P V), so a rounding to bf16 can land one ulp either side: at most
#: DECODE_SHARE of the bf16 outputs lie more than one ulp from the plain
#: version's, and each lies within DECODE_ROW_GAP of its query row's largest
#: |output|, which is one to two bf16 ulps of that output (one at the bottom
#: of its binade, two at the top): an output near zero lies many of its own
#: ulps away when one rounding of P goes the other way. float32 outputs agree
#: within DECODE_F32_TOL (absolute, on outputs of unit scale).
DECODE_SHARE = 1e-3
DECODE_ROW_GAP = 2 ** -7
DECODE_F32_TOL = 2e-6


def decode_case(gen, kind, args, scale):
    """One call of a ``DECODE_CASES`` entry on ``gen``'s device. Returns q,
    the wrapper's record of the call, the kernel and the plain version as
    callables of no arguments, and the keys and values in the compute type
    for a library attention (None for int8 caches)."""
    from texocr_tpu_torch.ops import decode_attention as da

    if kind == "cross":
        q, kv, mask = decode_cross_inputs(gen, **args)
        keys = None if "k8" in kv else (kv["k"], kv["v"])
        return (q, da.cross_call(q, kv, mask),
                lambda: da.cross_attention(q, kv, scale=scale, key_mask=mask),
                lambda: da.cross_attention_plain(q, kv, scale=scale, key_mask=mask), keys)
    args = dict(args)
    rows, t = args.pop("rows"), args.pop("t")
    q, cache = decode_self_inputs(gen, rows, t, **args)
    t0 = args.get("t0") or 0
    keys = None if "k8" in cache else (cache["k"][:, :, :t + 1], cache["v"][:, :, :t + 1])
    return (q, da.self_call(q, cache, t, t0),
            lambda: da.self_attention(q, cache, t, t0, scale=scale),
            lambda: da.self_attention_plain(q, cache, t, t0, scale=scale), keys)


def decode_gaps(got, want) -> dict:
    """The kernel's output against the plain version's under the limits
    above: the readings, and ``ok``."""
    finite = bool(torch.isfinite(got.float()).all())
    if got.dtype == torch.float32:
        err = float((got - want).abs().max())
        return {"max_abs_err": err, "ok": finite and err <= DECODE_F32_TOL}
    gaps = bf16_gaps(got, want)
    gaps["ok"] = (finite and gaps["share_over_1_ulp"] <= DECODE_SHARE
                  and gaps["max_row_gap"] <= DECODE_ROW_GAP)
    return gaps


def bf16_ulps(a, b) -> torch.Tensor:
    """How many bf16 units in the last place lie between a and b (tensors of
    bf16 values), element by element."""
    def ordered(x):
        i = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def bf16_gaps(got, want) -> dict:
    """How far the kernel's bf16 decode attention output lies from the plain
    version's: the share of elements more than one bf16 ulp apart, and the
    largest gap as a share of the largest |output| of its query row (an
    output near zero lies many of its own ulps away when a single rounding
    of P goes the other way), and that gap in bf16 ulps of the row's largest
    |output|."""
    row_max = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    gap = (got.float() - want.float()).abs()
    row_ulp = torch.ldexp(torch.ones_like(row_max), torch.frexp(row_max).exponent - 8)
    return {"share_over_1_ulp": float((bf16_ulps(got, want) > 1).float().mean()),
            "max_row_gap": float((gap / row_max).max()),
            "max_row_gap_ulps": float((gap / row_ulp).max())}


def moe_bound_ms(tokens, touched, inter, hidden, k) -> tuple:
    """(least ms, "bytes" or "operations") of one expert layer's two launches
    (``ops.moe_experts.launch``) on an H100 SXM, over ``tokens`` tokens that
    each choose ``k`` experts of width ``inter`` over ``hidden``, ``touched``
    experts receiving rows: the tokens in, the touched experts' three weight
    matrices, the (token, choice) rows' intermediate out and in, their
    float32 outputs and routing weights, moved once at 3.35 TB/s, against
    2 x rows x 3 x hidden x inter operations at 989 TFLOP/s."""
    rows = tokens * k
    moved = (tokens * hidden * 2 + touched * 3 * inter * hidden * 2 + 2 * rows * inter * 2
             + rows * hidden * 4 + rows * 4)
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * rows * 3 * hidden * inter / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_attention_bound_ms(q, call) -> float:
    """Least time of one decode attention call on an H100 SXM: its bytes at
    3.35 TB/s (the work is far below the tensor cores' operations per byte).
    Counted once each: q and the output, the keys' and values' rows it reads
    in their stored types (``call`` from ``ops.decode_attention.cross_call``
    or ``self_call``), their int8 scales and the key mask."""
    b, h, rows, dh = q.shape
    elem = q.element_size()
    n, n8 = call["n"], call["n8"]
    moved = 2 * b * h * rows * dh * elem  # q and the output
    if "k" in call:
        moved += 2 * b * h * (n - n8) * dh * elem
    if "k8" in call:
        from texocr_tpu_torch.ops.decode_attention import SPLIT

        moved += 2 * b * h * n8 * dh
        moved += 2 * b * h * (n8 if call["mode"] == SPLIT else dh) * elem  # sk and sv
    if "mask" in call:
        moved += b * n
    return moved / H100_BYTES_PER_S * 1e3
