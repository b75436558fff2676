"""Peaks of the chip and the least time of a kernel: the benchmark's frozen
copy, so that a change to the program cannot move what its shares divide.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit): 989 TFLOP/s bfloat16, 495 TFLOP/s TF32, 3.35 TB/s of HBM.
``attention_bound_ms`` is ``texocr_tpu_torch/ops/bench.py``'s arithmetic, with
the valid key count of each batch row taken in place of Nk where a call
passes ``kv_lens``.
"""

from __future__ import annotations

from typing import Optional, Sequence

H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
H100_BYTES_PER_S = 3.35e12


def attention_bound_ms(q_shape: Sequence[int], nk: int, bf16: bool,
                       kv_lens: Optional[Sequence[int]] = None) -> tuple:
    """(least ms, "operations" or "bytes") of one attention forward over
    (B, H, Nq, dh) queries and Nk keys: q, k, v and o each moved once at
    3.35 TB/s, against 4 * Nq * Nk * dh operations per (batch, head) on the
    tensor cores, bfloat16 at 989 TFLOP/s or float32 as three TF32 products
    at 495 TFLOP/s. ``kv_lens``: the valid keys of each batch row."""
    b, h, nq, dh = q_shape
    keys = list(kv_lens) if kv_lens is not None else [nk] * b
    flops = sum(4.0 * h * nq * n * dh for n in keys)
    t_ops = flops / H100_BF16_FLOPS * 1e3 if bf16 else 3 * flops / H100_TF32_FLOPS * 1e3
    elem = 2 if bf16 else 4
    moved = sum((2 * nq + 2 * n) * h * dh * elem for n in keys)
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
