"""The least time of the routed-expert kernels (``moe_expert*``), for
``moe_experts_roofline.kimivl``: for each launch the larger of its bytes at
3.35 TB/s and its operations at 989 TFLOP/s (``portbench/roofline.py``'s
peaks), counted from the configuration and the rows routed.

Two launches a layer, each counted for what it needs once:

- gate and up: the token rows in (D bf16 values each), the gate and up
  weights of every expert with rows, the (token, choice) rows' silu(gate) *
  up out (I each); 2 x rows x D x 2I operations;
- down: those rows in, the down weights of every expert with rows, the rows'
  weighted outputs out (D float32 each) and their weights in (one float32
  each); 2 x rows x I x D operations.

The experts with rows come from the program's device counter
``moe.expert_launches`` over the traced batch: per layer, the launches in
which each expert had rows, summed over the experts. The prefill's launch
is bound by its operations whatever experts it touched (at most E); the
steps share the rest, E taken off for the prefill, evenly: a per-launch
bound is convex in the experts it touches, so the even share gives a least
time no longer than the launches' own.
"""

from __future__ import annotations

from typing import Sequence

from portbench.reference.kimivl import Arch
from portbench.roofline import H100_BF16_FLOPS, H100_BYTES_PER_S

BF16, F32 = 2, 4


def launch_ms(arch: Arch, tokens: int, experts: int) -> float:
    """The least ms of one layer's two launches over ``tokens`` tokens, with
    ``experts`` experts holding rows."""
    c = arch.lm
    d, i, k = c["hidden_size"], c["moe_intermediate_size"], c["num_experts_per_tok"]
    rows = tokens * k
    gate_up_bytes = tokens * d * BF16 + experts * 2 * i * d * BF16 + rows * i * BF16
    down_bytes = rows * i * BF16 + experts * d * i * BF16 + rows * d * F32 + rows * F32
    total = 0.0
    for moved, ops in ((gate_up_bytes, 2.0 * rows * d * 2 * i), (down_bytes, 2.0 * rows * i * d)):
        total += max(moved / H100_BYTES_PER_S, ops / H100_BF16_FLOPS)
    return total * 1e3


def batch_ms(arch: Arch, batch: int, prefix: int, steps: int,
             expert_launches: Sequence[int]) -> float:
    """The least ms of a batch's launches: the prefill's (``batch`` x
    ``prefix`` tokens) and each step's (``batch`` tokens), in every expert
    layer, given each layer's launches-with-rows summed over its experts."""
    experts = arch.lm["n_routed_experts"]
    return sum(launch_ms(arch, batch * prefix, experts)
               + steps * launch_ms(arch, batch, max(0, n - experts) / steps)
               for n in expert_launches)
