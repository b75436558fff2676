"""The routed-expert product of a mixture-of-experts layer: hand-written Triton
kernels and their plain version.

Replaces no Pallas kernel: the JAX package has no expert layer. It serves the
``mla_moe`` decoder (``models/moe.py``): y = sum_i w_i E_i(x) over each
token's chosen experts, E(x) = W_down(silu(W_gate x) * W_up x). A decode step
at batch 256 routes 1,536 rows a layer to nearly every one of 64 experts, so
the product reads every expert's weights once a layer and is bound by those
bytes; a prefill of 40,960 tokens gives each expert thousands of rows and is
bound by operations. The design is vLLM's ``moe_align_block_size`` and
``fused_moe``:

- ``align`` sorts the (token, choice) rows by expert on the device and pads
  each expert's run to a multiple of the block of rows, with the expert of
  each block, the padded length and the rows of each expert. Every buffer's
  size follows from the shapes alone (T * k + E * (block - 1) rows, rounded
  up to a block), so nothing is read back to the host, no row is dropped,
  and the whole is capturable in a CUDA graph.
- ``moe_expert_gate_up``: for a block of sorted rows (one expert) and a tile
  of the expert's width, the gate and up products of the gathered token
  rows, and silu(gate) * up in float32, stored in the compute type at the
  rows' sorted places: each expert's weights are read once a block.
- ``moe_expert_down``: that expert's down product of those rows, times each
  row's routing weight, stored in float32 at the row's (token, choice)
  place; the sum over a token's choices follows in plain PyTorch.

Two launches a layer, in prefill and in decode alike; the telemetry counter
``moe_experts.launches`` counts them (CUDA-graph replays add theirs,
``models/graphed.py``). ``routed`` takes the plain version for CPU tensors
and the kernels for CUDA tensors, or raises ``ValueError`` for a call they
do not take: nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from texocr_tpu_torch import telemetry

_kernels = None

#: (block rows, width tile, depth tile, warps, stages) of each launch: few
#: rows an expert (decode) or many (prefill).
DECODE_TILES = {"gate_up": (64, 64, 64, 4, 4), "down": (64, 64, 64, 4, 4)}
PREFILL_TILES = {"gate_up": (128, 64, 64, 8, 3), "down": (128, 128, 64, 8, 3)}
#: Mean rows an expert above which the prefill tiles are taken.
PREFILL_ROWS = 128


def tiles(rows: int, experts: int) -> dict:
    """The launch tiles for ``rows`` routed rows over ``experts``."""
    return PREFILL_TILES if rows > PREFILL_ROWS * experts else DECODE_TILES


def align(topk_ids: torch.Tensor, n_experts: int, block: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, k) expert choices -> (sorted_ids (P,) int32, the flat (token,
    choice) index of each sorted row, T * k in padding; block_experts
    (P / block,) int32, each block's expert; padded (1,) int32, the rows up
    to the last expert's padded run; counts (E,) int64, the rows of each
    expert). P = T * k + E * (block - 1) rounded up to ``block``. Rows of one
    expert keep their flat order. All on ``topk_ids``' device, with no read
    back to the host."""
    flat = topk_ids.reshape(-1)
    n = flat.numel()
    device = flat.device
    counts = torch.zeros(n_experts, dtype=torch.int64, device=device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    padded_counts = (counts + (block - 1)) // block * block
    ends = padded_counts.cumsum(0)
    order = torch.sort(flat, stable=True).indices
    sorted_e = flat[order]
    first = counts.cumsum(0) - counts
    dest = (ends - padded_counts)[sorted_e] + torch.arange(n, device=device) - first[sorted_e]
    size = -(-(n + n_experts * (block - 1)) // block) * block
    sorted_ids = torch.full((size,), n, dtype=torch.int32, device=device)
    sorted_ids.scatter_(0, dest, order.to(torch.int32))
    starts = torch.arange(0, size, block, device=device)
    block_experts = torch.searchsorted(ends, starts, right=True).clamp_max_(n_experts - 1)
    return sorted_ids, block_experts.to(torch.int32), ends[-1:].to(torch.int32), counts


def routed_plain(x: torch.Tensor, topk_ids: torch.Tensor, topk_weights: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 block: int = DECODE_TILES["down"][0]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' arithmetic in PyTorch: the rows aligned as ``align``
    gives them, each block's products in float32 with its one expert's
    weights, silu(gate) * up rounded to x's type, the down product times
    the routing weight in float32, summed over each token's choices.
    x: (T, H); topk_ids, topk_weights: (T, k); w_gate, w_up: (E, I, H);
    w_down: (E, H, I). Returns ((T, H) float32, counts (E,))."""
    t, k = topk_ids.shape
    n = t * k
    sorted_ids, block_experts, _, counts = align(topk_ids, w_gate.shape[0], block)
    ids = sorted_ids.long()
    valid = ids < n
    rows = torch.where(valid, ids // k, 0)
    a = (x[rows] * valid[:, None]).float().view(-1, block, x.shape[1])
    e = block_experts.long()
    gate = torch.bmm(a, w_gate[e].float().transpose(1, 2))
    up = torch.bmm(a, w_up[e].float().transpose(1, 2))
    h = (F.silu(gate) * up).to(x.dtype)
    y = torch.bmm(h.float(), w_down[e].float().transpose(1, 2)).reshape(-1, x.shape[1])
    y = y * topk_weights.reshape(-1).float()[ids.clamp_max(n - 1)][:, None]
    out = torch.zeros(n, x.shape[1], dtype=torch.float32, device=x.device)
    out[ids[valid]] = y[valid]
    return out.view(t, k, -1).sum(1), counts


def _build():
    """The two Triton kernels, compiled at their first launch."""
    global _kernels
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def moe_expert_gate_up(x_ptr, wg_ptr, wu_ptr, h_ptr, sorted_ptr, experts_ptr, padded_ptr,
                           n_valid, top_k, N, K, stride_x, stride_we, stride_wn, stride_h,
                           BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
        pid = tl.program_id(0)
        n_tiles = tl.cdiv(N, BN)
        pid_m = pid // n_tiles
        pid_n = pid % n_tiles
        if pid_m * BM >= tl.load(padded_ptr):
            return
        rows = pid_m * BM + tl.arange(0, BM)
        ids = tl.load(sorted_ptr + rows)
        valid = ids < n_valid
        tok = (ids // top_k).to(tl.int64)
        e = tl.load(experts_ptr + pid_m).to(tl.int64)
        cols = pid_n * BN + tl.arange(0, BN)
        ks = tl.arange(0, BK)
        col_ok = cols[None, :] < N
        a_ptrs = x_ptr + tok[:, None] * stride_x + ks[None, :]
        w_off = e * stride_we + cols[None, :].to(tl.int64) * stride_wn + ks[:, None]
        g_ptrs = wg_ptr + w_off
        u_ptrs = wu_ptr + w_off
        acc_g = tl.zeros((BM, BN), dtype=tl.float32)
        acc_u = tl.zeros((BM, BN), dtype=tl.float32)
        for k0 in range(0, K, BK):
            k_ok = ks < K - k0
            a = tl.load(a_ptrs, mask=valid[:, None] & k_ok[None, :], other=0.0)
            g = tl.load(g_ptrs, mask=k_ok[:, None] & col_ok, other=0.0)
            u = tl.load(u_ptrs, mask=k_ok[:, None] & col_ok, other=0.0)
            acc_g = tl.dot(a, g, acc_g)
            acc_u = tl.dot(a, u, acc_u)
            a_ptrs += BK
            g_ptrs += BK
            u_ptrs += BK
        h = acc_g * tl.sigmoid(acc_g) * acc_u
        h_ptrs = h_ptr + rows[:, None].to(tl.int64) * stride_h + cols[None, :]
        tl.store(h_ptrs, h.to(h_ptr.dtype.element_ty), mask=valid[:, None] & col_ok)

    @triton.jit
    def moe_expert_down(h_ptr, wd_ptr, out_ptr, tw_ptr, sorted_ptr, experts_ptr, padded_ptr,
                        n_valid, N, K, stride_h, stride_we, stride_wn, stride_out,
                        BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
        pid = tl.program_id(0)
        n_tiles = tl.cdiv(N, BN)
        pid_m = pid // n_tiles
        pid_n = pid % n_tiles
        if pid_m * BM >= tl.load(padded_ptr):
            return
        rows = pid_m * BM + tl.arange(0, BM)
        ids = tl.load(sorted_ptr + rows)
        valid = ids < n_valid
        e = tl.load(experts_ptr + pid_m).to(tl.int64)
        cols = pid_n * BN + tl.arange(0, BN)
        ks = tl.arange(0, BK)
        col_ok = cols[None, :] < N
        a_ptrs = h_ptr + rows[:, None].to(tl.int64) * stride_h + ks[None, :]
        w_ptrs = wd_ptr + e * stride_we + cols[None, :].to(tl.int64) * stride_wn + ks[:, None]
        acc = tl.zeros((BM, BN), dtype=tl.float32)
        for k0 in range(0, K, BK):
            k_ok = ks < K - k0
            a = tl.load(a_ptrs, mask=valid[:, None] & k_ok[None, :], other=0.0)
            w = tl.load(w_ptrs, mask=k_ok[:, None] & col_ok, other=0.0)
            acc = tl.dot(a, w, acc)
            a_ptrs += BK
            w_ptrs += BK
        acc = acc * tl.load(tw_ptr + ids, mask=valid, other=0.0)[:, None]
        out_ptrs = out_ptr + ids[:, None].to(tl.int64) * stride_out + cols[None, :]
        tl.store(out_ptrs, acc, mask=valid[:, None] & col_ok)

    _kernels = (triton, moe_expert_gate_up, moe_expert_down)
    return _kernels


def _check(x, topk_ids, topk_weights, w_gate, w_up, w_down) -> None:
    """Raises ``ValueError`` for a CUDA call the kernels do not take."""
    t, hidden = x.shape
    e, inter, h2 = w_gate.shape
    tensors = (x, topk_ids, topk_weights, w_gate, w_up, w_down)
    if any(a.device != x.device for a in tensors):
        raise ValueError("the routed-expert kernels take tensors of one device")
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in (w_gate, w_up, w_down)):
        raise ValueError(f"the routed-expert kernels take bfloat16 rows and weights, got "
                         f"{x.dtype} and {w_gate.dtype}")
    if (h2 != hidden or w_up.shape != w_gate.shape or w_down.shape != (e, hidden, inter)
            or topk_ids.shape != topk_weights.shape or topk_ids.shape[0] != t):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, gate {tuple(w_gate.shape)},"
                         f" up {tuple(w_up.shape)}, down {tuple(w_down.shape)}, choices "
                         f"{tuple(topk_ids.shape)} and {tuple(topk_weights.shape)}")
    if topk_weights.dtype != torch.float32 or topk_ids.dtype != torch.int64:
        raise ValueError("choices are int64 and their weights float32")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("the routed-expert kernels take contiguous tensors")


def routed(x: torch.Tensor, topk_ids: torch.Tensor, topk_weights: torch.Tensor,
           w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum_i w_i E_i(x) over each token's choices: ((T, H) float32, the rows
    of each expert (E,) int64). The plain version for CPU tensors; for CUDA
    tensors the two kernels, after ``_check``."""
    t, k = topk_ids.shape
    n_experts = w_gate.shape[0]
    tile = tiles(t * k, n_experts)
    if x.device.type != "cuda":
        return routed_plain(x, topk_ids, topk_weights, w_gate, w_up, w_down,
                            block=tile["down"][0])
    _check(x, topk_ids, topk_weights, w_gate, w_up, w_down)
    aligned = align(topk_ids, n_experts, tile["gate_up"][0])
    out = launch(x, topk_weights, w_gate, w_up, w_down, aligned, tile)
    return out.view(t, k, -1).sum(1), aligned[3]


def launch(x: torch.Tensor, topk_weights: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor, w_down: torch.Tensor, aligned: tuple, tile: dict) -> torch.Tensor:
    """The two kernels over rows ``align`` sorted: each (token, choice) row's
    weighted expert output, (T * k, D) float32."""
    triton, gate_up, down = _build()
    t, k = topk_weights.shape
    inter, hidden = w_gate.shape[1], x.shape[1]
    bm, bn, bk, warps, stages = tile["gate_up"]
    if tile["down"][0] != bm:
        raise ValueError("both launches align rows to one block")
    sorted_ids, block_experts, padded, _ = aligned
    h = torch.empty(sorted_ids.shape[0], inter, dtype=x.dtype, device=x.device)
    blocks = block_experts.shape[0]
    gate_up[(blocks * triton.cdiv(inter, bn),)](
        x, w_gate, w_up, h, sorted_ids, block_experts, padded, t * k, k, inter, hidden,
        x.stride(0), w_gate.stride(0), w_gate.stride(1), h.stride(0),
        BM=bm, BN=bn, BK=bk, num_warps=warps, num_stages=stages)
    out = torch.empty(t * k, hidden, dtype=torch.float32, device=x.device)
    _, bn, bk, warps, stages = tile["down"]
    down[(blocks * triton.cdiv(hidden, bn),)](
        h, w_down, out, topk_weights, sorted_ids, block_experts, padded, t * k, hidden, inter,
        h.stride(0), w_down.stride(0), w_down.stride(1), out.stride(0),
        BM=bm, BN=bn, BK=bk, num_warps=warps, num_stages=stages)
    telemetry.count("moe_experts.launches", 2)
    return out
