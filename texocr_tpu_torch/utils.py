"""Helpers: LaTeX post-processing, the sampler's top-k filter and TF-SAME
padding math."""

from __future__ import annotations

import math
import re
from typing import Tuple

import torch


def process_output(output: str) -> str:
    """Strip whitespace from decoded LaTeX, keeping the single space a LaTeX
    command needs before an alphanumeric argument.

    '\\int _ { 0 } ^ { 1 } x ^ 2 d x' -> '\\int_{0}^{1}x^2dx'
    """
    output = re.sub(r"(\\[a-zA-Z]+)\s+([a-zA-Z0-9])", r"\1<SPACE>\2", output)
    output = re.sub(r"\s+", "", output)
    return output.replace("<SPACE>", " ")


def topk_filter_size(vocab_size: int, threshold: float = 0.9) -> int:
    """Number of logits the top-k filter keeps: ``int((1 - threshold) * V)``,
    kept as the reference computes it, float quirk included (99, not 100, for
    threshold 0.9 and V = 1000)."""
    return int((1 - threshold) * vocab_size)


def top_k_lower_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, a tie going to
    the lower index as ``lax.top_k`` breaks it (a stable descending sort;
    ``torch.topk`` promises no order among ties on CUDA)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def topk_filter(logits: torch.Tensor, threshold: float = 0.9) -> torch.Tensor:
    """``logits`` (..., V) with all but the top k set to -inf. Exactly k
    survive, ties included (``top_k_lower_index``). Raises when k <= 0
    instead of keeping nothing."""
    k = topk_filter_size(logits.shape[-1], threshold)
    if k <= 0:
        raise ValueError(
            f"top-k filter keeps 0 logits (vocab={logits.shape[-1]}, threshold={threshold})"
        )
    values, order = top_k_lower_index(logits, k)
    return torch.full_like(logits, -math.inf).scatter(-1, order, values)


def same_pad_lo_hi(x: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """(lo, hi) TF-SAME padding of one spatial dim of size ``x`` for kernel
    ``k``, stride ``s`` and dilation ``d``: lo = total // 2, hi = the rest."""
    total = max((math.ceil(x / s) - 1) * s + (k - 1) * d + 1 - x, 0)
    return total // 2, total - total // 2


def pad_to_multiple(x: int, multiple: int) -> int:
    """Round ``x`` up to the next multiple (the render-time canvas rule: height
    to 16k, width to 64k)."""
    return ((x + multiple - 1) // multiple) * multiple
