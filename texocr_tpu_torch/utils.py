"""Helpers: LaTeX post-processing, the sampler's top-k filter, TF-SAME
padding math, and the reference's public helpers ``max_negative_val``,
``count_parameters``, ``alphabetize_config``, ``center_pad_image`` and
``exact_match``."""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple, Union

import numpy as np
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


def max_negative_val(dtype: torch.dtype) -> float:
    """The most negative finite value of a floating ``dtype``."""
    return -float(torch.finfo(dtype).max)


def get_padding(kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """Static symmetric padding of a conv layer."""
    return ((stride - 1) + dilation * (kernel_size - 1)) // 2


def get_same_padding(x: int, k: int, s: int, d: int = 1) -> int:
    """Total TF-SAME padding of one spatial dim of size ``x`` for kernel
    ``k``, stride ``s`` and dilation ``d``."""
    return max((math.ceil(x / s) - 1) * s + (k - 1) * d + 1 - x, 0)


def is_static_pad(kernel_size: int, stride: int = 1, dilation: int = 1) -> bool:
    """Whether TF-SAME padding is the same for every input size."""
    return stride == 1 and (dilation * (kernel_size - 1)) % 2 == 0


def same_pad_lo_hi(x: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """(lo, hi) TF-SAME padding of one spatial dim: lo = total // 2, hi = the
    rest."""
    total = get_same_padding(x, k, s, d)
    return total // 2, total - total // 2


def pad_to_multiple(x: int, multiple: int) -> int:
    """Round ``x`` up to the next multiple (the render-time canvas rule: height
    to 16k, width to 64k)."""
    return ((x + multiple - 1) // multiple) * multiple


def exact_match(pred: List[int], target: List[int]) -> bool:
    """Whether two token id sequences are equal."""
    return list(pred) == list(target)


def count_parameters(params: Union[torch.nn.Module, Dict[str, torch.Tensor]]) -> int:
    """Total element count of a module's parameters (each shared parameter
    once) or of a state dict's tensors (every key)."""
    tensors = params.parameters() if isinstance(params, torch.nn.Module) else params.values()
    return sum(t.numel() for t in tensors)


def alphabetize_config(config: dict, path: str = "config.yml") -> dict:
    """``config`` sorted by key, and written to ``path`` as YAML. Needs
    PyYAML (the 'yaml' package)."""
    try:
        import yaml
    except ImportError:
        raise ImportError(f"writing the YAML config {path} needs PyYAML (the 'yaml' "
                          "package)") from None
    config = dict(sorted(config.items()))
    with open(path, "w") as f:
        yaml.dump(config, f)
    return config


def center_pad_image(img: np.ndarray, height: int, width: int, fill: float = 0.0) -> np.ndarray:
    """An (H, W[, C]) array padded with ``fill`` to (height, width), centred
    (the odd pixel at the bottom and the right): the reference's
    ImagePadding transform."""
    pad_h, pad_w = height - img.shape[0], width - img.shape[1]
    pads = ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2))
    return np.pad(img, pads + ((0, 0),) * (img.ndim - 2), constant_values=fill)
