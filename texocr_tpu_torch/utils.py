"""Host-side helpers: LaTeX post-processing and TF-SAME padding math."""

from __future__ import annotations

import math
import re
from typing import Tuple


def process_output(output: str) -> str:
    """Strip whitespace from decoded LaTeX, keeping the single space a LaTeX
    command needs before an alphanumeric argument.

    '\\int _ { 0 } ^ { 1 } x ^ 2 d x' -> '\\int_{0}^{1}x^2dx'
    """
    output = re.sub(r"(\\[a-zA-Z]+)\s+([a-zA-Z0-9])", r"\1<SPACE>\2", output)
    output = re.sub(r"\s+", "", output)
    return output.replace("<SPACE>", " ")


def same_pad_lo_hi(x: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """(lo, hi) TF-SAME padding of one spatial dim of size ``x`` for kernel
    ``k``, stride ``s`` and dilation ``d``: lo = total // 2, hi = the rest."""
    total = max((math.ceil(x / s) - 1) * s + (k - 1) * d + 1 - x, 0)
    return total // 2, total - total // 2


def pad_to_multiple(x: int, multiple: int) -> int:
    """Round ``x`` up to the next multiple (the render-time canvas rule: height
    to 16k, width to 64k)."""
    return ((x + multiple - 1) // multiple) * multiple
