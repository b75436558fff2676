"""The tokenizer's pre-split pattern in the standard library's ``re``.

``SPLIT_PATTERN`` is the GPT-4-style pattern that the JAX package compiles
with the ``regex`` module; it is kept here for reference only. ``split_re()``
compiles the same pattern for ``re`` (Python 3.11 and later: possessive
quantifiers): ``\\p{L}`` and ``\\p{N}`` become character classes of the code
points whose ``unicodedata`` category starts with L or N, collected once over
0..0x10FFFF at the first call, and ``\\s`` the Unicode White_Space property,
which is what ``regex`` matches (``re``'s ``\\s`` also takes U+001C..U+001F).

The two agree on every code point that the running Python's ``unicodedata``
assigns (Unicode 15.0.0 in Python 3.12). They differ on code points that a
later Unicode assigns as letters or numbers and that a newer ``regex`` knows.
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata

SPLIT_PATTERN = (
    r"""'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+| ?\p{N}{1,3}|"""
    r""" ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"""
)

# Unicode's White_Space property: the same list in every Unicode version.
_WHITE_SPACE = r"\t\n\x0b\x0c\r\x20\x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


def _ranges(major: str) -> str:
    """The code points whose general category starts with ``major``, as the
    body of a character class: ``\\Uxxxxxxxx`` ranges."""
    out, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp))[0] == major:
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            out.append(f"\\U{start:08x}-\\U{prev:08x}")
            start = None
    if start is not None:
        out.append(f"\\U{start:08x}-\\U{prev:08x}")
    return "".join(out)


@functools.cache
def split_re() -> re.Pattern:
    """``SPLIT_PATTERN`` compiled for ``re`` (built at the first call)."""
    letters, numbers, space = _ranges("L"), _ranges("N"), _WHITE_SPACE
    return re.compile(
        rf"'(?i:[sdmt]|ll|ve|re)|[^\r\n{letters}{numbers}]?+[{letters}]+| ?[{numbers}]{{1,3}}|"
        rf" ?[^{space}{letters}{numbers}]++[\r\n]*|[{space}]*[\r\n]|[{space}]+(?![^{space}])"
        rf"|[{space}]+"
    )
