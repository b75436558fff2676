"""Measure the exact-match ceiling that the typeset renderer itself imposes.

The counterpart of the JAX package's ``tools/ambiguity_scan.py``. Two label
strings that typeset to the same pixels are label noise no decoder can
undo: it maps the image to one of them and misses the rest. The scan
renders each label of a split at fixed conditions (``--dpi``, default 125,
and make_demo_dataset's top-level wrap), hashes the PNG bytes matplotlib's
mathtext writes for each line, groups the labels by hash, and prints

    exact-match ceiling = sum over groups of (its most frequent label's count) / N

over label instances. ``--raw`` skips ``compact_latex`` (mathtext then drops
the script of a digit base, as the renderer did before that fix).
``--fliptest`` instead flips the first ``^``/``_`` after a digit in each
label that has one and counts the flips that render the same.

    python -m texocr_tpu_torch.tools.ambiguity_scan --labels data/test/labels.txt \\
        [--raw] [--fliptest] [--dpi 125] [--limit N] [--examples 8]

The numbers equal the JAX tool's. Where the JAX tool counts every label as
failed when matplotlib cannot be imported, this one raises ``ImportError``:
only mathtext's own parse errors (``ValueError``) count as failed labels.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import io
import json
import sys
from typing import List, Optional, Sequence

from texocr_tpu_torch.tools.make_demo_dataset import wrap_top_level


def render_hash(eq: str, dpi: int, compact: bool) -> str:
    """SHA-1 over the PNG bytes of each wrapped line of ``eq``."""
    try:
        from matplotlib import mathtext
    except ImportError as e:
        raise ImportError("the ambiguity scan renders with matplotlib's mathtext: install "
                          "matplotlib") from e
    from texocr_tpu_torch.data.factory.render_data import compact_latex

    h = hashlib.sha1()
    for line in wrap_top_level(eq, char_budget=int(88 * 125 / dpi)):
        buf = io.BytesIO()
        mathtext.math_to_image(f"${compact_latex(line) if compact else line}$", buf, dpi=dpi,
                               format="png")
        h.update(buf.getvalue())
    return h.hexdigest()


def flip_one_digit_script(tokens: Sequence[str]) -> Optional[List[str]]:
    """The tokens with the first ``^``/``_`` after a digit flipped, or None
    where there is none."""
    for i in range(1, len(tokens)):
        if tokens[i] in ("^", "_") and tokens[i - 1].isdigit():
            out = list(tokens)
            out[i] = "_" if tokens[i] == "^" else "^"
            return out
    return None


def _mode(compact: bool) -> str:
    return "compacted (fixed)" if compact else "raw (pre-fix)"


def run_fliptest(labels: Sequence[str], dpi: int, compact: bool, limit: Optional[int]) -> dict:
    """Flips each label's first digit-base script and counts the flips that
    render the same as the label (out-of-dataset neighbours the collision
    scan cannot see)."""
    tested = collisions = skipped = 0
    for eq in labels:
        flipped = flip_one_digit_script(eq.split(" "))
        if flipped is None:
            continue
        if limit and tested >= limit:
            break
        try:
            ha = render_hash(eq, dpi, compact)
            hb = render_hash(" ".join(flipped), dpi, compact)
        except ValueError:  # mathtext cannot parse it
            skipped += 1
            continue
        tested += 1
        collisions += ha == hb
        if tested % 250 == 0:
            print(f"  fliptest {tested} tested, {collisions} collisions", flush=True)
    return {"fliptest_labels": tested, "flip_renders_identical": collisions,
            "flip_collision_rate": round(collisions / max(tested, 1), 4), "failed": skipped,
            "mode": _mode(compact), "dpi": dpi}


def scan(labels: Sequence[str], dpi: int, compact: bool, examples: int = 8) -> dict:
    """Groups ``labels`` by render hash and returns the scan's numbers,
    printing up to ``examples`` colliding pairs."""
    groups = collections.defaultdict(collections.Counter)
    failed = 0
    for i, eq in enumerate(labels):
        try:
            groups[render_hash(eq, dpi, compact)][eq] += 1
        except ValueError:  # mathtext cannot parse it
            failed += 1
        if (i + 1) % 500 == 0:
            print(f"  {i + 1}/{len(labels)} rendered", flush=True)

    n = sum(sum(c.values()) for c in groups.values())
    reachable = sum(max(c.values()) for c in groups.values())
    ambiguous = [c for c in groups.values() if len(c) > 1]
    unreachable = sum(sum(c.values()) - max(c.values()) for c in ambiguous)
    for c in ambiguous[:examples]:
        a, b = list(c)[:2]
        print(f"COLLISION:\n  {a}\n  {b}")
    return {"labels": len(labels), "rendered": n, "failed": failed,
            "distinct_renders": len(groups), "ambiguous_groups": len(ambiguous),
            "unreachable_instances": unreachable,
            "exact_match_ceiling": round(reachable / max(n, 1), 4), "mode": _mode(compact),
            "dpi": dpi}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--labels", required=True, help="labels.txt of the split (a label a line)")
    p.add_argument("--dpi", type=int, default=125)
    p.add_argument("--raw", action="store_true",
                   help="skip compact_latex (the renderer before the digit-script fix)")
    p.add_argument("--fliptest", action="store_true",
                   help="flip one digit-base ^/_ per label and count identical renders "
                        "instead of the collision scan")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--examples", type=int, default=8, help="print up to N colliding pairs")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    with open(args.labels) as f:
        labels = [ln.rstrip("\n") for ln in f if ln.strip()]
    if args.fliptest:
        result = run_fliptest(labels, args.dpi, not args.raw, args.limit)
    else:
        result = scan(labels[: args.limit] if args.limit else labels, args.dpi, not args.raw,
                      args.examples)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
