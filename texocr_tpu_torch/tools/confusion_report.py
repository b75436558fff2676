"""Per-token confusion report from an evaluation's pairs dump.

Input: the JSON lines that ``test_model(..., pairs_out=...)`` writes (one line
per row: the pad-stripped ``pred`` and ``gold`` token ids), through
``python -m texocr_tpu_torch.evaluation.cli --pairs_out`` or
``python -m texocr_tpu_torch.tools.eval_full_split --pairs_out``.

Each pred/gold pair is aligned by a Levenshtein backtrace (substitution cost
1), and the edit operations are counted:

- substitutions, gold token -> predicted token, counted by pair;
- insertions and deletions, per token;
- each gold token's error rate (how often that vocabulary token is misread),
  over the tokens seen at least 100 times.

The report is the JAX package's ``tools/confusion_report.py``'s, line for
line; the ids are named by the port's tokenizer.

Usage:
  python -m texocr_tpu_torch.tools.confusion_report pairs.jsonl [--top 30] \\
      [--tokenizer texocr_tpu_torch/tokenizer/vocab/tokenizer_clean_1k.txt]
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from typing import List, Optional

from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH, RegexBPETokenizer


def align_ops(pred: List[int], gold: List[int]) -> list:
    """The edit operations of a least-cost alignment, from the ends back:
    ('sub', g, p), ('del', g) or ('ins', p); matches are left out. Ties go to
    the diagonal, then to a deletion."""
    n, m = len(gold), len(pred)
    prev = list(range(m + 1))
    back = [[0] * (m + 1) for _ in range(n + 1)]  # 0 diagonal, 1 up (del), 2 left (ins)
    back[0] = [2] * (m + 1)
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        back[i][0] = 1
        gi = gold[i - 1]
        for j in range(1, m + 1):
            c_diag = prev[j - 1] + (gi != pred[j - 1])
            c_del = prev[j] + 1
            c_ins = cur[j - 1] + 1
            best = min(c_diag, c_del, c_ins)
            cur[j] = best
            back[i][j] = 0 if best == c_diag else (1 if best == c_del else 2)
        prev = cur
    i, j, ops = n, m, []
    while i > 0 or j > 0:
        b = back[i][j]
        if i > 0 and j > 0 and b == 0:
            if gold[i - 1] != pred[j - 1]:
                ops.append(("sub", gold[i - 1], pred[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and b == 1:
            ops.append(("del", gold[i - 1]))
            i -= 1
        else:
            ops.append(("ins", pred[j - 1]))
            j -= 1
    return ops


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pairs", help="JSON lines from test_model(pairs_out=...)")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer file to name the ids (default: the shipped 1k)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    tok = RegexBPETokenizer().load(args.tokenizer or DEFAULT_VOCAB_PATH)

    def name(tid):
        try:
            return repr(tok.decode([tid]))
        except (KeyError, ValueError):
            return f"<id {tid}>"

    subs, dels, ins = Counter(), Counter(), Counter()
    gold_count = Counter()
    rows = toks = errs = 0
    with open(args.pairs) as f:
        for line in f:
            d = json.loads(line)
            pred, gold = d["pred"], d["gold"]
            rows += 1
            toks += len(gold)
            gold_count.update(gold)
            for op in align_ops(pred, gold):
                errs += 1
                if op[0] == "sub":
                    subs[(op[1], op[2])] += 1
                elif op[0] == "del":
                    dels[op[1]] += 1
                else:
                    ins[op[1]] += 1

    print(f"rows: {rows}  gold tokens: {toks}  edit errors: {errs} "
          f"({errs / max(toks, 1):.2%} of gold tokens)")
    n_sub = sum(subs.values())
    print(f"  substitutions: {n_sub}  deletions: {sum(dels.values())}  "
          f"insertions: {sum(ins.values())}")
    print(f"\ntop {args.top} substitutions (gold -> pred):")
    for (g, pr), c in subs.most_common(args.top):
        print(f"  {c:7d}  {c / max(n_sub, 1):6.2%}  {name(g)} -> {name(pr)}")
    print(f"\ntop {args.top} deletions (gold token dropped):")
    for g, c in dels.most_common(args.top):
        print(f"  {c:7d}  {name(g)}")
    print(f"\ntop {args.top} insertions (spurious pred token):")
    for pr, c in ins.most_common(args.top):
        print(f"  {c:7d}  {name(pr)}")
    print("\nper-token error rate (gold tokens with >=100 occurrences):")
    err_by_gold = Counter()
    for (g, _), c in subs.items():
        err_by_gold[g] += c
    for g, c in dels.items():
        err_by_gold[g] += c
    rates = [(err_by_gold[g] / gold_count[g], g) for g in gold_count if gold_count[g] >= 100]
    for rate, g in sorted(rates, reverse=True)[:args.top]:
        print(f"  {rate:6.2%}  {name(g)}  ({err_by_gold[g]}/{gold_count[g]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
