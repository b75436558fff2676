"""Resumable evaluation of a whole test split.

Runs ``python -m texocr_tpu_torch.evaluation.cli`` with ``--metrics_out``
(one JSON line per finished batch). When the process dies, it starts it
again with ``--skip_batches`` set to the number of lines written so far: the
loader's order is fixed for a fixed config seed, so the rerun continues at
the next batch. Restarts are bounded: ``--max_retries`` restarts in a row
that write no new line end the run. At the end it prints the row-weighted
means of every recorded batch as one ``FINAL`` JSON line, as the JAX
package's ``tools/eval_full_split.py`` does.

Usage:
  python -m texocr_tpu_torch.tools.eval_full_split -d data --config cfg.json \\
      --checkpoint ckpts/checkpoint_e39 --decode beam --max_len 475 \\
      --metrics_out beam_metrics.jsonl [--pairs_out pairs.jsonl] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional


def n_done(path: str) -> int:
    """The batches recorded in ``path`` (its non-empty lines)."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def aggregate(path: str) -> dict:
    """The row-weighted means of every batch recorded in ``path``."""
    rows, acc, em, sim = 0, 0.0, 0.0, 0.0
    batches = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            r = rec["rows"]
            rows += r
            acc += rec["token_acc"] * r
            em += rec["exact_match"] * r
            sim += rec["edit_similarity"] * r
            batches += 1
    if rows == 0:
        return {"batches": 0, "rows": 0}
    return {"batches": batches, "rows": rows, "token_acc": acc / rows,
            "exact_match": em / rows, "edit_similarity": sim / rows}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-d", "--data_dir", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="what evaluation.cli --checkpoint takes")
    p.add_argument("--decode", default="greedy", choices=("greedy", "beam"))
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--max_len", type=int, default=276)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--metrics_out", required=True,
                   help="per-batch JSON lines; also the state a restart resumes from")
    p.add_argument("--pairs_out", default=None,
                   help="per-row pred/gold token ids for tools.confusion_report (appended "
                        "across restarts: a batch the dying process half wrote may leave "
                        "rows twice, harmless for aggregate confusions)")
    p.add_argument("--kv_quant", default=None, choices=("none", "int8"),
                   help="override the config's cross-attention K/V quantization")
    p.add_argument("--self_kv_quant", default=None, choices=("none", "int8"),
                   help="override the config's decode self-attention K/V quantization")
    p.add_argument("--device", default=None,
                   help="passed to evaluation.cli (its default: cuda)")
    p.add_argument("--max_retries", type=int, default=8,
                   help="restarts in a row without a new batch before giving up")
    return p.parse_args(argv)


def eval_command(args: argparse.Namespace, done: int) -> List[str]:
    """The evaluation CLI's command line, resuming after ``done`` batches."""
    cmd = [sys.executable, "-m", "texocr_tpu_torch.evaluation.cli",
           "-d", args.data_dir, "--config", args.config, "--checkpoint", args.checkpoint,
           "--decode", args.decode, "--beam_size", str(args.beam_size),
           "--max_len", str(args.max_len), "--skip_batches", str(done),
           "--metrics_out", args.metrics_out]
    for flag in ("max_batches", "pairs_out", "kv_quant", "self_kv_quant", "device"):
        value = getattr(args, flag)
        if value is not None:
            cmd += [f"--{flag}", str(value)]
    return cmd


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    stalls = 0
    while True:
        done = n_done(args.metrics_out)
        print(f"[eval_full_split] starting at batch {done + 1} "
              f"(attempt with {stalls} stalls so far)", flush=True)
        rc = subprocess.call(eval_command(args, done))
        if rc == 0:
            break
        stalls = 0 if n_done(args.metrics_out) > done else stalls + 1
        if stalls > args.max_retries:
            print(f"[eval_full_split] no progress after {stalls} retries; giving up",
                  file=sys.stderr, flush=True)
            return 1
        print(f"[eval_full_split] eval process died (rc={rc}); resuming", flush=True)
    print("[eval_full_split] FINAL " + json.dumps(aggregate(args.metrics_out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
