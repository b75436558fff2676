"""Run the curriculum training chain with one command.

The counterpart of the JAX package's ``tools/train_curriculum.py``, with its
stage recipes (``STAGES``, published in ``RESULTS.md``), stage grammar and
warm-start chaining. Trained from scratch at the realistic difficulty the
flagship memorises; what works is a chain of warm-started stages of rising
difficulty and data scale. Each stage builds its dataset with
``python -m texocr_tpu_torch.tools.make_demo_dataset`` (skipped where its
pickles exist) and trains with ``python -m texocr_tpu_torch.tools.demo_train``,
warm-started from the previous stage's checkpoint directory. Each stage's
final metrics go to ``<results_dir>/stage_<X>.json``; the default,
``results/torch/``, keeps them apart from the JAX runs' files in
``results/``.

    python -m texocr_tpu_torch.tools.train_curriculum                 # stages A..F
    python -m texocr_tpu_torch.tools.train_curriculum --stages A-C    # grounding only
    python -m texocr_tpu_torch.tools.train_curriculum --stages F,G    # later stages
    python -m texocr_tpu_torch.tools.train_curriculum --dry_run       # print the commands
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Each stage: the dataset's build arguments and the training arguments.
# `epochs`/`decay_steps` pairs end the cosine schedule at the stage's last
# step. Every stage trains device-resident with augmentation at batch 32.
STAGES = {
    # A: short labels on small canvases: bootstraps reading glyphs.
    "A": dict(
        data="data_simple",
        dataset=["--n", "4000", "--simple"],
        train=["--epochs", "150", "--lr", "3e-4"],
    ),
    # B: labels rich in entropy, on short single-line canvases only.
    "B": dict(
        data="data_entropic",
        dataset=["--n", "10000", "--entropic"],
        train=["--epochs", "80", "--lr", "3e-4", "--max_canvas", "32", "640"],
    ),
    # C: the whole entropic mix, up to (96, 1008) wrapped canvases.
    "C": dict(
        data="data_entropic",
        dataset=["--n", "10000", "--entropic"],
        train=["--epochs", "100", "--lr", "3e-4", "--warmup_steps", "200",
               "--decay_steps", "25000", "--eval_max_len", "330",
               "--eval_batch_size", "32", "--eval_batches", "4"],
    ),
    # D: the structured LaTeX grammar at 8k distinct equations.
    "D": dict(
        data="data_realistic",
        dataset=["--n", "10000", "--realistic"],
        train=["--epochs", "100", "--lr", "3e-4", "--warmup_steps", "200",
               "--decay_steps", "25000", "--eval_max_len", "475",
               "--eval_batch_size", "32", "--eval_batches", "6",
               "--save_freq", "20", "--val_freq", "10"],
    ),
    # E: the same regime with 2.4x the distinct equations.
    "E": dict(
        data="data_real24k",
        dataset=["--n", "24000", "--realistic", "--seed", "7"],
        train=["--epochs", "60", "--lr", "3e-4", "--warmup_steps", "200",
               "--decay_steps", "36000", "--eval_max_len", "475",
               "--eval_batch_size", "32", "--eval_batches", "6",
               "--save_freq", "20", "--val_freq", "10"],
    ),
    # F: twice the data again.
    "F": dict(
        data="data_real48k",
        dataset=["--n", "48000", "--realistic", "--seed", "11"],
        train=["--epochs", "40", "--lr", "3e-4", "--warmup_steps", "200",
               "--decay_steps", "48000", "--eval_max_len", "475",
               "--eval_batch_size", "32", "--eval_batches", "225",
               "--save_freq", "10", "--val_freq", "10"],
    ),
    # G: the reference's 100k-equation scale; remat leaves room beside the
    # resident buckets for the (160, 1008) backward.
    "G": dict(
        data="data_real100k",
        dataset=["--n", "100000", "--realistic", "--seed", "13"],
        train=["--epochs", "40", "--lr", "3e-4", "--warmup_steps", "200",
               "--decay_steps", "100000", "--eval_max_len", "500",
               "--eval_batch_size", "32", "--eval_batches", "150",
               "--save_freq", "10", "--val_freq", "10", "--remat",
               "--host_val"],
    ),
    # T: mathtext typesetting (fraction bars, radicals, kerning, invisible
    # grouping braces): fine-tunes the chain onto typeset glyphs.
    "T": dict(
        data="data_typeset24k",
        dataset=["--n", "24000", "--realistic", "--typeset", "--seed", "17"],
        train=["--epochs", "40", "--lr", "3e-4", "--warmup_steps", "200",
               "--decay_steps", "24000", "--eval_max_len", "475",
               "--eval_batch_size", "32", "--eval_batches", "112",
               "--save_freq", "10", "--val_freq", "10"],
    ),
    # U: typeset at stage F's scale; typeset renders skew tall, so remat.
    "U": dict(
        data="data_typeset48k",
        dataset=["--n", "48000", "--realistic", "--typeset", "--seed", "19"],
        train=["--epochs", "40", "--lr", "3e-4", "--warmup_steps", "200",
               "--decay_steps", "48000", "--eval_max_len", "475",
               "--eval_batch_size", "32", "--eval_batches", "225",
               "--save_freq", "10", "--val_freq", "10", "--remat",
               "--host_val"],
    ),
    # V: stage U's recipe on the same equations rendered after the digit-base
    # script fix (render_data.compact_latex).
    "V": dict(
        data="data_typeset48k_v2",
        dataset=["--n", "48000", "--realistic", "--typeset", "--seed", "19"],
        train=["--epochs", "40", "--lr", "3e-4", "--warmup_steps", "200",
               "--decay_steps", "48000", "--eval_max_len", "475",
               "--eval_batch_size", "32", "--eval_batches", "225",
               "--save_freq", "10", "--val_freq", "10", "--remat",
               "--host_val"],
    ),
    # W: typeset at the reference's 100k scale, warm-started from V; 4-bit
    # resident images halve the buckets' memory.
    "W": dict(
        data="data_typeset100k",
        dataset=["--n", "100000", "--realistic", "--typeset", "--seed", "23"],
        train=["--epochs", "40", "--lr", "3e-4", "--warmup_steps", "200",
               "--decay_steps", "100000", "--eval_max_len", "475",
               "--eval_batch_size", "32", "--eval_batches", "200",
               "--save_freq", "10", "--val_freq", "10", "--remat",
               "--host_val", "--pack_bits", "4"],
    ),
}

ORDER = list(STAGES)


def parse_stages(spec: str) -> List[str]:
    """'A-D' / 'A,C,F' / 'A-C,F' -> the ordered stage list."""
    out: List[str] = []
    for part in spec.upper().split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-", 1)
            if lo not in ORDER or hi not in ORDER:
                raise SystemExit(f"unknown stage range: {part}")
            if ORDER.index(lo) > ORDER.index(hi):
                raise SystemExit(f"reversed stage range: {part} (did you mean {hi}-{lo}?)")
            out.extend(ORDER[ORDER.index(lo): ORDER.index(hi) + 1])
        elif part:
            if part not in ORDER:
                raise SystemExit(f"unknown stage: {part}")
            out.append(part)
    return out


def run(cmd: List[str], dry: bool) -> None:
    """Prints ``cmd`` and, unless ``dry``, runs it with the repository on
    the module path."""
    print("+", " ".join(cmd), flush=True)
    if not dry:
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
        subprocess.run(cmd, check=True, env=env)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stages", default="A-F", help="stage list, e.g. A-F or A-C,F (default A-F)")
    p.add_argument("--base_dir", default="curriculum",
                   help="where the datasets and the stages' checkpoints live")
    p.add_argument("--results_dir", default=os.path.join(REPO, "results", "torch"),
                   help="where each stage's metrics JSON is written")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--init_from", default=None,
                   help="warm-start directory of the first selected stage (default: the "
                        "previous stage's checkpoints, or none for stage A)")
    p.add_argument("--force_data", action="store_true",
                   help="rebuild datasets even if the pickles exist")
    p.add_argument("--device", default="cuda", help="torch device to train on (default: cuda)")
    p.add_argument("--dry_run", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    stages = parse_stages(args.stages)
    if not stages:
        raise SystemExit("no stages selected")
    py = sys.executable
    base_dir = os.path.abspath(args.base_dir)

    prev_ckpt = args.init_from
    if prev_ckpt is None and stages[0] != "A":
        prev = ORDER[ORDER.index(stages[0]) - 1]
        cand = os.path.join(base_dir, f"stage{prev}_ckpts")
        if not os.path.isdir(cand):
            raise SystemExit(f"stage {stages[0]} needs a warm start; {cand} not found "
                             "(pass --init_from or start from stage A)")
        prev_ckpt = cand

    for name in stages:
        spec = STAGES[name]
        data_dir = os.path.join(base_dir, spec["data"])
        save_dir = os.path.join(base_dir, f"stage{name}_ckpts")
        if args.force_data or not os.path.exists(os.path.join(data_dir, "train", "trainset.pkl")):
            run([py, "-m", "texocr_tpu_torch.tools.make_demo_dataset", "--out", data_dir]
                + spec["dataset"], args.dry_run)
        else:
            print(f"[stage {name}] dataset {data_dir} exists, skipping build")

        metrics_out = os.path.join(os.path.abspath(args.results_dir), f"stage_{name}.json")
        cmd = [py, "-m", "texocr_tpu_torch.tools.demo_train", "--data", data_dir,
               "--device_data", "--augment", "--batch_size", str(args.batch_size),
               "--save_dir", save_dir, "--metrics_out", metrics_out,
               "--device", args.device] + spec["train"]
        if prev_ckpt:
            cmd += ["--init_from", prev_ckpt]
        run(cmd, args.dry_run)
        prev_ckpt = save_dir

    print(f"curriculum complete; final checkpoints in {prev_ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
