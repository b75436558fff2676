"""Split a master file of LaTeX labels into train, test and val sets.

    python -m texocr_tpu_torch.data.factory.split_data master.txt data -c config/data_config.yml

As the JAX package: ids ``eq_<n>.png`` number the master's lines from 1,
zero-padded to the width of the line count, before a
``np.random.default_rng(seed).permutation`` shuffles lines and ids; the
first ``num_equations`` shuffled lines are cut into train, test and val by
the ``splits`` ratios, each into ``<split>/labels.txt`` and ``ids.txt``. The
config is YAML (PyYAML, imported then) or ``.json`` with the same keys.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Tuple

import numpy as np

from texocr_tpu_torch.config import load_config


def split_data(input_file: str, splits: Tuple[float, float, float], output_dir: str,
               num_equations: int, seed: int = 42, verbose: bool = True) -> None:
    if abs(sum(splits) - 1.0) > 1e-9:
        raise ValueError("The sum of the splits must be 1.")
    train_ratio, test_ratio, _ = splits

    lines = [ln.strip() for ln in Path(input_file).read_text().splitlines()]
    width = len(str(len(lines)))
    ids = [f"eq_{i:0{width}d}.png" for i in range(1, len(lines) + 1)]

    perm = np.random.default_rng(seed).permutation(len(lines))
    lines = [lines[i] for i in perm]
    ids = [ids[i] for i in perm]

    total = min(num_equations, len(lines))
    lines, ids = lines[:total], ids[:total]
    n_train = int(total * train_ratio)
    n_test = int(total * test_ratio)
    if verbose:
        print(f"Splitting data: {n_train} train | {n_test} test | "
              f"{total - n_train - n_test} val")

    out = Path(output_dir)
    chunks = {
        "train": (lines[:n_train], ids[:n_train]),
        "test": (lines[n_train: n_train + n_test], ids[n_train: n_train + n_test]),
        "val": (lines[n_train + n_test:], ids[n_train + n_test:]),
    }
    for split, (labels, split_ids) in chunks.items():
        d = out / split
        d.mkdir(parents=True, exist_ok=True)
        (d / "labels.txt").write_text("\n".join(labels) + "\n")
        (d / "ids.txt").write_text("\n".join(split_ids) + "\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Split LaTeX equations into sets.")
    p.add_argument("input_file", type=str)
    p.add_argument("output_dir", type=str)
    p.add_argument("-c", "--config", type=str, default="config/data_config.yml")
    args = p.parse_args(argv)

    config = load_config(args.config)
    splits = tuple(float(v) for v in config["splits"].values())
    split_data(args.input_file, splits, args.output_dir, config["num_equations"],
               config["seed"])


if __name__ == "__main__":
    main()
