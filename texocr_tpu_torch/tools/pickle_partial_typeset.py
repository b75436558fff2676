"""Pickle a training-ready subset of a typeset build that is still rendering.

The counterpart of the JAX package's ``tools/pickle_partial_typeset.py``.
A large ``make_demo_dataset --realistic --typeset`` build spends hours in its
render pool; this tool turns the train images rendered so far into a whole
dataset directory, so a typeset warm-up stage can train while the rest
renders. The labels are drawn again from the build's seed (the
``--realistic`` label stream, so only such builds), the longest contiguous
run of rendered train ids from ``eq_00000.png`` on is taken (a torn tail is
left out), and its last ``--holdout`` rows become the val and test halves.
Each split's ``images/`` is a symlink to the build's train images, and the
pickles come from ``ImageDataset``; no renderer is needed.

    python -m texocr_tpu_torch.tools.pickle_partial_typeset --src data_typeset100k \\
        --out data_typesetT --n 100000 --seed 23 [--take N] [--holdout 640]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from texocr_tpu_torch.tools.make_demo_dataset import image_ids, realistic_equation


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", required=True, help="the build's directory (make_demo_dataset --out)")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=100000,
                   help="the build's --n (the label stream depends on it)")
    p.add_argument("--seed", type=int, default=23, help="the build's --seed")
    p.add_argument("--take", type=int, default=None,
                   help="rows to use (default: every contiguously rendered one)")
    p.add_argument("--holdout", type=int, default=640,
                   help="rows at the end of the take kept for the val and test halves")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    rng = np.random.default_rng(args.seed)
    eqs = [realistic_equation(rng) for _ in range(args.n)]
    train_eqs = eqs[: int(args.n * 0.8)]

    src_images = os.path.abspath(os.path.join(args.src, "train", "images"))
    avail = 0
    while avail < len(train_eqs) and os.path.exists(
            os.path.join(src_images, f"eq_{avail:05d}.png")):
        avail += 1
    take = min(args.take or avail, avail)
    if take < 2 * args.holdout:
        raise SystemExit(f"only {take} rendered rows; need >= {2 * args.holdout}")

    half = args.holdout // 2
    n_train = take - 2 * half
    splits = {"train": (0, n_train), "val": (n_train, n_train + half),
              "test": (n_train + half, take)}
    for split, (lo, hi) in splits.items():
        root = os.path.join(args.out, split)
        os.makedirs(root, exist_ok=True)
        link = os.path.join(root, "images")
        if not os.path.exists(link):
            os.symlink(src_images, link)
        with open(os.path.join(root, "labels.txt"), "w") as f:
            f.write("\n".join(train_eqs[lo:hi]) + "\n")
        with open(os.path.join(root, "ids.txt"), "w") as f:
            f.write("\n".join(image_ids(hi)[lo:]) + "\n")

    from texocr_tpu_torch.data.dataset import ImageDataset
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

    for split, (lo, hi) in splits.items():
        root = os.path.join(args.out, split)
        ds = ImageDataset(root, DEFAULT_VOCAB_PATH, dataset_size=hi - lo)
        ds.save(os.path.join(root, f"{split}set.pkl"))
        print(f"{split}: pickled {len(ds)} rows, {len(ds.sizes)} buckets, "
              f"max_seq_len {ds.max_seq_len}")
    print(f"partial typeset dataset at {args.out}: {take} of {len(train_eqs)} train rows "
          f"rendered so far")
    return 0


if __name__ == "__main__":
    sys.exit(main())
