"""Build one split's dataset from its render directory and pickle it.

    python -m texocr_tpu_torch.data.factory.pickle_data -c config/data_config.yml --split train -s data/train/trainset.pkl [--lazy]

The directory is the config's ``<split>_dir``, the tokenizer its
``tokenizer_path``, the size cap its ``num_equations``. ``--lazy`` pickles
the file names and sizes in place of the pixels (``ImageDataset(lazy=True)``),
which the training loader then decodes per batch. Either package loads the
pickle.
"""

from __future__ import annotations

import argparse
import time

from texocr_tpu_torch.config import load_config
from texocr_tpu_torch.data.dataset import ImageDataset


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Dataset build utilities.")
    p.add_argument("-c", "--config", type=str, default="config/data_config.yml")
    p.add_argument("--split", type=str, default="train", choices=["train", "val", "test"])
    p.add_argument("-s", "--save", type=str, default="dataset.pkl")
    p.add_argument("--lazy", action="store_true",
                   help="pickle file names and sizes, not pixels")
    return p.parse_args(argv)


def main(args: argparse.Namespace) -> None:
    start = time.time()
    config = load_config(args.config)
    dataset = ImageDataset(root_dir=config[f"{args.split}_dir"],
                           tokenizer_path=config["tokenizer_path"],
                           dataset_size=config["num_equations"], lazy=args.lazy)
    dataset.save(args.save)
    print(f"Pickled {len(dataset)}-item {args.split} dataset to {args.save} "
          f"in {time.time() - start:.2f}s.")


if __name__ == "__main__":
    main(parse_args())
