"""Training CLI, the JAX package's surface:

    python -m texocr_tpu_torch.training.cli -d data --config config/config.yml

``-d`` holds ``{train/trainset, val/valset, test/testset}.pkl`` as either
package's ``ImageDataset.save`` writes them. The host loader augments the
train split; with ``device_data: true`` in the config, ``device_data_augment``
decides instead.
"""

from __future__ import annotations

import argparse

from texocr_tpu_torch.config import load_config
from texocr_tpu_torch.data.dataset import load_datasets
from texocr_tpu_torch.training.loop import train_model


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train the TexOCR model with the PyTorch port.",
        epilog="The JAX package's multi-host flags (--multihost, --coordinator, "
               "--num_processes, --process_id) are not ported yet (ROADMAP Queue 1 "
               "item 13): this trainer runs on one device.",
    )
    parser.add_argument("-d", "--data_dir", type=str, default="data",
                        help="Directory containing dataset pickle files.")
    parser.add_argument("--config", type=str, default="config/config.yml",
                        help="Path to the configuration file (.yml, or .json without PyYAML).")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the latest checkpoint in save_dir.")
    parser.add_argument("--metrics", type=str, default=None,
                        help="Write JSON-lines training metrics to this file.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to train on (default: cuda).")
    return parser.parse_args(argv)


def main(args: argparse.Namespace) -> None:
    config = load_config(args.config)
    if args.resume:
        config["resume"] = True
    print("Loading datasets...")
    train_set, val_set, _ = load_datasets(args.data_dir)
    train_set.augment = True  # the host loader's augmentation, train split only
    print("Datasets loaded!")
    train_model(train_set, val_set, config, metrics_path=args.metrics, device=args.device)


if __name__ == "__main__":
    main(parse_args())
