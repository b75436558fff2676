"""Training CLI, the JAX package's surface:

    python -m texocr_tpu_torch.training.cli -d data --config config/config.yml

``-d`` holds ``{train/trainset, val/valset, test/testset}.pkl`` as either
package's ``ImageDataset.save`` writes them. The host loader augments the
train split; with ``device_data: true`` in the config, ``device_data_augment``
decides instead.

On N GPUs, one process each: ``torchrun --nproc_per_node N -m
texocr_tpu_torch.training.cli --multihost ...``, or in each process
``--coordinator host:port --num_processes N --process_id I``; the config's
``mesh`` lays the ranks out (``parallel/``).
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from texocr_tpu_torch.config import load_config
from texocr_tpu_torch.data.dataset import load_datasets
from texocr_tpu_torch.parallel.distributed import local_device, maybe_initialize_distributed
from texocr_tpu_torch.training.loop import train_model


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train the TexOCR model with the PyTorch port.",
        epilog="Multi-process: one process per GPU. --num_processes counts processes "
               "(GPUs), where the JAX package's flag counts hosts; the config's mesh "
               "(default {data: -1, model: 1}) lays them out.",
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
                        help="Torch device to train on (default: cuda; in a process group "
                             "cuda:LOCAL_RANK).")
    parser.add_argument("--multihost", action="store_true",
                        help="Join a process group (NCCL on CUDA, gloo on the CPU) before "
                             "building the mesh; alone, from torchrun's environment.")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of process 0 (explicit multi-process).")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="The number of processes (one per GPU).")
    parser.add_argument("--process_id", type=int, default=None,
                        help="This process's rank.")
    return parser.parse_args(argv)


def main(args: argparse.Namespace) -> None:
    joined = maybe_initialize_distributed(
        multihost=args.multihost, coordinator=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id, device=args.device)
    if joined:
        print(f"multi-host: process {dist.get_rank()}/{dist.get_world_size()}, "
              f"{dist.get_world_size()} global devices", flush=True)
    try:
        config = load_config(args.config)
        if args.resume:
            config["resume"] = True
        print("Loading datasets...")
        train_set, val_set, _ = load_datasets(args.data_dir)
        train_set.augment = True  # the host loader's augmentation, train split only
        print("Datasets loaded!")
        train_model(train_set, val_set, config, metrics_path=args.metrics,
                    device=local_device(args.device))
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main(parse_args())
