"""Train the flagship on a demo dataset, then score it on the test split.

The counterpart of the JAX package's ``tools/demo_train_tpu.py``, with its
arguments and its training config, and ``--device`` (default ``cuda``).
``train_model`` trains on the pickles of ``--data`` (``make_demo_dataset``
writes them); the decode budget is clamped to the trained positional table
(``clamp_to_pos_table``); ``test_model`` decodes at most
``--eval_batches`` test batches greedily (through CUDA graphs on the card).
It prints the history and metrics as one JSON line and, with
``--metrics_out``, writes them with the run's arguments to that file.

    python -m texocr_tpu_torch.tools.make_demo_dataset --out data_demo --n 1200
    python -m texocr_tpu_torch.tools.demo_train --data data_demo --epochs 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", type=str, default="data_demo")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--save_dir", type=str, default="demo_ckpts")
    p.add_argument("--eval_batches", type=int, default=4)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_from", type=str, default=None,
                   help="warm-start the weights from a checkpoint (or a save_dir); fresh "
                        "optimizer state")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seq_pad", type=int, default=128,
                   help="labels pad to a multiple of this")
    p.add_argument("--eval_max_len", type=int, default=120)
    p.add_argument("--eval_batch_size", type=int, default=None)
    p.add_argument("--keep_small", action="store_true",
                   help="keep partial tail batches (small datasets)")
    p.add_argument("--device_data", action="store_true",
                   help="the dataset resident on the device, batches picked there "
                        "(training/device_data.py)")
    p.add_argument("--steps_per_call", type=int, default=16)
    p.add_argument("--save_freq", type=int, default=None)
    p.add_argument("--val_freq", type=int, default=None)
    p.add_argument("--augment", action="store_true",
                   help="scale, translate and brightness augmentation on the device "
                        "(with --device_data)")
    p.add_argument("--wd", type=float, default=0.0, help="Adam weight decay")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clip (0: off)")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear lr warmup steps (with --decay_steps)")
    p.add_argument("--decay_steps", type=int, default=0,
                   help="cosine decay horizon in steps; 0: a constant lr")
    p.add_argument("--pack_bits", type=int, default=8, choices=(8, 4),
                   help="resident image depth: 4 packs two pixels a byte")
    p.add_argument("--bucket_cap", type=int, default=None,
                   help="most resident rows per bucket (a seeded subset beyond it)")
    p.add_argument("--max_canvas", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="train only on buckets within (H, W)")
    p.add_argument("--remat", action="store_true",
                   help="recompute sub-layer and bottleneck activations in the backward")
    p.add_argument("--metrics_out", type=str, default=None,
                   help="also write the final metrics JSON to this file")
    p.add_argument("--host_val", action="store_true",
                   help="feed the val split from the host instead of keeping it resident")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train and evaluate on (default: cuda)")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> dict:
    """The training config of ``args``: the flagship's widths with the demo's
    training keys, as the JAX tool passes it to ``train_model``."""
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

    optimizer_args = {"lr": args.lr, "weight_decay": args.wd}
    if args.grad_clip:
        optimizer_args["grad_clip"] = args.grad_clip
    if args.decay_steps:
        optimizer_args["lr_schedule"] = {"warmup_steps": args.warmup_steps,
                                         "decay_steps": args.decay_steps}
    return {
        "tokenizer_path": DEFAULT_VOCAB_PATH,
        "patch_size": 16,
        "glu": True,
        "bos_token": 998,
        "eos_token": 997,
        "trg_pad_idx": 999,
        "batch_size": args.batch_size,
        "n_epochs": args.epochs,
        "optimizer": "Adam",
        "optimizer_args": optimizer_args,
        "seed": 42,
        "save_checkpoint": True,
        "save_dir": args.save_dir,
        "save_freq": args.save_freq or max(args.epochs // 2, 1),
        "val_freq": args.val_freq or max(args.epochs // 2, 1),
        "drop_last": True,
        "keep_small": args.keep_small,
        "batch_shuffle": True,
        "id_shuffle": True,
        "dtype": "bfloat16",
        "use_flash_attention": "auto",
        "mesh": {"data": -1},
        "mask_pad_loss": True,
        "seq_pad_multiple": args.seq_pad,
        "loss_fn": "CrossEntropyLoss",
        "resume": args.resume,
        "init_from": args.init_from,
        "remat": args.remat,
        "device_data_val": not args.host_val,
        "device_data": args.device_data,
        "device_data_steps_per_call": args.steps_per_call,
        "device_data_augment": args.augment,
        "device_data_max_canvas": tuple(args.max_canvas) if args.max_canvas else None,
        "device_data_bucket_cap": args.bucket_cap,
        "device_data_pack_bits": args.pack_bits,
        "encoder": {"n_channels": 1, "embed_dim": 256, "num_layers": 4, "heads": 8},
        "decoder": {"embed_dim": 256, "num_layers": 4, "heads": 8, "cross_attend": True,
                    "dropout": 0.1, "exp_factor": 4},
    }


def run(args: argparse.Namespace, config: dict) -> dict:
    """Trains with ``config`` on ``args.data``, evaluates the test split and
    writes ``args.metrics_out``; returns {"history": ..., **metrics}."""
    from texocr_tpu_torch.data.dataset import ImageDataset
    from texocr_tpu_torch.evaluation.evaluate import clamp_to_pos_table, test_model
    from texocr_tpu_torch.training.loop import train_model

    sets = {split: ImageDataset.load(os.path.join(args.data, split, f"{split}set.pkl"))
            for split in ("train", "val", "test")}
    model, _, history = train_model(sets["train"], sets["val"], config, device=args.device)

    # The decode must stay inside the trained positional table.
    eval_config = dict(config)
    eval_config["vocab_size"] = sets["test"].tokenizer.vocab_size
    eval_max_len = clamp_to_pos_table(model.state_dict(), eval_config, args.eval_max_len)
    if args.eval_batch_size:
        eval_config["batch_size"] = args.eval_batch_size
    model.eval()
    metrics = test_model(sets["test"], model, eval_config, max_len=eval_max_len, verbose=True,
                         max_batches=args.eval_batches)
    final = {"history": history, **metrics}
    print(json.dumps(final))
    if args.metrics_out:
        record = {"args": vars(args), "final_train_loss": history[-1] if history else None,
                  **metrics}
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"metrics written to {args.metrics_out}")
    return final


def main(argv=None) -> int:
    args = parse_args(argv)
    run(args, build_config(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
