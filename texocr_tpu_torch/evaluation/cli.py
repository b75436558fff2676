"""Evaluation CLI:

    python -m texocr_tpu_torch.evaluation.cli -d data --config config.json \\
        [--checkpoint path] [--max_len 276] [--decode greedy|beam] [--device cuda]

``-d`` holds ``test/testset.pkl`` as either package's ``ImageDataset.save``
writes it. ``--checkpoint`` takes what ``checkpoint.load_weights`` reads: a
reference state dict, the port's checkpoints, or a JAX training run's
``checkpoint_e*`` orbax directory (its ``params_cache.msgpack`` first, where
the JAX package wrote one). On a CUDA device every batch
decodes through CUDA graphs (``evaluate.test_model``).
"""

from __future__ import annotations

import argparse
import os

from texocr_tpu_torch.checkpoint.io import load_weights
from texocr_tpu_torch.config import ModelConfig, load_config
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.evaluation.evaluate import clamp_to_pos_table, test_model
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.utils import pad_to_multiple


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate the TexOCR model with the PyTorch port.")
    p.add_argument("-d", "--data_dir", type=str, default="data")
    p.add_argument("--config", type=str, default="config/config.yml",
                   help="configuration file (.yml, or .json without PyYAML)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help=".pth/.pt/.npz state dict, a checkpoint directory of the port's "
                        "trainer or of a JAX run (orbax), or the save_dir of either (its "
                        "latest epoch)")
    p.add_argument("--max_len", type=int, default=276)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--decode", type=str, default="greedy", choices=("greedy", "beam"))
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--skip_batches", type=int, default=0,
                   help="skip the first N batches (resume a long eval; the loader "
                        "order is fixed for a fixed seed)")
    p.add_argument("--pairs_out", type=str, default=None,
                   help="append one JSON line per row with pad-stripped pred/gold token ids")
    p.add_argument("--metrics_out", type=str, default=None,
                   help="append per-batch metrics to this JSONL file")
    p.add_argument("--kv_quant", type=str, default=None, choices=("none", "int8"),
                   help="override the config's cross-attention K/V quantization")
    p.add_argument("--self_kv_quant", type=str, default=None, choices=("none", "int8"),
                   help="override the config's decode self-attention K/V quantization")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on (default: cuda)")
    return p.parse_args(argv)


def main(args: argparse.Namespace) -> dict:
    config = load_config(args.config)
    if args.kv_quant is not None:
        config["kv_quant"] = args.kv_quant
    if args.self_kv_quant is not None:
        config["self_kv_quant"] = args.self_kv_quant
    test_set = ImageDataset.load(os.path.join(args.data_dir, "test", "testset.pkl"))
    # The positional table covers the collator's rounded label lengths and the
    # decode budget.
    config["max_length"] = max(
        pad_to_multiple(test_set.max_seq_len, config.get("seq_pad_multiple", 1)),
        args.max_len + 1,
    )
    config["vocab_size"] = test_set.tokenizer.vocab_size
    state = None
    if args.checkpoint:
        state = load_weights(args.checkpoint)
        args.max_len = clamp_to_pos_table(state, config, args.max_len)
    else:
        print("WARNING: no checkpoint given; evaluating a random init.")
    model = OCRModel(ModelConfig.from_dict(config), device=args.device,
                     seed=config.get("seed", 42))
    if state is not None:
        model.load_state_dict(state, strict=True)
    model.eval()
    return test_model(test_set, model, config, max_len=args.max_len,
                      max_batches=args.max_batches, decode_mode=args.decode,
                      beam_size=args.beam_size, skip_batches=args.skip_batches,
                      metrics_out=args.metrics_out, pairs_out=args.pairs_out)


if __name__ == "__main__":
    main(parse_args())
