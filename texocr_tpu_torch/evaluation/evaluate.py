"""Evaluation harness: batched greedy or beam decode over a test split on the
device, then token accuracy (reference batch_acc), exact match and edit
similarity on the host."""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from texocr_tpu_torch.checkpoint.convert import POS_EMBED_KEY
from texocr_tpu_torch.data.dataset import ImageDataset, create_dataloader
from texocr_tpu_torch.evaluation.metrics import batch_acc, edit_similarity, exact_match_rate
from texocr_tpu_torch.models import OCRModel, generate


def clamp_to_pos_table(state_dict: Dict[str, torch.Tensor], config: dict, max_len: int) -> int:
    """Sync ``config['max_length']`` to the positional table in
    ``state_dict`` (reference keys) and clamp the decode budget to it.
    Returns the clamped ``max_len``; mutates ``config``."""
    pos_rows = int(state_dict[POS_EMBED_KEY].shape[0])
    if max_len + 1 > pos_rows:
        print(f"WARNING: decode budget {max_len} exceeds the checkpoint's "
              f"positional table ({pos_rows} rows); clamping to {pos_rows - 1}.")
        max_len = pos_rows - 1
    config["max_length"] = pos_rows
    return max_len


def test_model(
    test_set: ImageDataset,
    model: OCRModel,
    config: dict,
    max_len: int = 276,
    verbose: bool = True,
    max_batches: Optional[int] = None,
    decode_mode: str = "greedy",
    beam_size: int = 5,
    skip_batches: int = 0,
    metrics_out: Optional[str] = None,
    pairs_out: Optional[str] = None,
) -> Dict[str, float]:
    """Decode the test split and report the mean per-batch token accuracy,
    exact match and edit similarity. ``decode_mode``: "greedy" or "beam"
    (``beam_size`` wide, no length penalty).

    ``pairs_out`` appends one JSON line per row with the pad-stripped
    predicted and gold token ids. ``skip_batches``/``metrics_out`` make a long
    evaluation resumable: the loader order is fixed for a fixed seed, each
    batch appends one JSON line to ``metrics_out``, and a rerun with
    ``skip_batches=<lines already written>`` continues where it stopped."""
    cfg = model.config
    device = next(model.parameters()).device
    if decode_mode not in ("greedy", "beam"):
        raise ValueError(f"unknown decode_mode: {decode_mode!r}")
    accs, ems, sims, n = [], [], [], 0
    # Skip at the sampler: a resumed run pays only for the id lists of the
    # batches already done, not their collation.
    loader = create_dataloader(test_set, config)
    for batch_ids in loader.sampler:
        if n < skip_batches:
            n += 1
            continue
        images, labels = loader.collate([test_set[i] for i in batch_ids])
        pred = generate(model, torch.as_tensor(images).to(device), max_len=max_len,
                        mode=decode_mode, beam_size=beam_size).cpu().numpy()
        # Targets exclude the leading BOS: the decode returns the suffix.
        target = np.asarray(labels)[:, 1:]
        accs.append(batch_acc(pred, target, cfg.pad_token))
        ems.append(exact_match_rate(pred, target, cfg.pad_token))
        sims.append(edit_similarity(pred, target, cfg.pad_token))
        n += 1
        if metrics_out:
            with open(metrics_out, "a") as f:
                f.write(json.dumps({
                    "batch": n, "rows": int(pred.shape[0]), "token_acc": float(accs[-1]),
                    "exact_match": float(ems[-1]), "edit_similarity": float(sims[-1]),
                }) + "\n")
        if pairs_out:
            with open(pairs_out, "a") as f:
                for r in range(pred.shape[0]):
                    f.write(json.dumps({
                        "pred": [int(t) for t in pred[r] if t != cfg.pad_token],
                        "gold": [int(t) for t in target[r] if t != cfg.pad_token],
                    }) + "\n")
        if verbose:
            print(f"batch {n}: token_acc {accs[-1]:.3f}  exact {ems[-1]:.3f}"
                  f"  edit_sim {sims[-1]:.3f}")
            print("  pred:", test_set.tokenizer.decode(
                [int(t) for t in pred[0] if t != cfg.pad_token]))
            print("  gold:", test_set.tokenizer.decode(
                [int(t) for t in target[0] if t != cfg.pad_token]))
        if max_batches and n >= max_batches:
            break

    out = {
        "token_acc": float(np.mean(accs)) if accs else 0.0,
        "exact_match": float(np.mean(ems)) if ems else 0.0,
        "edit_similarity": float(np.mean(sims)) if sims else 0.0,
        "batches": n,
    }
    if verbose:
        print(f"Test accuracy: {out['token_acc']:.4f}  exact match: {out['exact_match']:.4f}  "
              f"edit similarity: {out['edit_similarity']:.4f}")
    return out


def single_prediction(test_set: ImageDataset, model: OCRModel, index: int = 0):
    """Teacher-forced argmax prediction for one sample through
    ``OCRModel.forward``: (pred_ids, gold_ids), the gold ids shifted past BOS."""
    image, token_ids = test_set[index]
    cfg = model.config
    device = next(model.parameters()).device
    labels = torch.tensor([[cfg.bos_token] + list(token_ids) + [cfg.eos_token]], device=device)
    with torch.inference_mode():
        logits, shifted = model(torch.as_tensor(image[None]).to(device), labels)
    return logits.argmax(-1)[0].tolist(), shifted[0].tolist()
