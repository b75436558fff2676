"""Evaluation harness: batched greedy or beam decode over a test split on the
device, then token accuracy (reference batch_acc), exact match and edit
similarity on the host.

On a CUDA model each batch decodes through CUDA graphs
(``models.graphed``, float input: the loader's batch as ``generate`` takes
it, so the tokens are ``generate``'s): one engine per key (batch shape,
mode, beam width, max_len), captured at the key's first batch and replayed
after, as the JAX package's ``test_model`` compiles one decode per batch
shape. The loader's last, smaller batch and every canvas bucket get a key of
their own. The engines live in a ``GraphCache`` local to the call, which
holds at most ``MAX_GRAPH_KEYS`` of them (the least recently used goes
first) and drops them all when the call returns, so their memory pools do
not outlive the evaluation. A model on the CPU decodes eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import json
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from texocr_tpu_torch.checkpoint.convert import POS_EMBED_KEY
from texocr_tpu_torch.data.dataset import ImageDataset, create_dataloader
from texocr_tpu_torch.evaluation.metrics import batch_acc, edit_similarity, exact_match_rate
from texocr_tpu_torch.models import OCRModel, generate
from texocr_tpu_torch.models.graphed import make_graphed_generate

#: Graph engines one evaluation holds at once. A key's pool is about 0.63 GB
#: at batch 8 x 350 tokens on full canvases (NVIDIA H100 80GB HBM3, 700 W),
#: so 16 keys fit beside the model; a split with more canvas buckets than
#: this recaptures the keys it dropped.
MAX_GRAPH_KEYS = 16

#: (batch, (H, W), max_len, mode, beam_size) -> a callable from (B, H, W, 1)
#: float32 model inputs on the device to (B, max_len) tokens; a verbose
#: ``GraphCache`` prints its ``capture_s`` where it has one
#: (``GraphedGenerate``'s).
EngineFactory = Callable[[int, Tuple[int, int], int, str, int], Callable]


class GraphCache:
    """The decode engines of one evaluation, one per key (batch shape, mode,
    beam width, max_len), built by ``factory`` at a key's first batch. At
    most ``max_keys`` are held: a new key beyond them drops the least
    recently used engine before it builds its own. ``keys`` lists every key
    built, in order (a dropped key that comes back is built again);
    ``close`` drops every engine."""

    def __init__(self, factory: EngineFactory, max_keys: int = MAX_GRAPH_KEYS,
                 verbose: bool = False):
        self.factory, self.max_keys, self.verbose = factory, max_keys, verbose
        self.engines: "collections.OrderedDict[tuple, Callable]" = collections.OrderedDict()
        self.keys = []

    def __call__(self, images: torch.Tensor, *, max_len: int, mode: str,
                 beam_size: int) -> torch.Tensor:
        key = (tuple(images.shape), mode, beam_size, max_len)
        engine = self.engines.pop(key, None)
        if engine is None:
            if len(self.engines) >= self.max_keys:
                self.engines.popitem(last=False)
            engine = self.factory(images.shape[0], tuple(images.shape[1:3]), max_len, mode,
                                  beam_size)
            self.keys.append(key)
            if self.verbose:
                capture_s = getattr(engine, "capture_s", None)
                took = "built" if capture_s is None else f"captured in {capture_s:.2f} s"
                print(f"graph key {key}: {took} "
                      f"({len(self.engines) + 1} held, {len(self.keys)} built)")
        self.engines[key] = engine
        return engine(images)

    def close(self) -> None:
        self.engines.clear()


def graph_engines(model: OCRModel) -> EngineFactory:
    """The factory of ``model``'s CUDA-graph engines on float input."""

    def factory(batch, canvas, max_len, mode, beam_size):
        return make_graphed_generate(model, batch, canvas, max_len, mode, beam_size=beam_size,
                                     float_input=True)

    return factory


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


@contextlib.contextmanager
def batch_decoder(model: OCRModel, max_len: int, mode: str, beam_size: int,
                  engine_factory: Optional[EngineFactory] = None, verbose: bool = False):
    """For the length of the ``with`` block, a function from a (B, H, W, 1)
    float32 batch to its (B, max_len) tokens on the model's device: through
    a ``GraphCache`` of ``engine_factory``'s engines (by default
    ``graph_engines(model)`` on a CUDA model), or with ``generate`` on a CPU
    model. The engines are dropped when the block ends."""
    device = next(model.parameters()).device
    if engine_factory is None and device.type == "cuda":
        engine_factory = graph_engines(model)
    if engine_factory is None:
        yield lambda x: generate(model, x.to(device), max_len=max_len, mode=mode,
                                 beam_size=beam_size)
        return
    graphs = GraphCache(engine_factory, verbose=verbose)
    try:
        yield lambda x: graphs(x.to(device), max_len=max_len, mode=mode, beam_size=beam_size)
    finally:
        graphs.close()
        if device.type == "cuda":
            torch.cuda.empty_cache()


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
    engine_factory: Optional[EngineFactory] = None,
) -> Dict[str, float]:
    """Decode the test split and report the mean per-batch token accuracy,
    exact match and edit similarity. ``decode_mode``: "greedy" or "beam"
    (``beam_size`` wide, no length penalty).

    ``pairs_out`` appends one JSON line per row with the pad-stripped
    predicted and gold token ids. ``skip_batches``/``metrics_out`` make a long
    evaluation resumable: the loader order is fixed for a fixed seed, each
    batch appends one JSON line to ``metrics_out``, and a rerun with
    ``skip_batches=<lines already written>`` continues where it stopped.

    ``engine_factory``: builds the decode engine of a key (see
    ``GraphCache``); by default ``graph_engines(model)`` on a CUDA model and
    none on the CPU, which decodes with ``generate``."""
    cfg = model.config
    if decode_mode not in ("greedy", "beam"):
        raise ValueError(f"unknown decode_mode: {decode_mode!r}")
    accs, ems, sims, n = [], [], [], 0
    # Skip at the sampler: a resumed run pays only for the id lists of the
    # batches already done, not their collation.
    loader = create_dataloader(test_set, config)
    with batch_decoder(model, max_len, decode_mode, beam_size, engine_factory,
                       verbose) as decode:
        for batch_ids in loader.sampler:
            if n < skip_batches:
                n += 1
                continue
            images, labels = loader.collate([test_set[i] for i in batch_ids])
            pred = decode(torch.as_tensor(images)).cpu().numpy()
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
