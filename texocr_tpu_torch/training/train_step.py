"""The training step: forward, loss, backward and the optimizer update.

The state is updated in place (the JAX package returns a new, donated one).
The dropout generator of step ``s`` is seeded from (seed, s), as the JAX
package folds the step into its dropout key, so a resumed run continues the
mask sequence. Metrics stay on the device; reading them is the caller's sync.

On a mesh each data rank trains on its rows of the global batch: its loss is
its share of the global loss (``losses.py``), the gradients are summed (not
averaged) over the data group in flat buckets after the backward, and the
metrics are the global batch's. DDP would average over the whole world and
knows nothing of the model group, so the step does this itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.models.ocr_model import OCRModel
from texocr_tpu_torch.parallel.layers import all_reduce_grads, all_reduce_sum
from texocr_tpu_torch.training.losses import sequence_ce_loss
from texocr_tpu_torch.training.optimizers import Optimizer


@dataclasses.dataclass
class TrainState:
    model: OCRModel
    optimizer: Optimizer
    step: int
    seed: int  # the dropout seed


def create_train_state(model: OCRModel, optimizer: Optimizer, seed: int) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, step=0, seed=seed)


def seeded_generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` through
    ``np.random.SeedSequence``: one independent stream per tuple of words."""
    key = int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one step, on ``device``, seeded from (seed, step)."""
    return seeded_generator(device, seed, step)


def _loss_and_acc(model: OCRModel, images, labels, mask_pad: bool, generator=None):
    """(this rank's share of the loss, the global token accuracy)."""
    logits, shifted = model(images, labels, generator=generator)
    pad = model.config.pad_token
    loss = sequence_ce_loss(logits, shifted, pad_token=pad, mask_pad=mask_pad, data=model.data)
    with torch.no_grad():
        acc_mask = (shifted != pad) if mask_pad else torch.ones_like(shifted, dtype=torch.bool)
        hits = (logits.argmax(-1) == shifted) & acc_mask
        acc = (all_reduce_sum(hits.sum(), model.data)
               / all_reduce_sum(acc_mask.sum(), model.data).clamp(min=1))
    return loss, acc


def update(state: TrainState, batch: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
           device, mask_pad: bool = True) -> Dict[str, torch.Tensor]:
    """One update of ``state`` in place on the (images, labels) that
    ``batch()`` makes on ``device``, with the metrics as device scalars.
    While a profile runs, its phases are spans with their device time:
    ``train.forward`` (``batch()``, the forward and the loss),
    ``train.backward`` and ``train.optimizer`` (the data group's gradient
    all-reduce and the optimizer's step)."""
    model = state.model
    with telemetry.span("train.forward", device=device):
        images, labels = batch()
        generator = step_generator(state.seed, state.step, images.device)
        state.optimizer.zero_grad()  # to None: launches nothing
        loss, acc = _loss_and_acc(model, images, labels, mask_pad, generator)
    with telemetry.span("train.backward", device=device):
        loss.backward()
    with telemetry.span("train.optimizer", device=device):
        all_reduce_grads(model.parameters(), model.data)
        state.optimizer.step()
    state.step += 1
    return {"loss": all_reduce_sum(loss.detach(), model.data), "token_acc": acc}


def make_train_step(*, mask_pad: bool = True):
    """(state, images, labels) -> {"loss", "token_acc"}: one update of
    ``state`` in place, with the metrics as device scalars."""

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        return update(state, lambda: (images, labels), images.device, mask_pad)

    return train_step


def make_eval_step(*, mask_pad: bool = True):
    """(model, images, labels) -> the loss, a device scalar, without dropout
    (on a mesh: the global batch's, from this rank's rows)."""

    @torch.no_grad()
    def eval_step(model: OCRModel, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(_loss_and_acc(model, images, labels, mask_pad)[0], model.data)

    return eval_step


def put_batch(images: np.ndarray, labels: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A host batch onto ``device``, without waiting for the copy."""
    return (torch.from_numpy(images).to(device, non_blocking=True),
            torch.from_numpy(labels).to(device, non_blocking=True))
