"""Sequence losses.

The reference trains with an UNMASKED cross entropy: pad positions count in
the loss. ``mask_pad=False`` reproduces that exactly; the default masks pads
out, as the JAX package's does.
"""

from __future__ import annotations

import torch


def sequence_ce_loss(logits: torch.Tensor, labels: torch.Tensor, *, pad_token: int,
                     mask_pad: bool = True) -> torch.Tensor:
    """Mean token cross entropy, a float32 scalar.

    logits: (B, T, V); labels: (B, T) int. Log-softmax in float32.
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if not mask_pad:
        return nll.mean()
    mask = (labels != pad_token).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def get_loss_fn(name: str):
    """The loss named by ``config['loss_fn']``; only CrossEntropyLoss exists."""
    if name in ("CrossEntropyLoss", "cross_entropy"):
        return sequence_ce_loss
    raise ValueError(f"unknown loss_fn: {name!r}")
