"""Sequence losses.

The reference trains with an UNMASKED cross entropy: pad positions count in
the loss. ``mask_pad=False`` reproduces that exactly; the default masks pads
out, as the JAX package's does.

Under data parallelism the loss is the global batch's: each data rank
divides its own sum by the global count (the all-reduced mask sum, or
B * T over every rank unmasked), so the ranks' losses, and their gradients,
sum to the global loss's. A mean of per-rank means would weigh a rank's
tokens by its own pad count.
"""

from __future__ import annotations

import torch

from texocr_tpu_torch.parallel.layers import all_reduce_sum
from texocr_tpu_torch.parallel.mesh import NO_AXIS, MeshAxis


def sequence_ce_loss(logits: torch.Tensor, labels: torch.Tensor, *, pad_token: int,
                     mask_pad: bool = True, data: MeshAxis = NO_AXIS) -> torch.Tensor:
    """Mean token cross entropy, a float32 scalar.

    logits: (B, T, V); labels: (B, T) int. Log-softmax in float32. ``data``:
    the data axis whose ranks hold the other rows of the batch; this rank's
    share of the global mean is returned (the all-reduce of the shares is
    the global loss)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if not mask_pad:
        if data.group is None:
            return nll.mean()
        return nll.sum() / (nll.numel() * data.size)
    mask = (labels != pad_token).float()
    return (nll * mask).sum() / all_reduce_sum(mask.sum(), data).clamp(min=1.0)


def get_loss_fn(name: str):
    """The loss named by ``config['loss_fn']``; only CrossEntropyLoss exists."""
    if name in ("CrossEntropyLoss", "cross_entropy"):
        return sequence_ce_loss
    raise ValueError(f"unknown loss_fn: {name!r}")
