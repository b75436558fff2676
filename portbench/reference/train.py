"""Training in plain PyTorch, float32: the yardstick of the training cells.

The teacher-forced forward of ``model.py`` over a batch of (image, label
row) pairs, the mean cross entropy over the label tokens that are not PAD,
the backward, and Adam (bias-corrected moments, eps outside the square
root, no weight decay). A batch is processed in blocks of rows whose
losses are divided by the whole batch's token count, so the gradients are
the whole batch's while the activations of one block fit.

The embed dropout follows the training recipe: each step's keep mask is a
uniform draw of the batch's (B, T, D) shape from a generator seeded from
(seed, step), kept where it is below 1 - rate, as the trainer's recipe
states; ``seeded_generator`` below is that recipe.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import model as ref

#: The trainer's stream tag of a bucket's epoch permutation.
PERM_TAG = 0x5E1EC7


def seeded_generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` through
    ``np.random.SeedSequence``."""
    key = int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key)


def epoch_permutation(n: int, seed: int, epoch: int, bucket: tuple, device) -> torch.Tensor:
    """The order in which an epoch walks a bucket's ``n`` rows."""
    tag = bucket[0] * 4096 + bucket[1]
    return torch.randperm(n, generator=seeded_generator(device, seed, epoch, tag, PERM_TAG),
                          device=device)


def label_rows(token_ids: Sequence[Sequence[int]], arch: ref.Arch, multiple: int) -> np.ndarray:
    """[BOS, tokens, EOS, PAD...] rows as long as the longest + 2, rounded up
    to ``multiple``."""
    width = -(-(max(len(s) for s in token_ids) + 2) // multiple) * multiple
    out = np.full((len(token_ids), width), arch.pad, np.int64)
    for i, s in enumerate(token_ids):
        out[i, 0] = arch.bos
        out[i, 1: len(s) + 1] = s
        out[i, len(s) + 1] = arch.eos
    return out


def batch_loss(p: ref.Params, arch: ref.Arch, images: torch.Tensor, labels: torch.Tensor,
               keep: Optional[torch.Tensor], prec: ref.Precision, block: int,
               backward: bool) -> float:
    """The mean masked cross entropy of one batch, (B, H, W) uint8 images
    and (B, L) label rows; with ``backward`` the parameters' ``.grad``
    receive its gradient, accumulated block by block."""
    target = labels[:, 1:]
    count = (target != arch.pad).sum().clamp(min=1).float()
    total = 0.0
    for lo in range(0, labels.shape[0], block):
        rows = slice(lo, lo + block)
        with torch.set_grad_enabled(backward):
            enc = ref.encode(ref.model_input(images[rows]), p, arch, prec)
            inp = labels[rows, :-1]
            logits = ref.decode_logits(inp, enc, p, arch, prec, mask=inp != arch.pad,
                                       keep=None if keep is None else keep[rows])
            tgt = target[rows]
            nll = -torch.gather(torch.log_softmax(logits, -1), -1, tgt[..., None])[..., 0]
            loss = (nll * (tgt != arch.pad)).sum() / count
        if backward:
            loss.backward()
        total += float(loss.detach())
        del enc, logits, nll, loss
    return total


def train_steps(params: ref.Params, arch: ref.Arch, batches: List[tuple], *, seed: int,
                lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                prec: ref.Precision = ref.FLOAT32, block: int = 16) -> Dict[str, object]:
    """Adam steps from ``params`` over ``batches`` [(images, labels)], step
    s drawing its dropout from (seed, s). Returns each step's loss, the
    first step's gradient of each parameter, and the norm of each
    parameter's change after the last step, by ``ref.leaves`` key."""
    keys = ref.leaves(arch)
    leaf = {k: params[k].detach().clone().requires_grad_(True) for k in keys}
    _, alias = ref.param_spec(arch)
    p = dict(leaf)
    for a, src in alias.items():
        p[a] = leaf[src]
    m = {k: torch.zeros_like(v) for k, v in leaf.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaf.items()}
    losses, grad1 = [], {}
    for s, (images, labels) in enumerate(batches):
        keep = None
        if arch.dropout > 0:
            shape = (labels.shape[0], labels.shape[1] - 1, arch.dec_dim)
            keep = torch.rand(shape, generator=seeded_generator(images.device, seed, s),
                              device=images.device) < 1.0 - arch.dropout
        for t in leaf.values():
            t.grad = None
        losses.append(batch_loss(p, arch, images, labels, keep, prec, block, backward=True))
        with torch.no_grad():
            if s == 0:
                grad1 = {k: t.grad.clone() for k, t in leaf.items()}
            b1, b2 = betas
            c1, c2 = 1 - b1 ** (s + 1), 1 - b2 ** (s + 1)
            for k, t in leaf.items():
                g = t.grad
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(c2)).add_(eps)
                t.addcdiv_(m[k], denom, value=-lr / c1)
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(leaf[k] - params[k])) for k in keys}
    return {"losses": losses, "grad1": grad1, "change": change}
