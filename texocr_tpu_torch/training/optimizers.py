"""Optimizers by config name, over ``torch.optim``, with the update rules of
the JAX package's optax chains.

- ``Adam``: ``torch.optim.Adam``, whose ``weight_decay`` is L2 added to the
  gradient before the moments (coupled), as optax's ``add_decayed_weights``
  before ``scale_by_adam`` is.
- ``AdamW``: ``torch.optim.AdamW`` (decoupled decay, ``optax.adamw``).
- ``SGD``: ``torch.optim.SGD`` with optional momentum, whose first step takes
  the gradient itself as the buffer, as ``optax.trace`` does.

``lr_schedule`` (``{"warmup_steps": W, "decay_steps": D, "end_value": E}``)
is ``optax.warmup_cosine_decay_schedule``'s formula as a ``LambdaLR``: linear
from 0 to ``lr`` over W steps, then a cosine to E over D - W steps (D counts
the warmup), held at E after. ``grad_clip`` scales the gradients by
``min(1, c / global_norm)`` before the update, as ``optax.clip_by_global_norm``
does (no epsilon in the norm), on the device without a host sync. Under
tensor parallelism the norm is the full gradient's: the squared norms of the
split parameters (marked ``tensor_model_parallel``) are summed over the
model group, and the replicated ones counted once.

Every trainable parameter takes part in every step, as every leaf does in
optax: one the forward did not read (the encoder of a decoder without
cross-attention) has a ``None`` gradient, which ``step`` makes zeros, so
weight decay moves it as JAX's optimizer does. The train step all-reduces
the gradients before ``step``, so those zeros never cross the data group.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch

from texocr_tpu_torch.parallel.layers import all_reduce_sum
from texocr_tpu_torch.parallel.mesh import NO_AXIS, MeshAxis


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps, decay_steps,
    end_value) as a function of the update count."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak == 0.0 else end_value / peak
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:  # linear_schedule(0, peak, warmup_steps)
            return peak * count / warmup_steps
        count = min(count - warmup_steps, cosine_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / cosine_steps)) + alpha
        return peak * decayed

    return schedule


class Optimizer:
    """A ``torch.optim`` optimizer with the optax chain's global-norm clip
    before it and its learning-rate schedule after it. ``step()`` applies one
    update from the parameters' ``.grad``. ``model_axis``: the model group
    whose ranks hold the other slices of the split parameters."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None,
                 grad_clip: Optional[float] = None, model_axis: MeshAxis = NO_AXIS):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.grad_clip = grad_clip
        self.model_axis = model_axis

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None and p.requires_grad:
                    p.grad = torch.zeros_like(p)
        if self.grad_clip:
            params = [p for group in self.optimizer.param_groups for p in group["params"]
                      if p.grad is not None]
            split = [p.grad for p in params if getattr(p, "tensor_model_parallel", False)]
            whole = [p.grad for p in params if not getattr(p, "tensor_model_parallel", False)]
            clip_by_global_norm(whole, self.grad_clip, split, self.model_axis)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dict(self) -> Dict:
        state = {"optimizer": self.optimizer.state_dict()}
        if self.scheduler is not None:
            state["scheduler"] = self.scheduler.state_dict()
        return state

    def load_state_dict(self, state: Dict) -> None:
        """Loads ``state_dict()``'s payload, or one converted from a JAX
        checkpoint (``checkpoint.convert.optimizer_state_from_jax``), which
        has no param groups (this optimizer keeps its own hyperparameters)
        and gives the schedule as its position alone."""
        inner = state["optimizer"]
        if "param_groups" not in inner:
            inner = {**inner, "param_groups": self.optimizer.state_dict()["param_groups"]}
        self.optimizer.load_state_dict(inner)
        schedule = state.get("scheduler")
        if (self.scheduler is None) != (schedule is None):
            raise ValueError("the checkpoint's optimizer state and this optimizer disagree on "
                             "having a learning-rate schedule")
        if self.scheduler is None:
            return
        if "base_lrs" not in schedule:  # the position alone: this schedule's rates there
            count = int(schedule["last_epoch"])
            lrs = [base * fn(count) for base, fn in zip(self.scheduler.base_lrs,
                                                         self.scheduler.lr_lambdas)]
            schedule = {**self.scheduler.state_dict(), "last_epoch": count, "_last_lr": lrs}
            for group, lr in zip(self.optimizer.param_groups, lrs):
                group["lr"] = lr
        self.scheduler.load_state_dict(schedule)


def clip_by_global_norm(grads, max_norm: float, split=(),
                        model_axis: MeshAxis = NO_AXIS) -> None:
    """Scales ``grads`` and ``split`` in place by ``max_norm / norm`` where
    their global L2 norm is at least ``max_norm`` (optax.clip_by_global_norm).
    ``grads``: gradients of replicated parameters, counted once; ``split``:
    this rank's slices of parameters split over ``model_axis``, whose squared
    norms are summed over it."""
    grads, split = list(grads), list(split)
    if model_axis.group is None:
        grads += split
        if not grads:
            return
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    else:
        device = (grads + split)[0].device

        def squares(gs):
            norms = [torch.linalg.vector_norm(g.float()) for g in gs]
            return torch.stack(norms).square().sum() if norms else torch.zeros((), device=device)

        norm = torch.sqrt(squares(grads) + all_reduce_sum(squares(split), model_axis))
        grads += split
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def get_optimizer(name: str, args: dict, params: Iterable[torch.nn.Parameter],
                  model_axis: MeshAxis = NO_AXIS) -> Optimizer:
    """'Adam' / 'AdamW' / 'SGD' with torch-style arguments (``lr``,
    ``weight_decay``, ``betas``, ``eps``, ``momentum``, and ``lr_schedule``
    and ``grad_clip`` as the module docstring says) over ``params``, some
    of them split over ``model_axis`` (a sharded model's ``tp``)."""
    args = dict(args)
    lr = args.pop("lr", 1e-3)
    grad_clip = args.pop("grad_clip", None)
    sched = args.pop("lr_schedule", None)
    weight_decay = args.pop("weight_decay", 0.0)
    betas = tuple(args.pop("betas", (0.9, 0.999)))
    eps = args.pop("eps", 1e-8)
    params = list(params)
    kind = name.lower()
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    elif kind == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=args.pop("momentum", 0.0),
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer: {name!r}")
    scheduler = None
    if sched:
        schedule = warmup_cosine_decay(lr, int(sched.get("warmup_steps", 0)),
                                       int(sched["decay_steps"]),
                                       float(sched.get("end_value", 0.0)))
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: schedule(count) / lr if lr else 0.0)
    return Optimizer(opt, scheduler, float(grad_clip) if grad_clip else None, model_axis)
