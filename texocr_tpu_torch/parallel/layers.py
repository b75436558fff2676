"""Tensor-parallel layers with explicit collectives, Megatron style.

Every function here takes the ``MeshAxis`` it reduces over and, where that
axis has no process group (one process, or a layer the model axis leaves
whole), returns what the plain layer returns, on the same code path. Only
``all_reduce``, ``broadcast`` and ``barrier`` are used: they are the
collectives that gloo runs on CUDA tensors as well as NCCL does, so two
ranks can share one card over gloo.

- ``copy_to_model``: identity forward, all-reduce of the gradient backward.
  A replicated activation enters a column-parallel layer through it: each
  rank's gradient of it is a partial sum over that rank's columns.
- ``reduce_from_model``: all-reduce forward, identity backward: the partial
  products of a row-parallel layer summed into the replicated output.
- ``gather_from_model``: a vocab-parallel tensor (..., V / m) made whole
  (..., V) by an all-reduce of a zero-filled tensor holding this rank's
  columns; the backward keeps this rank's columns of the (replicated)
  gradient.

Row-parallel layers add their bias once, after the sum, never on every
rank; ``to_logits`` likewise after the gather.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
import torch.nn.functional as F

from texocr_tpu_torch import telemetry
from texocr_tpu_torch.parallel.mesh import MeshAxis

#: Gradient bytes per all-reduce of the data-parallel step: a few
#: collectives a step (the flagship's 100 MB of float32 gradients in 4).
BUCKET_BYTES = 32 << 20

#: The span names of the collectives in a profiler trace: the model group's
#: activations, the data group's gradients, the global counts and metrics,
#: and the decode's tokens.
MODEL_SPAN = "tp_all_reduce"
GRAD_SPAN = "grad_all_reduce"
SUM_SPAN = "sum_all_reduce"
ROWS_SPAN = "gather_rows"


def _all_reduce(x: torch.Tensor, axis: MeshAxis, span: str = MODEL_SPAN) -> torch.Tensor:
    with telemetry.span(span):
        dist.all_reduce(x, group=axis.group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        width = x.shape[-1]
        ctx.axis, ctx.width = axis, width
        full = x.new_zeros(*x.shape[:-1], width * axis.size)
        full[..., axis.rank * width: (axis.rank + 1) * width] = x
        return _all_reduce(full, axis)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.axis.rank * ctx.width
        return grad[..., lo: lo + ctx.width], None


def copy_to_model(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return x if axis.group is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return x if axis.group is None else _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    return x if axis.group is None else _GatherFromModel.apply(x, axis)


def row_parallel(dense, x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``dense`` (a ``TorchDense`` holding this rank's input columns) on
    this rank's slice ``x`` of its input: the partial products summed over
    the model group, then the (replicated) bias added once."""
    if axis.group is None:
        return dense(x)
    y = reduce_from_model(F.linear(x.to(dense.dtype), dense.weight.to(dense.dtype)), axis)
    return y if dense.bias is None else y + dense.bias.to(dense.dtype)


def vocab_parallel_logits(dense, x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``dense`` holding this rank's vocab rows of the output projection:
    the whole (..., V) logits on every model rank, the bias added after the
    gather."""
    if axis.group is None:
        return dense(x)
    local = F.linear(copy_to_model(x, axis).to(dense.dtype), dense.weight.to(dense.dtype))
    y = gather_from_model(local, axis)
    return y if dense.bias is None else y + dense.bias.to(dense.dtype)


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             axis: MeshAxis) -> torch.Tensor:
    """Rows ``ids`` of an embedding table whose vocab rows are split over
    the model group (``weight``: this rank's rows): each rank looks up the
    ids in its range, zeros the rest, and the all-reduce sums the one row
    per id."""
    if axis.group is None:
        return F.embedding(ids, weight)
    rows = weight.shape[0]
    local = ids - axis.rank * rows
    inside = (local >= 0) & (local < rows)
    emb = F.embedding(torch.where(inside, local, torch.zeros_like(local)), weight)
    emb = torch.where(inside[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))
    return reduce_from_model(emb, axis)


def all_reduce_sum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor; ``x`` itself without a
    process group). No gradient flows through it: for metrics and counts."""
    if axis.group is None:
        return x
    return _all_reduce(x.detach().clone(), axis, SUM_SPAN)


def all_reduce_grads(params, axis: MeshAxis, bucket_bytes: int = BUCKET_BYTES) -> int:
    """Sums every parameter's gradient over ``axis`` (the data group) in
    place, in flat buckets of about ``bucket_bytes`` (one collective each,
    not one per parameter). Parameters without a gradient are skipped; every
    rank has the same ones. Returns the bytes reduced (0 without a group)."""
    if axis.group is None:
        return 0
    grads = [p.grad for p in params if p.grad is not None]
    total = 0
    bucket: List[torch.Tensor] = []
    size = 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        last = i == len(grads) - 1
        if size >= bucket_bytes or last or grads[i + 1].dtype != g.dtype:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            _all_reduce(flat, axis, GRAD_SPAN)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset: offset + t.numel()].view_as(t))
                offset += t.numel()
            total += size
            bucket, size = [], 0
    return total


def gather_rows(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The whole (B, ...) tensor from each data rank's equal block of rows
    ``x`` (B / data, ...), on every rank: this rank's block placed in zeros
    and all-reduced over ``axis``."""
    if axis.group is None:
        return x
    per = x.shape[0]
    full = x.new_zeros(per * axis.size, *x.shape[1:])
    full[axis.rank * per: (axis.rank + 1) * per] = x
    return _all_reduce(full, axis, ROWS_SPAN)
