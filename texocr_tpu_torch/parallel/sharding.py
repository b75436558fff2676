"""Parameter and batch sharding rules, in the port's (the reference's)
parameter names and torch layouts (Linear weights are (out, in)).

Tensor-parallel layout, the JAX package's Megatron-style column/row pairs
(``texocr_tpu/parallel/sharding.py``):

- attention ``q``/``k``/``v`` weights (inner, E): COLUMN, split over
  'model' along inner (whole heads per rank).
- attention ``fc_out.0`` weight (2E, inner): ROW, split along inner.
- MLP ``fc_in`` weight (2H or H, E) and bias: COLUMN; MLP ``fc_out``
  weight (E, H): ROW.
- ``token_embedding`` (V, E) and ``to_logits`` weight (V, E): the vocab.
- everything else is replicated: conv and backbone parameters, norms, the
  biases of row-parallel layers and ``to_logits``'s bias.

A dimension that 'model' does not divide stays replicated, as the JAX
package's ``shard_pytree`` leaves it. Two places differ from the JAX
layout, with the same numbers:

- **Whole heads.** GSPMD may split ``inner`` inside a head; the port splits
  attention only by whole heads and replicates q/k/v/fc_out when 'model'
  does not divide the head count.
- **GLU halves.** GEGLU splits its ``fc`` output into contiguous (value,
  gate) halves, so rank m keeps the m-th slice of the value half and the
  m-th slice of the gate half: its local product is then split into its
  own (value, gate) pair by the same ``chunk(2)``. JAX's ``P(None,
  'model')`` gives its shards contiguous columns and GSPMD moves the data.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from texocr_tpu_torch.parallel.mesh import AXIS_ORDER, mesh_axis

#: The head width of every attention layer (``models/attention.py``): the
#: head count of a q/k/v or fc_out weight is its inner width over this.
DIM_HEAD = 64

_ATTENTION = ("q", "k", "v")


def _model_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(AXIS_ORDER.index("model"))


def _is_glu(parts: Sequence[str]) -> bool:
    """GEGLU's dense layer: ``...fc_in.fc.{weight,bias}``."""
    return len(parts) >= 3 and parts[-3] == "fc_in" and parts[-2] == "fc"


def split_dim(key: str, shape: Sequence[int], model: int) -> Optional[int]:
    """The dimension of ``key``'s full tensor of ``shape`` that a 'model'
    axis of ``model`` ranks splits, or None where it stays replicated."""
    parts = key.split(".")
    if len(parts) < 2:
        return None
    leaf, parent = parts[-1], parts[-2]
    grand = parts[-3] if len(parts) >= 3 else ""
    dim, units = None, None
    if leaf == "weight" and len(shape) == 2:
        if parent in _ATTENTION:
            dim, units = 0, shape[0] // DIM_HEAD  # heads
        elif parent == "0" and grand == "fc_out":  # attention's out-projection
            dim, units = 1, shape[1] // DIM_HEAD
        elif parent == "fc_out":  # the MLP's
            dim = 1
        elif grand == "fc_in" and parent in ("fc", "0"):  # GEGLU, dense + gelu
            dim = 0
        elif parent in ("to_logits", "token_embedding"):
            dim = 0
    elif leaf == "bias" and grand == "fc_in" and parent in ("fc", "0"):
        dim = 0
    if dim is None:
        return None
    if units is None:
        units = shape[dim] // 2 if _is_glu(parts) else shape[dim]
    return dim if units % model == 0 else None


def param_partition_spec(key: str, shape: Sequence[int], mesh) -> Tuple[Optional[str], ...]:
    """The partition of ``key``'s full tensor over ``mesh``, a JAX
    ``PartitionSpec`` as a tuple over the torch tensor's dimensions: "model"
    on the split one, None elsewhere; () where it is replicated."""
    dim = split_dim(key, shape, _model_size(mesh))
    if dim is None:
        return ()
    return tuple("model" if i == dim else None for i in range(len(shape)))


def shard_tensor(key: str, full: torch.Tensor, model: int, rank: int) -> torch.Tensor:
    """Model rank ``rank``'s slice of ``key``'s full tensor (the tensor itself
    where it is replicated)."""
    dim = split_dim(key, full.shape, model)
    if dim is None or model == 1:
        return full
    if _is_glu(key.split(".")):
        value, gate = full.chunk(2, dim)
        return torch.cat([value.chunk(model, dim)[rank], gate.chunk(model, dim)[rank]], dim)
    return full.chunk(model, dim)[rank].contiguous()


def place_shard(key: str, local: torch.Tensor, full_shape: Sequence[int], model: int,
                rank: int) -> torch.Tensor:
    """A zero tensor of ``full_shape`` holding model rank ``rank``'s slice
    ``local`` where ``shard_tensor`` took it: the model ranks' placements sum
    to the full tensor, exactly (each element is one slice's value plus
    zeros)."""
    dim = split_dim(key, full_shape, model)
    if dim is None or model == 1:
        return local
    full = local.new_zeros(full_shape)
    width = local.shape[dim]
    if _is_glu(key.split(".")):
        half = full_shape[dim] // 2
        value, gate = local.chunk(2, dim)
        full.narrow(dim, rank * width // 2, width // 2).copy_(value)
        full.narrow(dim, half + rank * width // 2, width // 2).copy_(gate)
    else:
        full.narrow(dim, rank * width, width).copy_(local)
    return full


def _gather(key: str, local: torch.Tensor, full_shape: Sequence[int], axis) -> torch.Tensor:
    """``key``'s full tensor from the model ranks' slices (see
    ``gather_state_dict``)."""
    if axis.size == 1 or split_dim(key, full_shape, axis.size) is None:
        return local
    full = place_shard(key, local, full_shape, axis.size, axis.rank)
    dist.all_reduce(full, group=axis.group)
    return full


def shard_state_dict(full: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of a reference-keyed full state dict."""
    axis = mesh_axis(mesh, "model")
    return {k: shard_tensor(k, v, axis.size, axis.rank) for k, v in full.items()}


def gather_state_dict(local: Dict[str, torch.Tensor], mesh,
                      full_shapes: Dict[str, Sequence[int]]) -> Dict[str, torch.Tensor]:
    """The reference-keyed full state dict from every model rank's slices,
    on every rank: each split tensor is its rank's slice placed in zeros and
    all-reduced over the model group (a sum of one value and zeros, so the
    tensor comes back bit for bit). ``full_shapes``: each key's full shape
    (``OCRModel.full_shapes``), which the slices alone cannot tell: 8 heads
    split 4 ways and 2 replicated heads leave the same local shape. A
    collective: every rank of the model group calls it."""
    axis = mesh_axis(mesh, "model")
    return {k: _gather(k, t, tuple(full_shapes[k]), axis) for k, t in local.items()}


def _map_optimizer_state(state: dict, keys: Sequence[str], fn) -> dict:
    """``state`` (``Optimizer.state_dict()``) with ``fn(key, tensor)`` applied
    to every per-parameter buffer of a parameter's shape (Adam's moments,
    SGD's momentum); scalars such as Adam's step count pass through. State
    named by parameter key (converted from a JAX checkpoint) comes out
    numbered in the order of ``keys``, and must name every key."""
    inner = state["optimizer"]
    named = {k for k in inner["state"] if isinstance(k, str)}
    if named and named != set(keys):
        raise ValueError(f"the optimizer state names {sorted(named - set(keys))[:3]} that the "
                         f"model lacks and lacks {sorted(set(keys) - named)[:3]}")
    position = {k: i for i, k in enumerate(keys)}
    per_param = {}
    for index, buffers in inner["state"].items():
        key = index if named else keys[index]
        per_param[position[key]] = {name: fn(key, t) if torch.is_tensor(t) and t.dim() > 0 else t
                            for name, t in buffers.items()}
    return {**state, "optimizer": {**inner, "state": per_param}}


def shard_optimizer_state(state: dict, keys: Sequence[str], mesh) -> dict:
    """This rank's slices of a full optimizer state. ``keys``: the parameter
    name of each optimizer index (``OCRModel.parameter_keys()``)."""
    axis = mesh_axis(mesh, "model")
    return _map_optimizer_state(state, keys,
                                lambda k, t: shard_tensor(k, t, axis.size, axis.rank))


def gather_optimizer_state(state: dict, keys: Sequence[str], mesh,
                           full_shapes: Dict[str, Sequence[int]]) -> dict:
    """The full optimizer state from every model rank's slices, as
    ``gather_state_dict`` gathers parameters. A collective."""
    axis = mesh_axis(mesh, "model")
    return _map_optimizer_state(state, keys,
                                lambda k, t: _gather(k, t, tuple(full_shapes[k]), axis))


def batch_rows(n: int, mesh) -> slice:
    """This data rank's rows of a global batch of ``n`` rows: the
    counterpart of the JAX package's ``batch_sharding``, whose
    ``device_put`` also refuses a batch the data axis does not divide."""
    data = mesh_axis(mesh, "data")
    if n % data.size:
        raise ValueError(f"a batch of {n} rows does not split over {data.size} data ranks")
    per = n // data.size
    return slice(data.rank * per, (data.rank + 1) * per)
