"""The named process mesh.

The JAX package spans one host's devices with GSPMD and lays them out on a
``data`` x ``model`` mesh. PyTorch runs one process per GPU, so here a mesh
axis counts processes (ranks): rank ``d * model + m`` sits at (d, m), the
row-major order of the JAX package's ``reshape`` of its device list. The
batch is split over ``data``; the attention heads, the MLP's hidden units
and the vocabulary over ``model`` (``parallel/sharding.py``).

With no process group initialised the mesh is 1 x 1 and the port issues no
collective: the single-process path is the one it always was. A process
group of any size, one rank included, takes the distributed path: every
axis of the mesh then has a process group, and the data axis's collectives
run even when it holds one rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_ORDER = ("data", "model")


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of the mesh as this rank sees it: its size, this rank's
    index along it and the process group of the ranks that share this rank's
    other coordinate. ``group`` is None without a process group, and then no
    collective runs."""

    size: int = 1
    rank: int = 0
    group: Optional[dist.ProcessGroup] = None


#: The axis of a single process, and of a layer the model axis does not split.
NO_AXIS = MeshAxis()


def mesh_sizes(spec: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """The axis sizes of ``spec`` over ``n`` processes, by the JAX package's
    rules: -1 fills the rest, at most one -1, a missing axis is 1, and the
    fixed axes must divide ``n`` (with a -1) or fit in it."""
    spec = dict(spec or {"data": -1})
    sizes = {ax: int(spec.get(ax, 1)) for ax in AXIS_ORDER}
    wildcard = [ax for ax, s in sizes.items() if s == -1]
    if len(wildcard) > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = 1
    for s in sizes.values():
        if s != -1:
            fixed *= s
    if wildcard:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[wildcard[0]] = n // fixed
    total = sizes["data"] * sizes["model"]
    if total > n:
        raise ValueError(f"mesh {sizes} wants {total} devices, have {n}")
    return sizes


def create_mesh(spec: Optional[Dict[str, int]] = None, world: Optional[int] = None,
                device=None) -> DeviceMesh:
    """A ``DeviceMesh`` with ``mesh_dim_names=("data", "model")`` from an
    axis -> size dict such as ``{"data": 2, "model": 2}`` (-1: the remaining
    processes; default ``{"data": -1}``).

    Over an initialised process group the mesh spans every rank of it (the
    port runs one mesh over all its processes, so a mesh of fewer ranks than
    the world raises) and builds each axis's process groups. Without one,
    the mesh is over ``world`` processes (default 1) as rank 0 sees them and
    has no process groups: it gives shapes and partition rules, and a 1 x 1
    mesh runs the single-process path. ``device``: the device type the ranks
    compute on (default cpu)."""
    device_type = torch.device(device).type if device is not None else "cpu"
    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    sizes = mesh_sizes(spec, world)
    shape = tuple(sizes[ax] for ax in AXIS_ORDER)
    ranks = torch.arange(shape[0] * shape[1]).view(shape)
    if not initialized:
        return DeviceMesh(device_type, ranks, mesh_dim_names=AXIS_ORDER, _init_backend=False,
                          _rank=0)
    if ranks.numel() != dist.get_world_size():
        raise ValueError(f"mesh {sizes} uses {ranks.numel()} of {dist.get_world_size()} "
                         "processes: the mesh must span the whole process group")
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXIS_ORDER)


def mesh_axis(mesh: Optional[DeviceMesh], name: str) -> MeshAxis:
    """``name``'s axis of ``mesh`` as this rank sees it (``NO_AXIS`` for no
    mesh). A mesh built without a process group has no groups: its axes of
    size 1 run without collectives, and one of more ranks raises."""
    if mesh is None:
        return NO_AXIS
    size = mesh.size(AXIS_ORDER.index(name))
    if not (dist.is_available() and dist.is_initialized()):
        if size > 1:
            raise ValueError(f"the {name} axis of {size} ranks needs a process group: "
                             "initialise one before building the mesh")
        return NO_AXIS
    return MeshAxis(size, mesh.get_local_rank(name), mesh.get_group(name))


def is_main_process() -> bool:
    """Whether this process logs and writes files: rank 0, or the only one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
