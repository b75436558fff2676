"""Multi-process initialisation: one process per GPU.

The JAX package runs one process per host and ``jax.distributed.initialize``
joins the hosts, after which ``jax.devices()`` spans them all. PyTorch runs
one process per GPU, so here ``--num_processes`` counts GPUs (ranks), where
the JAX flag counts hosts. The mesh (``parallel/mesh.py``) then lays those
ranks out on its data x model axes.

Entry points:
- ``torchrun --nproc_per_node N -m texocr_tpu_torch.training.cli --multihost
  ...``: the rank, world size and rendezvous come from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), the counterpart of the JAX package's pod
  auto-detection.
- ``python -m texocr_tpu_torch.training.cli --coordinator host:port
  --num_processes N --process_id I`` in each of N processes.
- library: ``maybe_initialize_distributed(...)`` before building the mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def maybe_initialize_distributed(
    multihost: bool = False,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> bool:
    """Initialises the default process group when multi-process training is
    asked for (``multihost``, or an explicit ``coordinator``); returns
    whether it is initialised. Idempotent: a second call returns True.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU. With
    ``multihost`` alone, torchrun's environment gives the rank, world size
    and rendezvous; ``coordinator`` ("host:port" of process 0),
    ``num_processes`` (the world size: GPUs, not hosts) and ``process_id``
    (this rank) give them explicitly, through ``tcp://host:port``. A group
    that fails to form raises: there is no single-process fallback."""
    if not (multihost or coordinator):
        return False
    if dist.is_initialized():
        return True
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        # Before the group forms: NCCL binds each rank to the current device.
        torch.cuda.set_device(device if device.index is not None
                              else _local_rank(process_id))
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
        return True
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num_processes and --process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def _local_rank(process_id: Optional[int]) -> int:
    """This process's index on its host: torchrun's ``LOCAL_RANK``, else the
    process id (one host), else ``RANK``."""
    for value in (os.environ.get("LOCAL_RANK"), process_id, os.environ.get("RANK")):
        if value is not None:
            return int(value)
    return 0


def local_device(device="cuda") -> torch.device:
    """The device this rank computes on: ``device`` where it names an index
    or is not CUDA; a bare ``cuda`` in a process group is the current CUDA
    device, which ``maybe_initialize_distributed`` set to
    ``cuda:LOCAL_RANK``."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    return torch.device("cuda", torch.cuda.current_device())
