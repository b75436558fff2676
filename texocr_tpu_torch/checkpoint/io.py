"""Training checkpoints: model and optimizer state, epoch and step.

The JAX package's cadence and directory naming (``save_dir/checkpoint_e{epoch}``,
the highest epoch is the latest), stored with ``torch.save`` as one
``state.pt`` in that directory and read back with
``torch.load(weights_only=True)``: tensors, numbers, strings and plain
containers only. The JAX package's checkpoints are orbax directories; the
port reads their params from the ``params_cache.msgpack`` beside them
(``convert.load_jax_params``). ``load_weights`` takes any of these.

Checkpoints are mesh-independent: on a process mesh the training loop saves
the full, reference-keyed model and optimizer state gathered from the model
ranks' slices (rank 0 writes), and on load each rank takes its slices
(``parallel/sharding.py``). A checkpoint of any mesh loads into one process.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from texocr_tpu_torch.checkpoint.convert import JAX_PARAMS_CACHE, load_jax_params, load_state

STATE_FILE = "state.pt"


def _path(save_dir: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(save_dir, f"checkpoint_e{epoch}"))


def save_checkpoint(save_dir: str, epoch: int, model_state: Dict[str, torch.Tensor],
                    optimizer_state: Optional[dict] = None, extra: Optional[dict] = None) -> str:
    """Writes ``save_dir/checkpoint_e{epoch}/state.pt`` (through a temporary
    file and a rename) and returns the directory."""
    path = _path(save_dir, epoch)
    os.makedirs(path, exist_ok=True)
    payload = {"model": model_state, "epoch": epoch}
    if optimizer_state is not None:
        payload["optimizer"] = optimizer_state
    if extra:
        payload.update(extra)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def load_checkpoint(path: str) -> dict:
    """The payload of a checkpoint directory, on the CPU."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The highest-epoch ``checkpoint_e*`` directory of ``save_dir``, or None."""
    if not os.path.isdir(save_dir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(save_dir):
        if name.startswith("checkpoint_e"):
            try:
                epoch = int(name[len("checkpoint_e"):])
            except ValueError:
                continue
            if epoch > best_epoch:
                best, best_epoch = os.path.join(save_dir, name), epoch
    return best


def warm_start_params(restored: Dict[str, torch.Tensor],
                      target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``restored`` adapted onto ``target``'s shapes, for fine-tuning.

    A tensor of ``target``'s shape is taken from ``restored`` (in the target's
    dtype). One that differs along exactly one axis (in practice the decoder's
    positional table, whose length follows the dataset's max_length) keeps the
    target's values with the overlap overwritten by the restored ones, in
    either direction. Any other mismatch, or a key ``restored`` lacks, keeps
    the target's tensor."""
    out = {}
    for key, t in target.items():
        r = restored.get(key)
        if r is None or r.dim() != t.dim():
            out[key] = t
            continue
        diff = [i for i in range(t.dim()) if r.shape[i] != t.shape[i]]
        if not diff:
            out[key] = r.to(dtype=t.dtype, device=t.device)
        elif len(diff) == 1:
            n = min(r.shape[diff[0]], t.shape[diff[0]])
            merged = t.clone()
            merged.narrow(diff[0], 0, n).copy_(r.narrow(diff[0], 0, n))
            out[key] = merged
        else:
            out[key] = t
    return out


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """Reference-keyed weights from any checkpoint the port reads: a state
    dict file (``.pth``/``.pt``/``.npz``), a JAX ``params_cache.msgpack``, a
    checkpoint directory of the port's trainer (``state.pt``) or of the JAX
    package's (its ``params_cache.msgpack``), or a ``save_dir`` of either
    (its latest epoch). A directory that holds none of these raises
    ``ValueError``, as ``convert.load_jax_params`` says."""
    path = str(path)
    if not os.path.isdir(path):
        return load_jax_params(path) if path.endswith(".msgpack") else load_state(path)
    if not any(os.path.exists(os.path.join(path, f)) for f in (STATE_FILE, JAX_PARAMS_CACHE)):
        path = latest_checkpoint(path) or path
    if os.path.exists(os.path.join(path, STATE_FILE)):
        return load_checkpoint(path)["model"]
    return load_jax_params(path)
