"""A launcher for a process group of spawned ranks, and the multi-process dry
run (the counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``).

``spawn(fn, world, args)`` starts ``world`` processes with the ``spawn``
method; they form a gloo process group through a ``file://`` store (no TCP
port is picked, so launches side by side cannot collide), each runs
``fn(*args)`` with one torch thread, and the parent gets each rank's result
in rank order. Gloo runs ``all_reduce``, ``broadcast`` and ``barrier`` on CUDA
tensors too, so several ranks can share one card. ``fn`` is a module-level
function of the port: the children import only what its module imports.

``dryrun_multichip(n)``: the flagship architecture at the JAX dry run's tiny
shapes (32 x 64 images, 16 labels, ``max_length`` 64, float32) on the mesh
``{data: n / 2, model: 2}`` for even n >= 4, else ``{data: n}``: one Adam step
on a batch of max(2 * data, 4), then 8 greedy steps under the same mesh. It
runs on the card unless ``device="cpu"`` is passed:

    python -c "from texocr_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4, device='cpu')"
"""

from __future__ import annotations

import os
import pickle
import queue as queue_module
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from texocr_tpu_torch.config import FLAGSHIP, ModelConfig
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.models.generate import mesh_greedy_decode
from texocr_tpu_torch.parallel.mesh import create_mesh
from texocr_tpu_torch.parallel.sharding import batch_rows
from texocr_tpu_torch.training.optimizers import get_optimizer
from texocr_tpu_torch.training.train_step import create_train_state, make_train_step


def _rank_main(rank: int, world: int, store: str, fn: Callable, args: Sequence,
               results) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # By value: torch's queue would share tensors through file descriptors
    # that die with this process.
    results.put((rank, True, pickle.dumps(value)))


def spawn(fn: Callable, world: int, args: Sequence = (), store_dir: Optional[str] = None,
          timeout: float = 900.0) -> list:
    """``fn(*args)`` on each of ``world`` spawned ranks of a gloo process
    group; returns their results in rank order. The group's ``file://``
    store lives in a new directory under ``store_dir`` (default: the
    temporary directory). A rank that raises or dies, or a run longer than
    ``timeout`` seconds, raises ``RuntimeError`` (with the rank's traceback),
    and every rank still running is stopped."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(rank, world, store, fn, tuple(args),
                                                      results))
                 for rank in range(world)]
        for p in procs:
            p.start()
        out = {}
        try:
            deadline = time.monotonic() + timeout
            while len(out) < world:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_module.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode}") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"ranks {sorted(set(range(world)) - set(out))} "
                                           f"did not finish in {timeout:.0f} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = pickle.loads(value)
        finally:
            for p in procs:
                p.join(timeout=30 if len(out) == world else 1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [out[r] for r in range(world)]


def _dryrun_rank(spec: dict, device) -> dict:
    device = torch.device(device)
    if device.type == "cuda":  # before the mesh, which would guess it
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    mesh = create_mesh(spec, device=device)
    config = ModelConfig.from_dict(dict(FLAGSHIP, max_length=64, dtype="float32"))
    model = OCRModel(config, device=device, seed=0, mesh=mesh)
    rng = np.random.default_rng(0)
    batch = max(2 * spec["data"], 4)
    images = rng.normal(size=(batch, 32, 64, 1)).astype(np.float32)
    labels = rng.integers(0, 900, size=(batch, 16)).astype(np.int32)
    labels[:, 0] = config.bos_token
    labels[:, -1] = config.pad_token
    state = create_train_state(
        model, get_optimizer("Adam", {"lr": 5e-4}, model.parameters(), model.tp), seed=0)
    rows = batch_rows(batch, mesh)
    metrics = make_train_step()(state, torch.from_numpy(images[rows]).to(device),
                                torch.from_numpy(labels[rows]).to(device))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss in the multichip dry run: {loss}")
    tokens = mesh_greedy_decode(model, torch.from_numpy(images).to(device), mesh, max_len=8)
    if tokens.shape != (batch, 8):
        raise AssertionError(f"decode shape {tuple(tokens.shape)}")
    if not ((tokens >= 0) & (tokens < config.decoder.vocab_size)).all():
        raise AssertionError("decoded ids outside the vocabulary")
    return {"loss": loss, "step": state.step, "tokens": tokens.cpu().numpy()}


def dryrun_multichip(n_devices: int, device="cuda", store_dir: Optional[str] = None) -> dict:
    """The training step and greedy decode of the flagship on ``n_devices``
    spawned ranks (see the module docstring) on ``device`` (each rank on the
    current card for "cuda"); prints an OK line and returns rank 0's loss,
    step count and the gathered tokens."""
    model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    spec = {"data": n_devices // model, "model": model}
    result = spawn(_dryrun_rank, n_devices, (spec, device), store_dir)[0]
    print(f"dryrun_multichip OK: mesh={spec}, loss={result['loss']:.4f}, "
          f"step={result['step']}, sharded greedy decode {tuple(result['tokens'].shape)} ok",
          flush=True)
    return result
