"""The rank programs that the parallel tests (``test_torch_port_parallel*.py``)
spawn through ``texocr_tpu_torch.parallel.dryrun.spawn``. No tests here: the
ranks import only torch, numpy and the port (not JAX), and take every input
(config, weights, batches) from the parent. Called in the parent without a
process group, a program runs the single-process port."""

import shutil

import torch
import torch.distributed as dist

from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.models.generate import mesh_generate, mesh_greedy_decode
from texocr_tpu_torch.parallel.mesh import create_mesh
from texocr_tpu_torch.parallel.sharding import batch_rows, gather_state_dict, shard_state_dict
from texocr_tpu_torch.training.device_data import make_chunk_train_step
from texocr_tpu_torch.training.optimizers import get_optimizer
from texocr_tpu_torch.training.train_step import create_train_state, make_train_step


def _rank0(value):
    return value if not dist.is_initialized() or dist.get_rank() == 0 else None


def _model(spec, config, weights):
    mesh = create_mesh(spec)
    model = OCRModel(ModelConfig.from_dict(config), device="cpu", mesh=mesh)
    model.load_state_dict(shard_state_dict(weights, mesh), strict=True)
    return mesh, model


def train_steps(spec, config, weights, batches, opt_args):
    """Adam steps on ``batches`` (global (images, labels) pairs) from
    ``weights`` on ``spec``'s mesh: each step's global (loss, token
    accuracy), whether the gathered initial weights were ``weights`` bit for
    bit, and (rank 0) the gathered weights after the steps."""
    mesh, model = _model(spec, config, weights)
    initial = gather_state_dict(model.state_dict(), mesh, model.full_shapes)
    round_trip = all(torch.equal(initial[k], v) for k, v in weights.items())
    state = create_train_state(
        model, get_optimizer("Adam", opt_args, model.parameters(), model.tp), seed=0)
    step = make_train_step()
    metrics = []
    for images, labels in batches:
        rows = batch_rows(len(images), mesh)
        m = step(state, torch.from_numpy(images[rows]), torch.from_numpy(labels[rows]))
        metrics.append((float(m["loss"]), float(m["token_acc"])))
    final = gather_state_dict(model.state_dict(), mesh, model.full_shapes)
    return {"metrics": metrics, "round_trip": round_trip,
            "weights": _rank0({k: v.clone() for k, v in final.items()})}


def greedy(spec, config, weights, images, max_len):
    """``mesh_greedy_decode`` of all of ``images`` on ``spec``'s mesh."""
    mesh, model = _model(spec, config, weights)
    return mesh_greedy_decode(model, torch.from_numpy(images), mesh, max_len=max_len).numpy()


def decode(spec, config, weights, images, max_len, mode, seed=0, beam_size=3):
    """``mesh_generate`` of all of ``images`` in ``mode`` on ``spec``'s mesh
    (sampling from a generator seeded with ``seed`` on every rank); a
    ``ValueError``'s message in place of the tokens."""
    mesh, model = _model(spec, config, weights)
    generator = torch.Generator().manual_seed(seed)
    try:
        tokens = mesh_generate(model, torch.from_numpy(images), mesh, max_len=max_len,
                               mode=mode, generator=generator, beam_size=beam_size)
    except ValueError as e:
        return str(e)
    return tokens.numpy()


def graphs(spec, config, weights):
    """The error ``make_graphed_generate`` raises on ``spec``'s mesh, as
    (type name, message)."""
    from texocr_tpu_torch.models.graphed import make_graphed_generate

    _, model = _model(spec, config, weights)
    try:
        make_graphed_generate(model, 1, (32, 64), 4)
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def world_program(runs):
    """Each (program name, args) of ``runs`` in order, on this rank; the
    results in a list."""
    return [globals()[name](*args) for name, args in runs]


def resident_chunk(spec, config, weights, bucket, perm, batch, n_steps):
    """One call of the resident train runner (augmentation on): the
    chunk's mean (loss, token accuracy) and, rank 0, the gathered weights."""
    mesh, model = _model(spec, config, weights)
    state = create_train_state(
        model, get_optimizer("Adam", {"lr": 1e-3}, model.parameters(), model.tp), seed=5)
    run = make_chunk_train_step(batch, augment=True, rows=batch_rows(batch, mesh))
    m = run(state, bucket, torch.from_numpy(perm), n_steps, 0)
    final = gather_state_dict(model.state_dict(), mesh, model.full_shapes)
    return {"metrics": (float(m["loss"]), float(m["token_acc"])),
            "weights": _rank0({k: v.clone() for k, v in final.items()})}


def checkpoint_then_resume(train_set, config, first_dir, resume_dir):
    """``train_model`` for one epoch under {model: 2} into ``first_dir``;
    rank 0 copies it to ``resume_dir``; then a resume there to two epochs
    under {data: 2}. Returns both runs' epoch losses."""
    from texocr_tpu_torch.training.loop import train_model

    first = train_model(train_set, None, dict(config, mesh={"model": 2}, n_epochs=1,
                                              save_dir=first_dir), verbose=False, device="cpu")
    if dist.get_rank() == 0:
        shutil.copytree(first_dir, resume_dir)
    dist.barrier()
    resumed = train_model(train_set, None, dict(config, mesh={"data": 2}, n_epochs=2,
                                                save_dir=resume_dir, resume=True),
                          verbose=False, device="cpu")
    return {"first": first[2], "resumed": resumed[2], "step": resumed[1].step}
