"""The training loop: epochs over the shape-bucketed host loader, the train
step on the device, and the checkpoint and validation cadence of the config.

With ``device_data: true`` the dataset is resident on the device instead
(``training/device_data.py``): each epoch is a plan of calls, each running up
to ``device_data_steps_per_call`` steps from one bucket, interleaved across
buckets in an order shuffled per epoch.

The device is synchronised once per epoch: metrics add up as device scalars
and are read after the epoch's last step, so the host queues steps ahead of
the device.

On a process group the config's ``mesh`` (default ``{data: -1, model: 1}``)
lays the ranks out (``parallel/``): every rank loads the same global batch
(the same seeds and shuffles) and trains on its data rank's rows; a batch
the data axis does not divide raises. Losses and validation are the global
batch's. Rank 0 alone logs, writes metrics and writes checkpoints, which
hold the full, reference-keyed model and optimizer state: a checkpoint
loads on any mesh, and into a single-process ``OCRModel``.
"""

from __future__ import annotations

import math
import random
import time
from typing import Optional

import torch

from texocr_tpu_torch.checkpoint.io import (
    latest_checkpoint,
    load_checkpoint,
    load_weights,
    save_checkpoint,
    warm_start_params,
)
from texocr_tpu_torch.config import ModelConfig, TrainConfig, with_defaults
from texocr_tpu_torch.data.dataset import ImageDataset, create_dataloader, prefetch
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.parallel.mesh import create_mesh, is_main_process
from texocr_tpu_torch.parallel.sharding import (
    batch_rows,
    gather_optimizer_state,
    gather_state_dict,
    shard_optimizer_state,
    shard_state_dict,
)
from texocr_tpu_torch.telemetry import MetricsLogger
from texocr_tpu_torch.training.device_data import (
    DeviceResidentData,
    epoch_permutation,
    make_chunk_eval_step,
    make_chunk_train_step,
)
from texocr_tpu_torch.training.losses import get_loss_fn
from texocr_tpu_torch.training.optimizers import get_optimizer
from texocr_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    put_batch,
)
from texocr_tpu_torch.utils import pad_to_multiple


def train_model(train_set: ImageDataset, val_set: Optional[ImageDataset], config: dict,
                verbose: bool = True, metrics_path: Optional[str] = None, device="cuda"):
    """Trains on ``device`` (CUDA unless the caller asks otherwise) and
    returns (model, TrainState, per-epoch mean train losses). ``config`` is
    the reference-format dict; ``max_length`` and ``vocab_size`` come from
    the dataset where it lacks them. ``init_from`` (a checkpoint directory or
    a save_dir) warm-starts the weights; ``resume`` continues from the latest
    checkpoint in ``save_dir``, step counter and optimizer state included.
    Either takes the port's checkpoints and the JAX package's orbax ones."""
    config = with_defaults(dict(config))
    tcfg = TrainConfig.from_dict(config)
    if "max_length" not in config:
        # The collator rounds label lengths up to seq_pad_multiple; the
        # positional table must cover the rounded length.
        config["max_length"] = pad_to_multiple(train_set.max_seq_len, tcfg.seq_pad_multiple)
    config.setdefault("vocab_size", train_set.tokenizer.vocab_size)
    get_loss_fn(config.get("loss_fn", "CrossEntropyLoss"))  # validates the name

    device = torch.device(device)
    mesh = create_mesh(config["mesh"], device=device)
    main = is_main_process()
    verbose = verbose and main
    model = OCRModel(ModelConfig.from_dict(config), device=device, seed=tcfg.seed, mesh=mesh)
    optimizer = get_optimizer(tcfg.optimizer, tcfg.optimizer_args, model.parameters(), model.tp)
    state = create_train_state(model, optimizer, tcfg.seed)

    if config.get("init_from"):
        # Weights only, shape-adapting: fresh optimizer state, epoch 0.
        path = latest_checkpoint(config["init_from"]) or config["init_from"]
        restored = load_weights(path)
        full = gather_state_dict(model.state_dict(), mesh, model.full_shapes)
        model.load_state_dict(shard_state_dict(warm_start_params(restored, full), mesh))
        if verbose:
            print(f"Warm-started params from {path}.")

    start_epoch = 0
    if config.get("resume"):
        path = latest_checkpoint(tcfg.save_dir)
        if path:
            restored = load_checkpoint(path)
            model.load_state_dict(shard_state_dict(restored["model"], mesh))
            optimizer.load_state_dict(shard_optimizer_state(
                restored["optimizer"], model.parameter_keys(), mesh))
            state.step = int(restored.get("step", 0))
            start_epoch = int(restored["epoch"]) + 1
            if verbose:
                print(f"Resumed from {path} (epoch {start_epoch}).")
    if verbose:
        n_params = sum(math.prod(model.full_shapes[k]) for k in model.parameter_keys())
        print(f"Devices: {tuple(mesh.shape)} {mesh.mesh_dim_names}, one {device.type} device "
              f"per rank")
        print(f"Device: {device}; model has {n_params} parameters.")

    logger = MetricsLogger(metrics_path if main else None, echo=verbose)
    train = _train_device_resident if config["device_data"] else _train_host
    start = time.time()
    try:
        history = train(state, mesh, train_set, val_set, tcfg, config, device, start_epoch,
                        logger, verbose)
    finally:
        logger.close()
    if verbose:
        print(f"Training took {time.time() - start:.2f} seconds.")
    return model, state, history


def _end_epoch(state: TrainState, mesh, tcfg: TrainConfig, logger: MetricsLogger, epoch: int,
               loss_sum: torch.Tensor, acc_sum: torch.Tensor, n_steps: int, n_images: int,
               t0: float) -> float:
    """Logs the epoch (its one sync), saves its checkpoint when due (the
    model ranks' slices gathered, rank 0 writing) and returns its mean
    loss."""
    mean_loss = float(loss_sum) / max(n_steps, 1)
    dt = time.time() - t0
    logger.log("train_epoch", epoch=epoch + 1, loss=mean_loss,
               token_acc=float(acc_sum) / max(n_steps, 1), steps=n_steps,
               images_per_sec=n_images / max(dt, 1e-9), seconds=dt)
    if tcfg.save_checkpoint and (epoch + 1) % tcfg.save_freq == 0:
        model = state.model
        weights = gather_state_dict(model.state_dict(), mesh, model.full_shapes)
        moments = gather_optimizer_state(state.optimizer.state_dict(), model.parameter_keys(),
                                         mesh, model.full_shapes)
        if is_main_process():
            save_checkpoint(tcfg.save_dir, epoch, weights, moments, extra={"step": state.step})
    return mean_loss


def _host_val(model: OCRModel, mesh, val_loader, eval_step, device) -> Optional[float]:
    """Mean loss over the val loader's batches, or None without a batch."""
    val_loss = torch.zeros((), device=device)
    n = 0
    for images, labels in val_loader:
        rows = batch_rows(len(images), mesh)
        val_loss += eval_step(model, *put_batch(images[rows], labels[rows], device))
        n += 1
    return float(val_loss) / n if n else None


def _train_host(state, mesh, train_set, val_set, tcfg, config, device, start_epoch, logger,
                verbose):
    """Epochs over the shape-bucketed host loader; each rank keeps its data
    rank's rows of every batch."""
    train_step = make_train_step(mask_pad=tcfg.mask_pad_loss)
    eval_step = make_eval_step(mask_pad=tcfg.mask_pad_loss)
    # One loader for the run: its seeds grow per epoch, so batches differ
    # between epochs; seed_offset keeps the schedule aligned after a resume.
    train_loader = create_dataloader(train_set, config, seed_offset=start_epoch)
    val_loader = create_dataloader(val_set, config) if val_set is not None else None
    history = []
    for epoch in range(start_epoch, tcfg.n_epochs):
        loss_sum = torch.zeros((), device=device)
        acc_sum = torch.zeros((), device=device)
        n_batches, n_images = 0, 0
        t0 = time.time()
        for images, labels in prefetch(iter(train_loader)):
            rows = batch_rows(len(images), mesh)
            metrics = train_step(state, *put_batch(images[rows], labels[rows], device))
            loss_sum += metrics["loss"]
            acc_sum += metrics["token_acc"]
            n_batches += 1
            n_images += len(images)
        history.append(_end_epoch(state, mesh, tcfg, logger, epoch, loss_sum, acc_sum,
                                  n_batches, n_images, t0))
        if val_loader is not None and (epoch + 1) % tcfg.val_freq == 0:
            val_loss = _host_val(state.model, mesh, val_loader, eval_step, device)
            if val_loss is not None:
                logger.log("val", epoch=epoch + 1, loss=val_loss)
    return history


def _train_device_resident(state, mesh, train_set, val_set, tcfg, config, device, start_epoch,
                           logger, verbose):
    """Epochs over the shape buckets resident on the device. Like the JAX
    package, this path reads ``batch_shuffle`` with a default of true and
    ``keep_small`` with a default of false (the host loader defaults both to
    false). Every rank holds every bucket (the JAX package's replicated
    placement), draws the same permutations and gathers its data rank's rows
    of each step."""
    batch_size = tcfg.batch_size
    steps_cap = config["device_data_steps_per_call"]
    staging = dict(seq_pad_multiple=tcfg.seq_pad_multiple, device=device,
                   max_canvas=config["device_data_max_canvas"],
                   size_round=config["device_data_size_round"],
                   pack_bits=config["device_data_pack_bits"])
    data = DeviceResidentData.from_dataset(
        train_set, min_bucket_items=1 if config.get("keep_small", False) else batch_size,
        bucket_cap=config["device_data_bucket_cap"], **staging)
    # device_data_val false streams the val split from the host loader, and
    # leaves the device's memory to the train buckets.
    val_data = val_loader = None
    if val_set is not None and config["device_data_val"]:
        val_data = DeviceResidentData.from_dataset(val_set, **staging)
    elif val_set is not None:
        val_loader = create_dataloader(val_set, config)
        eval_step = make_eval_step(mask_pad=tcfg.mask_pad_loss)
    if verbose:
        for key, b in data.buckets.items():
            print(f"  bucket {key}: {b.n} images, seq_len {b.seq_len}, "
                  f"{b.images.nbytes / 1e6:.0f} MB on device")

    rows = batch_rows(batch_size, mesh)
    run_steps = make_chunk_train_step(batch_size, mask_pad=tcfg.mask_pad_loss,
                                      augment=bool(config["device_data_augment"]), rows=rows)
    eval_steps = make_chunk_eval_step(batch_size, mask_pad=tcfg.mask_pad_loss, rows=rows)
    plan = data.plan(batch_size, steps_cap=steps_cap)
    plan_rng = random.Random(tcfg.seed + start_epoch)
    history = []
    for epoch in range(start_epoch, tcfg.n_epochs):
        # Buckets interleave call by call, in an order shuffled per epoch.
        if config.get("batch_shuffle", True):
            plan_rng.shuffle(plan)
        perms = {key: epoch_permutation(b.n, tcfg.seed, epoch, key[0] * 4096 + key[1], device)
                 for key, b in data.buckets.items()}
        loss_sum = torch.zeros((), device=device)
        acc_sum = torch.zeros((), device=device)
        n_steps = 0
        t0 = time.time()
        for key, steps, chunk_start in plan:
            metrics = run_steps(state, data.buckets[key], perms[key], steps, chunk_start)
            loss_sum += metrics["loss"] * steps
            acc_sum += metrics["token_acc"] * steps
            n_steps += steps
        history.append(_end_epoch(state, mesh, tcfg, logger, epoch, loss_sum, acc_sum, n_steps,
                                  n_steps * batch_size, t0))
        if (epoch + 1) % tcfg.val_freq:
            continue
        if val_data is not None:
            val_loss = torch.zeros((), device=device)
            n = 0
            for key, steps, off in val_data.plan(batch_size, steps_cap):
                val_loss += eval_steps(state.model, val_data.buckets[key], steps, off) * steps
                n += steps
            if n:
                logger.log("val", epoch=epoch + 1, loss=float(val_loss) / n)
        elif val_loader is not None:
            val_loss = _host_val(state.model, mesh, val_loader, eval_step, device)
            if val_loss is not None:
                logger.log("val", epoch=epoch + 1, loss=val_loss)
    return history
