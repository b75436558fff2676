"""The training loop: epochs over the shape-bucketed host loader, the train
step on the device, and the checkpoint and validation cadence of the config.

The device is synchronised once per epoch: metrics add up as device scalars
and are read after the epoch's last step, so the host queues steps ahead of
the device. The device-resident loader (``device_data: true``) is not ported
yet and raises (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from texocr_tpu_torch.checkpoint.io import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
    warm_start_params,
)
from texocr_tpu_torch.config import ModelConfig, TrainConfig, with_defaults
from texocr_tpu_torch.data.dataset import ImageDataset, create_dataloader, prefetch
from texocr_tpu_torch.models import OCRModel
from texocr_tpu_torch.telemetry import MetricsLogger
from texocr_tpu_torch.training.losses import get_loss_fn
from texocr_tpu_torch.training.optimizers import get_optimizer
from texocr_tpu_torch.training.train_step import (
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
    checkpoint in ``save_dir``, step counter and optimizer state included."""
    config = with_defaults(dict(config))
    tcfg = TrainConfig.from_dict(config)
    if "max_length" not in config:
        # The collator rounds label lengths up to seq_pad_multiple; the
        # positional table must cover the rounded length.
        config["max_length"] = pad_to_multiple(train_set.max_seq_len, tcfg.seq_pad_multiple)
    config.setdefault("vocab_size", train_set.tokenizer.vocab_size)
    get_loss_fn(config.get("loss_fn", "CrossEntropyLoss"))  # validates the name

    device = torch.device(device)
    model = OCRModel(ModelConfig.from_dict(config), device=device, seed=tcfg.seed)
    optimizer = get_optimizer(tcfg.optimizer, tcfg.optimizer_args, model.parameters())
    state = create_train_state(model, optimizer, tcfg.seed)

    if config.get("init_from"):
        # Weights only, shape-adapting: fresh optimizer state, epoch 0.
        path = latest_checkpoint(config["init_from"]) or config["init_from"]
        restored = load_checkpoint(path)["model"]
        model.load_state_dict(warm_start_params(restored, model.state_dict()))
        if verbose:
            print(f"Warm-started params from {path}.")

    start_epoch = 0
    if config.get("resume"):
        path = latest_checkpoint(tcfg.save_dir)
        if path:
            restored = load_checkpoint(path)
            model.load_state_dict(restored["model"])
            optimizer.load_state_dict(restored["optimizer"])
            state.step = int(restored.get("step", 0))
            start_epoch = int(restored["epoch"]) + 1
            if verbose:
                print(f"Resumed from {path} (epoch {start_epoch}).")
    if verbose:
        n_params = sum(p.numel() for p in model.parameters())
        print(f"Device: {device}; model has {n_params} parameters.")

    logger = MetricsLogger(metrics_path, echo=verbose)
    train_step = make_train_step(mask_pad=tcfg.mask_pad_loss)
    eval_step = make_eval_step(mask_pad=tcfg.mask_pad_loss)
    # One loader for the run: its seeds grow per epoch, so batches differ
    # between epochs; seed_offset keeps the schedule aligned after a resume.
    train_loader = create_dataloader(train_set, config, seed_offset=start_epoch)
    val_loader = create_dataloader(val_set, config) if val_set is not None else None
    history = []
    start = time.time()
    try:
        for epoch in range(start_epoch, tcfg.n_epochs):
            epoch_loss = torch.zeros((), device=device)
            epoch_acc = torch.zeros((), device=device)
            n_batches, n_images = 0, 0
            t0 = time.time()
            for images, labels in prefetch(iter(train_loader)):
                images, labels = put_batch(images, labels, device)
                metrics = train_step(state, images, labels)
                epoch_loss += metrics["loss"]
                epoch_acc += metrics["token_acc"]
                n_batches += 1
                n_images += images.shape[0]
            mean_loss = float(epoch_loss) / max(n_batches, 1)  # the epoch's one sync
            dt = time.time() - t0
            history.append(mean_loss)
            logger.log("train_epoch", epoch=epoch + 1, loss=mean_loss,
                       token_acc=float(epoch_acc) / max(n_batches, 1), steps=n_batches,
                       images_per_sec=n_images / max(dt, 1e-9), seconds=dt)

            if tcfg.save_checkpoint and (epoch + 1) % tcfg.save_freq == 0:
                save_checkpoint(tcfg.save_dir, epoch, model.state_dict(),
                                optimizer.state_dict(), extra={"step": state.step})

            if val_loader is not None and (epoch + 1) % tcfg.val_freq == 0:
                val_loss = torch.zeros((), device=device)
                n = 0
                for images, labels in val_loader:
                    val_loss += eval_step(model, *put_batch(images, labels, device))
                    n += 1
                if n:
                    logger.log("val", epoch=epoch + 1, loss=float(val_loss) / n)
    finally:
        logger.close()
    if verbose:
        print(f"Training took {time.time() - start:.2f} seconds.")
    return model, state, history
