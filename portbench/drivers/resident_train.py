"""Training on device-resident data, as ``training.loop`` runs it: the
trainers' path.

Set-up: the mix's seeded rows staged by ``DeviceResidentData`` (shape
buckets of uint8 images and packed label rows), the model on the seed's
weights, the configuration's optimizer, and ``make_chunk_train_step`` over
``plan()``, shuffled per epoch as the loop shuffles it (from the mix's
``schedule_seed``) with the loop's permutations of the rows.
The set-up drives that one training state through its first steps with
the runner itself: three one-step calls from the first planned call that has three (the
steps compared with the reference) and one step of every other bucket, so
every shape has run before the window opens; the window continues the same
state from there, epoch boundaries included. The last call of the window is
cut so that it ends near the window's length; images per second are every
step's rows over the window's time, synchronised at its end. A traced run
measures the same window untraced, then profiles the mix's ``trace.steps``
steps of the bucket with the most rows after it closes.
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from portbench import checks, flops, traffic
from portbench.harness import Run
from portbench.reference import model as ref
from portbench.reference import train as ref_train
from portbench.trace import Slice

#: Steps the set-up runs and the reference follows.
COMPARED_STEPS = 3


def run(run: Run) -> None:
    from texocr_tpu_torch.config import ModelConfig
    from texocr_tpu_torch.data.dataset import ImageDataset
    from texocr_tpu_torch.models.ocr_model import OCRModel
    from texocr_tpu_torch.training import device_data as dd
    from texocr_tpu_torch.training.optimizers import get_optimizer
    from texocr_tpu_torch.training.train_step import create_train_state

    mix, cfg = run.cell.mix, run.model_config
    device, seed = run.device, run.seed
    arch = ref.Arch.from_config(cfg)
    params = ref.make_params(arch, seed, device)
    images, labels = traffic.training_rows(mix, seed, arch.eos, device)
    ds = ImageDataset.from_arrays(images, labels, tokenizer_path=cfg["tokenizer_path"])
    batch = cfg["batch_size"]
    data = dd.DeviceResidentData.from_dataset(
        ds, seq_pad_multiple=cfg["seq_pad_multiple"], min_bucket_items=batch, device=device,
        size_round=mix["size_round"], pack_bits=mix["pack_bits"])
    del ds
    model = OCRModel(ModelConfig.from_dict(cfg), device=device, seed=seed)
    model.load_state_dict(params, strict=True)
    optimizer = get_optimizer(cfg["optimizer"], cfg["optimizer_args"], model.parameters())
    state = create_train_state(model, optimizer, seed)
    if "frozen" in run.faults:
        optimizer.step = lambda: None
    if "half_batch" in run.faults:
        whole = dd.gather_batch
        dd.gather_batch = lambda bucket, idx: whole(bucket, idx[: len(idx) // 2])
    run_steps = dd.make_chunk_train_step(batch, mask_pad=cfg["mask_pad_loss"])
    plan = data.plan(batch, steps_cap=mix["steps_per_call"])
    # The order of the calls is the mix's own, so that every seed's window
    # holds the same steps; the rows are the seed's.
    plan_rng = random.Random(mix["schedule_seed"])

    epoch = -1
    queue, perms = [], {}

    def next_call():
        nonlocal epoch, queue, perms
        if not queue:
            epoch += 1
            plan_rng.shuffle(plan)
            perms = {key: dd.epoch_permutation(b.n, seed, epoch, key[0] * 4096 + key[1], device)
                     for key, b in data.buckets.items()}
            queue = [list(call) for call in plan]
        return queue[0]

    def take(call, steps):
        """Runs ``steps`` of the queued ``call`` and consumes them."""
        key, _, start = call
        out = run_steps(state, data.buckets[key], perms[key], steps, start)
        call[1] -= steps
        call[2] += steps
        if call[1] == 0:
            queue.remove(call)
        return out

    # The compared steps, from the first planned call that has as many,
    # then one step of every other bucket.
    next_call()
    first = next(c for c in queue if c[1] >= COMPARED_STEPS)
    first_key, first_start = first[0], first[2]
    names = [n for n, _ in model.named_parameters()]
    prog = {"losses": []}
    for s in range(COMPARED_STEPS):
        prog["losses"].append(float(take(first, 1)["loss"]))
        if s == 0:
            moments = [optimizer.optimizer.state.get(p, {}).get("exp_avg")
                       for p in model.parameters()]
            beta1 = optimizer.optimizer.param_groups[0]["betas"][0]
            prog["grad1"] = {n: torch.zeros_like(p) if m is None else m / (1 - beta1)
                             for n, m, p in zip(names, moments, model.parameters())}
    with torch.no_grad():
        prog["change"] = {n: float(torch.linalg.vector_norm(p - params[n]))
                          for n, p in model.named_parameters()}
    for key in data.buckets:
        if key != first_key:
            take(next(c for c in queue if c[0] == key), 1)

    steps_done = 0
    step_flops = []
    loss_sum = torch.zeros((), device=device)
    metrics = None
    run.setup_done()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds:
            break
        call = next_call()
        steps = call[1]
        if steps_done:  # cut the call that would outlast the window
            steps = min(steps, max(1, math.ceil((run.seconds - elapsed) * steps_done / elapsed)))
        metrics = take(call, steps)
        loss_sum += metrics["loss"] * steps
        key = call[0]
        step_flops += [batch * flops.train_flops(arch, key[0], key[1],
                                                 data.buckets[key].seq_len)] * steps
        steps_done += steps
        if not queue:  # the loop reads the epoch's loss at its end
            float(loss_sum)
    if device == "cuda":
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    run.read_memory_peak()
    run.attempted = steps_done
    run.e2e["train_images_per_s"] = steps_done * batch / window
    run.counters.update(window_s=window, model_flops=sum(step_flops),
                        window_peak_bytes=torch.cuda.max_memory_allocated()
                        if device == "cuda" else None)
    if run.trace:
        trace(run, state, data, perms, run_steps, mix["trace"]["steps"])

    # The reference follows the compared steps, after the program's state is gone.
    del state, model, optimizer, run_steps, data, perms, loss_sum, metrics
    if "half_batch" in run.faults:
        dd.gather_batch = whole
    if device == "cuda":
        torch.cuda.empty_cache()
    rows = [i for i, img in enumerate(images) if img.shape == first_key]
    perm = ref_train.epoch_permutation(len(rows), seed, 0, first_key, device)
    table = torch.from_numpy(ref_train.label_rows([labels[i] for i in rows], arch,
                                                  cfg["seq_pad_multiple"])).to(device)
    batches = []
    for s in range(COMPARED_STEPS):
        idx = perm[((first_start + s) * batch + torch.arange(batch, device=device)) % len(rows)]
        pick = idx.tolist()
        imgs = torch.from_numpy(np.stack([images[rows[j]] for j in pick]))
        batches.append((imgs.to(device), table[idx]))
    lr = cfg["optimizer_args"]["lr"]
    with ref.float32_products():
        reference = ref_train.train_steps(params, arch, batches, seed=seed, lr=lr,
                                          block=mix["check"]["block"])
        numbers = {"program": checks.train_numbers(prog, reference)}
        for c in run.controls:
            low = ref_train.train_steps(params, arch, batches, seed=seed, lr=lr,
                                        prec=checks.CONTROLS[c], block=mix["check"]["block"])
            numbers[c] = checks.train_numbers(low, reference)
    run.counters["numbers"] = numbers
    run.judge(numbers)


def trace(run: Run, state, data, perms, run_steps, steps: int) -> None:
    """Profiles ``steps`` steps of the bucket with the most rows, recording
    each flash launch's shape and valid keys."""
    from texocr_tpu_torch.ops import flash_attention as fa

    key = max(data.buckets, key=lambda k: data.buckets[k].n)
    launches = []
    inner = fa.launch

    def launch(lib, q, k, v, **kw):
        kv = kw.get("kv_lens")
        launches.append((tuple(q.shape), k.shape[2], q.dtype == torch.bfloat16,
                         None if kv is None else kv.tolist()))
        return inner(lib, q, k, v, **kw)

    Slice.prime()
    run.slice = Slice(sync=True)
    fa.launch = launch
    try:
        with run.slice:
            run_steps(state, data.buckets[key], perms[key], steps, 0)
    finally:
        fa.launch = inner
    run.slice.launches = launches
    run.counters["traced_bucket"] = [*key, data.buckets[key].seq_len]
