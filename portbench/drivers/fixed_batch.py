"""Fixed batches back to back through ``TexOCR.generate_batch``: the batch
users' path.

Set-up: the engine on the seed's weights, its graph key for the mix's
(batch, canvas, max_len, mode) captured and replayed once. Window: batch
after batch of fresh seeded canvases made on the device, each call's
tokens copied to the host as a batch user reads them, until the window's
time is spent; images per second over the time from the window's start to
the last batch's completion. A traced run measures the same window
untraced, then profiles one more batch after it closes.
"""

from __future__ import annotations

import time

import torch

from portbench import checks, flops, traffic
from portbench.harness import Run
from portbench.reference import model as ref
from portbench.trace import Slice


def images(mix: dict, seed: int, index: int, device) -> torch.Tensor:
    """Batch ``index``'s (B, H, W, 1) uint8 canvases."""
    h, w = mix["canvas"]
    return traffic.ink_batch(mix["batch"], h, w, mix["ink"],
                             traffic.torch_seed(seed, 4, index), device)[..., None]


def run(run: Run) -> None:
    from texocr_tpu_torch.serving.wrapper import TexOCR

    mix, cfg = run.cell.mix, run.model_config
    arch = ref.Arch.from_config(cfg)
    params = ref.make_params(arch, run.seed, run.device, mix["eos_logit"])
    engine = TexOCR(cfg, device=run.device, state_dict=params)
    args = dict(max_len=mix["max_len"], mode=mix["mode"])
    warm = images(mix, run.seed, -1, run.device)
    for _ in range(2):  # capture, then one replay
        engine.generate_batch(warm, **args).cpu()
    del warm
    fault = run.faults.get("tokens")

    tokens = []
    run.setup_done()
    t0 = time.perf_counter()
    t_end = t0
    while t_end - t0 < run.seconds:
        out = engine.generate_batch(images(mix, run.seed, len(tokens), run.device), **args).cpu()
        t_end = time.perf_counter()
        tokens.append(fault(out) if fault else out)
    if run.trace:
        batch = images(mix, run.seed, len(tokens), run.device)
        Slice.prime()
        run.slice = Slice(sync=True)
        with run.slice:
            engine.generate_batch(batch, **args).cpu()
    run.read_memory_peak()

    n = len(tokens) * mix["batch"]
    run.attempted = n
    run.e2e["batch_images_per_s"] = n / (t_end - t0)
    h, w = mix["canvas"]
    run.counters.update(window_s=t_end - t0,
                        decode_steps=mix["max_len"],
                        model_flops=n * flops.serve_flops(arch, h, w, mix["max_len"]))

    del engine
    if run.device == "cuda":
        torch.cuda.empty_cache()
    chk = mix["check"]
    # The first and last batches and a seeded draw of others.
    others = traffic.rng(run.seed, 11).permutation(len(tokens)).tolist()[: chk["batches"]]
    picked = sorted({0, len(tokens) - 1, *others})
    acc = checks.Gaps(run.controls)
    for b in picked:
        rows = traffic.rng(run.seed, 10, b).permutation(mix["batch"])[: chk["rows"]].tolist()
        canv = images(mix, run.seed, b, run.device)[rows, ..., 0]
        served = [_until_end(tokens[b][r].tolist(), arch) for r in rows]
        with ref.float32_products():
            checks.token_gaps(acc, canv, served, params, arch, mix["max_len"])
    run.counters["gaps"] = acc.numbers()
    run.counters["compared"] = {"rows": acc.rows, "tokens": acc.tokens}
    run.judge(run.counters["gaps"])


def _until_end(row, arch: ref.Arch):
    """A row's tokens up to (not including) its first EOS."""
    return row[: row.index(arch.eos)] if arch.eos in row else row
