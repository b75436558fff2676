"""Fixed batches back to back through ``TexOCR.generate_batch`` with the
prefix decoder (``decoder.kind: mla_moe``): the batch users of a VLM
decoder. ``fixed_batch``'s loop, canvases and window, with:

- weights made on the device from the seed in the configuration's
  ``param_dtype`` (``reference/kimivl.py``), the routers' correction biases
  balanced on the text positions of 8 seeded canvases apart from the
  window's read with seeded token ids (``BALANCE_ROWS``), and handed to the
  engine, which holds them in place: the card keeps one copy;
- the program's device counter ``moe.expert_rows`` read before and after the
  window: its sum has to be batches x batch x (prefix + max_len) x k x
  expert layers, every image's prefix rows and step rows (BOS is step 0's
  input) routed to k experts in each expert layer, or the run fails;
- no served token of the window is EOS, or the run fails: EOS's logit is
  pinned at 0 below the others', so every row decodes to ``max_len`` and
  no step is left to PAD (PAD is an ordinary row of the head, chosen now
  and then without ending a row, and PAD fills a row only after its EOS);
- the check: rows of the first, the last and a seeded draw of other
  batches, teacher-forced through the reference over the tokens served.

It imports what only a program with the prefix decoder has, so a program
without it fails at once.
"""

from __future__ import annotations

import time

import torch

from portbench import checks, flops_kimivl, traffic
from portbench.drivers.fixed_batch import images
from portbench.harness import Run
from portbench.reference import kimivl as ref_kimi
from portbench.reference import model as ref
from portbench.trace import Slice
from texocr_tpu_torch import telemetry
from texocr_tpu_torch.models.moe import EXPERT_LAUNCHES, EXPERT_ROWS

#: Canvases whose text positions balance the routers.
BALANCE_ROWS = 8


def expected_rows(arch: ref_kimi.Arch, mix: dict, batches: int) -> int:
    """Routed rows of ``batches`` batches over every expert layer."""
    prefix = arch.prefix(*mix["canvas"])
    return (batches * mix["batch"] * (prefix + mix["max_len"])
            * arch.lm["num_experts_per_tok"] * arch.moe_layers)


def counted(name: str) -> torch.Tensor:
    """A host copy of the program's device counter ``name``."""
    return telemetry.device_counters()[name]


def run(run: Run) -> None:
    from texocr_tpu_torch.serving.wrapper import TexOCR

    mix, cfg = run.cell.mix, run.model_config
    arch = ref_kimi.Arch.from_config(cfg)
    params = ref_kimi.make_params(arch, run.seed, run.device, mix["eos_logit"])
    canvases = images(mix, run.seed, -2, run.device)[:BALANCE_ROWS, ..., 0]
    text = torch.from_numpy(traffic.rng(run.seed, 12).integers(
        0, arch.lm["vocab_size"], (canvases.shape[0], mix["max_len"]))).to(run.device)
    text[:, 0] = arch.bos
    ref_kimi.balance_routers(params, arch, canvases, text)
    engine = TexOCR(cfg, device=run.device, state_dict=params)
    args = dict(max_len=mix["max_len"], mode=mix["mode"])
    warm = images(mix, run.seed, -1, run.device)
    for _ in range(2):  # capture, then one replay
        engine.generate_batch(warm, **args).cpu()
    del warm
    fault = run.faults.get("tokens")

    tokens = []
    before = counted(EXPERT_ROWS)
    run.setup_done()
    t0 = time.perf_counter()
    t_end = t0
    while t_end - t0 < run.seconds:
        out = engine.generate_batch(images(mix, run.seed, len(tokens), run.device), **args).cpu()
        t_end = time.perf_counter()
        tokens.append(out)
    window_rows = counted(EXPERT_ROWS) - before
    want = expected_rows(arch, mix, len(tokens))
    if int(window_rows.sum()) != want:
        raise RuntimeError(f"moe.expert_rows counted {int(window_rows.sum())} routed rows over "
                           f"{len(tokens)} batches; the traffic routes {want}")
    ended = sum(int((t == arch.eos).sum()) for t in tokens)
    if ended:
        raise RuntimeError(f"{ended} served tokens are EOS; the mix pins EOS below every "
                           "other logit, so each row decodes to max_len")
    if fault:
        tokens = [fault(t) for t in tokens]
    if run.trace:
        batch = images(mix, run.seed, len(tokens), run.device)
        Slice.prime()
        start = counted(EXPERT_LAUNCHES)
        run.slice = Slice(sync=True)
        with run.slice:
            engine.generate_batch(batch, **args).cpu()
        run.counters["traced_launches"] = (counted(EXPERT_LAUNCHES) - start).tolist()
    run.read_memory_peak()

    n = len(tokens) * mix["batch"]
    run.attempted = n
    run.e2e["batch_images_per_s"] = n / (t_end - t0)
    h, w = mix["canvas"]
    run.counters.update(window_s=t_end - t0, decode_steps=mix["max_len"],
                        expert_rows=window_rows.tolist(), prefix=arch.prefix(h, w),
                        model_flops=n * flops_kimivl.image_flops(arch, h, w, mix["max_len"]))

    del engine
    if run.device == "cuda":
        torch.cuda.empty_cache()
    chk = mix["check"]
    others = traffic.rng(run.seed, 11).permutation(len(tokens)).tolist()[: chk["batches"]]
    picked = sorted({0, len(tokens) - 1, *others})
    acc = checks.Gaps(run.controls)
    for b in picked:
        rows = traffic.rng(run.seed, 10, b).permutation(mix["batch"])[: chk["rows"]].tolist()
        canv = images(mix, run.seed, b, run.device)[rows, ..., 0]
        served = tokens[b][rows].to(run.device)
        with ref.float32_products():
            token_gaps(acc, canv, served, params, arch)
    run.counters["gaps"] = acc.numbers()
    run.counters["compared"] = {"rows": acc.rows, "tokens": acc.tokens}
    run.judge(run.counters["gaps"])


def token_gaps(acc: checks.Gaps, canvases: torch.Tensor, served: torch.Tensor,
               params: ref_kimi.Params, arch: ref_kimi.Arch) -> None:
    """Adds to ``acc`` the gaps of the (B, T) served tokens of (B, H, W)
    canvases, teacher-forced through the reference (BOS, then the served
    tokens but the last), and of each control's first-ranked tokens."""
    acc.rows += served.shape[0]
    acc.tokens += served.numel()
    inp = torch.cat([torch.full_like(served[:, :1], arch.bos), served[:, :-1]], dim=1)
    with torch.no_grad():
        logits = ref_kimi.text_logits(canvases, inp, params, arch)
        acc.add("program", checks._gaps(logits, served))
        for c in acc.sides[1:]:
            low = ref_kimi.text_logits(canvases, inp, params, arch, checks.CONTROLS[c])
            acc.add(c, checks._gaps(logits, low.argmax(-1)))
            del low
