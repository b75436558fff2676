#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (texocr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA device must be present; prints its name and power limit.
  2. build: compiles every CUDA kernel of the serving path from csrc/.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     test shapes and at the serving path's shapes, with timings of the kernel,
     the plain version and one PyTorch library call as a yardstick.
  4. golden: the committed reference goldens through the port on the card in
     float32 (kernel path): exact greedy tokens, encoder output within 1e-4.
  5. serve: the flagship configuration at full width in bfloat16 with seeded
     random weights, answering single requests of three bucket sizes and
     batches of 8 full canvases, each bucket warmed up first and each timed
     REPEATS times (median); launch counts are read from this phase only.
  6. profile: where the serving time goes, for a batch of 8 full canvases:
     encode and a DECODE_STEPS-step greedy decode, wall time (host clock) and
     device kernels (torch.profiler).
  7. encoder: kernel path against the plain path at the full canvas, float32.
Then one JSON line of per-kernel numbers, the card's name and power limit, and
the last line {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
REPEATS = 3  # timed runs per request and per batch; the median is reported
BATCH = 8  # full canvases per batch
DECODE_STEPS = 350  # the serving default max_len; random weights never emit EOS


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; inputs stay L2-warm between calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def attention_bound_ms(q, k) -> tuple:
    """Least time for one unmasked attention call: q, k, v and o each moved
    once, against 4 * Nq * Nk * dh operations per (batch, head)."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    flops = 4.0 * b * h * nq * nk * dh
    peak = H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_F32_FLOPS
    nbytes = (2 * nq + 2 * nk) * b * h * dh * q.element_size()
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash_kernel(fa, gen):
    """Kernel vs plain on the card; returns the serving layout's numbers.

    ``split`` cases build q, k, v as the encoder does: (B, N, H * dh) split
    into heads, a (B, H, N, dh) view with strides (N * H * dh, dh, H * dh, 1).
    There the kernel must also give exactly what it gives on contiguous
    copies of the same values: its arithmetic does not depend on strides."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [
        # (B, H, Nq, Nk, dh, causal, kv_lens, dtype, split)
        (2, 3, 200, 200, 64, False, None, torch.float32, False),
        (2, 3, 200, 200, 64, True, None, torch.float32, False),
        (2, 3, 64, 300, 64, False, None, torch.float32, False),
        (3, 3, 96, 160, 64, False, [160, 100, 1], torch.float32, False),
        (2, 2, 130, 130, 64, True, [0, 7], torch.float32, False),
        (2, 2, 70, 90, 128, False, None, torch.float32, False),
        (8, 8, 631, 631, 64, False, None, torch.float32, False),
        (8, 8, 631, 631, 64, False, None, torch.bfloat16, False),
        (8, 8, 631, 631, 64, False, None, torch.float32, True),
        (8, 8, 631, 631, 64, False, None, torch.bfloat16, True),  # serving: 8 full canvases
    ]
    row = None
    for b, h, nq, nk, dh, causal, lens, dtype, split in cases:
        if split:
            q, k, v = (torch.randn(b, n, h * dh, device="cuda", generator=gen).to(dtype)
                       .view(b, n, h, dh).transpose(1, 2) for n in (nq, nk, nk))
        else:
            q, k, v = (torch.randn(b, h, n, dh, device="cuda", generator=gen).to(dtype)
                       for n in (nq, nk, nk))
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = dh ** -0.5
        got = fa.flash_attention(q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)
        torch.cuda.synchronize()
        plain = fa.flash_attention_plain(q, k, v, scale=scale, causal=causal, kv_lens=kv_lens)
        if dtype == torch.float32:
            err = (got - plain).abs().max().item()
            tol = 1e-4
            ok = err <= tol
            note = f"max|kernel-plain| {err:.3e} (tol {tol:g})"
        else:
            # bfloat16: kernel and bf16 plain both against the float32 plain
            # version on the same bf16 inputs.
            ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), scale=scale,
                                           causal=causal, kv_lens=kv_lens)
            err = (got.float() - ref).abs().max().item()
            plain_err = (plain.float() - ref).abs().max().item()
            tol = max(2 * plain_err, 2e-2)
            ok = err <= tol
            vs_plain = (got.float() - plain.float()).abs().max().item()
            note = (f"max|kernel-f32| {err:.3e}, max|plain-f32| {plain_err:.3e} (tol {tol:.3e}); "
                    f"max|kernel-plain| {vs_plain:.3e}, max|f32| {ref.abs().max().item():.3e}")
        if split:
            dense = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                       scale=scale, causal=causal, kv_lens=kv_lens)
            stride_diff = (got.float() - dense.float()).abs().max().item()
            ok = ok and stride_diff == 0
            note += f"; max|split-contiguous| {stride_diff:.3e} (must be 0)"
        log(f"[kernels] flash_attention {(b, h, nq, nk, dh)} causal={causal} "
            f"kv_lens={lens} {str(dtype)[6:]} strides={q.stride()}: {note} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash attention kernel disagrees with its plain version")
        if split and dtype == torch.bfloat16:
            bound, bound_by = attention_bound_ms(q, k)
            kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, scale=scale))
            row = {
                "max_abs_err": err,
                "ms": kernel_ms,
                "kernel_ms": kernel_ms,
                "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, scale=scale)),
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, scale=scale)),
            }
            log(f"[kernels] flash_attention {(b, h, nq, nk, dh)} bf16 split-head timing: "
                + json.dumps({k_: row[k_] for k_ in ("ms", "plain_ms", "library_ms", "bound_ms")}))
    return row


def check_golden(fa):
    """The committed reference goldens through the port on the card."""
    from texocr_tpu_torch.checkpoint import load_state
    from texocr_tpu_torch.config import ModelConfig
    from texocr_tpu_torch.models import OCRModel, greedy_decode

    config = {
        "img_size": (48, 128), "patch_size": 16, "vocab_size": 50, "max_length": 32,
        "glu": True, "bos_token": 48, "eos_token": 47, "trg_pad_idx": 49,
        "dtype": "float32",
        "encoder": {"n_channels": 1, "embed_dim": 64, "num_layers": 2, "heads": 2,
                    "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                    "stem_channels": 32},
        "decoder": {"embed_dim": 64, "num_layers": 2, "heads": 2, "cross_attend": True,
                    "dropout": 0.0, "exp_factor": 4},
    }
    goldens = os.path.join(REPO, "tests", "goldens")
    model = OCRModel(ModelConfig.from_dict(config), device="cuda")
    model.load_state_dict(load_state(os.path.join(goldens, "model_state.npz")), strict=True)
    io = np.load(os.path.join(goldens, "model_io.npz"))
    images = torch.from_numpy(io["images"]).permute(0, 2, 3, 1).contiguous().cuda()
    before = fa.flash_attention.launches
    with torch.inference_mode():
        enc = model.encode(images)
    tokens = greedy_decode(model, enc, bos_token=48, eos_token=-1, pad_token=49,
                           max_len=io["greedy_tokens"].shape[1] - 1)
    launches = fa.flash_attention.launches - before
    enc_ok = np.allclose(enc.cpu().numpy(), io["enc_out"], rtol=1e-4, atol=1e-4)
    enc_err = float(np.abs(enc.cpu().numpy() - io["enc_out"]).max())
    tokens_ok = np.array_equal(tokens.cpu().numpy(), io["greedy_tokens"][:, 1:])
    log(f"[golden] enc_out max err {enc_err:.3e} (rtol/atol 1e-4) {'ok' if enc_ok else 'FAIL'}; "
        f"greedy tokens {'exact' if tokens_ok else 'DIFFER'}; flash launches {launches}")
    if not (enc_ok and tokens_ok and launches > 0):
        raise AssertionError("golden check failed on the card")


def canvas(rng, h, w) -> np.ndarray:
    """A white uint8 canvas with dark strokes, like a rendered equation."""
    img = np.full((h, w), 255, np.uint8)
    for _ in range(max(4, w // 40)):
        r, c = rng.integers(0, h - 6), rng.integers(0, w - 30)
        img[r: r + 3, c: c + int(rng.integers(8, 30))] = 0
    return img


def serve(fa, rng):
    """The flagship model at full width, bf16, seeded random weights."""
    from texocr_tpu_torch.config import FLAGSHIP
    from texocr_tpu_torch.serving import TexOCR
    from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

    engine = TexOCR(dict(FLAGSHIP, tokenizer_path=DEFAULT_VOCAB_PATH, seed=0), device="cuda")
    requests = [canvas(rng, 160, 1008), canvas(rng, 96, 512), canvas(rng, 32, 128)]
    batch = np.stack([canvas(rng, 160, 1008) for _ in range(BATCH)])[..., None]
    # Warm-up at every shape timed below, before the counted run: the first
    # run at a shape pays for cuDNN's choice of convolution algorithms.
    for img in requests:
        engine(img, max_len=8)
    engine.generate_batch(batch, max_len=8)
    torch.cuda.synchronize()

    fa.flash_attention.launches = 0
    request_s = []
    for img in requests:
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            ids, latex = engine(img)
            times.append(time.perf_counter() - t0)
            if not all(0 <= i < 1000 for i in ids) or not isinstance(latex, str):
                raise AssertionError(f"bad request output: {ids[:10]} {latex!r}")
        request_s.append(float(np.median(times)))
        log(f"[serve] request {img.shape}: {len(ids)} tokens, median {request_s[-1] * 1e3:.1f} ms "
            f"of {[round(t * 1e3, 1) for t in times]} ms, latex {latex[:40]!r}")
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        tokens = engine.generate_batch(batch, max_len=DECODE_STEPS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    batch_s = float(np.median(times))
    launches = fa.flash_attention.launches
    tokens = tokens.cpu().numpy()
    if tokens.shape != (BATCH, DECODE_STEPS) or tokens.min() < 0 or tokens.max() >= 1000:
        raise AssertionError(f"bad batch tokens: shape {tokens.shape}")
    for row in tokens:
        engine.postprocess(row)  # the strings decode
    encodes = REPEATS * (len(requests) + 1)
    n_layers = FLAGSHIP["encoder"]["num_layers"]
    log(f"[serve] batch of {BATCH} (160, 1008): median {batch_s:.3f} s of "
        f"{[round(t, 3) for t in times]} s, {BATCH / batch_s:.2f} img/s; "
        f"flash launches {launches} for {encodes} encodes")
    if launches != n_layers * encodes:
        raise AssertionError(f"expected {n_layers} flash launches per encode, got {launches}")
    return {"request_s": request_s, "batch_s": batch_s, "launches": launches,
            "engine": engine, "batch": batch}


def device_kernels(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall time (host clock,
    profiled), the device time summed over its kernels, their count, and the
    8 kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = {}
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
            count += 1
    if count == 0:
        raise AssertionError("torch.profiler recorded no device kernels")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_s": wall_s, "device_s": sum(by_name.values()), "kernels": count,
            "top": [{"name": n[:90], "s": s} for n, s in top]}


def profile_serving(engine, batch) -> dict:
    """Where a batch's serving time goes: encode, then a DECODE_STEPS-step
    greedy decode (no early stop), each timed unprofiled on the host clock
    (median of REPEATS, synchronised) and then profiled once."""
    from texocr_tpu_torch.models import greedy_decode

    model, cfg = engine.model, engine.model.config
    x = 1.0 - torch.from_numpy(batch).cuda().float() / 255.0
    result = {}
    with torch.inference_mode():
        enc = model.encode(x)

        def decode():
            greedy_decode(model, enc, bos_token=cfg.bos_token, eos_token=-1,
                          pad_token=cfg.pad_token, max_len=DECODE_STEPS)

        for name, fn in (("encode", lambda: model.encode(x)), ("decode", decode)):
            times = []
            for _ in range(REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            wall_s = float(np.median(times))
            prof = device_kernels(fn)
            result[name] = {"wall_s": wall_s, "device_busy_share": prof["device_s"] / wall_s,
                            **prof}
    result["decode"]["steps"] = DECODE_STEPS
    result["decode"]["wall_s_per_step"] = result["decode"]["wall_s"] / DECODE_STEPS
    result["decode"]["kernels_per_step"] = result["decode"]["kernels"] / DECODE_STEPS
    log(f"[profile] batch {BATCH} (160, 1008) bf16: encode {result['encode']['wall_s'] * 1e3:.2f} ms "
        f"wall, {result['encode']['device_s'] * 1e3:.2f} ms on the device; decode "
        f"{DECODE_STEPS} steps {result['decode']['wall_s']:.3f} s wall, "
        f"{result['decode']['device_s']:.3f} s on the device, "
        f"{result['decode']['kernels_per_step']:.1f} kernels per step")
    log("[profile] " + json.dumps(result))
    return result


def check_encoder_paths(rng):
    """Full-canvas flagship encoder, float32: kernel path against plain path."""
    from texocr_tpu_torch.config import FLAGSHIP, ModelConfig
    from texocr_tpu_torch.models import OCRModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs = []
    images = np.stack([canvas(rng, 160, 1008) for _ in range(2)])[..., None]
    x = 1.0 - torch.from_numpy(images).cuda().float() / 255.0
    for use_flash in (True, False):
        cfg = ModelConfig.from_dict(dict(FLAGSHIP, dtype="float32", use_flash_attention=use_flash))
        model = OCRModel(cfg, device="cuda", seed=0)
        with torch.inference_mode():
            outs.append(model.encode(x))
        del model
    err = (outs[0] - outs[1]).abs().max().item()
    tol = 1e-3
    log(f"[encoder] full canvas f32, kernel vs plain path: max err {err:.3e} (tol {tol:g}) "
        f"{'ok' if err <= tol else 'FAIL'}")
    if not (err <= tol and torch.isfinite(outs[0]).all()):
        raise AssertionError("encoder kernel path disagrees with the plain path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from texocr_tpu_torch.ops import build
    from texocr_tpu_torch.ops import flash_attention as fa

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _, build_log = build.build(fa.SOURCE)
    log(f"[build] {fa.SOURCE} built in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    row = check_flash_kernel(fa, gen)
    check_golden(fa)
    rng = np.random.default_rng(0)
    served = serve(fa, rng)
    profile_serving(served["engine"], served["batch"])
    del served["engine"]
    check_encoder_paths(rng)

    kernels = [dict(
        name="flash_attention",
        route="cuda",
        source="texocr_tpu_torch/csrc/flash_attention.cu",
        replaces="texocr_tpu/ops/flash_attention.py:62",
        launches=served["launches"],
        **row,
    )]
    log(json.dumps({"kernels": kernels}))
    log(f"[serve] median per-request s {served['request_s']}, batch img/s "
        f"{BATCH / served['batch_s']} on {card}")
    log(card_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
