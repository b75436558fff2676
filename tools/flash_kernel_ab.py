#!/usr/bin/env python3
"""Times versions of the port's flash-attention source against each other on
one NVIDIA GPU, in one process.

    python3 tools/flash_kernel_ab.py [--dtype bfloat16|float32] OLD.cu [OTHER.cu ...]

Builds ``texocr_tpu_torch/csrc/flash_attention.cu`` ("current") and each
given source (same C interface, e.g. the parent commit's copy from
``git show``) with the same nvcc flags, checks each at (8, 8, 631, 64) in the
chosen type (bfloat16 by default) and times each at the serving path's shapes
(split-head, unmasked; L2-warm and L2-cold; CUDA-graph replays, as
``chip_smoke.py`` times them). The check holds bfloat16 to the float32 plain
version within 2e-2, and float32 to float64 within 1e-4; a source that fails
it (say, a variant with one phase cut out, to see what that phase costs) is
timed all the same, and the tool then exits with 1. Sources run in the
order current, the others, the others reversed, current, so drift on the card
shows as a difference between a source's two rounds. Then one round each of
the plain version and of ``scaled_dot_product_attention`` (with the device
kernels it ran), and the bound per shape. Prints one JSON line per round, then
the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from texocr_tpu_torch.ops import build  # noqa: E402
from texocr_tpu_torch.ops import flash_attention as fa  # noqa: E402
from texocr_tpu_torch.ops.bench import (  # noqa: E402
    SERVING_SHAPES,
    attention_bound_ms,
    attention_f64,
    device_kernel_names,
    split_heads,
    time_ms,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def timed_row(name, shaped_calls) -> dict:
    """``shaped_calls``: (shape, call) pairs; device ms per call of each."""
    row = {"source": name}
    for shape, call in shaped_calls:
        # relaxed: an older source may make host-side CUDA calls on every
        # launch (cudaFuncSetAttribute), which a strict capture refuses.
        row[str(shape)] = {
            "ms": time_ms(call, capture_error_mode="relaxed"),
            "ms_l2_cold": time_ms(call, cold=True, capture_error_mode="relaxed"),
        }
    return row


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    parser.add_argument("sources", nargs="+", help="other versions of flash_attention.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = DTYPES[args.dtype]
    sources = {"current": build.CSRC_DIR / fa.SOURCE}
    for arg in args.sources:
        path = Path(arg).resolve()
        sources[path.stem if path.stem not in sources else str(path)] = path
    libs = {}
    for name, path in sources.items():
        library, log = build.build(str(path))
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"[build] {name}: {library.name} {regs}", flush=True)
        libs[name] = fa.bind(library)

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {shape: tuple(split_heads(gen, *shape, dtype) for _ in range(3))
              for shape in SERVING_SHAPES}
    q, k, v = inputs[SERVING_SHAPES[0]]
    if dtype == torch.float32:
        ref, tol, against = attention_f64(q, k, v, 0.125), 1e-4, "f64"
    else:
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), scale=0.125)
        tol, against = 2e-2, "f32"
    failed = []
    for name, lib in libs.items():
        got = fa.launch(lib, q, k, v, scale=0.125)
        err = (got.to(ref.dtype) - ref).abs().max().item()
        ok = err <= tol
        print(f"[check] {name}: max|kernel-{against}| {err:.3e} at {SERVING_SHAPES[0]} "
              f"{args.dtype} (tol {tol:g}) {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            failed.append(name)

    names = list(libs)
    for name in names + names[1:][::-1] + names[:1]:
        calls = [(shape, lambda lib=libs[name], q=q, k=k, v=v, dh=shape[3]:
                  fa.launch(lib, q, k, v, scale=dh ** -0.5))
                 for shape, (q, k, v) in inputs.items()]
        print(json.dumps(timed_row(name, calls)), flush=True)
    plain = [(shape, lambda q=q, k=k, v=v, dh=shape[3]:
              fa.flash_attention_plain(q, k, v, scale=dh ** -0.5))
             for shape, (q, k, v) in inputs.items()]
    print(json.dumps(timed_row("plain", plain)), flush=True)
    library = [(shape, lambda q=q, k=k, v=v, dh=shape[3]:
                torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=dh ** -0.5))
               for shape, (q, k, v) in inputs.items()]
    row = timed_row("library", library)
    row["kernels"] = {str(shape): device_kernel_names(call) for shape, call in library}
    print(json.dumps(row), flush=True)
    print(json.dumps({"source": "bound", **{str(shape): attention_bound_ms(q, k)
                                            for shape, (q, k, _) in inputs.items()}}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    if failed:
        print(f"flash_kernel_ab: {failed} disagree with the plain version", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
