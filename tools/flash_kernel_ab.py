#!/usr/bin/env python3
"""Times versions of the port's flash-attention source against each other on
one NVIDIA GPU, in one process.

    python3 tools/flash_kernel_ab.py OLD.cu [OTHER.cu ...]

Builds ``texocr_tpu_torch/csrc/flash_attention.cu`` ("current") and each
given source (same C interface, e.g. the parent commit's copy from
``git show``) with the same nvcc flags, checks each at (8, 8, 631, 64) against
the float32 plain version, and times each at the serving path's shapes
(bfloat16, split-head, unmasked; L2-warm and L2-cold; CUDA-graph replays, as
``chip_smoke.py`` times them). Sources run in the order current, the others,
the others reversed, current, so drift on the card shows as a difference
between a source's two rounds. Prints one JSON line per round, then the
card's name and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from texocr_tpu_torch.ops import build  # noqa: E402
from texocr_tpu_torch.ops import flash_attention as fa  # noqa: E402
from texocr_tpu_torch.ops.bench import SERVING_SHAPES, split_heads, time_ms  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("flash_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sources = {"current": build.CSRC_DIR / fa.SOURCE}
    for arg in argv:
        path = Path(arg).resolve()
        sources[path.stem if path.stem not in sources else str(path)] = path
    libs = {}
    for name, path in sources.items():
        library, log = build.build(str(path))
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"[build] {name}: {library.name} {regs}", flush=True)
        libs[name] = fa.bind(library)

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {shape: tuple(split_heads(gen, *shape, torch.bfloat16) for _ in range(3))
              for shape in SERVING_SHAPES}
    q, k, v = inputs[SERVING_SHAPES[0]]
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), scale=0.125)
    for name, lib in libs.items():
        err = (fa.launch(lib, q, k, v, scale=0.125).float() - ref).abs().max().item()
        print(f"[check] {name}: max|kernel-f32| {err:.3e} at {SERVING_SHAPES[0]}", flush=True)
        if not err <= 2e-2:
            raise AssertionError(f"{name} disagrees with the plain version")

    names = list(libs)
    order = names + names[1:][::-1] + names[:1]
    for name in order:
        row = {"source": name}
        for shape, (q, k, v) in inputs.items():
            def call(lib=libs[name], q=q, k=k, v=v, dh=shape[3]):
                fa.launch(lib, q, k, v, scale=dh ** -0.5)
            # relaxed: an older source may make host-side CUDA calls on every
            # launch (cudaFuncSetAttribute), which a strict capture refuses.
            row[str(shape)] = {
                "ms": time_ms(call, capture_error_mode="relaxed"),
                "ms_l2_cold": time_ms(call, cold=True, capture_error_mode="relaxed"),
            }
        print(json.dumps(row), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
