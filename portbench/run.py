"""The benchmark of texocr_tpu_torch: one cell, one seed, one window.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic (``harness.load_cell``), makes
the weights and inputs from the seed, warms up every shape the traffic uses
(``setup_s``), measures for ``--seconds``, checks what the timed path
produced against the plain float32 reference, and prints one JSON line
last: the end-to-end metrics (``--trace 0``) or the per-layer ones
(``--trace 1``), read from the window's counters and from a profiled slice:
of the serving window under its load, or of one more batch or a few more
training steps after a batch or training window closes. The numbers
compared, each with its limit, close both the line (under ``checks``) and
standard error.

It needs a CUDA device: without one, or with fewer than the cell asks for,
it exits with code 2 and prints no result. It exits with code 3 and no
result if JAX or the JAX package was loaded by the end of the run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

# Build and kernel caches live in the checkout, at fixed paths.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(HERE / ".cache" / sub)
os.environ.setdefault("USE_FLAX", "0")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str,
             bench_path: Path = None, data_dir: Path = None, faults=None) -> dict:
    """One run of ``workload``; returns the result line's object. ``device``
    "cpu" drives the same path on the CPU (tests); there it refuses a traced
    run, whose metrics only a CUDA device gives."""
    from portbench import harness

    cell = harness.load_cell(workload, bench_path or harness.ROOT / "BENCHMARK.json",
                             data_dir or harness.HERE)
    if trace and device != "cuda":
        raise RuntimeError("--trace 1 reads device metrics (busy time, kernels, memory), "
                           "which need a CUDA device; there is none here")
    run = harness.Run(cell, seed, seconds, trace, device, T_START)
    run.faults.update(faults or {})
    harness.driver(cell.mix["driver"]).run(run)
    return harness.result(run)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    from portbench import harness

    chips = harness.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    except Exception:
        # Exit now: a failed run leaves the profiler's and the driver's
        # threads behind, which can hold an orderly exit forever.
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
