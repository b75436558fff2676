"""Readings behind the limits, and the serving cell's knee: run on the chip
by hand when a cell is defined, never by the benchmark's own runs.

    python3 portbench/calibrate.py readings --workload <cell> --seeds 1,2,3
        [--seconds S] [--controls fp8,int4_cache] [--fault half_batch|frozen]
        [--dtype float32]
    python3 portbench/calibrate.py sweep --workload <cell> --rates 12,16,20
        [--seconds S]

``readings`` runs the cell's timed path once per seed, in one process, at
the cell's own load for a short window, and prints per seed the numbers
compared (program), each control's reading at the same positions or steps
(the reference in a lower precision), whether the run is correct with each
control put in the program's place, and with ``--fault`` the numbers of the
program with that fault planted. ``sweep``
runs the open loop at each rate and prints the latency tails, the rate
completed and the drift of latency from the window's first third to its
last (a queue that grows).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from portbench import harness  # noqa: E402

FAULTS = ("half_batch", "frozen", "tokens")


def alter_tokens(tokens):
    """The first token of every row replaced by the next id: an answer
    altered where it is produced."""
    out = tokens.clone()
    out[:, 0] = (out[:, 0] + 1) % 997
    return out


def one(cell, seed, seconds, faults, device="cuda") -> dict:
    """One run; beside what it judged, the verdict of ``Run.judge`` with
    each control in turn put in the program's place."""
    run = harness.Run(cell, seed, seconds, False, device, time.perf_counter())
    run.faults.update(faults)
    harness.driver(cell.mix["driver"]).run(run)
    out = {"seed": seed, "correct": run.correct, "setup_s": run.setup_s,
           "checks": {k: v for k, (v, _) in run.checks.items()}, "e2e": run.e2e}
    numbers = run.counters.get("gaps") or run.counters["numbers"]
    verdicts = {}
    for side in numbers:
        run.faults["in_place"] = side
        run.judge(numbers)
        verdicts[side] = run.correct
    calls = run.counters.get("call_s")
    return {**out, "in_place_correct": verdicts, "numbers": numbers,
            "compared": run.counters.get("compared"),
            "call_s_median": statistics.median(calls) if calls else None}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("readings", "sweep"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--controls", default="")
    p.add_argument("--fault", choices=FAULTS)
    p.add_argument("--dtype", help="run the program in this compute type (a witness)")
    args = p.parse_args()
    cell = harness.load_cell(args.workload)
    if args.dtype:
        cell.config["model"]["dtype"] = args.dtype
    if args.mode == "readings":
        faults = {}
        if args.controls:
            faults["controls"] = args.controls.split(",")
        if args.fault == "tokens":
            faults["tokens"] = alter_tokens
        elif args.fault:
            faults[args.fault] = True
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(one(cell, seed, args.seconds, faults)), flush=True)
        return 0
    for rate in (float(r) for r in args.rates.split(",")):
        cell.mix["rate_per_s"] = rate
        run = harness.Run(cell, 1000 + int(rate), args.seconds, False, "cuda",
                          time.perf_counter())
        harness.driver(cell.mix["driver"]).run(run)
        print(json.dumps({"rate": rate, **run.e2e, "attempted": run.attempted,
                          "failed": run.failed, "fill": statistics.mean(
                              run.counters["fills"]) if run.counters["fills"] else None,
                          "late_p95": harness.percentile(run.counters["lateness_s"], 95),
                          "drift_s": run.counters.get("drift_s"),
                          "completed_per_s": run.counters.get("completed_per_s")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
