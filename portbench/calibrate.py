"""Readings for setting the limits of `correct`, on the chip: runs of a
cell on several seeds in one process, each printing the numbers its
check compares, optionally with the control (the reference computed in
the next lower precision, "fp8") or with a fault planted under the timed
path (`faults`).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3
        --seconds 30 [--control fp8] [--fault half_batch]
        [--set lr=0.1] [--out calib.jsonl]

Each run appends one JSON line (cell, seed, what was planted, the
checks, the notes) to --out and prints it."""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench import run as bench_run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    for seed in [int(s) for s in args.seeds.split(",")]:
        cell = harness.cell(args.workload)
        for kv in args.set:
            k, v = kv.split("=", 1)
            cell["params"][k] = json.loads(v)
        torch.cuda.reset_peak_memory_stats()
        ctx, values, dev, _ = bench_run.execute(
            cell, seed, args.seconds, 0, control=args.control,
            fault=args.fault, t_start=time.perf_counter())
        line = json.dumps({"cell": args.workload, "seed": seed,
                           "control": args.control, "fault": args.fault,
                           "set": args.set, "checks": ctx.checks,
                           "metrics": values, "notes": ctx.notes,
                           "memory_peak_bytes": dev["memory_peak_bytes"],
                           "setup_s": ctx.setup_s}, default=str)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del ctx
        ctx_free()


def ctx_free():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
