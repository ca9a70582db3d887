#!/usr/bin/env python3
"""Run `chip_smoke.py`'s step 17 alone on one NVIDIA card: the MLP graph
through `tutel_tpu_torch.parted` at helloworld's default width under a
world-1 NCCL group, its default plan and five forced plans against the
plain torch chain, with K10 (squared ReLU, float32) as the activation node
(well under a minute with K10's build); then where a step's time goes.

Run from the root of a checkout, with no arguments:

    python3 tools/parted_phases.py

It prints the card's name and power limit, builds K10's float32 instance,
starts the world-1 NCCL group (`init_world1`) and runs `parted_phase`,
which prints its JSON line. Then three calls each of the ZERO plan, the
A2A plan and the plain chain run under torch.profiler (device busy ms and
ms by kernel kind) beside the same three calls timed by CUDA events, and
a line of those profiles is printed. A failed check raises, so the script
exits non-zero; so does a profile whose device busy ms fall below
BUSY_SHARE_MIN of the events' window (a profile that lost events).
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tutel_tpu_torch import parted, system  # noqa: E402
from tutel_tpu_torch.csrc import build  # noqa: E402
from tutel_tpu_torch.parted import spmdx  # noqa: E402

# the profile's device busy ms over the CUDA-event ms of the same three
# calls run unprofiled: the card idles only in a plan's host gaps (ZERO's
# busy share under the profiler read 0.91, the chain's 1.00, on an H100)
BUSY_SHARE_MIN = 0.75
REPS = 3


def event_ms(fn):
    """fn() between two CUDA events, after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def parted_profile(smi):
    """Three calls each of the ZERO and A2A plans (the slowest) and of the
    plain chain under torch.profiler, each beside its CUDA-event window;
    raises if a profile's busy ms fall below BUSY_SHARE_MIN of it."""
    y2 = cs.parted_graph(spmdx)
    fns = {name: parted.compile_graph(
        y2, spmdx.Config(cs.PARTED_PLANS[name][0])) for name in ("zero",
                                                                "a2a")}
    args = fns["zero"].example_inputs(cs.SEED)
    fns["plain_chain"] = lambda *a: cs.SQUARED_RELU.fn(a[0] @ a[1]) @ a[2]
    profiles = {}
    with torch.no_grad():
        for name, fn in fns.items():
            def calls():
                return [fn(*args) for _ in range(REPS)]
            window = event_ms(calls)
            p = cs.profiled(calls)
            share = p["device_busy_ms"] / window
            profiles[name] = {"event_ms": window, "busy_over_event": share,
                              **{k: p[k] for k in (
                                  "device_busy_ms", "span_ms", "busy_share",
                                  "ms_by_kind")}}
            if share < BUSY_SHARE_MIN:
                raise RuntimeError(
                    f"parted profile of {name}: {p['device_busy_ms']} busy "
                    f"ms for {window} event ms ({share} < {BUSY_SHARE_MIN}):"
                    " the profile lost events")
    return {"phase": "parted_profile", "calls": REPS,
            "busy_share_min": BUSY_SHARE_MIN, "profiles": profiles,
            "card": smi}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all((), [cs.SQUARED_RELU.cuda_source(torch.float32)])
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    env = cs.init_world1()
    try:
        print(json.dumps(cs.parted_phase(smi, env)), flush=True)
        print(json.dumps(parted_profile(smi)), flush=True)
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
