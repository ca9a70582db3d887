#!/usr/bin/env python3
"""Run `chip_smoke.py`'s step 16 alone on one NVIDIA card: K6 and K7 at
head_dim 16 and 32 against their twins, then the slice-6c examples and the
autotuner under a world-1 NCCL group (about two minutes with the build of
K6, K7 and K8).

Run from the root of a checkout, with no arguments:

    python3 tools/slice6c_phases.py

It prints the card's name and power limit, builds K6, K7 and K8, runs
`small_head_dim_checks`, computes the CPU references (`slice6c_cpu_refs`),
starts the world-1 NCCL group (`init_world1`) and runs `slice6c_phases`,
which prints each phase's JSON line. A failed check raises, so the script
exits non-zero.
"""

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tutel_tpu_torch import system  # noqa: E402
from tutel_tpu_torch.csrc import build  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build_all(("decode_attn", "prefill_attn", "kv_write"))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cs.small_head_dim_checks(cs.hbm_bytes_per_s(smi))
    refs = cs.slice6c_cpu_refs()
    env = cs.init_world1()
    try:
        cs.slice6c_phases(smi, env, refs)
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
