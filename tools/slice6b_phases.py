#!/usr/bin/env python3
"""Run `chip_smoke.py`'s step 15 alone on one NVIDIA card: sequence
parallelism, the vision model and the host library (no CUDA kernel to
build, about a minute).

Run from the root of a checkout, with no arguments:

    python3 tools/slice6b_phases.py

It prints the card's name and power limit, computes the CPU references
(`slice6b_cpu_refs`), starts the world-1 NCCL group (`init_world1`) and
runs `slice6b_phases`, which prints each phase's JSON line. A failed check
raises, so the script exits non-zero.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tutel_tpu_torch import system  # noqa: E402


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    refs = cs.slice6b_cpu_refs()
    env = cs.init_world1()
    try:
        cs.slice6b_phases(smi, env, refs)
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
