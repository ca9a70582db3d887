#!/usr/bin/env python3
"""Profile one decode chunk of the MoE server on one NVIDIA card, on the
two-call path (K1 twice a step), the W4A8 fused path (K3 once a step) and
the W4A8 two-call path (K5 twice a step).

Run from the root of a checkout, with no arguments:

    python3 tools/moe_step_profile.py

It builds `chip_smoke.py`'s decode server (`decode_layer`,
`decode_params`: 128 experts x 2048 x 2048, INT4, top-2, bfloat16, 256
slots) and prints, for each path, `chip_smoke.moe_profiles`' line: the
device's busy ms per step and busy share of the chunk, the expert
kernel's launches, device ms per step and share, and the top kernels;
the first line is the card's name and power limit. On an older checkout
copy this file and this checkout's `chip_smoke.py` there.
"""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("moe_step_profile.py: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    layer = cs.decode_layer(0)
    cs.moe_profiles(layer, cs.decode_layer(8), cs.decode_params(layer), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
