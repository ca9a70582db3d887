"""Variable-length collectives over the world (counterpart:
tutel_tpu/examples/all_to_all_v.py).

Rank d sends d + 1 rows to every peer with `net.batch_all_to_all_v` (the
rows for peer p hold the value 100 * d + p), then all-gathers its valid
rows with `net.batch_all_gather_v`, and prints what it received.

Run:  python -m tutel_tpu_torch.examples.all_to_all_v [--device cpu]
Over N ranks: torchrun --nproc_per_node N -m
          tutel_tpu_torch.examples.all_to_all_v --device cpu

Returns this rank's (received rows [capacity, cols], recv counts [W],
gathered rows [capacity * W, cols], gathered counts [W]) on the CPU.
"""

import argparse

import torch

from tutel_tpu_torch import net, system
from tutel_tpu_torch.utils import resolve_device


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--capacity", type=int, default=64)
    parser.add_argument("--cols", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def run(args, log=print):
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    w, d, cap = env.global_size, env.global_rank, args.capacity
    c = d + 1
    if w * c > cap:
        raise ValueError(f"--capacity {cap} holds fewer than the {w * c} "
                         f"rows rank {d} sends")
    block = torch.zeros((cap, args.cols), dtype=torch.float32)
    for p in range(w):
        block[p * c:(p + 1) * c] = 100 * d + p
    counts = torch.full((w,), c, dtype=torch.int32)
    out, recv = net.batch_all_to_all_v(block.to(device), counts.to(device),
                                       output_size=cap)
    total = torch.sum(recv).to(device)
    gathered, gcounts = net.batch_all_gather_v(out, total,
                                               output_size=cap * w)
    out, recv = out.cpu(), recv.cpu()
    log(f"[rank {d}] recv_counts = {recv.tolist()}, rows:")
    off = 0
    for s in range(w):
        rows = out[off:off + int(recv[s])]
        log(f"  from {s}: {rows[:, 0].tolist()}")
        off += int(recv[s])
    log(f"[all_gather_v] per-rank valid rows = {gcounts.tolist()}")
    return out, recv, gathered.cpu(), gcounts.cpu()


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
