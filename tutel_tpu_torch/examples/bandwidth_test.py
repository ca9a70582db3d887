"""Collective bandwidth over the world (counterpart:
tutel_tpu/examples/bandwidth_test.py).

AllToAll, AllReduce, AllGather and ReduceScatter over the world's process
group, each chained `--iters` times as the JAX example chains them (acc =
op(acc * 1.0000001)) after one warm-up chain. The reported rate is the
reference's algorithmic bandwidth: the global payload's bytes over the
time of one op, from CUDA events on the card, or a synchronized wall
clock on the CPU. On one rank every op is a local copy, not a transfer
over a link.

Run:  python -m tutel_tpu_torch.examples.bandwidth_test --size_mb 64
          [--device cpu]
Over N ranks: torchrun --nproc_per_node N -m
          tutel_tpu_torch.examples.bandwidth_test --device cpu

Returns (GB/s by op, this rank's last chain output by op, on the CPU).
"""

import argparse
import time

import torch

from tutel_tpu_torch import net, system
from tutel_tpu_torch.utils import resolve_device


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--size_mb", type=int, default=64)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--num_devices", type=int, default=0)
    return parser.parse_args(argv)


def ops(w):
    return {
        "AllToAll": net.simple_all_to_all,
        "AllReduce": net.simple_all_reduce,
        "AllGather": lambda t: net.simple_all_gather(t)[:t.shape[0]],
        "ReduceScatter": lambda t: net.simple_reduce_scatter(t).repeat(w, 1),
    }


def run(args, log=print):
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    w, me = env.global_size, env.global_rank
    if args.num_devices and args.num_devices != w:
        raise ValueError(f"--num_devices {args.num_devices} != the world's "
                         f"{w} ranks")
    n = args.size_mb * 1024 * 1024 // 4 // (w * w) * (w * w)
    # this rank's block [w, n / (w * w)] of the global arange, so the
    # all-to-all's split divides by w
    x = torch.arange(n, dtype=torch.float32).reshape(w * w, -1)[
        me * w:(me + 1) * w].to(device)

    def chained(op):
        acc = x
        for _ in range(args.iters):
            acc = op(acc * 1.0000001)
        return acc

    results, outputs = {}, {}
    with torch.no_grad():
        for name, op in ops(w).items():
            r = chained(op)                                   # warm-up
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                r = chained(op)
                end.record()
                torch.cuda.synchronize()
                dt = start.elapsed_time(end) / 1e3 / args.iters
            else:
                net.barrier()
                t0 = time.perf_counter()
                r = chained(op)
                net.barrier()
                dt = (time.perf_counter() - t0) / args.iters
            gbs = n * 4 / dt / 1e9
            results[name] = gbs
            outputs[name] = r.cpu()
            log("[%s] % 10.3f GB/s  (%.3f ms, %d ranks, %d MB)" %
                (name, gbs, dt * 1e3, w, n * 4 // 2 ** 20))
    return results, outputs


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
