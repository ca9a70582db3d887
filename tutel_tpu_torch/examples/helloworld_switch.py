"""Dynamic switching of the MoE layer's per-call settings (counterpart:
tutel_tpu/examples/helloworld_switch.py).

The same layer is called with top_k / capacity_factor (and adaptive_r
under expert slicing) changed at every call, cycling through the JAX
example's configs. The JAX example's first-call "compile" and warm
"cached" labels measure XLA recompilation, which eager PyTorch does not
have; here each config's first-call and warm times are logged and
returned (host time around a call that ends in a synchronize on the
card), and nothing is asserted about them.

Run:  python -m tutel_tpu_torch.examples.helloworld_switch --steps 24
          [--device cpu]

`run(args, params=..., x=...)` takes the global parameters and the input
[batch, tokens, M] from elsewhere (the tests pass the JAX example's
through `convert`); without them they are drawn on the CPU from seeds 1
and 0. Returns (timings: config name -> per-call seconds, outputs: config
name -> (output, l_aux) of its last call, on the CPU).
"""

import argparse

import torch

from tutel_tpu_torch import moe, system
from tutel_tpu_torch.utils import resolve_device, tree_leaves, tree_replace

# the per-call config cycle (the JAX example's)
CONFIGS = [
    {"top_k": 2, "capacity_factor": 1.0},
    {"top_k": 1, "capacity_factor": 1.0},
    {"top_k": 2, "capacity_factor": 2.0},
    {"top_k": 2, "capacity_factor": 0.0},    # dropless
    {"top_k": 1, "capacity_factor": -1.2},   # capped dropless
]


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_tokens", type=int, default=512)
    parser.add_argument("--model_dim", type=int, default=1024)
    parser.add_argument("--hidden_size", type=int, default=1024)
    parser.add_argument("--num_experts", type=int, default=2)
    parser.add_argument("--steps", type=int, default=24)
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def build_layer(args, device, group):
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), dtype=dtype,
        parallel_type="adaptive:1", group=group, device=device)


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    layer = build_layer(args, device, env)
    if params is None:
        params = build_layer(args, "cpu", [env.global_rank]).init(
            torch.Generator().manual_seed(1))
    if x is None:
        x = torch.randn((args.batch_size, args.num_tokens, args.model_dim),
                        generator=torch.Generator().manual_seed(0))
    params = layer.shard_params(tree_replace(
        params, [p.to(device) for p in tree_leaves(params)]))
    rows = x.shape[0] // env.global_size
    x = x[env.global_rank * rows:(env.global_rank + 1) * rows]
    x = x.to(device=device, dtype=layer.dtype)

    configs = list(CONFIGS)
    if layer.sharded_count > 1:
        configs += [{"top_k": 2, "capacity_factor": 1.0, "adaptive_r": r}
                    for r in layer.valid_rs if r > 0]
    timings, outputs = {}, {}
    with torch.no_grad():
        for i in range(args.steps):
            cfg = configs[i % len(configs)]
            t0 = system.record_time()
            out, l_aux = layer(params, x, **cfg)
            dt = system.record_time(out) - t0
            name = str(sorted(cfg.items()))
            state = "first" if name not in timings else "warm"
            timings.setdefault(name, []).append(dt)
            outputs[name] = (out.float().cpu(), float(l_aux))
            log(f"STEP-{i} {cfg} [{state}]: {dt * 1e3:.2f} ms, "
                f"l_aux={float(l_aux):.5f}")

    log("\n[Summary] first-call vs warm per config:")
    for name, ts in timings.items():
        warm = ts[1:] or ts
        log(f"  {name}: first {ts[0] * 1e3:.1f} ms, "
            f"warm avg {sum(warm) / len(warm) * 1e3:.2f} ms over "
            f"{len(warm)}")
    return timings, outputs


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
