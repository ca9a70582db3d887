"""Expert-choice MoE training demo (counterpart:
tutel_tpu/examples/helloworld_expert_choice.py).

Each expert picks its own top-C tokens (C = capacity_factor * S / E over
the global token pool), so every expert's load is exactly C; the
auxiliary is the router z-loss. The same flags and loss as the JAX
example: mean((y - tanh(roll(x, 1)))^2) + zloss_weight * z, plain SGD
p - lr * g, 20 steps; the run checks that the loss falls.

Run:  python -m tutel_tpu_torch.examples.helloworld_expert_choice
          [--device cpu]
Over N ranks as pure expert parallelism (gloo for --device cpu, nccl for
cuda; the layer all-gathers the scores and exchanges the selected rows):
      torchrun --nproc_per_node N -m
          tutel_tpu_torch.examples.helloworld_expert_choice --device cpu
          --num_devices N

`run(args, params=..., x=...)` takes the global parameters and input from
elsewhere (the tests pass the JAX example's through `convert`); without
them they are drawn on the CPU from seeds 1 and 0. Each rank holds its
shard of the experts and its rows of the batch; its loss is its share of
the global loss (its rows' squared errors over the global count, and the
replicated z-loss over the world), and the logged loss is their sum.
"""

import argparse

import torch

from tutel_tpu_torch import moe, net, system
from tutel_tpu_torch.utils import resolve_device, sgd_step, tree_leaves, \
    tree_replace


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--num_devices", type=int, default=1)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--num_tokens", type=int, default=64)
    parser.add_argument("--model_dim", type=int, default=64)
    parser.add_argument("--hidden_size", type=int, default=128)
    parser.add_argument("--num_local_experts", type=int, default=4)
    parser.add_argument("--capacity_factor", type=float, default=2.0)
    parser.add_argument("--zloss_weight", type=float, default=1e-3)
    parser.add_argument("--num_steps", type=int, default=20)
    parser.add_argument("--lr", type=float, default=5e-2)
    return parser.parse_args(argv)


def build_layer(args, device, group):
    return moe.moe_layer(
        gate_type={"type": "expert_choice",
                   "capacity_factor": args.capacity_factor,
                   "gate_noise": 0.0},
        experts={"type": "ffn",
                 "num_experts_per_device": args.num_local_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=group,
        device=device)


def run(args, log=print, params=None, x=None):
    """Train num_steps steps; returns the per-step global losses."""
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    w = env.global_size
    if args.num_devices != w:
        raise ValueError(f"--num_devices {args.num_devices} != the world's "
                         f"{w} ranks")
    layer = build_layer(args, device, env)
    if params is None:     # the global parameters, drawn on the CPU
        params = build_layer(args, "cpu", [env.global_rank]).init(
            torch.Generator().manual_seed(1))
    if x is None:
        x = torch.randn((args.batch * args.num_tokens, args.model_dim),
                        generator=torch.Generator().manual_seed(0))
    params = layer.shard_params(tree_replace(
        params, [p.to(device) for p in tree_leaves(params)]))
    x = x.to(device)
    target = torch.tanh(torch.roll(x, 1, dims=1))
    rows = x.shape[0] // w
    mine = slice(env.global_rank * rows, (env.global_rank + 1) * rows)
    x_local, t_local = x[mine], target[mine]

    def loss_fn(p):
        out, z_loss = layer(p, x_local, training=True)
        return torch.sum((out - t_local) ** 2) / target.numel() \
            + args.zloss_weight * z_loss / w

    losses = []
    for i in range(args.num_steps):
        params, loss, _ = sgd_step(loss_fn, params, args.lr)
        losses.append(float(net.simple_all_reduce(loss)))
        log(f"STEP-{i}: loss = {losses[-1]:.5f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses[0]} -> "
                           f"{losses[-1]}")
    log(f"\n[Summary] expert-choice loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {args.num_steps} steps ({w} device(s)).")
    return losses


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
