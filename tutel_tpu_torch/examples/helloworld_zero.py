"""ZeRO-1 data-parallel training of one MoE layer (counterpart:
tutel_tpu/examples/helloworld_zero.py).

Pure data parallelism with sharded optimizer state: the layer is one
rank's math (each rank builds it over a one-rank group of its own, made by
`net.create_standalone_group`, every rank making every rank's group in one
order), the tokens are split over the ranks, and `net.ZeroOptimizer`
keeps Adam's state only for this rank's flat shard of each parameter; its
reduce-scatter of the gradients (their sum over the ranks) is the
data-parallel all-reduce. Each rank's loss is mean(out^2) + 0.01 * l_aux
over its rows; the printed loss is the mean over the ranks.

Run:  python -m tutel_tpu_torch.examples.helloworld_zero [--device cpu]
Over N ranks (gloo for --device cpu, nccl for cuda):
      torchrun --nproc_per_node N -m tutel_tpu_torch.examples.helloworld_zero
          --device cpu

`run(args, params=..., x=...)` takes the global parameters and input from
elsewhere (the tests pass the JAX example's through `convert`); without
them they are drawn from seeds 1 and 0 on the CPU. The training gate
noise comes from a Generator seeded with 2 plus the rank.
"""

import argparse

import torch

from tutel_tpu_torch import moe, net, system
from tutel_tpu_torch.utils import resolve_device, tree_leaves, tree_replace


def build_layer(args, device, group):
    return moe.moe_layer(
        gate_type={"type": "top", "k": args.top, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=group,
        device=device)


def run(args, log=print, params=None, x=None):
    """Train num_steps ZeRO steps; returns the per-step losses (the mean
    over the ranks)."""
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    w, me = env.global_size, env.global_rank
    # one one-rank group a rank, made by every rank in one order
    own = None
    for r in range(w):
        g = net.create_standalone_group([r])
        own = g if r == me else own
    layer = build_layer(args, device, own if own is not None else [me])
    if params is None:                  # drawn on the CPU for every device
        params = build_layer(args, "cpu", [me]).init(
            torch.Generator().manual_seed(1))
    if x is None:
        x = torch.randn((args.batch_size * args.num_tokens, args.model_dim),
                        generator=torch.Generator().manual_seed(0))
    params = tree_replace(params, [p.to(device) for p in tree_leaves(params)])
    if x.shape[0] % w:
        raise ValueError(f"{x.shape[0]} tokens do not split over {w} ranks")
    rows = x.shape[0] // w
    x_local = x[me * rows:(me + 1) * rows].to(device)

    opt = net.ZeroOptimizer(torch.optim.Adam, None, lr=args.lr)
    state = opt.init(params)
    key = torch.Generator(device=device).manual_seed(2 + me)
    losses = []
    for i in range(args.num_steps):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        out, l_aux = layer(tree_replace(params, leaves), x_local, key=key,
                           training=True)
        loss = torch.mean(out.float() ** 2) + 0.01 * l_aux
        grads = torch.autograd.grad(loss, leaves)
        params, state = opt.step(params, list(grads), state)
        mean = net.simple_all_reduce(loss.detach()) / w
        losses.append(float(mean))
        log(f"STEP-{i}: loss = {losses[-1]:.5f}")
    shard = next(iter(state.state.values()))["exp_avg"]
    log(f"[Check] optimizer-state leaf is 1/{w} of its parameter: "
        f"shape {tuple(shard.shape)}")
    return losses


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--num_tokens", type=int, default=64)
    parser.add_argument("--model_dim", type=int, default=128)
    parser.add_argument("--hidden_size", type=int, default=128)
    parser.add_argument("--num_experts", type=int, default=2)
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--num_steps", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
