"""Multi-process helloworld: one process a rank, started by the launcher
(counterpart: tutel_tpu/examples/helloworld_multiprocess.py).

    OMPI_COMM_WORLD_SIZE=2 OMPI_COMM_WORLD_RANK=r MASTER_PORT=p \\
        python -m tutel_tpu_torch.launcher.run -m \\
        tutel_tpu_torch.examples.helloworld_multiprocess --device cpu

Each process joins the process group the launcher's environment
describes (`system.maybe_init_distributed`, through
`init_data_model_parallel`), holds its shard of the experts and its rows
of the global input (the input split over the expert-parallel ranks), and
runs the same training step; the loss it prints is the global loss, the
same on every rank. `--use_2dh` runs the layer's two-level all-to-all
over a (hosts, ranks a host) mesh with one rank a host, so its outer leg
crosses process boundaries.

`run(args, params=..., x=...)` takes the global parameters and the input
[num_samples, M] from elsewhere (the tests pass the JAX example's through
`convert`); without them they are drawn on the CPU from seeds 0 and 1.
Returns the per-step losses.
"""

import argparse

import torch

from tutel_tpu_torch import moe, net, system
from tutel_tpu_torch.utils import resolve_device, sgd_step, tree_leaves, \
    tree_replace


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_samples", type=int, default=64)
    parser.add_argument("--model_dim", type=int, default=32)
    parser.add_argument("--hidden_size", type=int, default=64)
    parser.add_argument("--num_steps", type=int, default=3)
    parser.add_argument("--use_2dh", action="store_true",
                        help="the two-level all-to-all on a (hosts, ranks "
                             "a host) mesh, one rank a host")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def build_layer(args, device, group, num_experts=1, use_2dh=False,
                num_hosts=None):
    return moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": num_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=group,
        use_2dh=use_2dh, num_hosts=num_hosts, device=device)


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    w, me = env.global_size, env.global_rank
    log(f"[rank {me}] world={w} ranks, {w} processes")
    layer = build_layer(args, device, env, use_2dh=args.use_2dh,
                        num_hosts=w if args.use_2dh else None)
    if params is None:       # the global parameters, drawn on the CPU
        params = build_layer(args, "cpu", [0], layer.num_global_experts
                             ).init(torch.Generator().manual_seed(0))
    if x is None:
        x = torch.randn((args.num_samples, args.model_dim),
                        generator=torch.Generator().manual_seed(1))
    params = layer.shard_params(tree_replace(
        params, [p.to(device) for p in tree_leaves(params)]))
    rows = x.shape[0] // w
    x_local = x[me * rows:(me + 1) * rows].to(device)

    def loss_fn(p):
        out, l_aux = layer(p, x_local, training=True)
        return torch.sum(out.float() ** 2) / (x.shape[0] * out.shape[-1]) \
            + l_aux / w

    losses = []
    for step in range(args.num_steps):
        params, loss, _ = sgd_step(loss_fn, params, 1e-2)
        losses.append(float(net.simple_all_reduce(loss)))
        log(f"STEP-{step}: loss = {losses[-1]:.6f}")
    return losses


def main():
    try:
        run(build_args(), log=lambda *a: print(*a, flush=True))
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
