"""Pipeline-parallel MoE training demo, GPipe (counterpart:
tutel_tpu/examples/helloworld_pipeline.py).

num_stages residual MoE blocks (top-2 of num_experts experts,
capacity_factor 1.0) form a GPipe pipeline over the 'pp' axis of the
world: rank s holds block s, and activations hop from stage to stage
(`parallel.pipeline`, `net.ppermute`). The same flags and loss as the JAX
example: mean((y - sin(cumsum(x)))^2) + 0.01 * l_aux, plain SGD
p - lr * g; the backward is autograd through the schedule.

Run:  python -m tutel_tpu_torch.examples.helloworld_pipeline
          --num_stages 1 [--device cpu]
Over N stages, one rank each (gloo for --device cpu, nccl for cuda):
      torchrun --nproc_per_node N -m
          tutel_tpu_torch.examples.helloworld_pipeline --device cpu
          --num_stages N

`run(args, params=..., x=...)` takes the stacked parameters of every
stage and the input from elsewhere (the tests pass the JAX example's
through `convert`); without them stage i's are drawn on the CPU from seed
i and x from seed 1. Every rank computes the loss of the same replicated
outputs and logs it.
"""

import argparse

import torch

from tutel_tpu_torch import moe, system
from tutel_tpu_torch.parallel import (ProcessMesh, local_stage_params,
                                      pipeline, stack_stage_params)
from tutel_tpu_torch.utils import resolve_device, sgd_step, tree_leaves, \
    tree_replace


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--num_stages", type=int, default=4)
    parser.add_argument("--n_micro", type=int, default=8)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--model_dim", type=int, default=32)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--num_experts", type=int, default=4)
    parser.add_argument("--num_steps", type=int, default=5)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--remat", action="store_true")
    return parser.parse_args(argv)


def build_layer(args, device, rank):
    """One stage's MoE block: a layer of this rank alone."""
    return moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0,
                   "gate_noise": 0.0},
        experts={"type": "ffn", "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=[rank],
        device=device)


def setup(args, params=None, x=None):
    """(device, mesh, the stage's layer, this rank's stage params, x):
    the world joined, its ranks as the 'pp' axis."""
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    if env.global_size != args.num_stages:
        raise ValueError(f"--num_stages {args.num_stages} != the world's "
                         f"{env.global_size} ranks (one stage a rank)")
    mesh = ProcessMesh(env.ranks, (args.num_stages,), ("pp",))
    layer = build_layer(args, device, env.global_rank)
    if params is None:     # every stage's parameters, drawn on the CPU
        cpu = build_layer(args, "cpu", env.global_rank)
        params = stack_stage_params([
            cpu.init(torch.Generator().manual_seed(i))
            for i in range(args.num_stages)])
    if x is None:
        x = torch.randn((args.batch, args.model_dim),
                        generator=torch.Generator().manual_seed(1))
    params = tree_replace(params, [p.to(device) for p in tree_leaves(params)])
    return device, mesh, layer, local_stage_params(params, mesh), x.to(device)


def stage_fn(layer):
    def stage(p, h):
        out, l_aux = layer(p, h)
        return h + out, l_aux
    return stage


def run(args, log=print, params=None, x=None):
    """Train num_steps steps; returns the per-step losses."""
    _, mesh, layer, local, x = setup(args, params, x)
    fwd = pipeline(stage_fn(layer), args.num_stages, mesh,
                   n_micro=args.n_micro, remat=args.remat, has_aux=True)
    target = torch.sin(torch.cumsum(x, dim=-1))

    def loss_fn(p):
        y, l_aux = fwd(p, x)
        return torch.mean((y - target) ** 2) + 0.01 * l_aux

    losses = []
    for step in range(args.num_steps):
        local, loss, _ = sgd_step(loss_fn, local, args.lr)
        losses.append(float(loss))
        log(f"STEP-{step}: loss = {losses[-1]:.6f}")
    return losses


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
