"""Data parallelism with the gradient all-reduce done by hand (counterpart:
tutel_tpu/examples/helloworld_ddp_tutel.py).

Where helloworld_ddp leaves the gate gradient's reduction to the layer's
backward, this example follows the reference's manual protocol: every
rank runs a one-rank layer on its own tokens, and after the backward the
gradients of the parameters that `scan_expert_func` did not mark are
averaged over the ranks (`net.simple_all_reduce(g) / W`), while the
marked expert parameters (the reference's skip_allreduce) keep their
local gradient. Loss mean(out^2) + l_aux; plain SGD p - 1e-2 * g.

Each rank computes what the JAX example's per-device step computes. That
step's local layer is built for num_local_experts experts but handed the
world's gate and a copy of every expert of the world, so it routes each
token to its top min(top, num_local_experts) of the world's experts, with
the capacity of num_local_experts experts. Here the local layer is a
one-rank layer over the world's experts (a replica on every rank), called
with that top_k and capacity (`capacity_override`).

Run:  python -m tutel_tpu_torch.examples.helloworld_ddp_tutel
          [--device cpu]
Over N ranks: torchrun --nproc_per_node N -m
          tutel_tpu_torch.examples.helloworld_ddp_tutel --device cpu

`run(args, params=..., x=...)` takes the world's initial parameters and
the global input [W * batch * tokens, M] from elsewhere (the tests pass
the JAX example's); without them they are drawn on the CPU from seeds 1
and 0. Returns the per-step losses (the mean over the ranks).
"""

import argparse

import torch

from tutel_tpu_torch import moe, net, system
from tutel_tpu_torch.ops import routing
from tutel_tpu_torch.utils import resolve_device, tree_leaves, tree_replace


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_tokens", type=int, default=64)
    parser.add_argument("--model_dim", type=int, default=32)
    parser.add_argument("--hidden_size", type=int, default=64)
    parser.add_argument("--num_local_experts", type=int, default=1)
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--num_steps", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def build_layer(args, device, num_experts, scan_expert_func=None):
    return moe.moe_layer(
        gate_type={"type": "top", "k": args.top, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": num_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1),
        scan_expert_func=scan_expert_func, group=[0], device=device)


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    w, me, nle = env.global_size, env.global_rank, args.num_local_experts

    skip_mask = {}   # expert param name -> True: its gradient stays local
    world_layer = build_layer(
        args, "cpu", nle * w,
        scan_expert_func=lambda name, p: skip_mask.setdefault(name, True))
    drawn = world_layer.init(torch.Generator().manual_seed(1))
    if params is None:
        params = drawn
    log(f"skip_allreduce marks: {sorted(skip_mask)}")

    local_tokens = args.batch_size * args.num_tokens
    if x is None:
        x = torch.randn((w * local_tokens, args.model_dim),
                        generator=torch.Generator().manual_seed(0))
    x = x[me * local_tokens:(me + 1) * local_tokens].to(device)
    layer = build_layer(args, device, nle * w)
    top_k = min(args.top, nle)
    capacity = routing.compute_static_capacity(local_tokens, nle, top_k, 1.0)
    gates = [{k: v.to(device) for k, v in params["gates"][0].items()}]
    experts = {k: v.to(device) for k, v in params["experts"].items()}

    losses = []
    for i in range(args.num_steps):
        p = {"gates": gates, "experts": experts}
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        p = tree_replace(p, leaves)
        out, l_aux = layer(p, x, training=True, top_k=top_k,
                           capacity_override=capacity)
        loss = torch.mean(out ** 2) + l_aux
        g = tree_replace(p, torch.autograd.grad(loss, leaves))
        # the manual protocol: average what is not marked, keep the rest
        g_gate = {k: net.simple_all_reduce(v) / w
                  for k, v in g["gates"][0].items()}
        g_exp = {k: v if skip_mask.get(k) else net.simple_all_reduce(v) / w
                 for k, v in g["experts"].items()}
        gates = [{k: (v - 1e-2 * g_gate[k]).detach()
                  for k, v in p["gates"][0].items()}]
        experts = {k: (v - 1e-2 * g_exp[k]).detach()
                   for k, v in p["experts"].items()}
        losses.append(float(net.simple_all_reduce(loss.detach()) / w))
        log(f"STEP-{i}: loss = {losses[-1]:.6f}")
    return losses


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
