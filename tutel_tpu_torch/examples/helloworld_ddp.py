"""Data-parallel training with MoE expert sharding (counterpart:
tutel_tpu/examples/helloworld_ddp.py).

The helloworld model over every rank of the world: tokens split over the
ranks (data parallelism on the batch), experts sharded over them (expert
parallelism). The gate's parameters are replicated, and the layer's
backward sums their gradient over the ranks, as JAX's jit inserts the
psum for a replicated parameter; JAX's check that the gate gradient is
replicated becomes a check that it is bitwise equal on every rank. Loss:
the nll of token 0 under log_softmax over the token axis of sum(out, -1),
plus 0.01 * l_aux; plain SGD p - lr * g.

Run:  python -m tutel_tpu_torch.examples.helloworld_ddp [--device cpu]
Over N ranks (gloo for --device cpu, nccl for cuda):
      torchrun --nproc_per_node N -m tutel_tpu_torch.examples.helloworld_ddp
          --device cpu

`run(args, params=..., x=...)` takes the global parameters and the input
[batch, tokens, M] from elsewhere (the tests pass the JAX example's
through `convert`); without them they are drawn on the CPU from seeds 1
and 0. Each rank holds its batch rows; its loss is its share of the
global loss, and the logged loss is their sum. Returns the per-step
losses.
"""

import argparse

import torch

from tutel_tpu_torch import moe, net, system
from tutel_tpu_torch.utils import resolve_device, sgd_step, tree_leaves, \
    tree_replace


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--num_tokens", type=int, default=256)
    parser.add_argument("--model_dim", type=int, default=256)
    parser.add_argument("--hidden_size", type=int, default=256)
    parser.add_argument("--num_local_experts", type=int, default=1)
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--num_steps", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def build_layer(args, device, group, num_local_experts=None):
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return moe.moe_layer(
        gate_type={"type": "top", "k": args.top, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device":
                 num_local_experts or args.num_local_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), dtype=dtype,
        group=group, device=device)


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    w, me = env.global_size, env.global_rank
    layer = build_layer(args, device, env)
    if params is None:       # the world's experts, drawn on the CPU
        params = build_layer(args, "cpu", [0], layer.num_global_experts
                             ).init(torch.Generator().manual_seed(1))
    if x is None:
        x = torch.randn((args.batch_size, args.num_tokens, args.model_dim),
                        generator=torch.Generator().manual_seed(0))
    params = layer.shard_params(tree_replace(
        params, [p.to(device) for p in tree_leaves(params)]))
    rows = args.batch_size // w
    x = x[me * rows:(me + 1) * rows].to(device=device, dtype=layer.dtype)

    def loss_fn(p):
        out, l_aux = layer(p, x, training=True)
        logits = torch.log_softmax(out.float().sum(dim=2), dim=1)
        return -logits[:, 0].sum() / args.batch_size + 0.01 * l_aux / w

    losses = []
    for i in range(args.num_steps):
        t0 = system.record_time()
        params, loss, grads = sgd_step(loss_fn, params, args.lr)
        loss = net.simple_all_reduce(loss)
        dt = system.record_time(loss) - t0
        losses.append(float(loss))
        log(f"STEP-{i}: loss = {losses[-1]:.5f}, step_time = {dt:.4f} s")

    # the gate gradient: every rank must hold the same bits (the sum over
    # the ranks that the layer's backward takes)
    gate_grad = tree_replace(params, grads)["gates"][0]["wg"]
    every = net.simple_all_gather(gate_grad[None])
    same = all(torch.equal(every[0], g) for g in every)
    log(f"[Check] gate grad equal on all {w} ranks: {same}")
    if not same:
        raise RuntimeError("the gate gradient differs between ranks")
    return losses


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
