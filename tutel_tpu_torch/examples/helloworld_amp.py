"""Mixed-precision MoE training (counterpart:
tutel_tpu/examples/helloworld_amp.py).

bfloat16 compute over float32 master parameters, as in the JAX example:
the layer is built with `dtype=torch.bfloat16` (its activations and the
expert weights at their point of use are bfloat16), the parameters stay
float32, and the gradients update them in float32. bfloat16 has float32's
exponent range, so there is no loss scaler. Loss mean(out.float()^2) +
l_aux, plain SGD p - 1e-2 * g.

Run:  python -m tutel_tpu_torch.examples.helloworld_amp [--device cpu]

`run(args, params=..., x=...)` takes the float32 global parameters and the
bfloat16 input [batch * tokens, M] from elsewhere (the tests pass the JAX
example's through `convert`); without them they are drawn on the CPU from
seeds 1 and 0. Returns the per-step losses.
"""

import argparse

import torch

from tutel_tpu_torch import moe, net, system
from tutel_tpu_torch.utils import resolve_device, sgd_step, tree_leaves, \
    tree_replace


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_tokens", type=int, default=128)
    parser.add_argument("--model_dim", type=int, default=64)
    parser.add_argument("--hidden_size", type=int, default=128)
    parser.add_argument("--num_local_experts", type=int, default=2)
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--num_steps", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def build_layer(args, device, group, dtype):
    return moe.moe_layer(
        gate_type={"type": "top", "k": args.top, "capacity_factor": 1.0},
        experts={"type": "ffn",
                 "num_experts_per_device": args.num_local_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), dtype=dtype,
        group=group, device=device)


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    w = env.global_size
    layer = build_layer(args, device, env, torch.bfloat16)
    if params is None:     # the float32 masters of the world's experts
        one = argparse.Namespace(**{**vars(args), "num_local_experts":
                                    args.num_local_experts * w})
        params = build_layer(one, "cpu", [0], torch.float32).init(
            torch.Generator().manual_seed(1))
    if x is None:
        x = torch.randn((args.batch_size * args.num_tokens, args.model_dim),
                        generator=torch.Generator().manual_seed(0))
    params = layer.shard_params(tree_replace(
        params, [p.to(device) for p in tree_leaves(params)]))
    if any(p.dtype != torch.float32 for p in tree_leaves(params)):
        raise ValueError("the master parameters must be float32")
    rows = x.shape[0] // w
    x = x[env.global_rank * rows:(env.global_rank + 1) * rows].to(
        device=device, dtype=torch.bfloat16)

    def loss_fn(p):
        out, l_aux = layer(p, x, training=True)
        return torch.sum(out.float() ** 2) / (out[0].numel() * rows * w) \
            + l_aux / w

    losses = []
    for i in range(args.num_steps):
        params, loss, _ = sgd_step(loss_fn, params, 1e-2)
        losses.append(float(net.simple_all_reduce(loss)))
        log(f"STEP-{i}: loss = {losses[-1]:.6f} (params fp32, "
            f"compute bf16)")
    return losses


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
