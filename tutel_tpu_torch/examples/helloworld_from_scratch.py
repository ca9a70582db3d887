"""MoE from the low-level ops, no MOELayer (counterpart:
tutel_tpu/examples/helloworld_from_scratch.py).

The whole pipeline by hand from the ops API: gate matmul -> softmax ->
`extract_critical` (with the gshard aux loss) -> `fast_encode` ->
batched expert FFN -> `fast_decode`, trained by autograd with plain SGD
p - 1e-3 * g on mean(out^2) + 0.01 * l_aux.

Run:  python -m tutel_tpu_torch.examples.helloworld_from_scratch
          [--device cpu]

`run(args, params=..., x=...)` takes the parameters {"wg" [M, E], "fc1"
[E, M, H], "fc2" [E, H, M]} and the input [S, M] from elsewhere (the
tests pass the JAX example's); without them they are drawn on the CPU
from seed 0. Returns the per-step losses.
"""

import argparse

import torch

from tutel_tpu_torch.ops import (extract_critical, fast_decode, fast_encode,
                                 routing)
from tutel_tpu_torch.utils import resolve_device, sgd_step, tree_leaves, \
    tree_replace


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_tokens", type=int, default=256)
    parser.add_argument("--model_dim", type=int, default=128)
    parser.add_argument("--hidden_size", type=int, default=256)
    parser.add_argument("--num_experts", type=int, default=4)
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--capacity_factor", type=float, default=1.0)
    parser.add_argument("--num_steps", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def init_params(args, generator):
    e, m, h = args.num_experts, args.model_dim, args.hidden_size
    return {"wg": torch.randn((m, e), generator=generator) * m ** -0.5,
            "fc1": torch.randn((e, m, h), generator=generator) * m ** -0.5,
            "fc2": torch.randn((e, h, m), generator=generator) * h ** -0.5}


def moe_forward(params, x, top_k, capacity):
    scores = torch.softmax(x @ params["wg"], dim=1)
    crit, l_aux = extract_critical(scores, top_k, capacity=capacity)
    y = fast_encode(x, crit)                           # [E, C, M]
    y = torch.relu(torch.bmm(y, params["fc1"]))
    y = torch.bmm(y, params["fc2"])
    return fast_decode(y, crit), l_aux                 # [S, M]


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    e, m, s, k = (args.num_experts, args.model_dim, args.num_tokens,
                  args.top)
    gen = torch.Generator().manual_seed(0)
    if params is None:
        params = init_params(args, gen)
    if x is None:
        x = torch.randn((s, m), generator=gen)
    params = tree_replace(params, [p.to(device) for p in
                                   tree_leaves(params)])
    x = x.to(device)
    capacity = routing.compute_static_capacity(s, e, k, args.capacity_factor)

    def loss_fn(p):
        out, l_aux = moe_forward(p, x, k, capacity)
        return torch.mean(out ** 2) + 0.01 * l_aux

    losses = []
    for i in range(args.num_steps):
        params, loss, _ = sgd_step(loss_fn, params, 1e-3)
        losses.append(float(loss))
        log(f"STEP-{i}: loss = {losses[-1]:.5f}")
    return losses


if __name__ == "__main__":
    run(build_args())
