"""Custom expert with sharded parameters (counterpart:
tutel_tpu/examples/helloworld_custom_expert_sharded.py).

A user-defined expert whose one parameter, a flat [E, M * M] matrix, is
stored sliced over the ranks that share each expert (sharded_count =
world / global experts; `--num_local_experts -2` shares each over two
ranks) and regathered for use: the expert declares `shard_axes` ({"w":
(0, 1)}: the expert dim and the dim that is sliced), and the layer's
regather hands `apply` the whole flat parameter, which it reshapes.
`parallel_type="data"` keeps one whole replica of the weights a rank
during the forward. Loss mean(out^2) + l_aux, plain SGD p - 1e-2 * g.

Run:  torchrun --nproc_per_node 2 -m
          tutel_tpu_torch.examples.helloworld_custom_expert_sharded
          --device cpu
On one rank: --num_local_experts 1 (-2 needs an even world).

`run(args, params=..., x=...)` takes the global parameters and the input
[batch * tokens, M] from elsewhere (the tests pass the JAX example's
through `convert`); without them they are drawn on the CPU from seeds 1
and 0. Each rank holds its rows; the logged loss is the sum of the ranks'
shares. Returns the per-step losses.
"""

import argparse
import dataclasses

import torch

from tutel_tpu_torch import moe, net, system
from tutel_tpu_torch.utils import resolve_device, sgd_step, tree_leaves, \
    tree_replace


@dataclasses.dataclass
class CustomShardedExpert:
    """W: logical [E_local, M, M], stored as a flat slice a rank."""
    model_dim: int
    num_experts_per_device: int = 1
    sharded_count: int = 1
    my_config: str = "relu"

    def shard_axes(self):
        # param name -> (expert dim, shard dim): dim 1 of the flat view is
        # sliced over the ranks sharing an expert
        return {"w": (0, 1)}

    def init(self, generator=None, dtype=torch.float32, device="cpu"):
        e, m = self.num_experts_per_device, self.model_dim
        if (m * m) % self.sharded_count:
            raise ValueError("M * M must divide over sharded_count")
        return {"w": torch.randn((e, m * m), generator=generator,
                                 dtype=dtype, device=device) * 0.001}

    def apply(self, params, x, ctx=None):
        e, _, m = x.shape
        w = params["w"]                      # the whole flat parameter
        if w.shape[-1] != m * m:
            raise ValueError("expected the regathered whole parameter; run "
                             "with parallel_type='data' (r=1) or "
                             "adaptive_r=0")
        y = torch.bmm(x, w.reshape(e, m, m).to(x.dtype))
        return torch.relu(y) if self.my_config == "relu" else y


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_tokens", type=int, default=64)
    parser.add_argument("--model_dim", type=int, default=32)
    parser.add_argument("--num_local_experts", type=int, default=-2)
    parser.add_argument("--top", type=int, default=1)
    parser.add_argument("--num_steps", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def build_layer(args, device, group, num_local_experts=None):
    return moe.moe_layer(
        gate_type={"type": "top", "k": args.top, "capacity_factor": 1.0},
        experts={"type": "custom", "module": CustomShardedExpert,
                 "num_experts_per_device":
                     num_local_experts or args.num_local_experts,
                 "my_config": "relu"},
        model_dim=args.model_dim, seeds=(1, 1, 1), parallel_type="data",
        group=group, device=device)


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    w, me = env.global_size, env.global_rank
    layer = build_layer(args, device, env)
    log(f"sharded_count = {layer.sharded_count}, "
        f"num_global_experts = {layer.num_global_experts}")
    if params is None:       # the global parameters, drawn on the CPU
        params = build_layer(args, "cpu", [0], layer.num_global_experts
                             ).init(torch.Generator().manual_seed(1))
    if x is None:
        x = torch.randn((args.batch_size * args.num_tokens, args.model_dim),
                        generator=torch.Generator().manual_seed(0))
    params = layer.shard_params(tree_replace(
        params, [p.to(device) for p in tree_leaves(params)]))
    n = sum(p.numel() for _, p in
            layer.get_parameter_iterator(params, "local_experts"))
    log(f"[Statistics] param count for MoE local_experts = {n}.")
    rows = x.shape[0] // w
    x_local = x[me * rows:(me + 1) * rows].to(device)

    def loss_fn(p):
        out, l_aux = layer(p, x_local, training=True)
        return torch.sum(out ** 2) / (x.shape[0] * out.shape[-1]) \
            + l_aux / w

    losses = []
    for i in range(args.num_steps):
        params, loss, _ = sgd_step(loss_fn, params, 1e-2)
        losses.append(float(net.simple_all_reduce(loss)))
        log(f"STEP-{i}: loss = {losses[-1]:.6f}")
    return losses


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
