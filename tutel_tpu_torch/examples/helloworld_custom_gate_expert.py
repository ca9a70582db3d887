"""Custom gate + custom expert modules (counterpart:
tutel_tpu/examples/helloworld_custom_gate_expert.py).

The pluggable protocols in their torch form (`"type": "custom"` with a
`"module"` class):
  gate:   class(model_dim, num_global_experts, **opts) with
          init(generator, dtype, device) / apply(params, x) -> logits and
          the attributes top_k / gate_noise / capacity_factor
  expert: class(model_dim, num_experts_per_device, sharded_count, **opts)
          with init(generator, dtype, device) / apply(params, x[, ctx]),
          x [E_local, rows, M], and optionally shard_axes() -> {param
          name: (expert dim, shard dim)}.
Loss mean(out^2) + 0.01 * l_aux, plain SGD p - 1e-3 * g.

Run:  python -m tutel_tpu_torch.examples.helloworld_custom_gate_expert
          [--device cpu]

`run(args, params=..., x=...)` takes the layer's parameters and the input
[S, M] from elsewhere (the tests pass the JAX example's); without them
they are drawn on the CPU from seeds 1 and 0. Returns the per-step losses.
"""

import argparse
import dataclasses

import torch

from tutel_tpu_torch import moe
from tutel_tpu_torch.utils import resolve_device, sgd_step, tree_leaves, \
    tree_replace


@dataclasses.dataclass
class SkipgramGate:
    """Custom gate: logits from the product of the token with a learned
    per-expert prototype."""
    model_dim: int
    num_global_experts: int
    k: int = 2
    capacity_factor: float = 1.0
    gate_noise: float = 0.0

    def __post_init__(self):
        self.top_k = min(self.num_global_experts, self.k)

    def init(self, generator=None, dtype=torch.float32, device="cpu"):
        return {"proto": torch.randn(
            (self.num_global_experts, self.model_dim), generator=generator,
            dtype=dtype, device=device) * self.model_dim ** -0.5}

    def apply(self, params, x):
        return x.float() @ params["proto"].float().t()


@dataclasses.dataclass
class GatedResidualExpert:
    """Custom expert: gated residual MLP x + (sigmoid(x Wg) * (x Wu)) Wd."""
    model_dim: int
    num_experts_per_device: int = 1
    sharded_count: int = 1
    hidden_size_per_expert: int = 256

    def __post_init__(self):
        if self.hidden_size_per_expert % self.sharded_count:
            raise ValueError("hidden_size_per_expert must divide over "
                             "sharded_count")
        self.hidden = self.hidden_size_per_expert // self.sharded_count

    def init(self, generator=None, dtype=torch.float32, device="cpu"):
        e, m, h = self.num_experts_per_device, self.model_dim, self.hidden

        def normal(shape, scale):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=device) * scale
        return {"w_gate": normal((e, m, h), m ** -0.5),
                "w_up": normal((e, m, h), m ** -0.5),
                "w_down": normal((e, h, m), self.hidden ** -0.5)}

    def shard_axes(self):
        return {"w_gate": (0, 2), "w_up": (0, 2), "w_down": (0, 1)}

    def apply(self, params, x, ctx=None):
        g = torch.bmm(x, params["w_gate"].to(x.dtype))
        u = torch.bmm(x, params["w_up"].to(x.dtype))
        return x + torch.bmm(torch.sigmoid(g) * u,
                             params["w_down"].to(x.dtype))


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_tokens", type=int, default=256)
    parser.add_argument("--model_dim", type=int, default=128)
    parser.add_argument("--hidden_size", type=int, default=256)
    parser.add_argument("--num_experts", type=int, default=4)
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--num_steps", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def build_layer(args, device):
    return moe.moe_layer(
        gate_type={"type": "custom", "module": SkipgramGate, "k": args.top},
        experts={"type": "custom", "module": GatedResidualExpert,
                 "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=[0],
        device=device)


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    layer = build_layer(args, device)
    if params is None:
        params = build_layer(args, "cpu").init(
            torch.Generator().manual_seed(1))
    if x is None:
        x = torch.randn((args.num_tokens, args.model_dim),
                        generator=torch.Generator().manual_seed(0))
    params = tree_replace(params, [p.to(device) for p in
                                   tree_leaves(params)])
    x = x.to(device)

    def loss_fn(p):
        out, l_aux = layer(p, x)
        return torch.mean(out ** 2) + 0.01 * l_aux

    losses = []
    for i in range(args.num_steps):
        params, loss, _ = sgd_step(loss_fn, params, 1e-3)
        losses.append(float(loss))
        log(f"STEP-{i}: loss = {losses[-1]:.5f}")
    return losses


if __name__ == "__main__":
    run(build_args())
