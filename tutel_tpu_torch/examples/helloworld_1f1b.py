"""1F1B pipeline-parallel MoE training demo (counterpart:
tutel_tpu/examples/helloworld_1f1b.py).

The model of helloworld_pipeline, driven by the explicit 1F1B schedule
(`parallel.pipeline_1f1b`): each tick interleaves one microbatch's forward
with an earlier microbatch's backward, so at most 2S-1 inputs are stashed
a stage, and each stage's gradients accumulate on its rank. The same
flags and loss as the JAX example: sum(y^2) / batch over each microbatch
(mean over microbatches) plus the blocks' l_aux, plain SGD p - lr * g;
the run checks that the loss falls.

Run:  python -m tutel_tpu_torch.examples.helloworld_1f1b --num_stages 1
          [--device cpu]
Over N stages: torchrun --nproc_per_node N -m
          tutel_tpu_torch.examples.helloworld_1f1b --device cpu
          --num_stages N

`run(args, params=..., x=...)` as in helloworld_pipeline.
"""

import argparse

from tutel_tpu_torch import system
from tutel_tpu_torch.examples.helloworld_pipeline import setup, stage_fn
from tutel_tpu_torch.parallel import pipeline_1f1b
from tutel_tpu_torch.utils import tree_leaves, tree_replace


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
    return parser.parse_args(argv)


def run(args, log=print, params=None, x=None):
    """Train num_steps steps; returns the per-step losses."""
    _, mesh, layer, local, x = setup(args, params, x)

    # a token-sum loss a microbatch (see pipeline_1f1b): the output's
    # energy over the batch
    def loss_fn(y):
        return (y.float() ** 2).sum() / args.batch

    train = pipeline_1f1b(stage_fn(layer), loss_fn, args.num_stages, mesh,
                          n_micro=args.n_micro, has_aux=True)
    losses = []
    for i in range(args.num_steps):
        loss, grads = train(local, x)
        local = tree_replace(local, [
            (p - args.lr * g.to(p.dtype)).detach()
            for p, g in zip(tree_leaves(local), tree_leaves(grads))])
        losses.append(float(loss))
        log(f"STEP-{i}: loss = {losses[-1]:.6f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses[0]} -> "
                           f"{losses[-1]}")
    log(f"\n[Summary] 1F1B loss {losses[0]:.5f} -> {losses[-1]:.5f} over "
        f"{args.num_steps} steps ({args.num_stages} stages, {args.n_micro} "
        f"microbatches).")
    return losses


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
