"""Single-file MoE training benchmark (counterpart:
tutel_tpu/examples/helloworld.py).

Same model and loop as the JAX example: one MoE layer; loss =
nll(log_softmax(sum(y, -1)), 0) over the token axis, plus l_aux_wt * l_aux;
plain SGD p - 1e-5 * g over the parameter tree, with no optimizer state;
fixed seeds; per-step loss / step_time / TFLOPS with the reference's
formula. step_time is host time around a step that ends in
`torch.cuda.synchronize()` on the card.

Run:  python -m tutel_tpu_torch.examples.helloworld --batch_size 16
          --num_tokens 512 --model_dim 2048 --hidden_size 2048
          --num_local_experts 2 --dtype float32 --top 2 [--device cpu]
Over N ranks (one process a rank; gloo for --device cpu, nccl for cuda):
      torchrun --nproc_per_node N -m tutel_tpu_torch.examples.helloworld
          --device cpu --num_devices N [--parallel_type data|model|auto|
          adaptive:r] [--use_2dh] [--a2a_ffn_overlap_degree D] ...

`run(args, params=..., x=...)` takes the global parameter tree and input
from elsewhere (the tests pass the JAX example's, through
`convert.from_jax_params`); without them the port seeds its own
generators, as `start(args, device)` does. The run joins the process group
the environment describes (`system.init_data_model_parallel`);
`--num_devices` must equal its world size. Each rank holds its shard of
the parameters (`MOELayer.shard_params`) and its rows of the global batch
(batch_size / W of them), and its loss is its share of the global loss
(the mean over the global token axis): the ranks' losses sum to JAX's, and
the logged loss is that sum. Flags of later slices raise (`UNSUPPORTED`).
"""

import argparse
import time

import torch

from tutel_tpu_torch import moe, net, system
from tutel_tpu_torch.utils import resolve_device, sgd_step

# flag -> why it raises here (the slice of the port that brings it)
UNSUPPORTED = {
    "checkpoint_path": "checkpoint files come with the launcher and "
                       "checkpoint tools (the next slice of expert "
                       "parallelism)",
    "use_scan": "one jit over all steps is a JAX compile strategy; this "
                "loop already times synchronized steps",
}


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--num_tokens", type=int, default=512)
    parser.add_argument("--model_dim", type=int, default=2048)
    parser.add_argument("--hidden_size", type=int, default=2048)
    parser.add_argument("--num_local_experts", type=int, default=2)
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--fp32_gate", default=False, action="store_true")
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--l_aux_wt", type=float, default=0.0)
    parser.add_argument("--a2a_ffn_overlap_degree", type=int, default=1)
    parser.add_argument("--num_steps", type=int, default=100)
    parser.add_argument("--parallel_type", type=str, default="adaptive:1")
    parser.add_argument("--checkpoint_path", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--use_2dh", default=False, action="store_true")
    parser.add_argument("--eval", default=False, action="store_true")
    parser.add_argument("--capacity_factor", type=float, default=1.0)
    parser.add_argument("--megablocks_size", type=int, default=0)
    parser.add_argument("--expert_type", type=str, default="ffn")
    parser.add_argument("--num_devices", type=int, default=0)
    parser.add_argument("--use_scan", default=False, action="store_true")
    return parser.parse_args(argv)


def _refuse_unsupported(args):
    given = {"checkpoint_path": bool(args.checkpoint_path),
             "use_scan": args.use_scan}
    for flag, on in given.items():
        if on:
            raise ValueError(f"--{flag}: {UNSUPPORTED[flag]}")


DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16}


def build_layer(args, device, env=None):
    """The example's MoE layer for these flags, on `device`, over the
    world of `env` (None: the default process group, or one rank)."""
    return moe.moe_layer(
        gate_type={"type": "top", "k": args.top, "fp32_gate": args.fp32_gate,
                   "capacity_factor": args.capacity_factor},
        experts={"type": args.expert_type,
                 "num_experts_per_device": args.num_local_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), dtype=DTYPES[args.dtype],
        a2a_ffn_overlap_degree=args.a2a_ffn_overlap_degree,
        parallel_type=args.parallel_type, use_2dh=args.use_2dh, group=env,
        device=device)


def start(args, device, layer=None):
    """A run's seeded global parameters and input, drawn on `device` (the
    CPU gives the same start to runs on two devices, and every rank the
    same): parameters from seed 1, x from seed 0."""
    device = torch.device(device)
    layer = build_layer(args, device) if layer is None else layer
    params = layer.init(torch.Generator(device=device).manual_seed(1))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((args.batch_size, args.num_tokens, args.model_dim),
                    generator=gen, device=device).to(DTYPES[args.dtype])
    return params, x


def run(args, log=print, params=None, x=None):
    """Build the layer and run the loop from the global `params` and `x`;
    returns (per-step global losses, average synchronized step time in
    seconds over the last 10 steps)."""
    _refuse_unsupported(args)
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    world = env.global_size
    if args.num_devices and args.num_devices != world:
        raise ValueError(f"--num_devices {args.num_devices}: the process "
                         f"group has {world} ranks")
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} does not split "
                         f"over {world} ranks")
    layer = build_layer(args, device, env)
    if params is None or x is None:
        seeded = start(args, device, layer)
        params = seeded[0] if params is None else params
        x = seeded[1] if x is None else x
    params = layer.shard_params(params)
    b = args.batch_size // world
    x = x[env.global_rank * b:(env.global_rank + 1) * b]

    num_global_experts = layer.num_global_experts
    local_count = sum(p.numel() for _, p in
                      layer.get_parameter_iterator(params, "local_experts"))
    shared_count = sum(p.numel() for _, p in
                       layer.get_parameter_iterator(params, "gate"))
    log("[Statistics] param count for MoE local_experts = %s, "
        "param count for MoE gate = %s." % (local_count, shared_count))

    key = torch.Generator(device=device).manual_seed(1)
    lr = 1e-5
    share = b / args.batch_size          # this rank's part of the mean

    def loss_fn(params):
        out, l_aux = layer(params, x, key=key, training=not args.eval,
                           megablocks_size=args.megablocks_size)
        logits = torch.log_softmax(torch.sum(out.float(), dim=2), dim=1)
        loss = -torch.mean(logits[:, 0]) * share
        if args.l_aux_wt:
            loss = loss + args.l_aux_wt * l_aux / world
        return loss

    tuples = (world, args.dtype, args.model_dim, args.hidden_size,
              args.batch_size * args.num_tokens, args.num_local_experts,
              args.top, args.a2a_ffn_overlap_degree, args.parallel_type,
              device.type)
    log("[Benchmark] world_size = %s, dtype = %s, model_dim = %s, "
        "hidden_size = %s, samples = %s, num_local_experts = %s, topK = %s, "
        "a2a_ffn_overlap_degree = %s, parallel_type = `%s`, device = `%s`"
        % tuples)

    average_time, losses = 0.0, []
    for i in range(args.num_steps):
        t_start = time.perf_counter()
        if args.eval:
            with torch.no_grad():
                loss = loss_fn(params)
        else:
            params, loss, _ = sgd_step(loss_fn, params, lr)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if world > 1:
            loss = net.simple_all_reduce(loss.detach())
        t_stop = time.perf_counter()

        mm_ceof = 1 if args.eval else 3
        cap_ceof = min(args.top, num_global_experts)
        step_time = t_stop - t_start
        tflops = (args.batch_size * args.num_tokens * args.model_dim *
                  args.hidden_size) * 4 * mm_ceof * cap_ceof * 1e-12 \
            / step_time
        loss_f = float(loss)
        losses.append(loss_f)
        log("STEP-%s: loss = %.5f, step_time = %.6f sec, perf = %.2f tflops."
            % (i, loss_f, step_time, tflops))
        if i + 10 >= args.num_steps:
            average_time += step_time

    average_time /= min(10, args.num_steps)
    log("\n[Summary] Average synchronized step_time = %s sec." % average_time)
    return losses, average_time


def main():
    args = build_args()
    try:
        env = system.init_data_model_parallel(device=args.device)
        run(args, log=env.dist_print)          # rank 0 prints
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
