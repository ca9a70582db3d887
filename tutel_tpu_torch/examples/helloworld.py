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
the logged loss is that sum, which every rank prints.

`--checkpoint_path` (a {rank}/{size} pattern or a file) reads and writes
the JAX example's one global file (rank 0 of size 1): a run loads it when
it exists (every rank reads the whole state, then takes its shard), and
at its end the ranks' `state_dict`s are gathered into the global state
(`checkpoint.reshard.gather_states`), which rank 0 writes. `--use_scan`
raises (`UNSUPPORTED`).
"""

import argparse
import os
import time

import torch
import torch.distributed as dist

from tutel_tpu_torch import checkpoint, moe, net, system
from tutel_tpu_torch.utils import resolve_device, sgd_step

# flag -> why it raises here
UNSUPPORTED = {
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
    if args.use_scan:
        raise ValueError(f"--use_scan: {UNSUPPORTED['use_scan']}")


def load_checkpoint(layer, params, pattern, log=print):
    """The global params with the checkpoint's state loaded, when the
    file exists (the JAX example's rank 0 of size 1)."""
    path = system.apply_rank_size_from_pattern(pattern, rank=0, size=1)
    if not os.path.exists(path):
        return params
    params = layer.load_state_dict(params, checkpoint.serial.flatten_state(
        checkpoint.load_state(path)))
    log(f"Checkpoint loaded from {path}.")
    return params


def save_checkpoint(layer, params, pattern, log=print):
    """Gather every rank's shard into the global state; rank 0 writes
    it."""
    states = [layer.state_dict(params)]
    if layer.world_size > 1:
        states = [None] * layer.world_size
        dist.all_gather_object(states, layer.state_dict(params),
                               group=layer.world_group)
    if layer.rank_index:
        return
    path = system.apply_rank_size_from_pattern(pattern, rank=0, size=1)
    checkpoint.save_state(path, checkpoint.serial.unflatten_state(
        checkpoint.gather_states(states)))
    log(f"Checkpoint saved to {path}.")


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
    if args.checkpoint_path:
        params = load_checkpoint(layer, params, args.checkpoint_path, log)
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
    if args.checkpoint_path:
        save_checkpoint(layer, params, args.checkpoint_path, log)
    return losses, average_time


def main():
    args = build_args()
    try:
        run(args)
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
