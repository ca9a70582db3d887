"""Sequence-parallel (SP x EP) Transformer-MoE training (counterpart:
tutel_tpu/examples/seqpar_lm.py).

The LM trains with its sequence split over the ranks of the default
process group, the same ranks its MoE layers run expert parallelism on:
attention runs context-parallel (--attn ulysses: the head <-> sequence
all-to-all pair; --attn ring: ring attention over `net.ppermute`, no head
bound, GQA through --num_kv_heads) and each MoE layer takes the rank's
rows. The first batch checks that the SP nll equals the nll of the
one-rank model with the same global experts (within 1e-3), then SGD
trains the SP model. At one rank `loss_seqpar` is `loss`.

Run:  python -m tutel_tpu_torch.examples.seqpar_lm [--device cpu]
Over N ranks (gloo for --device cpu, nccl for cuda):
      torchrun --nproc_per_node N -m tutel_tpu_torch.examples.seqpar_lm
          --device cpu

`run(args, params=...)` takes the global parameters from elsewhere (the
tests pass the JAX example's through `convert`); without them they are
drawn from seed 0 on the CPU, so every device starts alike. The token
batches come from numpy's RandomState(0), as in the JAX example.
"""

import argparse
import dataclasses

import numpy as np
import torch

from tutel_tpu_torch import system
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.utils import (resolve_device, sgd_step, tree_leaves,
                                   tree_replace)


def run(args, log=print, params=None):
    """SP-train args.steps SGD steps; returns the per-step losses."""
    device = resolve_device(args.device)
    env = system.init_data_model_parallel(device=device)
    sp, me = env.global_size, env.global_rank
    if args.attn == "ulysses" and args.num_heads % sp:
        raise ValueError(f"num_heads={args.num_heads} must divide the "
                         f"{sp}-rank world for Ulysses (pass --attn ring to "
                         "lift the bound)")
    if args.seq_len % sp:
        raise ValueError(f"seq_len={args.seq_len} must divide the {sp}-rank "
                         "world (the loss runs the full sequence and "
                         "shifts the logits afterwards)")
    cfg = TransformerMoEConfig(
        vocab_size=256, max_len=args.seq_len, model_dim=args.model_dim,
        num_heads=args.num_heads, num_layers=args.num_layers,
        ffn_hidden=2 * args.model_dim, moe_every=2,
        num_local_experts=args.experts_per_device, top_k=2,
        capacity_factor=2.0, expert_hidden=2 * args.model_dim,
        num_kv_heads=args.num_kv_heads)
    sp_model = TransformerMoE(cfg, device=device)
    e_global = next(iter(sp_model.moe_layers.values())).num_global_experts
    one = dataclasses.replace(cfg, num_local_experts=e_global)
    ref_model = TransformerMoE(one, group=[me], device=device)
    if params is None:                  # drawn on the CPU for every device
        params = TransformerMoE(one, group=[me], device="cpu").init(
            torch.Generator().manual_seed(0))
    params = tree_replace(params, [p.to(device) for p in tree_leaves(params)])
    sp_params = sp_model.shard_params(params)

    rng = np.random.RandomState(0)

    def batch():
        return torch.from_numpy(rng.randint(
            0, 256, (args.batch, args.seq_len))).to(device)
    ov = {"capacity_override": args.batch * args.seq_len}

    def sp_loss(p, toks):
        return sp_model.loss_seqpar(p, toks, l_aux_wt=0.0, training=True,
                                    moe_overrides=ov,
                                    attn_mode=args.attn)[1][0]

    # sanity: SP == the one-rank model on the first batch
    tokens = batch()
    with torch.no_grad():
        ref_nll = float(ref_model.loss(params, tokens, l_aux_wt=0.0,
                                       training=True,
                                       moe_overrides=ov)[1][0])
        sp_nll = float(sp_loss(sp_params, tokens))
    log(f"single-device nll {ref_nll:.6f} | {sp}-way SP nll "
        f"{sp_nll:.6f} (|delta| {abs(ref_nll - sp_nll):.2e})")
    assert abs(ref_nll - sp_nll) < 1e-3, (ref_nll, sp_nll)

    losses = []
    for i in range(args.steps):
        toks = batch()
        sp_params, loss, _ = sgd_step(lambda p: sp_loss(p, toks), sp_params,
                                      args.lr)
        losses.append(float(loss))
        log(f"STEP-{i}: loss = {losses[-1]:.6f}")
    return losses


def build_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--model_dim", type=int, default=64)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--experts_per_device", type=int, default=1)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--attn", type=str, default="ulysses",
                   choices=("ulysses", "ring"),
                   help="context-parallel attention: the Ulysses "
                        "head<->sequence a2a pair, or ring attention (no "
                        "head bound; GQA supported)")
    p.add_argument("--num_kv_heads", type=int, default=0,
                   help="grouped-query attention KV heads (0 = MHA)")
    return p.parse_args(argv)


def main():
    try:
        run(build_args())
    finally:
        system.destroy()


if __name__ == "__main__":
    main()
