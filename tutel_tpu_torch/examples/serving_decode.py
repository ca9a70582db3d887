"""Continuous-batching decode serving, single-layer and full-model
(counterpart: tutel_tpu/examples/serving_decode.py).

  * `MoeDecodeEngine` drives a MOELayer (16 float FFN experts, top-2,
    dropless) over embedding-space states with speculative capacity and
    the residual-norm state update.
  * `LmDecodeEngine` serves a small Transformer-MoE LM (4 heads of 16, a
    float cache): prompt prefill on admission (kernel K7 on the card),
    chunked decode over the KV cache (K6 for attention, K8 for the cache
    writes), attention windows in 16-position buckets, and sampling at
    temperature 0.8 / top_k 40 from a torch.Generator (its tokens are not
    jax.random's).

Run:  python -m tutel_tpu_torch.examples.serving_decode [--device cpu]

`run(args, params=..., x=...)` takes the MoE layer's parameters
(`params["moe"]`), the LM's (`params["lm"]`) and the [requests,
model_dim] initial states (`x`) from elsewhere (the tests pass the JAX
example's through `convert`); without them they are drawn on the CPU from
seeds 0, 2 and 1. Returns (the MoE engine's stats, the LM engine's stats,
the MoE engine's final states by uid, the LM timing: seconds, tokens/s
and ms a decode step; host time around a run that ends in a synchronize
on the card).
"""

import argparse

import numpy as np
import torch

from tutel_tpu_torch import moe, system
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.serving import (LmDecodeEngine, LmRequest,
                                     MoeDecodeEngine, Request)
from tutel_tpu_torch.utils import resolve_device, tree_leaves, tree_replace


def build_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--experts", type=int, default=16)
    p.add_argument("--model_dim", type=int, default=128)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--requests", type=int, default=48)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--spec", type=float, default=8.0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_layer(args, device):
    return moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        experts={"type": "ffn", "num_experts_per_device": args.experts,
                 "hidden_size_per_expert": 2 * args.model_dim},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=[0],
        device=device)


def lm_config(args):
    return TransformerMoEConfig(
        vocab_size=211, max_len=96, model_dim=64, num_heads=4,
        num_layers=2, ffn_hidden=128, moe_every=2,
        num_local_experts=args.experts // 2, top_k=2,
        expert_hidden=128, capacity_factor=0.0)


def lm_requests(vocab_size):
    rng = np.random.RandomState(0)
    return [LmRequest(uid=i,
                      prompt=rng.randint(0, vocab_size,
                                         size=4 + i % 3).astype(np.int32),
                      max_new_tokens=24)
            for i in range(12)]


def _to(tree, device):
    return tree_replace(tree, [t.to(device) for t in tree_leaves(tree)])


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    params = dict(params or {})

    # -- single-layer engine: speculative capacity + residual state ----
    layer = build_layer(args, device)
    moe_params = params.get("moe")
    if moe_params is None:
        moe_params = build_layer(args, "cpu").init(
            torch.Generator().manual_seed(0))
    if x is None:
        x = torch.randn((args.requests, args.model_dim),
                        generator=torch.Generator().manual_seed(1))
    eng = MoeDecodeEngine(layer, _to(moe_params, device),
                          max_batch=args.batch,
                          speculative_capacity=args.spec,
                          state_update="residual_norm")
    reqs = [Request(uid=i, state=x[i].to(device), remaining=12 + i % 5)
            for i in range(args.requests)]
    finals = eng.run(reqs, chunk=args.chunk)
    log(f"MoeDecodeEngine: {eng.stats['finished']} requests finished, "
        f"{eng.stats['tokens']} tokens, "
        f"{eng.stats['spec_retries']} speculation retries "
        f"(speculated cap {eng._spec_cap(args.batch, args.batch)} vs "
        f"worst {args.batch})")
    if len(finals) != args.requests:
        raise RuntimeError(f"{len(finals)} of {args.requests} MoE requests "
                           f"finished")

    # -- full-model engine: prefill + windowed KV decode ----------------
    cfg = lm_config(args)
    model = TransformerMoE(cfg, group=[0], device=device)
    lm_params = params.get("lm")
    if lm_params is None:
        lm_params = TransformerMoE(cfg, group=[0], device="cpu").init(
            torch.Generator().manual_seed(2))
    lm = LmDecodeEngine(model, _to(lm_params, device), max_batch=8,
                        moe_overrides={"capacity_override": 8},
                        attn_bucket=16,
                        sampler={"temperature": 0.8, "top_k": 40,
                                 "seed": 0})
    t0 = system.record_time()
    outs = lm.run(lm_requests(cfg.vocab_size), chunk=args.chunk)
    seconds = system.record_time() - t0
    timing = {"seconds": seconds,
              "tokens_per_s": lm.stats["tokens"] / seconds,
              "ms_per_step": seconds * 1e3 / max(lm.stats["steps"], 1)}
    log(f"LmDecodeEngine: {lm.stats['finished']} requests finished, "
        f"{lm.stats['tokens']} tokens generated "
        f"(attention windows <= {lm.attn_bucket}-position buckets); "
        f"{timing['tokens_per_s']:.1f} tokens/s, "
        f"{timing['ms_per_step']:.3f} ms a decode step")
    if len(outs) != 12 or not all(len(v) for v in outs.values()):
        raise RuntimeError("an LM request generated no tokens")
    return eng.stats, lm.stats, finals, timing


if __name__ == "__main__":
    run(build_args())
