"""Train a decoder-only Transformer-MoE language model (counterpart:
tutel_tpu/examples/moe_transformer_lm.py).

A causal LM whose every `--moe_every`-th FFN is a MoE layer, the aux loss
weighted by --l_aux_wt, trained with AdamW (optax's defaults: betas 0.9 /
0.999, eps 1e-8, weight decay 1e-4 on every parameter) in a plain Python
loop.

Corpus: --data_file (one byte-token document) if given, else a synthetic
structured corpus (arithmetic-progression byte patterns). The batches of
seq_len + 1 tokens are cut from it by the host native library
(`csrc.sample_windows`, built with g++ on first use; a failed build
raises).

Run: python -m tutel_tpu_torch.examples.moe_transformer_lm --steps 50
         [--device cpu]

`run(args, params=...)` takes the parameters from elsewhere (the tests
pass the JAX example's through `convert`); without them they are drawn
from seed 0 on the CPU, so every device starts alike.
"""

import argparse
import time

import numpy as np
import torch

from tutel_tpu_torch import checkpoint, csrc
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.utils import resolve_device, tree_leaves, tree_replace


def make_corpus(args):
    if args.data_file:
        with open(args.data_file, "rb") as f:
            return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
    rng = np.random.RandomState(0)
    chunks = []
    for _ in range(512):
        start, step = rng.randint(0, 256), rng.randint(1, 7)
        chunks.append((start + step * np.arange(64)) % 256)
    return np.concatenate(chunks).astype(np.int32)


def make_batches(args):
    """[steps, batch, seq_len + 1] int32 windows of the corpus at offsets
    from numpy's RandomState(1), as in the JAX example."""
    corpus = make_corpus(args)
    starts = np.random.RandomState(1).randint(
        0, len(corpus) - args.seq_len - 1, size=(args.steps, args.batch_size))
    return csrc.sample_windows(corpus, starts.reshape(-1).astype(np.int64),
                               args.seq_len + 1).reshape(
        args.steps, args.batch_size, -1)


def build_model(args, device):
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[args.dtype]
    cfg = TransformerMoEConfig(
        vocab_size=256, max_len=args.seq_len, model_dim=args.model_dim,
        num_heads=args.num_heads, num_layers=args.num_layers,
        ffn_hidden=args.hidden, moe_every=args.moe_every,
        num_local_experts=args.num_experts, top_k=args.top,
        expert_hidden=args.hidden, dtype=dtype)
    return TransformerMoE(cfg, group=[0], device=device)


def run(args, log=print, params=None):
    """Train args.steps AdamW steps; returns the per-step losses."""
    device = resolve_device(args.device)
    model = build_model(args, device)
    if params is None:                  # drawn on the CPU for every device
        params = build_model(args, "cpu").init(
            torch.Generator().manual_seed(0))
    batches = make_batches(args).to(device)
    leaves = [p.detach().to(device).clone().requires_grad_(True)
              for p in tree_leaves(params)]
    params = tree_replace(params, leaves)
    opt = torch.optim.AdamW(leaves, lr=args.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    key = torch.Generator(device=device).manual_seed(7)
    losses, nlls, l_auxs = [], [], []
    t0 = time.perf_counter()
    for batch in batches:
        opt.zero_grad(set_to_none=True)
        loss, (nll, l_aux) = model.loss(params, batch, key=key,
                                        l_aux_wt=args.l_aux_wt)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        nlls.append(nll.detach())
        l_auxs.append(l_aux.detach())
    losses, nlls, l_auxs = (torch.stack(v).tolist()
                            for v in (losses, nlls, l_auxs))
    dt = time.perf_counter() - t0
    for i in range(0, args.steps, max(1, args.steps // 10)):
        log(f"STEP-{i}: loss = {losses[i]:.4f}, nll = {nlls[i]:.4f}, "
            f"l_aux = {l_auxs[i]:.5f}")
    tok_s = args.steps * args.batch_size * args.seq_len / dt
    log(f"[Summary] {args.steps} steps in {dt:.1f}s, ~{tok_s:.0f} "
        f"tokens/s; final loss = {losses[-1]:.4f}")
    if args.checkpoint_path:
        state = {f"block{i}": checkpoint.serial.unflatten_state(
            layer.state_dict(params["blocks"][i]["moe"]))
            for i, layer in model.moe_layers.items()}
        checkpoint.save_state(args.checkpoint_path, state)
        log(f"MoE checkpoint saved to {args.checkpoint_path}.")
    return losses


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--model_dim", type=int, default=128)
    parser.add_argument("--num_heads", type=int, default=4)
    parser.add_argument("--num_layers", type=int, default=4)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--moe_every", type=int, default=2)
    parser.add_argument("--num_experts", type=int, default=4)
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--l_aux_wt", type=float, default=0.01)
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--data_file", type=str, default="")
    parser.add_argument("--checkpoint_path", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main():
    run(build_args())


if __name__ == "__main__":
    main()
