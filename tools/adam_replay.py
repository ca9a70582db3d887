#!/usr/bin/env python3
"""Why `chip_smoke.py` holds its Adam trainers (vision_train, native_lm)
step by step and not by trajectory.

Run from the root of a checkout:

    python3 tools/adam_replay.py [--device cuda] [--dump PATH]
                                 [--against PATH]

It computes the trainers' CPU states (`adam_cpu_states`) and prints, for
each trainer, the CPU's trajectory losses (run it under two CPU code paths,
e.g. with ATEN_CPU_CAPABILITY=default, to see them part). Then, from each
of the CPU's states, one line a step: the loss and gradients on --device
against the CPU's (the error of all leaves as one vector, and the three
leaves furthest off, max |diff| / max |CPU's|), and both sides against a
float64 gradient on the CPU. The models round to float32 with `.float()`
in places; while it takes the float64 gradient the tool maps `.float()`
to `.double()`.

--dump PATH saves the CPU's step-0 gradients; --against PATH compares
them with such a dump (made under another code path): the elements whose
sign differs, each beside its leaf's largest |gradient|.
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tutel_tpu_torch.examples import moe_transformer_lm as mtl  # noqa: E402
from tutel_tpu_torch.models import VisionMoE, VisionMoEConfig  # noqa: E402
from tutel_tpu_torch.utils import tree_replace  # noqa: E402


def leaf_names(tree, prefix=""):
    """Paths of a tree's tensors in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def vision_loss64():
    model = VisionMoE(VisionMoEConfig(dtype=torch.float64), device="cpu")
    images, labels = cs.vision_batch()
    return lambda params, _: model.loss(params, images.double(), labels)[0]


def lm_loss64():
    args = cs.native_lm_args("cpu", cs.NATIVE_CPU_STEPS)
    model = mtl.build_model(args, "cpu")
    model.cfg = dataclasses.replace(model.cfg, dtype=torch.float64)
    key = torch.Generator().manual_seed(7)
    return lambda params, batch: model.loss(params, batch, key=key,
                                            l_aux_wt=args.l_aux_wt)[0]


def grads_of(loss_fn, start, before, batch, device, dtype=None):
    leaves = [p.to(device=device, dtype=dtype or p.dtype).requires_grad_(True)
              for p in before]
    loss = loss_fn(tree_replace(start, leaves), batch)
    return float(loss), [g.float().cpu()
                         for g in torch.autograd.grad(loss, leaves)]


def float64_grads(make_loss, start, before, batch):
    as_float = torch.Tensor.float
    torch.Tensor.float = lambda t: (t.double() if t.is_floating_point()
                                    else as_float(t))
    try:
        return grads_of(make_loss(), start, before, batch, "cpu",
                        torch.float64)
    finally:
        torch.Tensor.float = as_float


def vector_err(got, ref):
    diff = sum(float((g - r).square().sum()) for g, r in zip(got, ref))
    return (diff / sum(float(r.square().sum()) for r in ref)) ** 0.5


def leaf_err(g, r):
    return float((g - r).abs().max() / r.abs().max())


def replay(name, loss_fn, make_loss64, start, states, batches, device):
    names = leaf_names(start)
    print(json.dumps({"trainer": name, "cpu_losses":
                      [st[1] for st in states]}), flush=True)
    for i, ((before, ref_loss, ref), batch) in enumerate(zip(states,
                                                             batches)):
        loss, got = grads_of(loss_fn, start, before, batch, device)
        loss64, exact = float64_grads(make_loss64, start, before, batch)
        per = sorted(((leaf_err(g, r), n) for g, r, n in
                      zip(got, ref, names)), reverse=True)[:3]
        print(json.dumps({
            "trainer": name, "step": i, "loss_diff": abs(loss - ref_loss),
            "loss64_diff_cpu": abs(loss64 - ref_loss),
            "grad_err": vector_err(got, ref), "worst_leaves": per,
            "device_vs_float64": max(leaf_err(g, e)
                                     for g, e in zip(got, exact)),
            "cpu_vs_float64": max(leaf_err(r, e)
                                  for r, e in zip(ref, exact))}), flush=True)


def sign_flips(ref, saved, names):
    """Elements whose sign differs between two step-0 gradients."""
    out = []
    for g, h, n in zip(ref, saved, names):
        flip = (g > 0) != (h > 0)
        if flip.any():
            out.append({"leaf": n, "count": int(flip.sum()),
                        "largest_flipped": float(g[flip].abs().max()),
                        "largest_flipped_saved": float(h[flip].abs().max()),
                        "leaf_largest": float(g.abs().max())})
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dump", default="")
    parser.add_argument("--against", default="")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = cs.adam_cpu_states()
    start, states = refs["native_lm"]
    first = {"vision_train": (cs.vision_start(), refs["vision"][0][2]),
             "native_lm": (start, states[0][2])}
    if args.dump:
        torch.save({k: grads for k, (_, grads) in first.items()}, args.dump)
    if args.against:
        saved = torch.load(args.against)
        for k, (tree, grads) in first.items():
            print(json.dumps({"trainer": k, "step0_sign_flips": sign_flips(
                grads, saved[k], leaf_names(tree))}), flush=True)
    replay("vision_train", cs.vision_loss(args.device), vision_loss64,
           cs.vision_start(), refs["vision"],
           [None] * cs.VISION_CPU_STEPS, args.device)
    replay("native_lm", cs.native_lm_loss(
        cs.native_lm_args(args.device, cs.NATIVE_CPU_STEPS), args.device),
        lm_loss64, start, states, mtl.make_batches(
            cs.native_lm_args("cpu", len(states))), args.device)


if __name__ == "__main__":
    main()
