#!/usr/bin/env python3
"""The greedy tokens of `chip_smoke.py`'s full-width LM serves, for
comparing two checkouts on one NVIDIA card.

Run from the root of a checkout:

    python3 tools/lm_tokens.py OUT_DIR [--twin]

It builds the LM of `chip_smoke.py` (LM_CONFIG, bfloat16, INT4 experts from
the same seeded weights) with two-layer and with SwiGLU experts, serves the
same 64 prompts of 1664 tokens, 320 new tokens each, through a fresh
LmDecodeEngine (as `chip_smoke.lm_serve` does, without its warm-up run,
which does not change the tokens), and prints one JSON line per serve with
the SHA-1 of the generated tokens in request order (`tokens_sha1`, the
digest `chip_smoke.py` prints for its serves) and writes the tokens to
OUT_DIR/tokens_<label>.npy ([64, 320] int64; column 0 is the prefill's
token, column i that of decode step i). It uses only what `chip_smoke.py`
and the port had before the window split of K6, so a copy of this file
runs on an older checkout too. With --twin the decode steps run K6's
plain twin (`decode_attn_reference`, PyTorch on the card) in place of the
kernel, writing tokens_<label>_twin.npy: a reference that two checkouts'
kernels can each be held against.

    python3 tools/lm_tokens.py OUT_DIR --forced STEPS

holds K6 against its twin teacher-forced, on the same engine, prompts and
weights: after the prefill, STEPS decode steps run with the twin, each
fed the twin's own greedy token, then the same steps run with the kernel,
fed the twin's tokens, so the two differ only by K6's arithmetic (and
what it feeds forward through the cache). For each step it prints the
largest |logit difference| over requests and vocabulary, the twin's
top-2 logit gap (smallest over requests), and the requests whose argmax
differs with their gaps. Tokens are not written.

    python3 tools/lm_tokens.py --compare DIR_A DIR_B

reads the tokens of the serves both directories hold (a twin's
tokens_<label>_twin.npy stands for its serve; no card needed) and prints,
for each serve, the decode step at which each request first differs
(-1: never), in request order.
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tutel_tpu_torch.models import transformer  # noqa: E402
from tutel_tpu_torch.models import TransformerMoE  # noqa: E402
from tutel_tpu_torch.ops.decode_attn import decode_attn_reference  # noqa: E402
from tutel_tpu_torch.models import TransformerMoEConfig  # noqa: E402
from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest  # noqa: E402

KERNEL_ATTN = transformer.decode_attn


def serve_tokens(model, params, n_requests=64, prompt_len=1664,
                 new_tokens=320, seed=cs.SEED):
    """[n_requests, new_tokens] greedy tokens of chip_smoke.lm_serve's run."""
    rng = np.random.default_rng(seed)
    reqs = [LmRequest(uid=i, prompt=rng.integers(
        0, model.cfg.vocab_size, prompt_len).astype(np.int32),
        max_new_tokens=new_tokens) for i in range(n_requests)]
    eng = LmDecodeEngine(model, params, max_batch=64,
                         speculative_capacity=4.0)
    for r in reqs:
        if not eng.try_add(r):
            raise RuntimeError("the LM serve admits every request at once")
    eng._flush_admissions()
    while eng.active:
        eng.step_chunk(16)
    return np.stack([np.asarray(eng._generated[u], np.int64)
                     for u in sorted(eng._generated)])


def forced_steps(model, params, steps, n_requests=64, prompt_len=1664,
                 seed=cs.SEED):
    """Teacher-forced logits: the twin's `steps` decode steps from its own
    greedy tokens, then the kernel's fed those tokens. Yields one record
    per step."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab_size, prompt_len).astype(
        np.int32) for _ in range(n_requests)]
    runs = {}
    for path, attn in (("twin", decode_attn_reference),
                       ("kernel", KERNEL_ATTN)):
        transformer.decode_attn = attn
        eng = LmDecodeEngine(model, params, max_batch=64,
                             speculative_capacity=4.0)
        for i, p in enumerate(prompts):
            if not eng.try_add(LmRequest(uid=i, prompt=p,
                                         max_new_tokens=steps + 1)):
                raise RuntimeError("the LM serve admits every request at "
                                   "once")
        eng._flush_admissions()
        tok, pos, logits = eng._tok, eng._pos, []
        fed = runs["twin"][1] if path == "kernel" else []
        for i in range(steps):
            if i % 16 == 0:                   # the engine's 16-step chunks
                attn_len = eng._attn_len(16)
            out = model.apply_decode(
                eng.params, tok, eng.cache, pos,
                moe_overrides={"capacity_override": eng.max_batch},
                attn_len=attn_len)[0].float()
            logits.append(out)
            if path == "twin":
                fed.append(out.argmax(-1))
            tok, pos = fed[i], pos + 1
            eng._host_pos = [p + 1 for p in eng._host_pos]
        runs[path] = (logits, fed)
        del eng
    transformer.decode_attn = KERNEL_ATTN
    for i, (lt, lk) in enumerate(zip(runs["twin"][0], runs["kernel"][0])):
        top2 = lt.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        flips = (lk.argmax(-1) != lt.argmax(-1)).nonzero()[:, 0].tolist()
        yield {"step": i + 1, "max_abs_logit_diff":
               float((lk - lt).abs().max()),
               "max_abs_logit": float(lt.abs().max()),
               "min_top2_gap": float(gap.min()),
               "requests_gap_at_most_diff": int(
                   (gap <= (lk - lt).abs().amax(-1)).sum()),
               "argmax_flips": {str(r): float(gap[r]) for r in flips}}


def token_files(directory):
    """{serve label: path} of the tokens_*.npy in a directory; a twin's
    file (tokens_<label>_twin.npy) counts under its serve's label."""
    files = {}
    for name in sorted(os.listdir(directory)):
        if name.startswith("tokens_") and name.endswith(".npy"):
            label = name[len("tokens_"):-len(".npy")].removesuffix("_twin")
            if label in files:
                raise ValueError(f"{directory} holds two token sets of "
                                 f"{label}")
            files[label] = os.path.join(directory, name)
    return files


def compare(dir_a, dir_b):
    a_files, b_files = token_files(dir_a), token_files(dir_b)
    labels = sorted(set(a_files) & set(b_files))
    if not labels:
        print(f"lm_tokens.py: no serve has tokens in both {dir_a} and "
              f"{dir_b}", file=sys.stderr)
        return 1
    for label in labels:
        a, b = np.load(a_files[label]), np.load(b_files[label])
        if a.shape != b.shape:
            raise ValueError(f"{label}: shapes {a.shape} and {b.shape}")
        first = [int(np.argmax(row)) if row.any() else -1 for row in a != b]
        print(json.dumps({"serve": label, "a": a_files[label],
                          "b": b_files[label],
                          "requests_differing": sum(f >= 0 for f in first),
                          "first_differing_step": first}), flush=True)
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir", nargs="?")
    parser.add_argument("--twin", action="store_true",
                        help="decode with K6's plain twin on the card")
    parser.add_argument("--forced", type=int, metavar="STEPS",
                        help="teacher-forced logits of K6 against its twin")
    parser.add_argument("--compare", nargs=2, metavar="DIR",
                        help="first differing steps of two token sets")
    args = parser.parse_args()
    if args.compare:
        return compare(*args.compare)
    if args.out_dir is None:
        parser.error("OUT_DIR is required")
    if not torch.cuda.is_available():
        print("lm_tokens.py: no CUDA device", file=sys.stderr)
        return 1
    out_dir, suffix = args.out_dir, "_twin" if args.twin else ""
    if args.twin:
        transformer.decode_attn = decode_attn_reference
    os.makedirs(out_dir, exist_ok=True)
    for label, expert_type in (("lm", "ffn"), ("swiglu_lm", "llama_ffn")):
        lm = TransformerMoE(TransformerMoEConfig(
            **cs.LM_CONFIG, expert_type=expert_type, dtype=torch.bfloat16),
            device="cuda")
        params = cs.lm_params(lm, torch.Generator(device="cuda").manual_seed(
            cs.SEED))
        if args.forced:
            for rec in forced_steps(lm, params, args.forced):
                print(json.dumps({"serve": label, **rec}), flush=True)
        else:
            toks = serve_tokens(lm, params)
            np.save(os.path.join(out_dir, f"tokens_{label}{suffix}.npy"),
                    toks)
            print(json.dumps({"serve": label + suffix,
                              "shape": list(toks.shape),
                              "tokens_sha1": hashlib.sha1(
                                  toks.reshape(-1).tobytes()).hexdigest()}),
                  flush=True)
        del lm, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
