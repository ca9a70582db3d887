#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (tutel_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from csrc/*.cu with nvcc, all at once, timed;
  3. holds each kernel (K1 grouped_gemm_quant, K2 fused_ffn_quant) against
     its plain PyTorch twin on the card in bfloat16, at the decode server's
     shape (128 experts, 2048 x 2048, INT4, capacity 32, the row counts of
     512 routed tokens), at the same width with every row live, and at a
     K < H shape, and times kernel, twin and a bf16 torch.bmm yardstick
     with CUDA events;
  4. serves 512 requests of 8-32 decode steps through MoeDecodeEngine at
     128 experts x 2048 x 2048, top-2, dropless, INT4, bfloat16, batch 256,
     residual_norm (the shape of benchmarks/bench_dropless_decode.py), with
     the fused kernel (auto_fuse=True), then a shorter run on the two-call
     path (auto_fuse=False), counting each kernel's launches in each run;
  5. checks a small engine on the card against the same engine on the CPU;
  6. prints one JSON line per kernel check, the server's JSON line, the
     {"kernels": [...]} line, and last {"ok": true, "device": {...}}.

Every failed check raises, so the script exits non-zero and prints no "ok"
line; without a GPU it exits non-zero at once.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tutel_tpu_torch import moe  # noqa: E402
from tutel_tpu_torch.csrc import build  # noqa: E402
from tutel_tpu_torch.ops import activations, fused_ffn, quant  # noqa: E402
from tutel_tpu_torch.ops import grouped_gemm_quant as gq  # noqa: E402
from tutel_tpu_torch.serving import MoeDecodeEngine, Request  # noqa: E402

SEED = 0
BF16_TOL = 2e-2            # max |kernel - twin| / max |twin|, bfloat16
SMALL_TOL = 1e-4           # GPU engine vs CPU engine, float32
BF16_PEAK = 989e12         # H100 SXM dense bf16 tensor-core FLOP/s
REPS = 20


def hbm_bytes_per_s(name):
    """Data-sheet memory bandwidth of the card named by nvidia-smi."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H100" in name:
        return 3.35e12
    raise RuntimeError(f"no memory bandwidth known for {name!r}")


def median_ms(fn, reps=REPS):
    """Median over `reps` single calls, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(got, ref, counts):
    """(max abs error, max abs error / max |ref|) over rows < counts."""
    live = (torch.arange(ref.shape[1], device=ref.device)[None, :, None]
            < counts.to(ref.device)[:, None, None])
    diff = torch.where(live, (got.float() - ref.float()).abs(), 0.0).max()
    scale = torch.where(live, ref.float().abs(), 0.0).max()
    return float(diff), float(diff / scale)


def check_kernels(shape, bandwidth):
    """Both kernels against their twins at one shape; returns two dicts."""
    name, e, c, k, h, n, rows, bias, act = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    w1 = quant.quantize(torch.randn(e, k, h, generator=g, device=dev) * 0.02, 4)
    w2 = quant.quantize(torch.randn(e, h, n, generator=g, device=dev) * 0.02, 4)
    b1 = torch.randn(e, h, generator=g, device=dev) * 0.1 if bias else None
    b2 = torch.randn(e, n, generator=g, device=dev) * 0.1 if bias else None
    stream = fused_ffn.prepare_fused_ffn(w1, w2, b1, b2)
    x = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)
    live_rows = int(counts.sum())
    live_experts = int((counts > 0).sum())
    act_fn = getattr(activations, act)
    out = []

    # K1 on fc1: x [E, C, K] @ W1 [K, H]
    got = gq.grouped_gemm_quant(x, w1, counts)
    ref = gq.grouped_gemm_quant_reference(x, w1, counts)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref, counts)
    w1_dense = quant.dequantize(w1, torch.bfloat16)
    moved = (live_experts * (w1.values[0].numel() + 4 * h)
             + live_rows * k * 2 + e * c * h * 2 + 4 * e)
    ops = 2 * live_rows * k * h
    out.append({
        "name": "grouped_gemm_quant", "shape": name,
        "E": e, "C": c, "K": k, "N": h, "live_rows": live_rows,
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": BF16_TOL,
        "ms": median_ms(lambda: gq.grouped_gemm_quant(x, w1, counts)),
        "plain_ms": median_ms(
            lambda: gq.grouped_gemm_quant_reference(x, w1, counts)),
        "bf16_bmm_ms": median_ms(lambda: torch.bmm(x, w1_dense)),
        "bytes": moved, "ops": ops,
        "bound_ms": 1e3 * max(moved / bandwidth, ops / BF16_PEAK),
        "bound_by": "bytes" if moved / bandwidth >= ops / BF16_PEAK
        else "operations"})
    del w1_dense

    # K2: act(x @ W1 + b1) @ W2 + b2
    got = fused_ffn.fused_ffn_quant(x, stream, counts, activation_fn=act_fn)
    ref = fused_ffn.fused_ffn_quant_reference(x, stream, counts, act_fn)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref, counts)
    w1_dense = quant.dequantize(w1, torch.bfloat16)
    w2_dense = quant.dequantize(w2, torch.bfloat16)
    per_expert = stream.wstream[0].numel() + 4 * stream.sb[0].numel()
    moved = (live_experts * per_expert + live_rows * k * 2
             + e * c * n * 2 + 4 * e)
    ops = 2 * live_rows * (k * h + h * n)
    out.append({
        "name": "fused_ffn_quant", "shape": name,
        "E": e, "C": c, "K": k, "H": h, "N": n, "live_rows": live_rows,
        "activation": act, "bias": bias,
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": BF16_TOL,
        "ms": median_ms(lambda: fused_ffn.fused_ffn_quant(
            x, stream, counts, activation_fn=act_fn)),
        "plain_ms": median_ms(lambda: fused_ffn.fused_ffn_quant_reference(
            x, stream, counts, act_fn)),
        "bf16_bmm_ms": median_ms(lambda: torch.bmm(
            act_fn(torch.bmm(x, w1_dense)), w2_dense)),
        "bytes": moved, "ops": ops,
        "bound_ms": 1e3 * max(moved / bandwidth, ops / BF16_PEAK),
        "bound_by": "bytes" if moved / bandwidth >= ops / BF16_PEAK
        else "operations"})
    for r in out:
        if not r["max_rel_err"] <= BF16_TOL:
            raise RuntimeError(f"{r['name']} at {name} disagrees with its "
                               f"twin: {r['max_rel_err']} > {BF16_TOL}")
    return out


def serve(layer, params, n_requests, steps, auto_fuse, seed):
    """Run requests through a fresh engine and check every output;
    returns (engine, seconds)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    states = torch.randn(n_requests, layer.model_dim, generator=g,
                         device="cuda").to(layer.dtype)
    lengths = np.random.default_rng(seed).integers(steps[0], steps[1] + 1,
                                                   n_requests)
    eng = MoeDecodeEngine(layer, params, max_batch=256, auto_fuse=auto_fuse,
                          state_update="residual_norm")
    reqs = [Request(uid=i, state=states[i], remaining=int(lengths[i]))
            for i in range(n_requests)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finals = eng.run(reqs, chunk=8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if len(finals) != n_requests:
        raise RuntimeError(f"{len(finals)} of {n_requests} requests finished")
    for uid, out in finals.items():
        if out.shape != (layer.model_dim,) or not torch.isfinite(
                out.float()).all():
            raise RuntimeError(f"request {uid}: bad output {out.shape}")
    return eng, seconds


def small_engine_check():
    """A small INT4 engine on the card (kernels) against the same engine on
    the CPU (plain twins), float32, fused and two-call paths."""
    kw = dict(gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
              experts={"type": "ffn", "num_experts_per_device": 8,
                       "hidden_size_per_expert": 512},
              model_dim=256)
    cpu_layer, gpu_layer = (moe.moe_layer(device=d, **kw)
                            for d in ("cpu", "cuda"))
    params = cpu_layer.init(torch.Generator().manual_seed(SEED))
    params["experts"] = quant.quantize_expert_params(params["experts"], 4)
    gpu_params = {"gates": [{"wg": params["gates"][0]["wg"].cuda()}],
                  "experts": {k: v.to("cuda")
                              for k, v in params["experts"].items()}}
    states = np.random.default_rng(SEED).standard_normal((24, 256)).astype(
        np.float32)
    worst = 0.0
    for auto_fuse in (True, False):
        finals = []
        for layer, p in ((cpu_layer, params), (gpu_layer, gpu_params)):
            eng = MoeDecodeEngine(layer, p, max_batch=16, auto_fuse=auto_fuse,
                                  state_update="residual_norm")
            finals.append(eng.run([Request(uid=i, state=states[i],
                                           remaining=2 + i % 3)
                                   for i in range(24)], chunk=2))
        for uid, ref in finals[0].items():
            err = float((finals[1][uid].float() - ref).abs().max()
                        / ref.abs().max())
            worst = max(worst, err)
    if not worst <= SMALL_TOL:
        raise RuntimeError(f"GPU engine disagrees with the CPU engine: "
                           f"{worst} > {SMALL_TOL}")
    return worst


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 twins in full
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    bandwidth = hbm_bytes_per_s(smi)

    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}),
          flush=True)

    # the decode server's shape: capacity 32 (the speculated buffer at 256
    # active tokens), row counts of 512 top-2 routings over 128 experts
    routed = np.random.default_rng(SEED).multinomial(512, [1 / 128] * 128)
    shapes = [("decode", 128, 32, 2048, 2048, 2048,
               np.minimum(routed, 32), False, "relu"),
              ("all_rows", 128, 32, 2048, 2048, 2048, [32] * 128, False,
               "relu"),
              ("k_lt_h", 64, 32, 1024, 4096, 1024,
               np.random.default_rng(SEED + 1).integers(0, 33, 64), True,
               "gelu")]
    checks = {}
    for shape in shapes:
        for r in check_kernels(shape, bandwidth):
            print(json.dumps(r), flush=True)
            checks[(r["name"], r["shape"])] = r
        torch.cuda.empty_cache()

    gate = {"type": "top", "k": 2, "capacity_factor": 0.0}
    layer = moe.moe_layer(
        gate_type=gate, model_dim=2048, dtype=torch.bfloat16, device="cuda",
        experts={"type": "ffn", "num_experts_per_device": 128,
                 "hidden_size_per_expert": 2048, "has_fc1_bias": False,
                 "has_fc2_bias": False})
    params = layer.init(torch.Generator(device="cuda").manual_seed(SEED))
    params["experts"] = quant.quantize_expert_params(params["experts"], 4)
    torch.cuda.empty_cache()
    serve(layer, params, 16, (2, 2), True, SEED + 7)           # warm-up
    serve(layer, params, 16, (2, 2), False, SEED + 7)

    counters = {"grouped_gemm_quant": gq.grouped_gemm_quant,
                "fused_ffn_quant": fused_ffn.fused_ffn_quant}
    launches = {}
    for path, auto_fuse, n_req, runs in (("fused", True, 512, "fused_ffn_quant"),
                                         ("two_call", False, 128,
                                          "grouped_gemm_quant")):
        for f in counters.values():
            f.launches = 0
        eng, seconds = serve(layer, params, n_req, (8, 32), auto_fuse,
                                SEED)
        counts = {k: f.launches for k, f in counters.items()}
        print(json.dumps({
            "phase": "serve", "path": path, "requests": n_req,
            "tokens": eng.stats["tokens"], "decode_steps": eng.stats["steps"],
            "spec_retries": eng.stats["spec_retries"], "seconds": seconds,
            "tokens_per_s": eng.stats["tokens"] / seconds,
            "launches": counts, "card": smi}), flush=True)
        other = [k for k in counters if k != runs][0]
        if counts[runs] <= 0 or counts[other] != 0:
            raise RuntimeError(f"{path} run launched {counts}")
        launches[runs] = counts[runs]

    print(json.dumps({"phase": "small_engine_vs_cpu",
                      "max_rel_err": small_engine_check(), "tol": SMALL_TOL}),
          flush=True)

    sources = {"grouped_gemm_quant": (
        "tutel_tpu_torch/csrc/grouped_gemm_quant.cu",
        "tutel_tpu/ops/grouped_gemm_pallas.py:94"),
        "fused_ffn_quant": ("tutel_tpu_torch/csrc/fused_ffn_quant.cu",
                            "tutel_tpu/ops/fused_ffn_pallas.py:209")}
    kernels = []
    for name, (source, replaces) in sources.items():
        r = checks[(name, "decode")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
