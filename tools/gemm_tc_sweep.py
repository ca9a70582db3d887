#!/usr/bin/env python3
"""Read the grouped GEMMs K1 (`grouped_gemm_quant`) and K5
(`grouped_gemm_w8a8`) and the fused W8A8 FFN K3 (`fused_ffn_w8a8`) on one
NVIDIA card, at the shapes `chip_smoke.py` checks and with each row tile
K1 and K5 take.

Run from the root of a checkout, with no arguments:

    python3 tools/gemm_tc_sweep.py

It builds only `csrc/grouped_gemm_quant.cu`, `csrc/fused_ffn_w8a8.cu` and
`csrc/grouped_gemm_w8a8.cu` (and each once more with -Xptxas -v:
registers, spills and shared memory of each kernel instance), then prints
one JSON line per reading:

  * `sass`: the tensor-core instructions of each K1/K3/K5 instance and the
    instructions a lane issues per weight byte in its weight loop
    (`chip_smoke.mma_sass`);
  * K1 in bfloat16 at the MoE decode step (128 experts, 2048 x 2048, INT4,
    the row counts of 512 routed rows at capacity 32), with every row live,
    at K < H, at the LM decode step and an LM prefill chunk, the MoE decode
    step in INT8 and with INT4 `blocks` = 2, and fc2 of a 14336-wide
    hidden (8 experts, every row live), each with the row tile the wrapper
    picks and with the other one (8 or 16 rows, through the wrapper's
    `_launch`); and in float32 (the CUDA-core body) at the MoE decode step;
  * K5 at `chip_smoke.py`'s four W8A8 shapes (the MoE decode step in INT4
    and INT8, every row live, and K < H in INT8) and with every row live
    at K = 4096, each with the 8-row tile and with the 16-row tile at 1,
    2, 4 and 8 strips a block (`planned`: the plan `w8a8.k5_plan` makes),
    its whole call's device ms and the kernel's alone
    (`kernel_device_ms`) and `host_us`;
  * K3 at the W4A8 decode step in INT4 and INT8, the same step over 32
    experts (32 blocks: the rate a block reaches without the others),
    the same step over 8 experts (a 34 MB stream that stays in L2 from
    call to call: the rate of a block fed from L2), with every row live
    and at K < H (INT8, gelu, bias).

Each reading is held against the plain twin (K5, and K3 where the
activation is relu: max abs error 0) and carries the profiled device ms
per call (K3 and K5 also the kernel's alone, and K3 the device ms of the
wrapper's quantization of x, `quantize_ms`), the event-timed ms, the live weight bytes per device second and the bound
share. The first line is the card's name, power limit and top SM clock
from nvidia-smi. Exits non-zero without a card or when a reading disagrees
with its twin.

    python3 tools/gemm_tc_sweep.py --default

reads each shape once through the wrappers' plain calls (no routed rows, no
pinned tile), skips ptxas and the SASS, so the same readings can be taken
on a checkout from before the tensor-core bodies (copy this file there).
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tutel_tpu_torch.csrc import build  # noqa: E402
from tutel_tpu_torch.ops import activations, fused_ffn, quant, w8a8  # noqa: E402
from tutel_tpu_torch.ops import grouped_gemm_quant as gq  # noqa: E402

SOURCES = ("grouped_gemm_quant", "fused_ffn_w8a8", "grouped_gemm_w8a8")


def emit(record):
    print(json.dumps(record), flush=True)


def ptxas(name):
    """Registers, spill bytes and shared memory of each kernel instance of
    csrc/<name>.cu, from nvcc -Xptxas -v."""
    out = build.BUILD_DIR / f"{name}-ptxas.{os.getpid()}.so"
    log = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, check=True).stdout
    if out.exists():
        out.unlink()
    report, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            report.setdefault(cur, {})["spills"] = [int(v) for v in
                                                    m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            report.setdefault(cur, {})["registers"] = int(m.group(1))
            cur = None
    return report


def routing(seed, routed, e, c):
    """Row counts of `routed` rows over e experts, clipped at capacity c."""
    return np.minimum(np.random.default_rng(seed).multinomial(
        routed, [1 / e] * e), c)


def read(label, kernel, call, ref, weight_bytes, bound_ms, exact=False,
         symbol=None, host=False, **extra):
    """Hold one call against its twin and time it; `symbol`: also the
    device ms of that kernel alone; `host`: also `host_us`."""
    got, again = call(), call()
    torch.cuda.synchronize()
    counts = extra.pop("counts")
    abs_err, rel_err = cs.errors(got, ref, counts)
    if (exact and abs_err != 0) or not rel_err <= cs.BF16_TOL \
            or not torch.equal(got, again):
        raise RuntimeError(f"{kernel} at {label}: {abs_err} / {rel_err}, "
                           f"or two calls differ")
    dev = cs.device_ms(call, None)
    if symbol:
        extra["kernel_device_ms"] = cs.device_ms(call, symbol)
    if host:
        extra["host_us"] = cs.host_us(call, calls=200)
    emit({"kernel": kernel, "shape": label, **extra,
          "max_abs_err": abs_err, "max_rel_err": rel_err,
          "device_ms": dev, "ms": cs.median_ms(call),
          "weight_TBps": weight_bytes / dev / 1e9,
          "bound_ms": bound_ms, "bound_share": bound_ms / dev})


def k1_case(label, e, c, k, n, rows, bits=4, blocks=1, dtype=torch.bfloat16,
            default=False, bandwidth=3.35e12):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    w = quant.quantize(torch.randn(e, k, n, generator=g, device=dev) * 0.02,
                       bits, shard_blocks=blocks)
    x = torch.randn(e, c, k, generator=g, device=dev).to(dtype)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)
    live, experts = int(counts.sum()), int((counts > 0).sum())
    ref = gq.grouped_gemm_quant_reference(x, w, counts)
    weights = experts * (w.values[0].numel() + 4 * n)
    moved = weights + live * k * x.element_size() + e * c * n * \
        x.element_size() + 4 * e
    bound_ms = cs.bound(moved, 2 * live * k * n, bandwidth)["bound_ms"]
    base = dict(counts=counts, E=e, C=c, K=k, N=n, bits=bits, blocks=blocks,
                dtype=str(dtype).split(".")[-1], live_rows=live)
    if default:
        read(label, "grouped_gemm_quant",
             lambda: gq.grouped_gemm_quant(x, w, counts), ref, weights,
             bound_ms, **base)
        return
    tiles = (8, 16) if dtype == torch.bfloat16 else (None,)
    for tile in tiles:
        plan = gq.tc_plan(e, c, live, tile)
        read(label, "grouped_gemm_quant",
             lambda: gq._launch(x, w, counts, plan), ref, weights, bound_ms,
             tile_rows=tile, plan=plan, **base)


def k5_case(label, e, c, k, n, rows, bits, default=False,
            bandwidth=3.35e12):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    w = quant.quantize(torch.randn(e, k, n, generator=g, device=dev) * 0.02,
                       bits)
    x = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)
    live, experts = int(counts.sum()), int((counts > 0).sum())
    ref = w8a8.grouped_gemm_w8a8_reference(x, w, counts)
    weights = experts * (w.values[0].numel() + 4 * n)
    moved = weights + live * k * 2 + e * c * n * 2 + 4 * e
    bound_ms = cs.bound(moved, 2 * live * k * n, bandwidth,
                        cs.INT8_PEAK)["bound_ms"]
    base = dict(exact=True, symbol="gmm_w8a8_kernel", host=True,
                counts=counts, E=e, C=c, K=k, N=n, bits=bits,
                live_rows=live)
    if default:
        read(label, "grouped_gemm_w8a8",
             lambda: w8a8.grouped_gemm_w8a8(x, w, counts), ref, weights,
             bound_ms, **base)
        return
    # the 8-row tile (one strip a block: k5_plan gives it no more), and the
    # 16-row tile with each count of strips a block; `planned` marks the
    # plan k5_plan makes from the routed rows
    chosen = w8a8.k5_plan(e, c, k, n, bits, fused_ffn.sm_count(0), live)
    plans = [gq.tc_plan(e, c, live, 8) + (1,)]
    plans += [gq.tc_plan(e, c, live, 16) + (s,) for s in (1, 2, 4, 8)]
    for plan in plans:
        read(label, "grouped_gemm_w8a8",
             lambda: w8a8._launch(x, w, counts, plan), ref, weights,
             bound_ms, tile_rows=plan[0], plan=plan,
             planned=plan == chosen, **base)


def k3_case(label, e, c, k, h, n, rows, bits, act, bias, default=False,
            bandwidth=3.35e12):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    w1 = quant.quantize(torch.randn(e, k, h, generator=g, device=dev) * 0.02,
                        bits)
    w2 = quant.quantize(torch.randn(e, h, n, generator=g, device=dev) * 0.02,
                        bits)
    b1 = torch.randn(e, h, generator=g, device=dev) * 0.1 if bias else None
    b2 = torch.randn(e, n, generator=g, device=dev) * 0.1 if bias else None
    stream = fused_ffn.prepare_fused_ffn(w1, w2, b1, b2)
    x = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)
    live, experts = int(counts.sum()), int((counts > 0).sum())
    fn = getattr(activations, act)
    ref = fused_ffn.fused_ffn_w8a8_reference(x, stream, counts, fn)
    weights = experts * ((k * h + h * n) * bits // 8 + 8 * (h + n))
    moved = weights + live * k * 2 + e * c * n * 2 + 4 * e
    bound_ms = cs.bound(moved, 2 * live * (k * h + h * n), bandwidth,
                        cs.INT8_PEAK)["bound_ms"]
    if default:
        call, plan = (lambda: fused_ffn.fused_ffn_w8a8(  # noqa: E731
            x, stream, counts, activation_fn=fn)), {}
    else:
        call, plan = (lambda: fused_ffn.fused_ffn_w8a8(  # noqa: E731
            x, stream, counts, activation_fn=fn, routed=live)), {
            "tile_rows": fused_ffn.tile_rows_w8a8(h, e, c, live)}
    read(label, "fused_ffn_w8a8", call, ref, weights, bound_ms,
         exact=act == "relu", symbol="fused_w8a8_kernel",
         quantize_ms=cs.device_ms(lambda: quant.quantize_activations(x),
                                  None), counts=counts, E=e, C=c, K=k, H=h, N=n,
         bits=bits, live_rows=live, **plan)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--default", action="store_true",
                        help="the wrappers' plain calls only; no ptxas, SASS")
    default = parser.parse_args().default
    if not torch.cuda.is_available():
        print("gemm_tc_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"card": smi})
    bandwidth = cs.hbm_bytes_per_s(smi)
    build.build_all(SOURCES)
    if not default:
        for name in SOURCES:
            emit({"ptxas": name, "kernels": ptxas(name)})
        emit({"sass": "grouped_gemm_quant", "kernels": cs.mma_sass(
            "grouped_gemm_quant", "gmm_quant_kernel_tc", "HMMA")})
        emit({"sass": "fused_ffn_w8a8", "kernels": cs.mma_sass(
            "fused_ffn_w8a8", "fused_w8a8_kernel", "IMMA")})
        emit({"sass": "grouped_gemm_w8a8", "kernels": cs.mma_sass(
            "grouped_gemm_w8a8", "gmm_w8a8_kernel", "IMMA")})
    moe = routing(cs.SEED, 512, 128, 32)
    k_lt_h = np.random.default_rng(cs.SEED + 1).integers(0, 33, 64)
    lm = routing(cs.SEED + 2, 128, 32, 16)
    prefill = np.random.default_rng(cs.SEED + 3).multinomial(
        16384, [1 / 32] * 32)
    kw = dict(default=default, bandwidth=bandwidth)
    k1_case("decode", 128, 32, 2048, 2048, moe, **kw)
    k1_case("all_rows", 128, 32, 2048, 2048, [32] * 128, **kw)
    k1_case("k_lt_h", 64, 32, 1024, 4096, k_lt_h, **kw)
    k1_case("lm_decode", 32, 16, 1024, 2048, lm, **kw)
    k1_case("decode_int8", 128, 32, 2048, 2048, moe, bits=8, **kw)
    k1_case("decode_blocks2", 128, 32, 2048, 2048, moe, blocks=2, **kw)
    k1_case("decode_f32", 128, 32, 2048, 2048, moe, dtype=torch.float32,
            **kw)
    # fc2 of a wide hidden with every row live: x staged a chunk at a time
    k1_case("wide_k", 8, 32, 14336, 4096, [32] * 8, **kw)
    torch.cuda.empty_cache()
    k1_case("lm_prefill", 32, 8192, 1024, 2048, prefill, **kw)
    torch.cuda.empty_cache()
    # K5 (fc1 of the W8A8 FFN as one GEMM) at chip_smoke.py's W8A8 shapes
    for label, rows, bits in (("decode", moe, 4), ("decode_int8", moe, 8),
                              ("all_rows", [32] * 128, 4)):
        k5_case(label, 128, 32, 2048, 2048, rows, bits, **kw)
    k5_case("k_lt_h", 64, 32, 1024, 4096, k_lt_h, 8, **kw)
    # every row live at K = 4096: x still one chunk a warp, but a block of
    # several strips takes 98 KB, so an SM holds 2 of them, not 3
    k5_case("all_rows_k4096", 128, 32, 4096, 2048, [32] * 128, 4, **kw)
    torch.cuda.empty_cache()
    for label, bits in (("decode", 4), ("decode_int8", 8)):
        k3_case(label, 128, 32, 2048, 2048, 2048, moe, bits, "relu", False,
                **kw)
    # the same step over 32 experts: 32 blocks on 132 SMs, so the weight
    # rate a block reaches when the others do not compete for memory
    k3_case("decode_e32", 32, 32, 2048, 2048, 2048,
            routing(cs.SEED + 4, 128, 32, 32), 4, "relu", False, **kw)
    # over 8 experts: their 34 MB stream stays in the 50 MB L2 from call to
    # call, so the rate a block reaches when HBM does not feed it
    k3_case("decode_e8", 8, 32, 2048, 2048, 2048,
            routing(cs.SEED + 5, 32, 8, 32), 4, "relu", False, **kw)
    k3_case("all_rows", 128, 32, 2048, 2048, 2048, [32] * 128, 4, "relu",
            False, **kw)
    k3_case("k_lt_h", 64, 32, 1024, 4096, 1024, k_lt_h, 8, "gelu", True,
            **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
