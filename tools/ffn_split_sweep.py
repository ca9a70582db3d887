#!/usr/bin/env python3
"""Sweep the hidden split (S) of the fused expert kernels K2
(`fused_ffn_quant`) and K4 (`fused_swiglu_quant`) on one NVIDIA card, and
read K3 (`fused_ffn_w8a8`) beside them.

Run from the root of a checkout, with no arguments:

    python3 tools/ffn_split_sweep.py

It builds only `csrc/fused_ffn_quant.cu`, `csrc/fused_swiglu_quant.cu` and
`csrc/fused_ffn_w8a8.cu` (and K2/K4 once more with -Xptxas -v, for each
kernel instance's registers and spills), then prints:

  * `sass_loops`: for each K2/K4 kernel instance, the loops of its SASS
    (`cuobjdump -sass`; a loop ends in a branch back to an earlier
    address) that load weights, with their instructions by opcode and the
    instructions a thread issues per weight byte it loads, and the weight
    rate the SMs could issue at that count (4 warp instructions per clock
    per SM at the card's top SM clock): the issue ceiling of the loop;
  * for each S at the shapes `chip_smoke.py` checks (K2 at the LM decode
    step, the MoE server's decode step and an LM prefill chunk; K4 at the
    SwiGLU LM's decode step and prefill chunk; bfloat16, INT4) and at a
    second and third batch size and capacity (the LM decode step with 32
    and 48 tokens, the MoE decode step at capacity 40 and with 64
    tokens), the profiled device ms per call
    (every kernel of the call: the main kernel and, for S > 1, the
    combine), the event-timed ms and the live weight bytes per device
    second, beside the S that `fused_ffn.split_plan` picks from the
    routed rows; every reading is held against the plain twin and two
    calls must be bitwise equal;
  * K3 at the W4A8 decode shape, INT4 and INT8: device ms and event ms.

One JSON line per reading on standard output; the first line is the
card's name, power limit and top SM clock from nvidia-smi. Exits non-zero
without a card or when a reading disagrees with its twin.

    python3 tools/ffn_split_sweep.py --default

reads each shape once with the wrapper's own choices (told the routed
rows where the wrapper takes them), pins nothing and skips ptxas and the
SASS, so the same readings can be taken on a checkout from before the
split (copy this file there).
"""

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tutel_tpu_torch.csrc import build  # noqa: E402
from tutel_tpu_torch.ops import activations, fused_ffn, quant  # noqa: E402

SPLIT_SOURCES = ("fused_ffn_quant", "fused_swiglu_quant")
SOURCES = SPLIT_SOURCES + ("fused_ffn_w8a8",)
DECODE_SPLITS = (1, 2, 3, 4, 6, 8)
DEFAULT = False


def emit(record):
    print(json.dumps(record), flush=True)


def ptxas(name):
    """Registers and spill bytes of each kernel instance of csrc/<name>.cu,
    from nvcc -Xptxas -v."""
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


def instance(mangled):
    """`kernel<dtype, bits, decode>` from a K2/K4 kernel's mangled name."""
    kernel = re.search(r"(fused_\w+?_(?:kernel|combine))", mangled).group(1)
    dtype = "bf16" if "bfloat16" in mangled else "f32"
    args = re.findall(r"L([ib])(\d+)E", mangled)
    return f"{kernel}<{', '.join([dtype] + [v for _, v in args])}>"


def sass_loops(name, sms, clock_hz):
    """The weight-loading loops of each kernel of csrc/<name>.cu's built
    library: innermost loops (no smaller loop inside) that hold a global
    load through the read-only path, with their static instructions by
    opcode, the bytes those loads bring a thread, instructions per byte,
    and the weight rate the card could issue at that count."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        head = part.split(None, 1)[0]
        if "_kernel" not in head:
            continue
        code = []                      # (address, opcode, operands)
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)([^;]*);", part):
            code.append((int(m.group(1), 16), m.group(3), m.group(4)))
        loops = []
        for addr, op, args in code:
            t = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        found = []
        for lo, hi in loops:
            if any(lo <= a and b <= hi and (a, b) != (lo, hi)
                   for a, b in loops):
                continue               # not innermost
            body = [(op, args) for a, op, args in code if lo <= a <= hi]
            loads = [op for op, _ in body if op.startswith("LDG")
                     and "CONSTANT" in op]
            if not loads:
                continue
            nbytes = sum(16 if ".128" in op else 8 if ".64" in op else 4
                         for op in loads)
            ops = {}
            for op, _ in body:
                base = op.split(".")[0]
                ops[base] = ops.get(base, 0) + 1
            per_byte = len(body) / nbytes
            found.append({
                "instructions": len(body), "load_bytes": nbytes,
                "per_weight_byte": per_byte,
                "issue_ceiling_TBps": sms * 4 * clock_hz * 32 / per_byte
                / 1e12,
                "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))})
        out[instance(head)] = found
    return out


def takes(kernel, arg):
    return arg in inspect.signature(kernel).parameters


def sweep(kernel, label, x, stream, counts, routed, splits, ref, tol,
          weight_bytes, **kw):
    e, c, _ = x.shape
    auto = (None, None)
    if takes(kernel, "routed"):
        kw["routed"] = routed
        auto = fused_ffn.split_plan(stream.bits, stream.k, stream.kr,
                                    stream.n, e, c, x.element_size(),
                                    fused_ffn.sm_count(x.device.index),
                                    routed=routed)
    pins = (None,) if DEFAULT else sorted(set(splits) | {auto[0] or 1})
    for split in pins:
        if split is not None and split > fused_ffn.max_split(stream.kr):
            continue
        pinned = {} if split is None else {"split": split}

        def call():
            return kernel(x, stream, counts, **pinned, **kw)
        got, again = call(), call()
        torch.cuda.synchronize()
        _, err = cs.errors(got, ref, counts)
        if not err <= tol or not torch.equal(got, again):
            raise RuntimeError(f"{kernel.__name__} at {label}, S={split}: "
                               f"{err} > {tol} or not bitwise repeatable")
        dev = cs.device_ms(call, None)
        emit({"kernel": kernel.__name__, "shape": label,
              "wrapper": "default" if DEFAULT else "pinned", "split": split,
              "auto_split": auto[0], "tile_rows": auto[1], "routed": routed,
              "max_rel_err": err, "device_ms": dev, "ms": cs.median_ms(call),
              "weight_TBps": weight_bytes / dev / 1e9})


def routing(seed, routed, e, c):
    """Row counts of `routed` rows routed uniformly to e experts, clipped
    at the capacity c (chip_smoke.py's shapes)."""
    return np.minimum(np.random.default_rng(seed).multinomial(
        routed, [1 / e] * e), c)


def k2_case(label, e, c, k, h, n, rows, bias, splits):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    w1 = quant.quantize(torch.randn(e, k, h, generator=g, device=dev) * 0.02, 4)
    w2 = quant.quantize(torch.randn(e, h, n, generator=g, device=dev) * 0.02, 4)
    b1 = torch.randn(e, h, generator=g, device=dev) * 0.1 if bias else None
    b2 = torch.randn(e, n, generator=g, device=dev) * 0.1 if bias else None
    stream = fused_ffn.prepare_fused_ffn(w1, w2, b1, b2)
    x = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)
    ref = fused_ffn.fused_ffn_quant_reference(x, stream, counts,
                                              activations.relu)
    live = int((counts > 0).sum())
    sweep(fused_ffn.fused_ffn_quant, label, x, stream, counts,
          int(counts.sum()), splits, ref, cs.BF16_TOL,
          live * (k * h + h * n) // 2, activation_fn=activations.relu)


def k4_case(label, e, c, k, h, n, rows, splits):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    ws = [quant.quantize(torch.randn(*s, generator=g, device=dev) * 0.02, 4)
          for s in ((e, k, h), (e, k, h), (e, h, n))]
    stream = fused_ffn.prepare_fused_swiglu(*ws)
    x = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)
    ref = fused_ffn.fused_swiglu_quant_reference(x, stream, counts)
    live = int((counts > 0).sum())
    sweep(fused_ffn.fused_swiglu_quant, label, x, stream, counts,
          int(counts.sum()), splits, ref, cs.BF16_TOL,
          live * (2 * k * h + h * n) // 2)


def k3_case(label, bits, rows):
    """K3 at the W4A8 decode shape (chip_smoke.py's check_w8a8_kernels)."""
    e, c, k, h, n = 128, 32, 2048, 2048, 2048
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    w1 = quant.quantize(torch.randn(e, k, h, generator=g, device=dev) * 0.02,
                        bits)
    w2 = quant.quantize(torch.randn(e, h, n, generator=g, device=dev) * 0.02,
                        bits)
    stream = fused_ffn.prepare_fused_ffn(w1, w2)
    x = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)

    def call():
        return fused_ffn.fused_ffn_w8a8(x, stream, counts,
                                        activation_fn=activations.relu)
    ref = fused_ffn.fused_ffn_w8a8_reference(x, stream, counts,
                                             activations.relu)
    _, err = cs.errors(call(), ref, counts)
    if not err <= cs.BF16_TOL:
        raise RuntimeError(f"fused_ffn_w8a8 at {label}: {err}")
    emit({"kernel": "fused_ffn_w8a8", "shape": label, "bits": bits,
          "max_rel_err": err, "device_ms": cs.device_ms(call, None),
          "ms": cs.median_ms(call)})


def main():
    global DEFAULT
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--default", action="store_true",
                        help="the wrapper's own split only; no ptxas, SASS")
    DEFAULT = parser.parse_args().default
    if not torch.cuda.is_available():
        print("ffn_split_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"card": smi})
    build.build_all(SOURCES)
    if not DEFAULT:
        mhz = float(re.search(r"(\d+) MHz", smi).group(1))
        sms = fused_ffn.sm_count(0)
        for name in SPLIT_SOURCES:
            emit({"ptxas": name, "kernels": ptxas(name)})
            emit({"sass_loops": name, "sms": sms, "sm_clock_mhz": mhz,
                  "kernels": sass_loops(name, sms, mhz * 1e6)})
    moe_rows = routing(cs.SEED, 512, 128, 32)
    lm_rows = routing(cs.SEED + 2, 128, 32, 16)
    prefill_rows = np.random.default_rng(cs.SEED + 3).multinomial(
        16384, [1 / 32] * 32)
    k2_case("lm_decode", 32, 16, 1024, 2048, 1024, lm_rows, True,
            DECODE_SPLITS)
    k4_case("lm_decode", 32, 16, 1024, 2048, 1024, lm_rows, DECODE_SPLITS)
    k2_case("decode", 128, 32, 2048, 2048, 2048, moe_rows, False,
            DECODE_SPLITS)
    # a second batch size and capacity: the LM step with 32 tokens (64
    # routed rows at the speculated capacity 8) and the MoE step's 512
    # routed rows at capacity 40
    lm32_rows = routing(cs.SEED + 4, 64, 32, 8)
    k2_case("lm_decode_b32", 32, 8, 1024, 2048, 1024, lm32_rows, True,
            DECODE_SPLITS)
    k4_case("lm_decode_b32", 32, 8, 1024, 2048, 1024, lm32_rows,
            DECODE_SPLITS)
    k2_case("decode_c40", 128, 40, 2048, 2048, 2048, moe_rows, False,
            DECODE_SPLITS)
    # and a third: 48 LM tokens (96 routed rows, capacity 12), 64 MoE
    # tokens (128 routed rows, capacity 8)
    k2_case("lm_decode_b48", 32, 12, 1024, 2048, 1024,
            routing(cs.SEED + 5, 96, 32, 12), True, DECODE_SPLITS)
    k2_case("decode_b64", 128, 8, 2048, 2048, 2048,
            routing(cs.SEED + 6, 128, 128, 8), False, DECODE_SPLITS)
    for label, bits in (("decode", 4), ("decode_int8", 8)):
        k3_case(label, bits, moe_rows)
    torch.cuda.empty_cache()
    # a prefill chunk's tiles hold 16 rows; a split only adds work
    k2_case("lm_prefill", 32, 8192, 1024, 2048, 1024, prefill_rows, True,
            (1, 2))
    k4_case("lm_prefill", 32, 8192, 1024, 2048, 1024, prefill_rows, (1, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
