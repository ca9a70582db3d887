#!/usr/bin/env python3
"""Read the decode attention kernel K6 (`decode_attn`) for each window
split S, and the KV write K8 (`write_step`), on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 tools/decode_attn_sweep.py

It builds only `csrc/decode_attn.cu` and `csrc/kv_write.cu` (and K6 once
more with -Xptxas -v, for each kernel instance's registers and spills),
then prints:

  * `sass`: for each K6 instance of the bfloat16 LM path (MQ 4, HD 128,
    every cache), the convergence instructions (WARPSYNC, ENDCOLLECTIVE)
    of the whole kernel, which must be 0, and the warp instructions of a
    tile loop per cache position: the static instructions of the loop
    that issues the tile's cp.async (its body is unrolled; an inner loop,
    such as the INT4 copy loop, is counted once and listed) over the
    tile's 32 positions, and the loop's instructions by opcode;
  * K6 at `chip_smoke.py`'s check shape (64 rows, 8 heads, 2 KV groups,
    HD 128, window 2048, fresh rows, bfloat16 queries) over the INT8,
    bfloat16 and INT4 caches, and over INT8 at 8 rows: for each S, the
    profiled device ms per call (every kernel of the call: the main
    kernel and, for S > 1, the merge), the event-timed ms, the host
    microseconds per call (1,000 calls, no sync), the share of the bytes
    bound, beside the S that `decode_attn.split_plan` picks; every reading
    is held against the plain twin and two calls must be bitwise equal;
  * K8 at one LM decode step (16 tensors): `write_step` and a prepared
    writer, each exact against the twin, with device ms, event ms and
    host microseconds.

One JSON line per reading on standard output; the first line is the
card's name and power limit from nvidia-smi. Exits non-zero without a
card or when a reading disagrees with its twin.

    python3 tools/decode_attn_sweep.py --default

reads each shape once with the wrapper's own choices, pins nothing,
skips ptxas, the SASS and the prepared writer, so the same readings can
be taken on a checkout from before the split (copy this file there).
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tutel_tpu_torch.csrc import build  # noqa: E402
from tutel_tpu_torch.ops import decode_attn as da  # noqa: E402
from tutel_tpu_torch.ops import kv_write  # noqa: E402

SPLITS = (1, 2, 4, 8, 16)
TILE_POSITIONS = 32            # kTile in csrc/decode_attn.cu


def emit(record):
    print(json.dumps(record), flush=True)


def ptxas(name):
    """Registers and spill bytes of each kernel instance of csrc/<name>.cu,
    from nvcc -Xptxas -v."""
    out = build.BUILD_DIR / f"{name}-ptxas.{os.getpid()}.so"
    log = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out), str(build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, check=True).stdout
    if out.exists():
        out.unlink()
    report, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = instance(m.group(1))
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
    """`decode_attn_kernel<dtype, MODE, HD, MQ>` (or the merge's
    `<dtype, HD, MQ>`) from a mangled name; checkouts before the head dims
    16 and 32 name DPL = HD / 32 in HD's place."""
    kernel = re.search(r"(decode_attn_(?:kernel|merge))", mangled).group(1)
    dtype = "bf16" if "bfloat16" in mangled else "f32"
    args = re.findall(r"Li(\d+)E", mangled)
    return f"{kernel}<{', '.join([dtype] + args)}>"


def sass_report():
    """The convergence instructions of every K6 instance, and the tile
    loop's warp instructions per position of the LM path's instances."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = build.library_path("decode_attn")
    sass = subprocess.run([tool, "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        head = part.split(None, 1)[0]
        name = instance(head)
        code = []                      # (address, opcode)
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)([^;]*);", part):
            code.append((int(m.group(1), 16), m.group(3), m.group(4)))
        conv = sum(op.startswith(("WARPSYNC", "ENDCOLLECTIVE"))
                   for _, op, _ in code)
        rec = {"convergence_instructions": conv}
        if name.startswith("decode_attn_kernel<bf16") and \
                name.endswith((", 128, 4>", ", 4, 4>")):     # HD 128, MQ 4
            loops = [(int(re.search(r"0x([0-9a-f]+)", args).group(1), 16),
                      addr) for addr, op, args in code
                     if op.startswith("BRA") and re.search(r"0x[0-9a-f]+",
                                                          args)
                     and int(re.search(r"0x([0-9a-f]+)", args).group(1),
                             16) < addr]
            tile = [(lo, hi) for lo, hi in loops if any(
                lo <= a <= hi and op.startswith("LDGSTS")
                for a, op, _ in code)]
            if tile:
                lo, hi = max(tile, key=lambda r: r[1] - r[0])
                inner = [(a, b) for a, b in loops
                         if lo <= a and b <= hi and (a, b) != (lo, hi)]
                n_outer = sum(lo <= a <= hi for a, _, _ in code)
                n_inner = [sum(a <= x <= b for x, _, _ in code)
                           for a, b in inner]
                ops = {}
                for a, op, _ in code:
                    if lo <= a <= hi:
                        base = op.split(".")[0]
                        ops[base] = ops.get(base, 0) + 1
                rec.update({
                    "tile_loop_instructions": n_outer,
                    "inner_loop_instructions": n_inner,
                    "warp_instructions_per_position":
                        n_outer / TILE_POSITIONS,
                    "by_opcode": dict(sorted(ops.items(),
                                             key=lambda kv: -kv[1])[:16])})
        out[name] = rec
    bad = {k: v for k, v in out.items() if v["convergence_instructions"]}
    if bad:
        raise RuntimeError(f"K6 instances with convergence instructions: "
                           f"{sorted(bad)}")
    return out


def attn_inputs(mode, b):
    """chip_smoke.py's K6 check: fresh rows, every row at pos W - 1."""
    nh, kvh, hd, t = (cs.ATT[k] for k in ("nh", "kvh", "hd", "t"))
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    q = torch.randn(b, nh, hd, generator=g, device="cuda").to(torch.bfloat16)
    k, ks, _ = cs.kv_cache(g, b, t, kvh, hd, mode)
    v, vs, _ = cs.kv_cache(g, b, t, kvh, hd, mode)
    kn, kns, _ = cs.kv_cache(g, b, 1, kvh, hd, mode)
    vn, vns, _ = cs.kv_cache(g, b, 1, kvh, hd, mode)
    pos = torch.full((b,), t - 1, dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, attn_len=t,
              kv_bits=4 if mode == "int4" else 8, k_new=kn[:, 0].contiguous(),
              v_new=vn[:, 0].contiguous(),
              k_new_scale=None if kns is None else kns[..., 0].contiguous(),
              v_new_scale=None if vns is None else vns[..., 0].contiguous())
    per_pos = 2 * kvh * hd * cs.BYTES_PER_VALUE[mode] + (
        0 if mode == "bfloat16" else 2 * kvh * 4)
    fresh = 2 * b * (kvh * hd * cs.BYTES_PER_VALUE[mode]
                     + (0 if mode == "bfloat16" else 4 * kvh))
    moved = b * (t - 1) * per_pos + fresh + 2 * q.numel() * 2 + 4 * b
    return q, k, v, pos, kw, moved


def read_attn(mode, b, bandwidth, split, planned):
    q, k, v, pos, kw, moved = attn_inputs(mode, b)
    if split is not None:
        kw["split"] = split

    def call():
        return da.decode_attn(q, k, v, pos, **kw)

    got, again = call(), call()
    launched = getattr(da.decode_attn, "last_split", split)
    torch.cuda.synchronize()
    ref = da.decode_attn_reference(
        q, k, v, pos, **{n: x for n, x in kw.items() if n != "split"})
    abs_err, err = cs.rel_err(got, ref)
    if not err <= cs.BF16_TOL or not torch.equal(got, again):
        raise RuntimeError(f"K6 {mode} B={b} S={split}: error {err}, "
                           f"bitwise repeat {torch.equal(got, again)}")
    dev = cs.device_ms(call, None)
    bound_ms = 1e3 * moved / bandwidth
    return {"name": "decode_attn", "cache": mode, "B": b,
            "split": launched if launched is not None else planned,
            "planned": planned, "device_ms": dev, "ms": cs.median_ms(call),
            "host_us": cs.host_us(call),
            # fewer calls than the launch queue holds (a split call
            # launches two kernels): the host's time, not the device's pace
            "host_us_300": cs.host_us(call, calls=300), "bound_ms": bound_ms,
            "bound_share": bound_ms / dev, "max_abs_err": abs_err,
            "max_rel_err": err, "bitwise_repeat": True}


def host_stages(mode, b):
    """Host microseconds per K6 call (1,000 calls, no sync) split in two:
    the wrapper's Python with the C entry replaced by a no-op, and the C
    entry alone (the record's checks, the launches) on one packed record."""
    q, k, v, pos, kw, _ = attn_inputs(mode, b)
    lib, launch = da._library()
    index = q.get_device()
    s = planned_split(mode, b)
    out = torch.empty_like(q)
    ws = torch.empty(b * 2 * s * 4 * 130, dtype=torch.float32,
                     device="cuda") if s > 1 else None
    kvh = 2
    rec = da.pack_record(q, k, v, pos, out, ws,
                         torch._C._cuda_getCurrentRawStream(index), index,
                         kvh=kvh, window=k.shape[1],
                         mode={"bfloat16": "float"}.get(mode, mode),
                         split=s, **{n: x for n, x in kw.items()
                                     if n not in ("attn_len", "kv_bits")})
    full = cs.host_us(lambda: da.decode_attn(q, k, v, pos, **kw))
    c_entry = cs.host_us(lambda: launch(rec))
    da._LOADED[:] = [(lib, lambda record: 0)]
    try:
        python = cs.host_us(lambda: da.decode_attn(q, k, v, pos, **kw))
    finally:
        da._LOADED[:] = [(lib, launch)]
    return {"name": "decode_attn_host_stages", "cache": mode, "B": b,
            "split": s, "host_us": full, "python_us": python,
            "c_entry_us": c_entry}


def planned_split(mode, b):
    """The S the wrapper picks, or None on a checkout without the plan."""
    if not hasattr(da, "split_for"):
        return None
    nh, kvh, hd, t = (cs.ATT[k] for k in ("nh", "kvh", "hd", "t"))
    return da.split_for(b, kvh, t, hd, nh // kvh,
                        {"bfloat16": "float"}.get(mode, mode),
                        torch.bfloat16, 0)


def read_kv_write(prepared):
    """K8 at one LM decode step, through write_step or a prepared writer."""
    b, kvh, hd, t = (cs.ATT[k] for k in ("b", "kvh", "hd", "t"))
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    rows_c = [torch.randint(-127, 128, (b, t, kvh * hd), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(8)]
    cols_c = [torch.rand(b, kvh, t, generator=g, device="cuda")
              for _ in range(8)]
    rows = [torch.randint(-127, 128, (b, kvh * hd), generator=g,
                          device="cuda", dtype=torch.int8) for _ in range(8)]
    cols = [torch.rand(b, kvh, generator=g, device="cuda") for _ in range(8)]
    pos = torch.randint(0, t, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    want_r = [c.clone() for c in rows_c]
    want_c = [c.clone() for c in cols_c]
    kv_write.write_step_reference(want_r, rows, pos, want_c, cols)
    if prepared:
        writer = kv_write.prepare(rows_c, cols_c)

        def call():
            writer(rows, pos, cols)
    else:
        def call():
            kv_write.write_step(rows_c, rows, pos, col_caches=cols_c,
                                cols=cols)
    call()
    torch.cuda.synchronize()
    if not all(torch.equal(a, w) for a, w in zip(rows_c + cols_c,
                                                 want_r + want_c)):
        raise RuntimeError("K8 is not exact")
    return {"name": "kv_write", "path": "prepared" if prepared
            else "write_step", "tensors": 16, "B": b,
            "device_ms": cs.device_ms(call, None), "ms": cs.median_ms(call),
            "host_us": cs.host_us(call)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--default", action="store_true",
                        help="the wrapper's own S only; no ptxas, SASS or "
                             "prepared writer")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_attn_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"card": smi, "default": args.default})
    bandwidth = cs.hbm_bytes_per_s(smi)
    build.build_all(("decode_attn", "kv_write"))
    if not args.default:
        emit({"phase": "ptxas", "kernels": ptxas("decode_attn")})
        emit({"phase": "sass", "kernels": sass_report()})
    for mode, b in (("int8", 64), ("bfloat16", 64), ("int4", 64),
                    ("int8", 8)):
        planned = planned_split(mode, b)
        splits = [None] if args.default else [None] + [
            s for s in SPLITS if s != planned]
        for split in splits:
            emit(read_attn(mode, b, bandwidth, split, planned))
        if not args.default and mode == "int8":
            emit(host_stages(mode, b))
        torch.cuda.empty_cache()
    for prepared in (False,) if args.default else (False, True):
        emit(read_kv_write(prepared))
    return 0


if __name__ == "__main__":
    sys.exit(main())
