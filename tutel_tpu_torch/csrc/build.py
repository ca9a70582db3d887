"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
by `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC` into `build/kernels/` at the root of the checkout, then loaded
with `ctypes`. Sources include no PyTorch header, so a build takes
seconds; the library name carries a hash of the source and of the shared
headers (`csrc/*.cuh`), so an edited source is rebuilt and a stale
library is never loaded.

`build_all()` starts one nvcc per source at once and waits for all of
them; `load(name)` builds one if needed and returns the loaded library.

A second way in takes a source given as text at run time (`jit.py`'s
injected and lifted kernels): `load_source(text, ...)` compiles it with
the same flags into `build/kernels/jit-<hash>.so`, the hash covering the
text and the flags, and loads it once per process; `build_all(texts=...)`
builds such texts in parallel with the fixed sources.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
_P, _I = ctypes.c_void_p, ctypes.c_int
# source -> (C entry point, its argument types); the sources define them
SIGNATURES = {
    # x, w, scales, counts, out; E, C, K, N, bits, blocks, dtype,
    # tile_rows, groups, device; stream
    "grouped_gemm_quant": ("grouped_gemm_quant_launch",
                           [_P] * 5 + [_I] * 10 + [_P]),
    # x, wstream, sb, counts, out, ws; E, C, K, kr, bw, t1, t2, n, bits,
    # act, dtype, tile_rows, split, device; stream
    "fused_ffn_quant": ("fused_ffn_quant_launch",
                        [_P] * 6 + [_I] * 14 + [_P]),
    # xq, sx, wstream, sb, counts, out; E, C, K, kr, bw, t1, t2, n, bits,
    # act, dtype, tile_rows, device; stream
    "fused_ffn_w8a8": ("fused_ffn_w8a8_launch", [_P] * 6 + [_I] * 13 + [_P]),
    # the arguments of fused_ffn_quant
    "fused_swiglu_quant": ("fused_swiglu_quant_launch",
                           [_P] * 6 + [_I] * 14 + [_P]),
    # x, w, scales, counts, out; E, C, K, N, bits, dtype, tile_rows,
    # groups, strips, device; stream
    "grouped_gemm_w8a8": ("grouped_gemm_w8a8_launch",
                          [_P] * 5 + [_I] * 10 + [_P]),
    # one launch record (ops/kv_write.py, ops/decode_attn.py _RECORD)
    "kv_write": ("kv_write_launch", [ctypes.c_char_p]),
    "decode_attn": ("decode_attn_launch", [ctypes.c_char_p]),
    # q, k, v, ks, vs, out; B, TQ, NH, KVH, HD, T, W, start, mode, dtype,
    # device; stream
    "prefill_attn": ("prefill_attn_launch", [_P] * 6 + [_I] * 11 + [_P]),
    # one launch record (ops/routing.py _RECORD)
    "route_locations": ("route_locations_launch", [ctypes.c_char_p]),
}
SOURCES = tuple(SIGNATURES)
# entry points a source has besides its launch: record, pointer to the
# answer
QUERIES = {"decode_attn": {"decode_attn_occupancy": [ctypes.c_char_p, _P]},
           "route_locations": {"route_locations_scratch":
                               [ctypes.c_char_p, _P]}}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded = {}
_lock = threading.Lock()


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels are "
                           "built on the machine with the GPU")
    return path


def library_path(name):
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared by the sources
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def source_name(text):
    """The library name of a source given as text: jit-<hash of the flags
    and the text>."""
    digest = hashlib.sha1("\0".join((*NVCC_FLAGS, text)).encode())
    return "jit-" + digest.hexdigest()[:12]


def _start(src, out):
    """Start nvcc on the source file `src` (a path, or the text of a source
    given at run time, written beside `out` as a .cu file); returns
    (process, tmp path, final path) or None when `out` is already built."""
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if isinstance(src, str):
        part = out.with_suffix(f".{os.getpid()}.part")
        part.write_text(src)
        os.replace(part, out.with_suffix(".cu"))
        src = out.with_suffix(".cu")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name, started):
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)       # atomic: a concurrent build sees all or none


def build_all(names=SOURCES, texts=()):
    """Compile every named source and every source text that is not built
    yet, all in parallel."""
    started = {name: _start(CSRC / f"{name}.cu", library_path(name))
               for name in names}
    for text in texts:
        name = source_name(text)
        started[name] = _start(text, BUILD_DIR / f"{name}.so")
    errors = []
    for name, s in started.items():
        if s is None:
            continue
        try:
            _finish(name, s)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def _open(path, signatures):
    """Load a library; `signatures` maps each C entry point (returning an
    int) to its ctypes argument types."""
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in signatures.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    lib.tt_error_string.argtypes = [ctypes.c_int]
    lib.tt_error_string.restype = ctypes.c_char_p
    return lib


def load(name):
    """The ctypes library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all((name,))
            entry, argtypes = SIGNATURES[name]
            lib = _loaded[name] = _open(library_path(name), {
                entry: argtypes, **QUERIES.get(name, {})})
        return lib


def load_source(text, signatures):
    """The ctypes library compiled from the CUDA source `text`, built on
    first use and loaded once per process; `signatures` maps each C entry
    point of the text (returning an int) to its ctypes argument types. The
    text must define `tt_error_string`, as every source in csrc/ does."""
    name = source_name(text)
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all((), (text,))
            lib = _loaded[name] = _open(BUILD_DIR / f"{name}.so",
                                        signatures)
        return lib


def check(lib, rc, what):
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.tt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
