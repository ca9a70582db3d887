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
    # x, w, scales, counts, out; E, C, K, N, bits, blocks, dtype, device;
    # stream
    "grouped_gemm_quant": ("grouped_gemm_quant_launch",
                           [_P] * 5 + [_I] * 8 + [_P]),
    # x, wstream, sb, counts, out; E, C, K, kr, bw, t1, t2, n, bits, act,
    # dtype, tile_rows, device; stream
    "fused_ffn_quant": ("fused_ffn_quant_launch",
                        [_P] * 5 + [_I] * 13 + [_P]),
    # xq, sx, wstream, sb, counts, out; the ints of fused_ffn_quant; stream
    "fused_ffn_w8a8": ("fused_ffn_w8a8_launch", [_P] * 6 + [_I] * 13 + [_P]),
    # the arguments of fused_ffn_quant
    "fused_swiglu_quant": ("fused_swiglu_quant_launch",
                           [_P] * 5 + [_I] * 13 + [_P]),
    # xq, sx, w, scales, counts, out; E, C, K, N, bits, dtype, device; stream
    "grouped_gemm_w8a8": ("grouped_gemm_w8a8_launch",
                          [_P] * 6 + [_I] * 7 + [_P]),
    # descriptor table (host), n, pos, B, device, stream
    "kv_write": ("kv_write_launch", [_P, _I, _P, _I, _I, _P]),
    # q, k, v, ks, vs, pos, k_new, v_new, k_new_scale, v_new_scale, out;
    # B, NH, KVH, HD, T, W, mode, dtype, device; stream
    "decode_attn": ("decode_attn_launch", [_P] * 11 + [_I] * 9 + [_P]),
    # q, k, v, ks, vs, out; B, TQ, NH, KVH, HD, T, W, start, mode, dtype,
    # device; stream
    "prefill_attn": ("prefill_attn_launch", [_P] * 6 + [_I] * 11 + [_P]),
}
SOURCES = tuple(SIGNATURES)
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


def _start(name):
    """Start nvcc for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


def build_all(names=SOURCES):
    """Compile every named source that is not built yet, all in parallel."""
    started = {name: _start(name) for name in names}
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


def load(name):
    """The ctypes library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            entry, argtypes = SIGNATURES[name]
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
            lib.tt_error_string.argtypes = [ctypes.c_int]
            lib.tt_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib, rc, what):
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.tt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
