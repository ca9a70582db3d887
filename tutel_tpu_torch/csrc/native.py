"""The host native library (counterpart: tutel_tpu/csrc/__init__.py).

`dispatch_cpu.cpp` holds the CPU reference of the dispatch (forward,
backward of the data, backward of the gates), the location cumsum and the
LM example's batch sampler, behind a plain C interface. `lib()` compiles
it on first use with `g++ -O3 -shared -fPIC` into `build/kernels/` at the
root of the checkout, named by a hash of the source and the flags as
`build.py` names the CUDA libraries, and loads it with ctypes; nothing is
built at import. A failed build raises.

Each function takes CPU tensors or numpy arrays and returns CPU tensors.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from .build import BUILD_DIR, CSRC

SOURCE = CSRC / "dispatch_cpu.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_lock = threading.Lock()


def library_path():
    digest = hashlib.sha1("\0".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"dispatch_cpu-{digest.hexdigest()[:12]}.so"


def _build(out):
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the host library "
                           "dispatch_cpu.cpp is built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for dispatch_cpu.cpp (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)       # atomic: a concurrent build sees all or none


def lib():
    """The loaded library, built on first use."""
    global _LIB
    with _lock:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _build(path)
            _LIB = ctypes.CDLL(str(path))
        return _LIB


def available():
    """Whether the library builds and loads here."""
    try:
        lib()
        return True
    except (OSError, RuntimeError):
        return False


def _host(a, dtype):
    """A C-contiguous numpy array of `dtype` holding a's values."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"the host library takes CPU tensors, got one "
                             f"on {a.device}")
        a = a.detach().numpy()
    return np.ascontiguousarray(a, dtype=dtype)


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _i64(x):
    return ctypes.c_int64(int(x))


def dispatch_forward(gates, indices, locations, x, capacity, experts,
                     use_gates=True):
    """[E, C, M] float32: each routed token's row (times its gate) at its
    expert and location; locations past the capacity are dropped (the CPU
    reference of `ops.dispatch.fast_encode`)."""
    g, i, loc = (_host(gates, np.float32), _host(indices, np.int32),
                 _host(locations, np.int32))
    xx = _host(x, np.float32)
    k, s = i.shape
    m = xx.shape[1]
    out = np.zeros((experts * capacity, m), np.float32)
    lib().dispatch_forward_f32(
        _p(g), _p(i), _p(loc), _p(xx), _p(out), _i64(k), _i64(s), _i64(m),
        _i64(capacity), _i64(experts), ctypes.c_int(1 if use_gates else 0))
    return torch.from_numpy(out.reshape(experts, capacity, m))


def dispatch_backward_data(gates, indices, locations, dispatched,
                           num_samples, use_gates=True):
    """[S, M] float32: each token's rows gathered back from the [E, C, M]
    buffer (times its gates) and summed (the CPU reference of
    `ops.dispatch.fast_decode`)."""
    g, i, loc = (_host(gates, np.float32), _host(indices, np.int32),
                 _host(locations, np.int32))
    d = _host(dispatched, np.float32)
    k, s = i.shape
    e, c, m = d.shape
    out = np.zeros((num_samples, m), np.float32)
    lib().dispatch_backward_data_f32(
        _p(g), _p(i), _p(loc), _p(d), _p(out), _i64(k), _i64(s), _i64(m),
        _i64(c), _i64(e), ctypes.c_int(1 if use_gates else 0))
    return torch.from_numpy(out)


def dispatch_backward_gate(indices, locations, dispatched, x):
    """[K, S] float32: the dot of each token's row with its slot of the
    [E, C, M] buffer, 0 where dropped (the gates' gradient of a decode)."""
    i, loc = _host(indices, np.int32), _host(locations, np.int32)
    d, xx = _host(dispatched, np.float32), _host(x, np.float32)
    k, s = i.shape
    e, c, m = d.shape
    out = np.zeros((k, s), np.float32)
    lib().dispatch_backward_gate_f32(
        _p(out), _p(i), _p(loc), _p(d), _p(xx), _i64(k), _i64(s), _i64(m),
        _i64(c), _i64(e))
    return torch.from_numpy(out)


def cumsum_locations(indices, experts):
    """(locations [K, S] int32, counts [E] int32): each routing's place in
    its expert's queue over the k-major token stream, and the queues'
    lengths (the reference's fast_cumsum_sub_one)."""
    i = _host(indices, np.int32)
    k, s = i.shape
    locations = np.zeros((k, s), np.int32)
    counts = np.zeros((experts,), np.int32)
    lib().cumsum_locations(_p(i), _p(locations), _p(counts), _i64(k),
                           _i64(s), _i64(experts))
    return torch.from_numpy(locations), torch.from_numpy(counts)


def sample_windows(corpus, offsets, window):
    """[len(offsets), window] int32: corpus[o:o + window] for each offset
    of a flat int32 corpus."""
    corpus = _host(corpus, np.int32)
    offsets = _host(offsets, np.int64)
    if len(offsets) and (offsets.min() < 0
                         or offsets.max() + window > len(corpus)):
        raise ValueError(f"a window of {window} at the offsets "
                         f"[{offsets.min()}, {offsets.max()}] leaves the "
                         f"corpus of {len(corpus)} tokens")
    out = np.empty((len(offsets), window), np.int32)
    lib().sample_windows_i32(_p(corpus), _p(offsets), _p(out),
                             _i64(len(offsets)), _i64(window))
    return torch.from_numpy(out)
