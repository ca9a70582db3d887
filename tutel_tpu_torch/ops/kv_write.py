"""One decode step's KV-cache writes in one kernel
(counterpart: tutel_tpu/ops/kv_write_pallas.py:146-214).

    row_caches[i][b, pos[b], :] = rows[i][b]     ([B, T, D_i] caches)
    col_caches[j][b, :, pos[b]] = cols[j][b]     ([B, H_j, T] caches)

`write_step` updates every cache in place and returns them. For CUDA
tensors it is one launch of kernel K8 (`csrc/kv_write.cu`) for all
tensors; for CPU tensors it runs the plain twin, `write_step_reference`
(indexed assignment). A row whose pos lies outside [0, T) is not written,
as an XLA scatter drops an out-of-range update.

The TPU kernel's 8-row and 128-lane read-modify-write windows and its
`step_vmem_bytes` budget were workarounds for Mosaic and are not ported:
on the GPU the write is a direct scatter.
"""

import numpy as np
import torch

from ..csrc import build

MAX_TENSORS = 64           # descriptors the kernel takes in one launch


def _pairs(row_caches, rows, col_caches, cols):
    row_caches, rows = list(row_caches), list(rows)
    col_caches, cols = list(col_caches), list(cols)
    if len(row_caches) != len(rows) or len(col_caches) != len(cols):
        raise ValueError("write_step needs one fresh tensor per cache")
    if not row_caches and not col_caches:
        raise ValueError("write_step needs at least one cache")
    b = (row_caches or col_caches)[0].shape[0]
    for c, r in zip(row_caches, rows):
        if c.ndim != 3 or c.shape[0] != b or tuple(r.shape) != (b, c.shape[2]) \
                or r.dtype != c.dtype:
            raise ValueError(f"row cache {tuple(c.shape)} {c.dtype} and row "
                             f"{tuple(r.shape)} {r.dtype} do not match")
    for c, s in zip(col_caches, cols):
        if c.ndim != 3 or c.shape[0] != b or tuple(s.shape) != (b, c.shape[1]) \
                or s.dtype != c.dtype:
            raise ValueError(f"col cache {tuple(c.shape)} {c.dtype} and col "
                             f"{tuple(s.shape)} {s.dtype} do not match")
    return row_caches, rows, col_caches, cols, b


def write_step_reference(row_caches, rows, pos, col_caches=(), cols=()):
    """Plain PyTorch twin of K8: indexed assignment, in place."""
    row_caches, rows, col_caches, cols, b = _pairs(row_caches, rows,
                                                   col_caches, cols)
    pos = pos.to(device=(row_caches or col_caches)[0].device,
                 dtype=torch.long)
    ids = torch.arange(b, device=pos.device)
    for c, r in zip(row_caches, rows):
        ok = (pos >= 0) & (pos < c.shape[1])
        c[ids[ok], pos[ok]] = r[ok]
    for c, s in zip(col_caches, cols):
        ok = (pos >= 0) & (pos < c.shape[2])
        c[ids[ok], :, pos[ok]] = s[ok]
    return row_caches, col_caches


def write_step(row_caches, rows, pos, col_caches=(), cols=()):
    """Write one row per batch row into every cache, in place (see the
    module doc). pos: [B] int. Returns (row_caches, col_caches)."""
    row_caches, rows, col_caches, cols, b = _pairs(row_caches, rows,
                                                   col_caches, cols)
    first = (row_caches or col_caches)[0]
    if first.device.type == "cpu":
        return write_step_reference(row_caches, rows, pos, col_caches, cols)
    if first.device.type != "cuda":
        raise ValueError(f"write_step runs on cpu or cuda, not {first.device}")
    n = len(row_caches) + len(col_caches)
    if n > MAX_TENSORS:
        raise ValueError(f"K8 takes at most {MAX_TENSORS} tensors, got {n}")
    desc = np.zeros((n, 6), np.int64)
    pairs = [(0, c, r) for c, r in zip(row_caches, rows)] + \
        [(1, c, s) for c, s in zip(col_caches, cols)]
    for i, (kind, c, src) in enumerate(pairs):
        for name, t in (("cache", c), ("fresh", src)):
            if t.device != first.device or not t.is_contiguous():
                raise ValueError(f"K8 needs contiguous tensors on "
                                 f"{first.device}; {name} {i} is "
                                 f"{t.device}, contiguous="
                                 f"{t.is_contiguous()}")
        if c.element_size() not in (1, 2, 4):
            raise ValueError(f"K8 copies 1, 2 or 4-byte elements, not "
                             f"{c.dtype}")
        t_len, width = (c.shape[1], c.shape[2]) if kind == 0 else \
            (c.shape[2], c.shape[1])
        desc[i] = (c.data_ptr(), src.data_ptr(), kind, c.element_size(),
                   t_len, width)
    pos32 = pos.to(device=first.device, dtype=torch.int32).contiguous()
    if tuple(pos32.shape) != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    lib = build.load("kv_write")
    stream = torch.cuda.current_stream(first.device).cuda_stream
    rc = lib.kv_write_launch(desc.ctypes.data, n, pos32.data_ptr(), b,
                             first.device.index or 0, stream)
    build.check(lib, rc, "kv_write")
    write_step.launches += 1
    return row_caches, col_caches


write_step.launches = 0
