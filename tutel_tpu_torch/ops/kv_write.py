"""One decode step's KV-cache writes in one kernel
(counterpart: tutel_tpu/ops/kv_write_pallas.py:146-214).

    row_caches[i][b, pos[b], :] = rows[i][b]     ([B, T, D_i] caches)
    col_caches[j][b, :, pos[b]] = cols[j][b]     ([B, H_j, T] caches)

`write_step` updates every cache in place and returns them. For CUDA
tensors it is one launch of kernel K8 (`csrc/kv_write.cu`) for all
tensors; for CPU tensors it runs the plain twin, `write_step_reference`
(indexed assignment). A row whose pos lies outside [0, T) is not written,
as an XLA scatter drops an out-of-range update.

`prepare(row_caches, col_caches)` is the same write for one set of
caches, prepared once: it checks the caches and packs their side of the
kernel's launch record, and each call then checks the fresh tensors
against what the caches expect and packs only their addresses, pos and
the stream into one ctypes call (the decode step keeps one per cache,
`TransformerMoE._flush_kv_writes`).

The TPU kernel's 8-row and 128-lane read-modify-write windows and its
`step_vmem_bytes` budget were workarounds for Mosaic and are not ported:
on the GPU the write is a direct scatter.
"""

import struct
import weakref

import torch

from ..csrc import build

MAX_TENSORS = 64           # descriptors the kernel takes in one launch
# the launch record (`Head`, `CacheDesc` in csrc/kv_write.cu): stream, pos,
# n, B, device, padding; then per cache its address, kind (0 row, 1
# column), itemsize, T and width; then the n fresh tensors' addresses
_HEAD = struct.Struct("<QQiiii")
_CACHE = struct.Struct("<Qiiii")


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
    row_caches, rows, col_caches, cols, _ = _pairs(row_caches, rows,
                                                   col_caches, cols)
    return prepare(row_caches, col_caches)(rows, pos, cols)


def _check_kernel_tensor(name, i, t, device):
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"K8 needs contiguous tensors on {device}; {name} "
                         f"{i} is {t.device}, contiguous={t.is_contiguous()}")


class StepWriter:
    """`write_step` for one set of caches (made by `prepare`, which checks
    their shapes): call it as writer(rows, pos, cols) with the fresh
    tensors in the order of the caches. It holds the caches weakly."""

    def __init__(self, row_caches, col_caches):
        caches = list(row_caches) + list(col_caches)
        self.n_rows = len(row_caches)
        self._refs = [weakref.ref(c) for c in caches]
        first = caches[0]
        self.device = first.device
        self.batch = first.shape[0]
        kinds = [0] * self.n_rows + [1] * len(col_caches)
        # what each fresh tensor must be: [B, D] of a row cache, [B, H] of
        # a column cache, of the cache's type
        self._expect = [((self.batch, c.shape[2] if k == 0 else c.shape[1]),
                         c.dtype) for c, k in zip(caches, kinds)]
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"write_step runs on cpu or cuda, not "
                             f"{self.device}")
        n = len(caches)
        if self.device.type == "cuda":
            if n > MAX_TENSORS:
                raise ValueError(f"K8 takes at most {MAX_TENSORS} tensors, "
                                 f"got {n}")
            for i, c in enumerate(caches):
                _check_kernel_tensor("cache", i, c, self.device)
                if c.element_size() not in (1, 2, 4):
                    raise ValueError(f"K8 copies 1, 2 or 4-byte elements, "
                                     f"not {c.dtype}")
        descs = []
        for c, kind in zip(caches, kinds):
            t_len, width = (c.shape[1], c.shape[2]) if kind == 0 else \
                (c.shape[2], c.shape[1])
            descs.append(_CACHE.pack(c.data_ptr(), kind, c.element_size(),
                                     t_len, width))
        self._descs = b"".join(descs)
        self._index = self.device.index or 0
        self._record = struct.Struct(
            f"{_HEAD.format}{len(self._descs)}s{n}Q")

    def caches(self):
        """The caches (None for one that is gone)."""
        return [r() for r in self._refs]

    def matches(self, row_caches, col_caches):
        """Whether this writer was prepared for exactly these caches."""
        return len(row_caches) == self.n_rows and \
            len(row_caches) + len(col_caches) == len(self._refs) and all(
                r() is c for r, c in zip(self._refs,
                                         (*row_caches, *col_caches)))

    def __call__(self, rows, pos, cols=()):
        """Write rows[i] into row cache i and cols[j] into column cache j
        at positions pos [B]; returns (row_caches, col_caches)."""
        caches = self.caches()
        if any(c is None for c in caches):
            raise ValueError("a cache of this writer is gone; prepare again")
        srcs = (*rows, *cols)
        if self.device.type == "cpu":            # the plain twin
            return write_step_reference(caches[:self.n_rows], rows, pos,
                                        caches[self.n_rows:], cols)
        dev = self.device
        ok = len(rows) == self.n_rows and len(srcs) == len(caches)
        if ok:
            for src, (shape, dtype) in zip(srcs, self._expect):
                if src.shape != shape or src.dtype != dtype or \
                        src.device != dev or not src.is_contiguous():
                    ok = False
                    break
        if not ok:                  # the refusal that says what is wrong
            _pairs(caches[:self.n_rows], rows, caches[self.n_rows:], cols)
            for i, src in enumerate(srcs):
                _check_kernel_tensor("fresh", i, src, dev)
            raise ValueError("write_step: the fresh tensors do not match "
                             "the caches")
        if tuple(pos.shape) != (self.batch,):
            raise ValueError(f"pos must be [{self.batch}], got "
                             f"{tuple(pos.shape)}")
        pos32 = pos.to(device=dev, dtype=torch.int32).contiguous()
        lib, launch = _library()
        rc = launch(self.pack(
            srcs, pos32, torch._C._cuda_getCurrentRawStream(self._index)))
        if rc:
            build.check(lib, rc, "kv_write")
        write_step.launches += 1
        return caches[:self.n_rows], caches[self.n_rows:]

    def pack(self, srcs, pos32, stream):
        """The launch record of one step (`Head`, then the caches'
        `CacheDesc`s, then the fresh tensors' addresses; csrc/kv_write.cu)
        as bytes."""
        return self._record.pack(stream, pos32.data_ptr(), len(srcs),
                                 self.batch, self._index, 0, self._descs,
                                 *(t.data_ptr() for t in srcs))


def prepare(row_caches, col_caches=()):
    """A `StepWriter` for these caches ([B, T, D] row caches, [B, H, T]
    column caches): `write_step` with the caches' checks and their side of
    the launch record done once. CPU caches write through the plain twin."""
    row_caches, col_caches = list(row_caches), list(col_caches)
    if not row_caches and not col_caches:
        raise ValueError("write_step needs at least one cache")
    b = (row_caches or col_caches)[0].shape[0]
    for c in row_caches + col_caches:
        if c.ndim != 3 or c.shape[0] != b:
            raise ValueError(f"cache {tuple(c.shape)} is not [{b}, ., .]")
    return StepWriter(row_caches, col_caches)


_LOADED = []


def _library():
    """(K8's library, its C entry), loaded once."""
    if not _LOADED:
        lib = build.load("kv_write")
        _LOADED.append((lib, lib.kv_write_launch))
    return _LOADED[0]


write_step.launches = 0
