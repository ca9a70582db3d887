"""Top-k token routing for sparse MoE: `extract_critical` and the capacity
math (counterpart: tutel_tpu/ops/routing.py:31-200).

Same decisions as the JAX module: top-k over softmax scores, slot locations
by an exclusive cumsum over the k-major (K*S, E) one-hot stream, optional
batch-prioritized order, gate normalization for k > 1, `token_mask` for
padding rows, and the padded / dropless / capped capacity helpers.

The locations come from `compute_locations`: on CUDA tensors the location
scan `csrc/route_locations.cu` (one launch up to `TILE` routings, three
above), which reads the expert ids and never builds the one-hot; on CPU
tensors its plain twin, `compute_locations_reference` (the one-hot and
its cumsum), which the tests hold against the JAX module. The two agree
bit for bit.

The top-k is a stable descending sort, so tied scores go to the lower
expert index first, as `jax.lax.top_k` orders them (`torch.topk` leaves
the order of ties open); a row of equal scores (a zero padding row: the
LM's expert-parallel padding, an idle serving slot) routes as in JAX.
"""

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from . import losses
from ..csrc import build

# the location scan's tile (kTile in csrc/route_locations.cu)
TILE = 4096
# its launch record (`Record`): stream, ids, mask, order, locations,
# counts, scratch; the ids' strides and the scratch's length; K, S, E,
# device
_RECORD = struct.Struct("<7Q3q4i")


class RoutingResult(NamedTuple):
    """Routing decision for one MoE invocation."""
    num_global_experts: int          # E
    indices: torch.Tensor            # [K, S] int64 expert id per (k, token)
    locations: torch.Tensor          # [K, S] int64 row within the expert
    gates: torch.Tensor              # [K, S] gate weight per (k, token)
    capacity: int                    # C
    dispatch_count: torch.Tensor     # [E] int32 tokens routed per expert

    @property
    def top_k(self):
        return self.indices.shape[0]


def cumsum_sub_one(mask, dim=0):
    """Inclusive cumsum minus one."""
    return torch.cumsum(mask, dim=dim) - 1


def compute_locations_reference(indices_ks, num_experts, token_mask=None,
                                importance_order=None):
    """Plain PyTorch twin of the location scan: the exclusive cumsum over
    the k-major [K*S, E] int64 one-hot (see `compute_locations`)."""
    experts = torch.arange(num_experts, device=indices_ks.device)
    # compare, not F.one_hot: on CUDA one_hot checks its range with a sync
    masks_kse = (indices_ks[:, :, None] == experts).long()
    if token_mask is not None:
        tm = token_mask.to(torch.bool)
        masks_kse = masks_kse * tm[None, :, None]
    k, s, e = masks_kse.shape
    flat = masks_kse.reshape(k * s, e)
    if importance_order is not None:
        offsets = (torch.arange(k, device=flat.device) * s)[:, None]
        perm = (importance_order[None, :].long() + offsets).reshape(-1)
        csum = torch.empty_like(flat)
        csum[perm] = cumsum_sub_one(flat[perm], dim=0)
    else:
        csum = cumsum_sub_one(flat, dim=0)
    locations = torch.sum(csum * flat, dim=1).reshape(k, s)
    counts = torch.sum(flat, dim=0).to(torch.int32)
    if token_mask is not None:
        locations = torch.where(tm[None, :], locations,
                                torch.full_like(locations, -1))
    return locations, counts


def compute_locations(indices_ks, num_experts, token_mask=None,
                      importance_order=None):
    """Per-(k, token) slot index inside its expert's buffer.

    indices_ks: [K, S] int64 expert ids (any strides); token_mask: an
    optional [S] bool, False tokens take location -1 and count nowhere;
    importance_order: an optional [S] permutation that ranks tokens within
    every k (batch-prioritized routing). Routing (k, j) sits at k*S + r of
    the stream, r = j or the rank of j in the order, and its location is
    the number of earlier routings to the same expert.
    Returns locations [K, S] int64 and per-expert totals [E] int32: on
    CUDA tensors from the location scan (`csrc/route_locations.cu`), on
    CPU tensors from `compute_locations_reference`.
    """
    if indices_ks.device.type == "cuda":
        return _scan(indices_ks, int(num_experts), token_mask,
                     importance_order)
    return compute_locations_reference(indices_ks, num_experts, token_mask,
                                       importance_order)


def scan_tiles(indices_ks):
    """The tiles the location scan runs over for these ids: ceil(K*S /
    TILE) on CUDA, 0 on the CPU (the plain twin runs)."""
    if indices_ks.device.type != "cuda":
        return 0
    return -(-indices_ks.numel() // TILE)


@functools.lru_cache(maxsize=None)
def _scratch_ints(k, s, e):
    """Scratch int32s the scan of K x S routings over e experts needs, as
    the library sizes it (`route_locations_scratch`)."""
    lib, _ = _library()
    ints = ctypes.c_longlong()
    build.check(lib, lib.route_locations_scratch(
        _RECORD.pack(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, k, s, e, 0),
        ctypes.byref(ints)), "route_locations_scratch")
    return ints.value


def _scan(indices_ks, e, token_mask, order):
    """The location scan on the ids' device (one ctypes call; one kernel
    launch up to one tile, three above, which `compute_locations.launches`
    counts)."""
    k, s = indices_ks.shape
    dev = indices_ks.device
    if indices_ks.dtype != torch.int64:
        raise ValueError(f"the location scan takes int64 ids, not "
                         f"{indices_ks.dtype}")
    if k * s >= 2 ** 31:
        raise ValueError(f"the location scan takes fewer than 2**31 "
                         f"routings, got {k} x {s}")
    locations = torch.empty((k, s), dtype=torch.int64, device=dev)
    counts = torch.empty(e, dtype=torch.int32, device=dev)
    if k * s == 0:
        return locations, counts.zero_()
    for name, t in (("token_mask", token_mask), ("importance_order", order)):
        if t is not None and (tuple(t.shape) != (s,) or t.device != dev):
            raise ValueError(f"{name} must be [{s}] on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    mask = None if token_mask is None else \
        token_mask.to(torch.bool).contiguous()
    order = None if order is None else order.to(torch.int64).contiguous()
    need = _scratch_ints(k, s, e)
    scratch = torch.empty(need, dtype=torch.int32, device=dev) \
        if need else None
    index = dev.index or 0
    lib, launch = _library()
    rc = launch(_RECORD.pack(
        torch._C._cuda_getCurrentRawStream(index), indices_ks.data_ptr(),
        0 if mask is None else mask.data_ptr(),
        0 if order is None else order.data_ptr(), locations.data_ptr(),
        counts.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        indices_ks.stride(0), indices_ks.stride(1), need, k, s, e, index))
    if rc:
        build.check(lib, rc, "route_locations")
    compute_locations.launches += 1 if k * s <= TILE else 3
    return locations, counts


_LOADED = []


def _library():
    """(The location scan's library, its C entry), loaded once."""
    if not _LOADED:
        lib = build.load("route_locations")
        _LOADED.append((lib, lib.route_locations_launch))
    return _LOADED[0]


# the scan's kernel launches (not its calls) in this process
compute_locations.launches = 0


def align_capacity(capacity, alignment):
    """Round capacity up to a multiple of `alignment`."""
    remainder = capacity % alignment
    if remainder > 0:
        capacity = capacity + alignment - remainder
    return int(capacity)


def compute_static_capacity(num_samples, num_global_experts, top_k,
                            capacity_factor, alignment=1):
    """Padded-mode capacity (capacity_factor > 0), from Python numbers."""
    if not capacity_factor > 0:
        raise ValueError("static capacity needs capacity_factor > 0")
    samples_per_expert = (num_samples + num_global_experts - 1) // num_global_experts
    capacity = top_k * int(capacity_factor * samples_per_expert)
    return align_capacity(capacity, alignment)


def capped_capacity_limit(num_samples, num_global_experts, top_k,
                          capacity_factor):
    """Upper bound for the capped-dropless mode (capacity_factor < 0)."""
    samples_per_expert = (num_samples + num_global_experts - 1) // num_global_experts
    return top_k * int(-capacity_factor * samples_per_expert)


def extract_critical(scores, top_k, capacity, loss_fn=losses.gshard_loss,
                     batch_prioritized_routing=False, normalize_gate=True,
                     token_mask=None):
    """Route tokens to experts with capacity C.

    scores: [S, E] softmax gate scores; token_mask: optional [S] bool,
    False rows are padding that take no slot and get location -1.
    Returns (RoutingResult, l_aux). Tokens whose location >= capacity are
    dropped at dispatch time.
    """
    num_samples, num_global_experts = scores.shape
    top_k = min(int(top_k), num_global_experts)
    if int(capacity) < 1:
        raise ValueError(
            f"capacity must be >= 1, got {capacity}; raise capacity_factor "
            "or alignment (a zero-size expert buffer cannot be dispatched)")

    topk_gates, topk_indices = torch.sort(scores, dim=1, descending=True,
                                          stable=True)
    topk_gates, topk_indices = topk_gates[:, :top_k], topk_indices[:, :top_k]
    indices_ks = topk_indices.t()                                  # [K, S]
    gates_ks = topk_gates.t()
    tm = None
    if token_mask is not None:
        tm = token_mask.to(torch.bool)
        gates_ks = gates_ks * tm.to(gates_ks.dtype)[None, :]

    l_aux = loss_fn(scores, topk_indices) if loss_fn is not None else None

    order = None
    if batch_prioritized_routing:
        importance = -torch.max(scores, dim=1).values
        order = torch.argsort(importance, stable=True)
    locations_ks, counts = compute_locations(indices_ks, num_global_experts,
                                             tm, order)

    if top_k > 1 and normalize_gate:
        denom = torch.clamp(torch.sum(gates_ks, dim=0),
                            min=torch.finfo(gates_ks.dtype).eps)
        gates_ks = gates_ks / denom

    result = RoutingResult(
        num_global_experts=num_global_experts,
        indices=indices_ks,
        locations=locations_ks,
        gates=gates_ks,
        capacity=int(capacity),
        dispatch_count=counts,
    )
    return result, l_aux


def required_capacity(dispatch_count):
    """Tensor scalar: the most tokens any expert received (the dropless
    capacity). No host sync; the caller decides when to read it."""
    return torch.max(dispatch_count)
