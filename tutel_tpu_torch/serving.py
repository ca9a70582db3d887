"""Continuous-batching MoE decode engine (counterpart: tutel_tpu/serving.py:39-523).

  * a slot buffer [max_batch, model_dim] of active sequences on the
    layer's device; requests join and leave between chunks. Admissions are
    staged on the host and written in one batched copy.
  * each chunk packs the active slots to the front, runs up to `chunk`
    decode steps of the layer with the tail masked by `valid_tokens`, and
    writes the states back.
  * dropless capacity is speculative by default: a chunk runs at a small
    multiple of the average per-expert load and carries a device-side
    needed-capacity probe (`MOELayer.count_needed_traceable`); a chunk
    whose routing overflowed the speculated buffer is replayed from its
    pre-chunk buffer at the observed capacity, so every fetched chunk is
    dropless. speculative_capacity=0 runs the content-independent worst
    case (capacity = the bucketed active count).
  * `state_update`: "replace" (state' = moe(state)) or "residual_norm"
    (state' = rmsnorm(state + moe(state)), which keeps untrained states
    from collapsing to zero and the routing load realistic).

Quantized expert params are fused into the single-kernel weight stream
on construction (`auto_fuse=True`), so a decode step runs the fused
kernel K2; with `auto_fuse=False` it runs K1 twice.
Inference routing is deterministic, so unlike the JAX engine no key chain
is carried. `LmDecodeEngine` is a later slice.
"""

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .ops.fused_ffn import prepare_fused_ffn_params
from .ops.quant import QuantizedWeight


def _maybe_fuse_expert_stream(params):
    """Attach the fused weight stream to quantized expert params; no-op when
    the experts aren't quantized, the shapes don't qualify or a stream is
    there already."""
    experts = params.get("experts") if isinstance(params, dict) else None
    if not isinstance(experts, dict) or "fused_stream" in experts:
        return params
    if not any(isinstance(v, QuantizedWeight) for v in experts.values()):
        return params
    fused = prepare_fused_ffn_params(experts)
    if fused is experts:
        return params
    out = dict(params)
    out["experts"] = fused
    return out


@dataclasses.dataclass
class Request:
    uid: Any
    state: Any                    # [model_dim] tensor or numpy array
    remaining: int                # decode steps left


class MoeDecodeEngine:
    """Continuous batching over a MOELayer decode step."""

    def __init__(self, layer, params, max_batch: int,
                 top_k: Optional[int] = None, capacity_bucket: int = 8,
                 auto_fuse: bool = True,
                 speculative_capacity: float = 8.0,
                 state_update: str = "replace"):
        if state_update not in ("replace", "residual_norm"):
            raise ValueError(f"unknown state_update {state_update!r}")
        self.layer = layer
        if auto_fuse:
            params = _maybe_fuse_expert_stream(params)
        self.params = params
        self.max_batch = int(max_batch)
        self.top_k = top_k
        self.capacity_bucket = max(int(capacity_bucket), 1)
        self.state_update = state_update
        self.device = layer.device
        self._buf = torch.zeros((self.max_batch, layer.model_dim),
                                dtype=layer.dtype, device=self.device)
        self._slots: List[Optional[Request]] = [None] * self.max_batch
        self._free = list(range(self.max_batch))[::-1]
        self._staged: List[Any] = []   # (slot, state) admissions to flush
        self.stats = {"steps": 0, "tokens": 0, "joined": 0, "finished": 0,
                      "spec_retries": 0}
        self.speculative_capacity = float(speculative_capacity or 0)
        # observed-need hints are shared by the engines driving one layer:
        # a later engine starts from the capacity a retry discovered
        hints = getattr(layer, "_serving_spec_hints", None)
        if hints is None:
            hints = layer._serving_spec_hints = {}
        self._spec_hint = hints        # (top_k, fill bucket) -> needed
        self._order_cache = None
        self._spec_over = None         # device bool: a fetch=False overflow
        self._count_fn = None
        if self.speculative_capacity > 0:
            self._count_fn = layer.count_needed_traceable(
                gate_index=0, top_k=top_k, training=False)

    # -- admission -----------------------------------------------------

    def try_add(self, request: Request) -> bool:
        """Admit a request if a slot is free; it joins at the next chunk."""
        if not self._free:
            return False
        slot = self._free.pop()
        self._slots[slot] = request
        self._staged.append((slot, request.state))
        self.stats["joined"] += 1
        return True

    def _flush_admissions(self):
        if not self._staged:
            return
        slots = torch.tensor([s for s, _ in self._staged], device=self.device)
        states = [st for _, st in self._staged]
        if all(isinstance(st, np.ndarray) for st in states):
            stack = torch.from_numpy(np.stack(states))
        else:
            stack = torch.stack([torch.as_tensor(st).to(self.device)
                                 for st in states])
        self._buf[slots] = stack.to(device=self.device, dtype=self._buf.dtype)
        self._staged = []

    @property
    def active(self) -> int:
        return self.max_batch - len(self._free)

    # -- capacity --------------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = self.capacity_bucket
        return max(b, (n + b - 1) // b * b)

    def _worst_cap(self, n_valid: int) -> int:
        """Lossless for every routing: a token's top-k experts are
        distinct, so no expert receives more rows than there are tokens."""
        return self._bucket(n_valid)

    def _spec_cap(self, n_valid: int, worst: int) -> int:
        """margin x the average per-expert load, raised to the largest need
        observed at this fill, bucket-aligned, within [bucket, worst]."""
        tk = min(int(self.top_k or self.layer.gates[0].top_k),
                 self.layer.num_global_experts)
        avg = -(-tk * n_valid // self.layer.num_global_experts)
        cap = int(avg * self.speculative_capacity)
        cap = max(cap, self._spec_hint.get(
            (self.top_k, self._bucket(n_valid)), 0))
        cap = -(-cap // self.capacity_bucket) * self.capacity_bucket
        return max(self.capacity_bucket, min(cap, worst))

    def _order_arrays(self, order, n_valid):
        """Pack permutation, its inverse and the active mask on the device,
        cached while slot occupancy is unchanged."""
        okey = (tuple(order), n_valid)
        cached = self._order_cache
        if cached is not None and cached[0] == okey:
            return cached[1:]
        perm = torch.tensor(order, device=self.device)
        inv = torch.tensor(np.argsort(order), device=self.device)
        amask = torch.tensor([r is not None for r in self._slots],
                             device=self.device)
        self._order_cache = (okey, perm, inv, amask)
        return perm, inv, amask

    # -- one chunk -----------------------------------------------------

    def _run_chunk(self, n_steps, n_valid, cap, with_probe, perm, inv,
                   amask):
        """n_steps of the layer over the packed buffer at capacity `cap`.
        Returns (new_buf, packed output, max needed capacity or None);
        self._buf is not modified, so a chunk can be replayed."""
        b = self._buf.index_select(0, perm)
        mask = torch.arange(self.max_batch, device=self.device) < n_valid
        mx = None
        for _ in range(n_steps):
            if with_probe:
                needed = self._count_fn(self.params, b, None, mask)
                mx = needed if mx is None else torch.maximum(mx, needed)
            o, _ = self.layer(self.params, b, top_k=self.top_k,
                              valid_tokens=n_valid, capacity_override=cap)
            if self.state_update == "residual_norm":
                r = (b + o).float()
                o = (r * torch.rsqrt(torch.mean(r * r, dim=-1, keepdim=True)
                                     + 1e-6)).to(b.dtype)
            b = o
        new_buf = torch.where(amask[:, None], b.index_select(0, inv),
                              self._buf)
        return new_buf, b, mx

    def _run_speculative(self, perm, inv, amask, n_valid, n_steps, worst,
                         fetch):
        """One chunk at the speculated capacity, replayed at the observed
        capacity if any step's routing overflowed it. Returns
        (new_buf, out, host copy of the live outputs or None)."""
        cap = self._spec_cap(n_valid, worst)
        while True:
            new_buf, out, mx = self._run_chunk(n_steps, n_valid, cap, True,
                                               perm, inv, amask)
            if cap >= worst:
                return new_buf, out, None      # lossless by construction
            if not fetch:
                over = mx > cap
                self._spec_over = over if self._spec_over is None \
                    else torch.logical_or(self._spec_over, over)
                return new_buf, out, None
            needed = int(mx)                   # the one sync of the chunk
            out_host = out[:n_valid].cpu()
            hk = (self.top_k, self._bucket(n_valid))
            self._spec_hint[hk] = max(self._spec_hint.get(hk, 0), needed)
            if needed <= cap:
                return new_buf, out, out_host
            self.stats["spec_retries"] += 1
            cap = min(worst, self._bucket(needed))

    @property
    def spec_overflow(self) -> bool:
        """True if a fetch=False speculative chunk overflowed its buffer (its
        outputs dropped rows); fetched chunks replay and are dropless."""
        return bool(self._spec_over) if self._spec_over is not None else False

    # -- the decode step ---------------------------------------------

    def step(self) -> Dict[Any, torch.Tensor]:
        """One dropless decode step over all active slots."""
        return self.step_chunk(1)

    def step_chunk(self, n_steps: int, fetch: bool = True
                   ) -> Dict[Any, torch.Tensor]:
        """Run up to `n_steps` decode steps (never past the shortest
        remaining budget) and return {uid: output} for the active requests;
        finished requests leave their slots.

        fetch=False skips the device-to-host copy of the outputs and
        returns {}: states stay in the slot buffer and retirement still
        advances. A speculative chunk then cannot replay; check
        `spec_overflow` before trusting what follows.
        """
        if self.active == 0:
            return {}
        self._flush_admissions()
        n_steps = max(1, min(n_steps, min(r.remaining for r in self._slots
                                          if r is not None)))
        n_valid = self.active
        order = [i for i, r in enumerate(self._slots) if r is not None] + \
                [i for i, r in enumerate(self._slots) if r is None]
        perm, inv, amask = self._order_arrays(order, n_valid)
        worst = self._worst_cap(n_valid)

        out_host = None
        if self.speculative_capacity > 0:
            new_buf, out, out_host = self._run_speculative(
                perm, inv, amask, n_valid, n_steps, worst, fetch)
        else:
            new_buf, out, _ = self._run_chunk(n_steps, n_valid, worst, False,
                                              perm, inv, amask)
        self._buf = new_buf

        results: Dict[Any, torch.Tensor] = {}
        if fetch and out_host is None:
            out_host = out[:n_valid].cpu()
        for j, slot in enumerate(order[:n_valid]):
            req = self._slots[slot]
            if fetch:
                results[req.uid] = out_host[j]
                req.state = out_host[j]
            req.remaining -= n_steps
            if req.remaining <= 0:
                self._slots[slot] = None
                self._free.append(slot)
                self.stats["finished"] += 1
        self.stats["steps"] += n_steps
        self.stats["tokens"] += n_valid * n_steps
        return results

    def run(self, requests: List[Request], max_steps: int = 10_000,
            chunk: int = 1) -> Dict[Any, torch.Tensor]:
        """Drive the engine until every request finishes; requests join as
        slots free up. Returns each uid's final output. chunk > 1 runs up to
        `chunk` steps per dispatch once no request can join."""
        pending = list(requests)[::-1]
        finals: Dict[Any, torch.Tensor] = {}
        steps_done = 0
        while steps_done < max_steps:
            while pending and self.try_add(pending[-1]):
                pending.pop()
            if self.active == 0 and not pending:
                break
            k = 1
            if chunk > 1:
                k = max(1, min(chunk, min(r.remaining for r in self._slots
                                          if r is not None)))
            finals.update(self.step_chunk(k))
            steps_done += k
        return finals
