"""Continuous-batching decode engines (counterpart: tutel_tpu/serving.py).

`MoeDecodeEngine` (tutel_tpu/serving.py:39-523) drives one MoE layer over
embedding vectors:

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
    case (capacity = the bucketed active count). An expert-choice gate
    turns speculation off (:143-146); its chunks pass the worst case as
    `capacity_override`, which the EC rule takes as C, so each expert
    takes every valid token, as in the JAX engine.
  * `state_update`: "replace" (state' = moe(state)) or "residual_norm"
    (state' = rmsnorm(state + moe(state)), which keeps untrained states
    from collapsing to zero and the routing load realistic).

Quantized expert params are fused into the single-kernel weight stream
on construction (`auto_fuse=True`), so a decode step runs the fused
kernel K2 (K3 for W4A8/W8A8 experts, `activation_bits=8`); with
`auto_fuse=False` it runs K1 twice (K5 twice).
Inference routing is deterministic, so unlike the JAX engine no key chain
is carried. Over a layer of W > 1 ranks every rank runs the same engine
over the same requests: each feeds the layer its rows of the globally
packed buffer (max_batch / W of them; the scalar `valid_tokens` masks the
tail, :29), the capacities are per (expert, source rank) buffers sized by
the largest rank's valid rows (`_worst_cap`, `_spec_cap`), the probe is
the largest over the ranks, and a chunk's states are all-gathered at its
end, so every rank holds the same states and makes the same admissions.

`LmDecodeEngine` (tutel_tpu/serving.py:526-1060) serves a whole
`models.TransformerMoE`: prompts in, tokens out. A [max_batch]-slot KV
cache; admissions prefill their prompts (grouped by padded length) and
join; chunks of decode steps run over every slot, with greedy or sampled
token selection and optional speculative MoE capacity with replay (off
over several ranks and for expert-choice gates, as in the JAX engine:
:640-650; an EC decode step then runs at C = capacity_factor * S / E).
Each
decode step runs kernels K6 and K8, each prefill chunk K7, and the INT4
MoE blocks K2 (K4 for SwiGLU `llama_ffn` experts, whose stream
`auto_fuse` attaches the same way). The caches are updated in place.
The JAX engine's jit
caches and XLA compiler options (`_chunk_compiler_options`) have no
counterpart in eager PyTorch.
"""

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import net, trace
from .ops.fused_ffn import prepare_fused_ffn_params
from .ops.quant import QuantizedWeight


def _maybe_fuse_expert_stream(params, layer=None):
    """Attach the fused weight stream to quantized expert params; no-op when
    the experts aren't quantized, the shapes don't qualify, a stream is
    there already, or the layer slices its experts (a stream holds whole
    hidden rows)."""
    if layer is not None and layer.sharded_count > 1:
        return params
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
            params = _maybe_fuse_expert_stream(params, layer)
        self.params = params
        self.max_batch = int(max_batch)
        if self.max_batch % layer.world_size:
            raise ValueError(f"max_batch {self.max_batch} does not split "
                             f"over {layer.world_size} ranks")
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
        # an expert-choice gate's capacity is exact by construction; every
        # chunk passes capacity_override = the worst case, which the EC
        # rule takes as C: each expert takes every valid token (as in JAX)
        if getattr(layer.gates[0], "expert_choice", False):
            self.speculative_capacity = 0.0
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
        distinct, so no expert receives more rows than there are tokens;
        over W ranks a capacity is a per-(expert, source rank) buffer, so
        the bound is a rank's rows (:220-231)."""
        worst = self._bucket(n_valid)
        if self.layer.world_size > 1:
            local = -(-self.max_batch // self.layer.world_size)
            worst = min(worst, self._bucket(min(n_valid, local)))
        return worst

    def _spec_cap(self, n_valid: int, worst: int) -> int:
        """margin x the average per-expert load, raised to the largest need
        observed at this fill, bucket-aligned, within [bucket, worst]; over
        W ranks the average is over the largest rank's valid rows
        (:235-255)."""
        tk = min(int(self.top_k or self.layer.gates[0].top_k),
                 self.layer.num_global_experts)
        w = self.layer.world_size
        s_loc = min(n_valid, -(-self.max_batch // w)) if w > 1 else n_valid
        avg = -(-tk * s_loc // self.layer.num_global_experts)
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
        w = self.layer.world_size
        if w > 1:                      # this rank's rows of the packed buffer
            rows = self.max_batch // w
            first = self.layer.rank_index * rows
            b, mask = b[first:first + rows], mask[first:first + rows]
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
        if w > 1:
            b = net.simple_all_gather(b, self.layer.world_group)
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


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LmRequest:
    uid: Any
    prompt: Any                   # [Tp] int token ids
    max_new_tokens: int
    stop_token: Optional[int] = None   # retire on emitting this id (kept
    #   in the output; not seen under fetch=False chunks)


def _make_token_selector(sampler, generator):
    """Token selection fn(logits [B, V]) -> [B] long.

    sampler None/{} or temperature 0 = greedy argmax. Otherwise a dict of
    temperature, top_k (keep the k highest logits) and top_p (keep the
    smallest prefix of the sorted distribution whose mass reaches p; the
    top token is always kept), composed in that order, then a
    categorical draw from `generator`."""
    t = float((sampler or {}).get("temperature", 1.0))
    if not sampler or t == 0.0:
        return lambda logits: torch.argmax(logits, dim=-1)
    top_k = int(sampler.get("top_k", 0))
    top_p = float(sampler.get("top_p", 0.0))

    def select(logits):
        lg = logits.float() / t
        if 0 < top_k < lg.shape[-1]:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        if top_p > 0.0:
            srt, order = torch.sort(lg, dim=-1, descending=True)
            p = torch.softmax(srt, dim=-1)
            keep = (torch.cumsum(p, dim=-1) - p) < top_p
            mask = torch.zeros_like(keep).scatter(-1, order, keep)
            lg = lg.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(lg, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return select


class LmDecodeEngine:
    """Continuous-batching token generation over a TransformerMoE.

    sampler: None = greedy (the same tokens as re-running the full
    forward); or a dict with temperature / top_k / top_p / seed (see
    `_make_token_selector`). Sampled runs are deterministic for a seed and
    an admission sequence.

    speculative_capacity > 0 runs decode chunks at capacity margin x the
    average per-expert load, with a needed-capacity probe per step; a
    chunk whose routing overflowed is replayed at the observed capacity,
    so fetched chunks stay dropless. The replay restarts from the
    pre-chunk tokens and positions over the post-chunk cache: a chunk only
    writes positions >= each row's pos, and every such cell is masked
    until the step that rewrites it.
    """

    def __init__(self, model, params, max_batch: int,
                 moe_overrides: Optional[dict] = None,
                 auto_fuse: bool = True,
                 sampler: Optional[dict] = None,
                 speculative_capacity: float = 0.0,
                 capacity_bucket: int = 8,
                 attn_bucket: int = 64,
                 prefill_bucket: int = 64):
        self.model = model
        if auto_fuse:
            params = dict(params)
            params["blocks"] = [
                {**blk, "moe": _maybe_fuse_expert_stream(
                    blk["moe"], model.moe_layers.get(i))}
                if "moe" in blk else blk
                for i, blk in enumerate(params["blocks"])]
        self.params = params
        self.max_batch = int(max_batch)
        self.device = model.device
        self.moe_overrides = dict(moe_overrides or {})
        self.sampler = dict(sampler or {})
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(self.sampler.get("seed", 0)))
        self._select = _make_token_selector(self.sampler, self._gen)
        self.cache = model.init_cache(self.max_batch)
        self._tok = torch.zeros(self.max_batch, dtype=torch.long,
                                device=self.device)
        self._pos = torch.zeros(self.max_batch, dtype=torch.int32,
                                device=self.device)
        self._slots: List[Optional[LmRequest]] = [None] * self.max_batch
        self._free = list(range(self.max_batch))[::-1]
        self._remaining = [0] * self.max_batch
        self._host_pos = [0] * self.max_batch
        self._staged: List[Any] = []   # (slot, LmRequest)
        self._generated: Dict[Any, List[int]] = {}
        self.stats = {"steps": 0, "tokens": 0, "joined": 0, "finished": 0,
                      "spec_retries": 0}
        self.capacity_bucket = max(int(capacity_bucket), 1)
        self.speculative_capacity = float(speculative_capacity or 0)
        if not model.moe_layers or any(
                lay.world_size > 1 or getattr(lay.gates[0], "expert_choice",
                                              False)
                for lay in model.moe_layers.values()):
            self.speculative_capacity = 0.0
        # observed needs are shared by the engines of one model: a hint
        # only raises the speculated capacity
        hints = getattr(model, "_serving_spec_hints", None)
        if hints is None:
            hints = model._serving_spec_hints = {}
        self._spec_hints = hints
        self._hint_key = (tuple(sorted(self.moe_overrides.items())),
                          self.max_batch)
        self._spec_over = None         # device bool: a fetch=False overflow
        # decode chunks read only the cache positions any live row can
        # reach, rounded up to attn_bucket (0 = always max_len)
        self.attn_bucket = int(attn_bucket)
        # admissions group by prompt length rounded up to prefill_bucket
        # (0 = exact length)
        self.prefill_bucket = int(prefill_bucket)

    @property
    def active(self) -> int:
        return self.max_batch - len(self._free)

    def try_add(self, request: LmRequest) -> bool:
        """Admit a request if a slot is free; it prefills at the next
        chunk."""
        if not self._free:
            return False
        tp = len(request.prompt)
        budget = self.model.cfg.max_len - tp - 1
        if budget <= 0:
            raise ValueError(f"prompt length {tp} leaves no room under "
                             f"max_len={self.model.cfg.max_len}")
        slot = self._free.pop()
        self._slots[slot] = request
        self._remaining[slot] = min(request.max_new_tokens, budget)
        self._staged.append((slot, request))
        self._generated[request.uid] = []
        self.stats["joined"] += 1
        if trace.enabled():
            trace.event("tutel.request.admit", uid=request.uid)
        return True

    # -- prefill (admission flush) --------------------------------------

    def _flush_admissions(self):
        """One prefill per prompt-length bucket, into a fresh cache of the
        group's rows, then copied into the engine cache's slots. Mixed
        true lengths inside a bucket ride the model's prompt_lens."""
        if not self._staged:
            return
        with trace.span("tutel.engine.admit") as sp:
            q = self.prefill_bucket
            if q > 0 and "capacity_factor" in self.moe_overrides:
                # a capacity-limited prefill lets pad tokens compete with
                # real ones for expert slots: group by exact length
                q = 0
            max_len = self.model.cfg.max_len
            by_len: Dict[int, List[Any]] = {}
            for slot, req in self._staged:
                tp = len(req.prompt)
                bl = min(-(-tp // q) * q, max_len) if q > 0 else tp
                by_len.setdefault(bl, []).append((slot, req))
            if sp:
                sp.set(requests=len(self._staged),
                       prompt_tokens=sum(len(r.prompt)
                                         for _, r in self._staged),
                       padded_tokens=sum(bl * len(g)
                                         for bl, g in by_len.items()),
                       groups=len(by_len))
            self._staged = []
            for bl, group in by_len.items():
                lens = [len(r.prompt) for _, r in group]
                prompts = np.stack([np.pad(np.asarray(r.prompt, np.int64),
                                           (0, bl - len(r.prompt)))
                                    for _, r in group])
                prompts = torch.from_numpy(prompts).to(self.device)
                lens_t = torch.tensor(lens, dtype=torch.int32,
                                      device=self.device)
                bucketed = q > 0 and any(n != bl for n in lens)
                logits, gc = self.model.prefill(
                    self.params, prompts, self.model.init_cache(len(group)),
                    moe_overrides=self.moe_overrides,
                    prompt_lens=lens_t if bucketed else None)
                first = self._select(logits)
                slots = torch.tensor([s for s, _ in group],
                                     device=self.device)
                for lc, glc in zip(self.cache, gc):
                    for kk in lc:
                        lc[kk][slots] = glc[kk]
                self._tok[slots] = first
                self._pos[slots] = lens_t
                with trace.sync("first_tokens"):
                    first_host = first.tolist()
                for (slot, req), n, tok in zip(group, lens, first_host):
                    self._host_pos[slot] = n
                    self._generated[req.uid].append(tok)
                    self._remaining[slot] -= 1
                    if sp:
                        trace.event("tutel.request.first_token", uid=req.uid)
                    if req.stop_token is not None and tok == req.stop_token:
                        self._remaining[slot] = 0  # retires at the next sweep

    # -- chunked decode -------------------------------------------------

    def _decode_chunk(self, n_steps, cap=None, with_probe=False,
                      attn_len=None, attempt=0):
        """n_steps decode steps from the engine's tokens and positions.
        Returns (tok, pos, toks [n_steps, B], max needed capacity or
        None); self._tok / self._pos are not modified, so a chunk can be
        replayed (`attempt` counts the replays, for the trace)."""
        ov = self.moe_overrides
        if cap is not None:
            ov = {**ov, "capacity_override": cap}
        tok, pos, toks, mx = self._tok, self._pos, [], None
        for _ in range(n_steps):
            with trace.span("tutel.engine.step") as sp:
                if sp:
                    sp.set(attempt=attempt)
                out = self.model.apply_decode(
                    self.params, tok, self.cache, pos, moe_overrides=ov,
                    capacity_probe=with_probe, attn_len=attn_len)
                if with_probe:
                    mx = out[3] if mx is None else torch.maximum(mx, out[3])
                tok = self._select(out[0])
                toks.append(tok)
                pos = pos + 1
        return tok, pos, torch.stack(toks), mx

    def _attn_len(self, n_steps: int) -> Optional[int]:
        """Cache positions the next n_steps can read: the largest live
        position plus the chunk, rounded up to attn_bucket; None (all of
        max_len) when disabled or when that reaches max_len. Idle slots
        decode junk that is never read back, so only live ones count."""
        if self.attn_bucket <= 0:
            return None
        mp = max((self._host_pos[s] for s, r in enumerate(self._slots)
                  if r is not None), default=0)
        b = self.attn_bucket
        t = min((mp + n_steps + b - 1) // b * b, self.model.cfg.max_len)
        return None if t >= self.model.cfg.max_len else t

    def _lm_spec_cap(self) -> int:
        """Speculated dropless capacity of a decode step: margin x the
        average per-expert load over the whole slot buffer (every slot
        routes, occupied or not), raised to the largest observed need,
        bucket-aligned, within [bucket, max_batch]."""
        tk = self.moe_overrides.get("top_k") or self.model.cfg.top_k
        e = min(lay.num_global_experts
                for lay in self.model.moe_layers.values())
        tk = min(int(tk), e)
        avg = -(-tk * self.max_batch // e)
        cap = max(int(avg * self.speculative_capacity),
                  self._spec_hints.get(self._hint_key, 0))
        cap = -(-cap // self.capacity_bucket) * self.capacity_bucket
        return max(self.capacity_bucket, min(cap, self.max_batch))

    @property
    def spec_overflow(self) -> bool:
        """True if a fetch=False speculative chunk overflowed its buffer
        (its tokens dropped rows); fetched chunks replay and stay
        dropless."""
        return bool(self._spec_over) if self._spec_over is not None \
            else False

    def step_chunk(self, n_steps: int, fetch: bool = True
                   ) -> Dict[Any, List[int]]:
        """Decode up to `n_steps` tokens for every active slot (never past
        the smallest remaining budget). Returns {uid: new tokens}.

        fetch=False skips the device-to-host copy of the tokens and
        returns {}: the cache and positions advance, but the tokens are
        not recorded (a timing mode). A speculative chunk then cannot
        replay: check `spec_overflow` afterwards."""
        with trace.span("tutel.engine.chunk") as sp:
            self._flush_admissions()
            for slot, req in enumerate(self._slots):
                if req is not None and self._remaining[slot] <= 0:
                    self._retire(slot, req, sp)  # budget spent by the prefill
            if self.active == 0:
                return {}
            n_steps = max(1, min(n_steps, *[self._remaining[s] for s, r in
                                            enumerate(self._slots)
                                            if r is not None]))
            attn_len = self._attn_len(n_steps)
            toks_np, cap, attempt = None, None, 0
            if self.speculative_capacity > 0:
                cap = self._lm_spec_cap()
                gen_state = self._gen.get_state()
                while True:
                    tok, pos, toks, mx = self._decode_chunk(
                        n_steps, cap=cap, with_probe=True, attn_len=attn_len,
                        attempt=attempt)
                    if cap >= self.max_batch:
                        break                      # lossless by construction
                    if not fetch:
                        over = mx > cap
                        self._spec_over = over if self._spec_over is None \
                            else torch.logical_or(self._spec_over, over)
                        break
                    with trace.sync("tokens"):
                        toks_np = toks.cpu().numpy()  # the overflow check
                    with trace.sync("capacity"):      # rides the fetch
                        needed = int(mx)
                    self._spec_hints[self._hint_key] = max(
                        self._spec_hints.get(self._hint_key, 0), needed)
                    if needed <= cap:
                        break
                    self.stats["spec_retries"] += 1
                    attempt += 1
                    toks_np = None
                    self._gen.set_state(gen_state)  # replay the same draws
                    cap = min(self.max_batch,
                              -(-needed // self.capacity_bucket)
                              * self.capacity_bucket)
            else:
                tok, pos, toks, _ = self._decode_chunk(n_steps,
                                                       attn_len=attn_len)
            if sp:
                sp.set(steps=n_steps, active=self.active, capacity=cap,
                       replays=attempt, attn_len=attn_len)
            self._tok, self._pos = tok, pos
            for slot, req in enumerate(self._slots):
                if req is not None:
                    self._host_pos[slot] += n_steps
            if not fetch:
                with trace.span("tutel.engine.sweep") as sw:
                    for slot, req in enumerate(self._slots):
                        if req is None:
                            continue
                        self._remaining[slot] -= n_steps
                        self.stats["tokens"] += n_steps
                        if self._remaining[slot] <= 0:
                            self._retire(slot, req, sw)
                self.stats["steps"] += n_steps
                return {}
            if toks_np is None:
                with trace.sync("tokens"):
                    toks_np = toks.cpu().numpy()   # [n_steps, B], one copy
            results: Dict[Any, List[int]] = {}
            with trace.span("tutel.engine.sweep") as sw:
                finished = self.stats["finished"]
                for slot, req in enumerate(self._slots):
                    if req is None:
                        continue
                    new = toks_np[:, slot].tolist()
                    stopped = False
                    if req.stop_token is not None and req.stop_token in new:
                        # keep up to and including the stop token
                        new = new[:new.index(req.stop_token) + 1]
                        stopped = True
                    self._generated[req.uid].extend(new)
                    results[req.uid] = new
                    self._remaining[slot] -= n_steps
                    self.stats["tokens"] += len(new)
                    if stopped or self._remaining[slot] <= 0:
                        self._retire(slot, req, sw)
                if sw:
                    sw.set(finished=self.stats["finished"] - finished)
            self.stats["steps"] += n_steps
            return results

    def _retire(self, slot, req, sp):
        """Free a finished request's slot (`sp`: the span it retires in)."""
        self._slots[slot] = None
        self._free.append(slot)
        self.stats["finished"] += 1
        if sp:
            trace.event("tutel.request.finish", uid=req.uid)

    def run(self, requests: List[LmRequest], chunk: int = 8,
            max_steps: int = 100_000) -> Dict[Any, np.ndarray]:
        """Drive until every request finishes; returns each uid's generated
        tokens (prompt not included)."""
        pending = list(requests)[::-1]
        steps = 0
        while steps < max_steps:
            while pending and self.try_add(pending[-1]):
                pending.pop()
            if self.active == 0 and not pending:
                break
            self.step_chunk(chunk)
            steps += chunk
        return {uid: np.asarray(toks, np.int32)
                for uid, toks in self._generated.items()}
