"""The MoE layer, inference and training, on one device or sharded over
the ranks of a process group (counterpart: tutel_tpu/impls/moe_layer.py).

Same calling convention as the JAX layer: `params = layer.init(...)`,
`out, l_aux = layer(params, x, ...)`. Ported: construction with the
expert-count math (`global_expert_count` :77, fractional and negative
counts, `sharded_count`, `valid_rs`, the data / model / auto /
adaptive:r parallel types :153-190), `init`, `shard_params`, the forward
with per-call `capacity_factor` (padded > 0, dropless == 0, capped < 0),
`top_k`, `capacity_override`, `a2a_ffn_overlap_degree`, `adaptive_r`,
`valid_tokens` (with `inequivalent_tokens`) and `megablocks_size`, the
alignment and static capacity math (:376-395), `resolve_capacity`
(:649), `count_needed_traceable` (:1264) and `state_dict` /
`load_state_dict` (:1444-1500).

Sharding. The layer's world is the process group it is given (`group`:
a `system.ParallelEnv`, a process group or a list of ranks; None = the
default group, or one rank without one). Each rank calls the layer with
its own rows of the global token batch (rank i holds rows [i*S, (i+1)*S)
of the flattened input) and its own shard of the parameters
(`shard_params` of the global ones), and gets its rows of the output.
The token-choice body follows the JAX body (:1099-1180): one rank; r == 0
(data-parallel experts: the expert weights all-gathered, :889-952);
expert parallelism with the tile and reshape for E < W; the chunked
a2a/FFN overlap; the `a2a_dtype` cast around the exchange; the two-level
exchange (`use_2dh`); `l_aux` averaged over the world. The dropless
capacity is the largest over the world (one all-reduce MAX after the
local probe). Quantized expert weights run under pure expert parallelism
and under expert slicing: a K-sliced INT4 matrix must have been packed per
shard block (`quantize_expert_params(..., sharded_count=)`), each rank
reads its slice as a one-block packing (`_local_quant_view`), and a
regather over n K-slices gives an n-block packing (K1 reads `blocks`).
A fused weight stream does not slice and raises.

Ragged expert parallelism (`use_ragged_ep=True`, :560-592): the dropless
pure-EP exchange of the routed rows only (`ops.ragged_ep`), its receive
buffer `max_recv` rows, probed (`resolve_max_recv`: the most rows any rank
receives, one all-reduce and one host sync) unless given.

Expert choice (a gate with `expert_choice = True`, :491-514, :972-1094):
each expert takes its top-C tokens of the world's pool (`_ec_body`,
`ops.expert_choice`); over several ranks the [s, E] scores are
all-gathered and only the selected rows cross the ragged exchange, or,
at adaptive_r == 0, the weights are gathered and no row crosses.

Composing under an outer schedule (:670-780): `local_forward` is the
body at a static capacity, without the dropless probe; `param_specs`
gives the placement of `shard_params` as a tree of per-dim mesh axes.

Gradients. The collectives are `net`'s autograd Functions, so
`loss.backward()` on every rank, with `loss` this rank's share of the
global loss, sends the cotangents back through the exchanges. The gate
parameters are replicated: the layer passes them through
`net.allreduce_backward`, so their gradient on every rank is the sum over
ranks, the global gradient (JAX's transpose of a replicated shard_map
input).

Training (`training=True`) runs under autograd: the gate noise is drawn
from the `key` Generator (once a call, shared by the dropless capacity
probe and the routing; over a world, every rank draws the whole batch's
noise and keeps its rows), the dispatch backward is `ops.dispatch`'s,
megablocks is off, and `remat_experts=True` recomputes the experts'
activations in the backward. When every token routes to every expert
(top_k == E) and nothing is dropped, one rank takes the dense dispatch,
as the JAX layer does (:592-605).

The JAX layer caches one compiled variant per static configuration; eager
PyTorch switches between configurations per call with no cache. Dropless
capacity is read from a routing probe with one host sync, as in the JAX
layer outside a jit.
"""

import dataclasses
import logging
import math
import os
import re
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from .. import experts as experts_registry
from .. import gates as gates_registry
from .. import net, trace
from ..convert import take_shard, to_tensor
from ..ops import dispatch as dispatch_ops
from ..ops import losses as losses_ops
from ..ops import routing as routing_ops
from ..ops.fused_ffn import FusedFFNStream
from ..ops.quant import QuantizedWeight
from ..parallel import mesh as mesh_lib
from ..utils import resolve_device

# param name -> (expert dim, shard dim) of the expert parameters
SHARD_AXES = {"fc1_w": (0, 2), "fc1_b": (0, 1), "fc2_w": (0, 1),
              "fc2_b": (0, 1), "w1": (0, 2), "w2": (0, 2), "w3": (0, 1)}

def _lcm(a, b):
    return a * b // math.gcd(a, b)


def _world_ranks(group):
    """The ranks of the layer's world for a `group` argument."""
    if group is None:
        return mesh_lib.default_ranks()
    if hasattr(group, "ranks"):                       # system.ParallelEnv
        return tuple(group.ranks)
    if isinstance(group, dist.ProcessGroup):
        return tuple(dist.get_process_group_ranks(group))
    return tuple(group)


class MOELayer:
    """Tutel-capability MoE layer in PyTorch, on one device or sharded over
    a process group."""

    @staticmethod
    def global_expert_count(num_local_experts, world_size=1):
        """Global expert count, incl. the fractional float form."""
        if not isinstance(num_local_experts, int):
            num_local_experts = -int(1 / (num_local_experts + 1e-5))
        if num_local_experts == 0:
            raise ValueError(
                "num_local_experts resolved to 0 (got %r); use a positive "
                "count, a negative shard degree, or a fractional float"
                % num_local_experts)
        if num_local_experts > 0:
            return num_local_experts * world_size
        if world_size % -num_local_experts:
            raise ValueError(
                f"num_local_experts={num_local_experts} shards each expert "
                f"across {-num_local_experts} devices, which must divide the "
                f"global device count ({world_size}).")
        return world_size // -num_local_experts

    def __init__(self, gate_type, model_dim: int, experts=None,
                 scan_expert_func=None, result_func=None, seeds=None,
                 group=None, a2a_ffn_overlap_degree=1, is_postscore=True,
                 batch_prioritized_routing=False, normalize_gate=True,
                 is_gshard_loss=True, parallel_type="adaptive:1",
                 use_2dh=False, dtype=torch.float32, a2a_dtype=None,
                 capacity_bucket: int = 0, num_hosts=None,
                 remat_experts=False, device="cuda", **kwargs):
        if model_dim % 2:
            raise ValueError("model_dim must be even, got %s" % model_dim)
        for k in kwargs:
            raise TypeError(
                "MOELayer got an unrecognized constructor argument: %s" % k)
        self.device = resolve_device(device)
        self.model_dim = model_dim
        self.scan_expert_func = scan_expert_func
        self.result_func = result_func
        # SKIP_MOE=1 at construction: the layer passes its input through
        # (the JAX layer's debug knob, read at the same point)
        self.skip_moe = int(os.environ.get("SKIP_MOE", "0")) != 0
        self.is_postscore = is_postscore
        self.batch_prioritized_routing = batch_prioritized_routing
        self.normalize_gate = normalize_gate
        self.is_gshard_loss = is_gshard_loss
        self.a2a_ffn_overlap_degree = a2a_ffn_overlap_degree
        self.use_2dh = use_2dh
        self.dtype = dtype
        self.a2a_dtype = a2a_dtype
        self.capacity_bucket = capacity_bucket
        self.remat_experts = remat_experts
        self.seeds = seeds

        # -- world ------------------------------------------------------
        self.ranks = _world_ranks(group)
        self.world_size = len(self.ranks)
        self.rank_index = (self.ranks.index(mesh_lib.this_rank())
                           if self.world_size > 1 else 0)
        if self.world_size > 1 and dist.get_backend() == "nccl" \
                and self.device.type != "cuda":
            raise ValueError("an NCCL process group needs device='cuda'")
        self.num_hosts = mesh_lib.infer_num_hosts(self.ranks, num_hosts)

        # -- expert-count math (:153-190) ---------------------------------
        experts = dict(experts or {})
        self.num_local_experts = experts.pop(
            "count_per_node", experts.pop("num_experts_per_device", 1))
        if self.num_local_experts == -1:
            self.num_local_experts = 1
        self.num_global_experts = MOELayer.global_expert_count(
            self.num_local_experts, self.world_size)
        if self.num_global_experts < self.world_size:
            self.sharded_count = self.world_size // self.num_global_experts
            self.num_local_experts = 1
        else:
            self.sharded_count = 1
        self.auto_parallel, self.adaptive_degree = False, self.sharded_count
        self.valid_rs = [0] + [i for i in range(1, self.sharded_count + 1)
                               if self.sharded_count % i == 0]
        if parallel_type.startswith("adaptive:"):
            self.adaptive_degree = min(max(int(
                parallel_type.split(":", 1)[1]), 0), self.sharded_count)
            if self.adaptive_degree not in self.valid_rs:
                raise ValueError(
                    "Unexpected value of adaptive_degree: %d, expecting a "
                    "candidate within %s." % (self.adaptive_degree,
                                              self.valid_rs))
        elif self.sharded_count == 1:
            pass
        elif parallel_type in ("data", "model"):
            self.adaptive_degree = (1 if parallel_type == "data"
                                    else self.sharded_count)
        elif parallel_type == "auto":
            self.auto_parallel, self.adaptive_degree = True, 1
        else:
            raise ValueError(
                "Unrecognized parallel type specified: %s" % parallel_type)

        experts_type = experts.pop("type")
        expert_cls = (experts.pop("module") if experts_type == "custom"
                      else experts_registry.resolve(experts_type))
        # the global view: `init` makes the global parameters; `apply`
        # follows the shapes of the shard it is given
        self.experts = expert_cls(
            model_dim=self.model_dim,
            num_experts_per_device=self.num_global_experts,
            sharded_count=self.sharded_count, **experts)
        # param name -> (expert dim, shard dim): a custom expert's own
        # `shard_axes()` in place of the built-in experts' (JAX
        # `_expert_shard_axes`)
        self._shard_axes = (self.experts.shard_axes()
                            if hasattr(self.experts, "shard_axes")
                            else SHARD_AXES)

        if isinstance(gate_type, str):
            if not re.match(r"^Top[0-9]+Gate$", gate_type):
                raise ValueError("Unrecognized gate_type: %s" % gate_type)
            gate_type = {"type": "top", "k": int(gate_type[3:-4])}
        if not isinstance(gate_type, list):
            gate_type = [gate_type]
        self.gates = []
        for single in gate_type:
            single = dict(single)
            g_type = single.pop("type")
            gate_cls = (single.pop("module") if g_type == "custom"
                        else gates_registry.resolve(g_type))
            self.gates.append(gate_cls(
                model_dim=self.model_dim,
                num_global_experts=self.num_global_experts, **single))

        # every mesh this layer can use, built now on every rank in one
        # order, so a per-call adaptive_r switch creates no group;
        # world_group: the process group over the layer's ranks (None at
        # one rank)
        self._meshes, self.world_group = {}, None
        if self.world_size > 1:
            for r in sorted({max(r, 1) for r in self.valid_rs}):
                self._meshes[r] = mesh_lib.MoeMesh(
                    self.ranks, self.world_size // self.sharded_count,
                    self.sharded_count, r).build()
            self.world_group = self._meshes[1].group(
                mesh_lib.MoeMesh.EP_AXES)
            if self._flat_2dh():
                self._hmesh = mesh_lib.HierarchicalMesh(
                    self.ranks, self.num_hosts).build()

    # -- parameters ----------------------------------------------------

    def init(self, generator=None) -> Dict[str, Any]:
        """Global parameters on the layer's device. Without a generator,
        the gate and expert weights come from generators seeded by
        `seeds`."""
        if generator is None:
            seeds = self.seeds or (1, 1, 1)
            gate_gen = torch.Generator(device=self.device).manual_seed(
                seeds[0] if seeds[0] is not None else 1)
            expert_gen = torch.Generator(device=self.device).manual_seed(
                seeds[1] if seeds[1] is not None else 1)
        else:
            gate_gen = expert_gen = generator
        gate_params = [gate.init(gate_gen, dtype=self.dtype,
                                 device=self.device) for gate in self.gates]
        expert_params = self.experts.init(expert_gen, dtype=self.dtype,
                                          device=self.device)
        if self.scan_expert_func is not None:
            for name, p in expert_params.items():
                self.scan_expert_func(name, p)
        return {"gates": gate_params, "experts": expert_params}

    def shard_params(self, params, adaptive_r=None):
        """This rank's shard of the global parameters, as the JAX layer
        places them (`_expert_specs` :260-283): under pure expert
        parallelism the expert dim over the world; under expert slicing
        (`sharded_count` > 1) the expert dim over 'e' and the shard dim
        over ('r', 'g'), whose flat index does not depend on r. Gates stay
        whole (replicated). One rank: the params as they are."""
        if self.world_size == 1:
            return params
        w, sc, pos = self.world_size, self.sharded_count, self.rank_index
        out = {}
        for name, v in params["experts"].items():
            e_dim, s_dim = self._shard_axes.get(name, (0, None))
            if sc == 1:
                out[name] = take_shard(v, e_dim, w, pos)
                continue
            if isinstance(v, FusedFFNStream):
                raise ValueError(
                    "fused weight streams don't support expert-slicing TP "
                    f"(sharded_count={sc}); drop the 'fused_stream' entry "
                    "for TP layouts")
            self._check_quant_sliceable(name, v, s_dim)
            # a QuantizedWeight slices its values on both dims and keeps
            # its [E, 1, N] scales whole on the size-1 dim
            v = take_shard(v, e_dim, w // sc, pos // sc)
            if s_dim is not None:
                v = take_shard(v, s_dim, sc, pos % sc)
            out[name] = v
        return {**params, "experts": out}

    def _check_quant_sliceable(self, name, v, s_dim):
        """Slicing an INT4 weight's packed contraction dim (dim 1 of
        [E, K/2, N] values) commutes with the nibble unpacking only when
        the packing was done per shard block (:848-866)."""
        if not isinstance(v, QuantizedWeight) or v.bits != 4 \
                or self.sharded_count <= 1:
            return
        if s_dim == 1 and v.blocks != self.sharded_count:
            raise ValueError(
                f"INT4 expert weight {name!r} is K-sliced over "
                f"sharded_count={self.sharded_count} but was packed "
                f"with shard_blocks={v.blocks}; slicing would "
                f"interleave nibble-packing halves. Quantize with "
                f"quantize_expert_params(..., sharded_count="
                f"{self.sharded_count}).")

    def _local_quant_view(self, expert_params):
        """A rank's K-slice of an INT4 weight packed per shard block is a
        one-block packing of its own K range: its `blocks` becomes 1, so
        the kernel, dequantize and the regather see the slice's true
        packing (:868-887)."""
        if self.sharded_count <= 1:
            return expert_params
        out = {}
        for name, p in expert_params.items():
            if isinstance(p, QuantizedWeight) and p.bits == 4 \
                    and p.blocks > 1 \
                    and self._shard_axes.get(name, (0, None))[1] is not None:
                p = dataclasses.replace(p, blocks=1)
            out[name] = p
        return out

    # -- capacity math -------------------------------------------------

    def _flat_2dh(self):
        return self.use_2dh and self.sharded_count == 1

    def _alignment(self, overlap_degree, megablocks_size):
        mega_up = max(megablocks_size, 1)
        base = self.sharded_count * overlap_degree
        alignment = (base + mega_up - 1) // mega_up * mega_up
        if alignment > 256:
            alignment = (alignment + 127) // 128 * 128
        # the reshape and chunk steps need capacity % (sharded*degree) == 0
        alignment = _lcm(alignment, base)
        if self.capacity_bucket:
            alignment = _lcm(alignment, self.capacity_bucket)
        return alignment

    def _static_capacity(self, samples, top_k, capacity_factor,
                         megablocks_size, overlap_degree=1):
        return routing_ops.compute_static_capacity(
            samples, self.num_global_experts, top_k, capacity_factor,
            alignment=self._alignment(overlap_degree, megablocks_size))

    # -- forward -------------------------------------------------------

    def _draw_noise(self, shape, key, device):
        """The training gate noise: standard normal float32 values drawn
        from `key` (a torch.Generator; None = the default generator)."""
        return torch.randn(shape, generator=key, device=device,
                           dtype=torch.float32)

    def _noise(self, gate_index, samples, training, key, device):
        """This call's gate noise [samples, E] for this rank's rows, or
        None: over a world, the noise of the whole batch is drawn and this
        rank keeps its rows."""
        if not (training and self.gates[gate_index].gate_noise > 0):
            return None
        noise = self._draw_noise(
            (self.world_size * samples, self.num_global_experts), key,
            device)
        return noise[self.rank_index * samples:
                     (self.rank_index + 1) * samples]

    def _routing(self, gate_params, x, gate_index, top_k, capacity,
                 noise=None, token_mask=None, with_loss=True):
        """logits -> (noised) scores -> extract_critical."""
        with trace.span("tutel.moe.route") as sp:
            if sp:
                sp.set(samples=x.shape[0], top_k=top_k, capacity=capacity)
            gate = self.gates[gate_index]
            logits = gate.apply(gate_params, x)
            logits_w_noise = logits
            if noise is not None:
                logits_w_noise = logits + gate.gate_noise * noise.to(
                    logits.dtype) / self.num_global_experts
            scores = torch.softmax(logits_w_noise, dim=1)
            if not with_loss:
                loss_fn = None
            elif self.is_gshard_loss:
                loss_fn = losses_ops.gshard_loss
            else:
                def loss_fn(s, topk_ids):
                    return losses_ops.load_importance_loss(
                        torch.softmax(logits, dim=1),
                        torch.gather(logits_w_noise, 1, topk_ids),
                        self.num_global_experts, gate.gate_noise)
            routed = routing_ops.extract_critical(
                scores, top_k, capacity=capacity, loss_fn=loss_fn,
                batch_prioritized_routing=self.batch_prioritized_routing,
                normalize_gate=self.normalize_gate, token_mask=token_mask)
            if sp:
                sp.set(scan_tiles=routing_ops.scan_tiles(routed[0].indices))
            return routed

    def _flat(self, x, reserve_dims):
        flat_m = 1
        for d in x.shape[-reserve_dims:]:
            flat_m *= int(d)
        return x.reshape(-1, flat_m).to(self.dtype)

    def _token_mask(self, valid_tokens, samples, device):
        """This rank's [samples] mask of valid rows, or None. A scalar is
        the global count over the packed batch (rank i owns rows
        [i*S, (i+1)*S)); a [world] vector gives each rank's count."""
        if valid_tokens is None:
            return None, samples
        vt = torch.as_tensor(valid_tokens).reshape(-1)
        if vt.numel() not in (1, self.world_size):
            raise ValueError(
                f"valid_tokens must be a scalar or a [world_size="
                f"{self.world_size}] vector, got {vt.numel()} values")
        with trace.sync("valid_tokens"):
            if vt.numel() == 1:
                n = int(vt[0]) - self.rank_index * samples
            else:
                n = int(vt[self.rank_index])
        n = min(max(n, 0), samples)
        return torch.arange(samples, device=device) < n, n

    def __call__(self, params, x, key=None, gate_index=0,
                 capacity_factor=None, top_k=None,
                 a2a_ffn_overlap_degree=None, reserve_dims=1,
                 inequivalent_tokens=False, valid_tokens=None,
                 adaptive_r=None, megablocks_size=0, training=False,
                 capacity_override=None, use_ragged_ep=False,
                 max_recv=None):
        """Forward pass of this rank's rows. Returns (output, l_aux).

        key: a torch.Generator for the training gate noise (None = the
        default generator). valid_tokens: a scalar count of valid rows of
        the global packed batch, or a [world] vector of each rank's count
        (the form `inequivalent_tokens=True` needs); padding rows take no
        expert slot, add nothing to l_aux and come out as zeros.
        a2a_ffn_overlap_degree and adaptive_r stay set for later calls, as
        in the JAX layer. use_ragged_ep: exchange only the routed rows
        (dropless pure expert parallelism over several ranks), into a
        receive buffer of max_recv rows (None: probed; rows past an
        explicit bound are dropped and come back as zeros).

        An expert-choice gate (`expert_choice = True`) takes C =
        capacity_override, else max(1, int(capacity_factor * N / E)) over
        the global pool of N = world * rows tokens (capacity_factor > 0),
        aligned and at most N; l_aux is the router z-loss.

        With SKIP_MOE=1 set at construction the layer is bypassed: it
        returns (result_func(x), 0). result_func, where given, maps the
        output of either path.
        """
        if self.skip_moe:
            out = self.result_func(x) if self.result_func else x
            return out, torch.zeros((), dtype=torch.float32, device=x.device)
        if inequivalent_tokens and valid_tokens is None:
            raise ValueError(
                "inequivalent_tokens=True: per-rank token counts differ, "
                "but no validity data was given; pass valid_tokens (a "
                "scalar global count or [world_size] per-rank counts) so "
                "padding rows are masked out.")
        gate = self.gates[gate_index]
        if a2a_ffn_overlap_degree is not None:
            self.a2a_ffn_overlap_degree = a2a_ffn_overlap_degree
        deg = self.a2a_ffn_overlap_degree
        top_k = min(int(top_k or gate.top_k), self.num_global_experts)
        if adaptive_r is not None:
            self.adaptive_degree = adaptive_r
        if self.adaptive_degree not in self.valid_rs:
            raise ValueError(f"adaptive_r={self.adaptive_degree} not within "
                             f"valid candidates {self.valid_rs}")
        w = self.world_size
        # megablocks narrows one device's local experts at inference
        if megablocks_size > 0 and (self.num_local_experts <= 1 or training
                                    or w > 1):
            megablocks_size = 0
        cf = capacity_factor if capacity_factor is not None \
            else gate.capacity_factor

        original_shape = x.shape
        if len(original_shape) < 2:
            raise ValueError("Input data must be at least 2D tensor: "
                             "(s)amples, .., (m)odel_dim")
        reserve_shape = original_shape[-reserve_dims:]
        x2 = self._flat(x, reserve_dims)
        samples = x2.shape[0]
        gate_params = self._gate_params(params, gate_index)

        alignment = self._alignment(deg, megablocks_size)
        noise = self._noise(gate_index, samples, training, key, x2.device)
        if use_ragged_ep and self._is_ec(gate_index):
            raise ValueError(
                "expert-choice routing has its own exactly-sized ragged "
                "exchange; use_ragged_ep does not apply")
        capacity = self._fixed_capacity(gate_index, samples, top_k, cf,
                                        capacity_override, megablocks_size,
                                        deg)
        if capacity is None:
            needed = self._count_needed(gate_params, x2, gate_index, top_k,
                                        noise)
            with trace.sync("capacity"):
                needed = int(needed)
            capacity = max(1, needed)
            if cf < 0:
                capacity = min(capacity, routing_ops.capped_capacity_limit(
                    samples, self.num_global_experts, top_k, cf))
            capacity = min(routing_ops.align_capacity(capacity, alignment),
                           routing_ops.align_capacity(top_k * samples,
                                                      alignment))

        ragged_max_recv = 0
        if use_ragged_ep:
            if not (w > 1 and self.sharded_count == 1):
                raise ValueError("ragged EP needs a multi-device pure-EP "
                                 "layout")
            if not (cf == 0 and valid_tokens is None
                    and megablocks_size == 0):
                raise ValueError("ragged EP is the dropless path "
                                 "(capacity_factor=0, no masking/megablocks)")
            if max_recv:
                ragged_max_recv = min(int(max_recv), routing_ops.
                                      align_capacity(w * top_k * samples, 128))
            else:
                ragged_max_recv = self._ragged_bound(gate_params, x2,
                                                     gate_index, top_k, noise)

        if self.auto_parallel and adaptive_r is None \
                and self.sharded_count > 1:
            # (:546-558) model-parallel when replicating the dispatched
            # activations r-fold costs less than regathering the weights
            local_param_numel = sum(
                v.numel() for v in params["experts"].values()
                if isinstance(v, torch.Tensor))
            y_numel = self.num_global_experts * capacity * x2.shape[1]
            use_mp = y_numel * (self.sharded_count - 1) * 2 \
                < local_param_numel
            self.adaptive_degree = self.sharded_count if use_mp else 1

        token_mask, n_valid = self._token_mask(valid_tokens, samples,
                                               x2.device)
        out, l_aux = self._forward(
            gate_params, params["experts"], x2, gate_index, top_k, capacity,
            self.adaptive_degree, training, noise, token_mask, n_valid,
            megablocks_size, ragged_max_recv)
        out = out.reshape(*original_shape[:-reserve_dims],
                          *reserve_shape[:-1], -1)
        if self.result_func is not None:
            out = self.result_func(out)
        return out, l_aux

    def _is_ec(self, gate_index):
        return bool(getattr(self.gates[gate_index], "expert_choice", False))

    def _gate_params(self, params, gate_index):
        """The gate's parameters; over a world their gradient is the sum
        over the ranks (a replicated input's)."""
        gate_params = params["gates"][gate_index]
        if self.world_size > 1 and torch.is_grad_enabled():
            gate_params = {k: net.allreduce_backward(v, self.world_group)
                           if v.requires_grad else v
                           for k, v in gate_params.items()}
        return gate_params

    def _ec_capacity(self, samples, cf, capacity_override, alignment):
        """Expert choice's C over the global pool of world * samples
        tokens (:491-514)."""
        num_samples = samples * self.world_size
        if capacity_override is not None:
            cap = int(capacity_override)
        else:
            if not cf > 0:
                raise ValueError("expert-choice needs capacity_factor > 0")
            cap = max(1, int(cf * num_samples / self.num_global_experts))
        return min(routing_ops.align_capacity(cap, alignment), num_samples)

    def _fixed_capacity(self, gate_index, samples, top_k, cf,
                        capacity_override, megablocks_size, deg):
        """The capacity no probe decides: expert choice's, an override's or
        capacity_factor > 0's, aligned (a token-choice one at most the
        top_k * samples rows); None for the dropless and capped rules."""
        alignment = self._alignment(deg, megablocks_size)
        if self._is_ec(gate_index):
            return self._ec_capacity(samples, cf, capacity_override,
                                     alignment)
        if capacity_override is not None:
            capacity = routing_ops.align_capacity(int(capacity_override),
                                                  alignment)
        elif cf > 0:
            capacity = self._static_capacity(samples, top_k, cf,
                                             megablocks_size, deg)
        else:
            return None
        return min(capacity, routing_ops.align_capacity(top_k * samples,
                                                        alignment))

    def _forward(self, gate_params, expert_params, x2, gate_index, top_k,
                 capacity, r, training, noise, token_mask, n_valid,
                 megablocks_size, ragged_max_recv):
        """The body at a resolved capacity and adaptive_r = r: routing,
        dispatch, experts, combine. Returns ([rows, O], l_aux)."""
        w = self.world_size
        if self._is_ec(gate_index):
            return self._ec_body(gate_params, expert_params, x2, gate_index,
                                 capacity, r, training, noise, token_mask)
        crit, l_aux = self._routing(gate_params, x2, gate_index, top_k,
                                    capacity, noise, token_mask)
        # dispatch_count and routed (the rows the experts get, a host
        # number the fused kernels plan from) describe this rank's own
        # routing; after the exchange the experts hold every rank's rows
        ctx = SimpleNamespace(
            megablocks_size=megablocks_size,
            dispatch_count=crit.dispatch_count if w == 1 else None,
            num_global_experts=self.num_global_experts,
            routed=top_k * n_valid if w == 1 else None, training=training,
            adaptive_degree=max(r, 1),
            sharded_count=self.sharded_count)
        if ragged_max_recv:
            from ..ops import ragged_ep
            out = ragged_ep.ragged_ep_forward(
                x2, crit, expert_params, self.experts.apply_grouped,
                self.world_group, ragged_max_recv,
                is_postscore=self.is_postscore, ctx=ctx, hier=self._hier())
        # one device, every token at every expert, nothing dropped: a
        # broadcast and a weighted sum take the place of the slot gathers
        elif w == 1 and top_k == self.num_global_experts \
                and capacity >= x2.shape[0] and megablocks_size == 0:
            with trace.span("tutel.moe.encode"):
                y = dispatch_ops.dense_encode(x2, crit, self.is_postscore)
            y = self._apply_experts(expert_params, y, ctx)
            with trace.span("tutel.moe.decode"):
                out = dispatch_ops.dense_decode(y, crit, self.is_postscore)
        else:
            with trace.span("tutel.moe.encode"):
                y = dispatch_ops.fast_encode(x2, crit, self.is_postscore)
            y = self._experts_body(expert_params, y, ctx, r)
            with trace.span("tutel.moe.decode"):
                out = dispatch_ops.fast_decode(y, crit, self.is_postscore)
        if w > 1:
            l_aux = net.simple_all_reduce(l_aux, self.world_group) / w
        return out, l_aux

    def _hier(self):
        """The (outer, inner) groups of the two-level exchange, or None."""
        if self._flat_2dh():
            return (self._hmesh.group("dcn"), self._hmesh.group("ici"))
        return None

    def _ec_body(self, gate_params, expert_params, x2, gate_index, capacity,
                 r, training, noise, token_mask):
        """The expert-choice flow (:972-1094): one rank routes, gathers,
        runs the experts and combines; over a world every rank all-gathers
        the [s, E] scores (and mask), takes the replicated top-C, and moves
        only the selected rows through the ragged exchange (expert slicing:
        the `sharded_count` ranks of an expert all receive them, and their
        partial or duplicate outputs sum on the token's owner). adaptive_r
        == 0 gathers the weights instead and computes the slots of this
        rank's own tokens: no activation crosses the wire. l_aux is the
        router z-loss over the valid tokens of the world."""
        from ..ops import expert_choice as ec_ops
        gate = self.gates[gate_index]
        e_global, w, sc = self.num_global_experts, self.world_size, \
            self.sharded_count
        logits = gate.apply(gate_params, x2)
        if noise is not None:
            logits = logits + gate.gate_noise * noise.to(logits.dtype) \
                / e_global
        scores = torch.softmax(logits, dim=1)
        e_local = e_global * sc // w if w > 1 else e_global
        ctx = SimpleNamespace(
            megablocks_size=0, num_global_experts=e_global,
            dispatch_count=torch.full((e_local,), capacity, dtype=torch.int32,
                                      device=x2.device),
            routed=None, training=training, adaptive_degree=max(r, 1),
            sharded_count=sc)
        if w == 1:
            ec = ec_ops.expert_choice_routing(scores, capacity, token_mask)
            y = ec_ops.ec_encode(x2, ec, self.is_postscore)
            y = self._apply_experts(expert_params, y, ctx)
            return (ec_ops.ec_decode(y, ec, x2.shape[0], self.is_postscore),
                    ec_ops.router_z_loss(logits, token_mask))

        expert_params = self._local_quant_view(expert_params)
        s, idx, group = x2.shape[0], self.rank_index, self.world_group
        mask_g = None
        if token_mask is not None:
            mask_g = net.simple_all_gather(token_mask.to(torch.int32),
                                           group).bool()
        ec = ec_ops.expert_choice_routing(
            net.simple_all_gather(scores, group), capacity, mask_g)
        if r == 0:
            # the weights gathered here: each rank computes the slots its
            # own tokens won; foreign slots take the zero pad row (id s)
            # with gate 0, and the combine drops them
            mine = (ec.indices // s) == idx
            loc = ec_ops.ECRouting(
                indices=torch.where(mine, ec.indices - idx * s,
                                    torch.full_like(ec.indices, s)),
                gates=torch.where(mine, ec.gates,
                                  torch.zeros_like(ec.gates)),
                capacity=ec.capacity)
            ctx.dispatch_count = torch.full((e_global,), capacity,
                                            dtype=torch.int32,
                                            device=x2.device)
            y = ec_ops.ec_encode(
                torch.cat([x2, x2.new_zeros((1, x2.shape[1]))]), loc,
                self.is_postscore)
            y = self._apply_experts(
                self._gather_expert_params(expert_params, 0), y, ctx)
            out = ec_ops.ec_decode(y, loc, s, self.is_postscore)
        else:
            plan = ec_ops.ec_ep_plan(ec.indices, idx, s, w, replicas=sc)
            row = idx // sc
            gates_local = ec.gates[row * e_local:(row + 1) * e_local]
            y = ec_ops.ec_ep_dispatch(x2, plan, group, e_local, ec.capacity,
                                      hier=self._hier())
            if not self.is_postscore:
                y = y * gates_local[..., None].to(y.dtype)
            eff = expert_params
            if sc > 1:
                eff = self._gather_expert_params(expert_params, r)
            y = self._apply_experts(eff, y, ctx)
            if self.is_postscore:
                y = y * gates_local[..., None].to(y.dtype)
            else:
                # dead slots (gate 0) must not send an expert's bias rows
                # to their tokens
                y = y * (gates_local[..., None] != 0).to(y.dtype)
            dup = sc // r
            if dup > 1:                   # g-fold duplicates count once
                y = y / dup
            out = ec_ops.ec_ep_combine(y, plan, s, group, hier=self._hier())
        zsum, zcnt = ec_ops.router_z_loss_parts(logits, token_mask)
        zsum = net.simple_all_reduce(zsum, group)
        zcnt = net.simple_all_reduce(zcnt.detach(), group)
        return out, zsum / torch.clamp(zcnt, min=1)

    def _apply_experts(self, expert_params, y, ctx):
        with trace.span("tutel.moe.experts") as sp:
            if sp:
                sp.set(experts=y.shape[0], capacity=y.shape[1],
                       routed=getattr(ctx, "routed", None),
                       model_dim=y.shape[-1],
                       hidden=getattr(self.experts, "hidden_size_per_expert",
                                      None),
                       bits=next((int(v.bits) for v in expert_params.values()
                                  if hasattr(v, "bits")),
                                 torch.finfo(y.dtype).bits))
            if self.remat_experts:
                # keep no expert activations for the backward; recompute them
                return torch.utils.checkpoint.checkpoint(
                    lambda p, t: self.experts.apply(p, t, ctx),
                    expert_params, y, use_reentrant=False)
            return self.experts.apply(expert_params, y, ctx)

    def _experts_body(self, expert_params, y, ctx, r):
        """The dispatched [E, C, M] buffer through the experts: here (one
        rank), after gathering the weights (r == 0), or across the world's
        exchange (:1126-1174)."""
        w = self.world_size
        if w == 1:
            return self._apply_experts(expert_params, y, ctx)
        expert_params = self._local_quant_view(expert_params)
        if r == 0:
            return self._apply_experts(
                self._gather_expert_params(expert_params, r), y, ctx)
        e_global, m = self.num_global_experts, y.shape[-1]
        if e_global < w:
            if r > 1:
                y = y.repeat(1, r, 1)
            y = y.reshape(w, -1, m)
        eff = expert_params
        if self.sharded_count > 1:
            eff = self._gather_expert_params(expert_params, r)
        deg = self.a2a_ffn_overlap_degree
        if deg > 1:
            # the chunked a2a / FFN pipeline: each chunk's exchange can
            # overlap another chunk's experts
            y = torch.cat([self._a2a(self._apply_experts(
                eff, self._a2a(c, 1, 0), ctx), 0, 1)
                for c in torch.chunk(y, deg, dim=1)], dim=1)
        else:
            y = self._a2a(self._apply_experts(eff, self._a2a(y, 1, 0), ctx),
                          0, 1)
        if e_global < w:
            y = y.reshape(e_global, r, -1, y.shape[-1])
            y = y.sum(dim=1) if r > 1 else y.reshape(e_global, -1,
                                                     y.shape[-1])
        return y

    def _a2a(self, t, in_dim, out_dim):
        """The world's exchange of the expert buffer, in `a2a_dtype` if
        set, flat or two-level."""
        ct = t if self.a2a_dtype is None else t.to(self.a2a_dtype)
        with trace.span("tutel.moe.a2a") as sp:
            if sp:
                sp.set(bytes=ct.numel() * ct.element_size())
            if self._flat_2dh():
                ct = net.all_to_all_2dh(ct, in_dim, out_dim,
                                        self._hmesh.group("dcn"),
                                        self._hmesh.group("ici"))
            else:
                ct = net.all_to_all(ct, in_dim, out_dim, self.world_group)
        return ct if self.a2a_dtype is None else ct.to(t.dtype)

    def _gather_expert_params(self, expert_params, r):
        """Regather this rank's expert shards for adaptive_r = r (:889-952):
        r == 0 gathers the global weights on every rank; under expert
        slicing r > 0 gathers the hidden shards over 'g' (to H/r a
        replica), and fc2_b whole, scaled by 1/r so the r partial sums add
        it once."""
        mesh = self._meshes[max(r, 1)]

        def gather(p, axes, dim):
            if mesh.size(axes) == 1:
                return p
            group = mesh.group(axes)
            if isinstance(p, FusedFFNStream):
                return dataclasses.replace(
                    p, wstream=net.simple_all_gather(p.wstream, group, dim),
                    sb=net.simple_all_gather(p.sb, group, dim))
            if isinstance(p, QuantizedWeight):
                scales = p.scales if p.scales.shape[dim] == 1 else \
                    net.simple_all_gather(p.scales, group, dim)
                # n K-slices of an INT4 weight make an n-block packing
                blocks = p.blocks * (mesh.size(axes) if p.bits == 4
                                     and dim == 1 else 1)
                return dataclasses.replace(
                    p, values=net.simple_all_gather(p.values, group, dim),
                    scales=scales, blocks=blocks)
            return net.simple_all_gather(p, group, dim)

        out = {}
        for name, p in expert_params.items():
            e_dim, s_dim = self._shard_axes.get(name, (0, None))
            if r == 0:
                if self.sharded_count > 1:
                    if s_dim is not None:
                        p = gather(gather(p, "g", s_dim), "r", s_dim)
                    p = gather(p, "e", e_dim)
                else:
                    p = gather(p, mesh_lib.MoeMesh.EP_AXES, e_dim)
            elif self.sharded_count > 1 and s_dim is not None:
                if name == "fc2_b":
                    p = gather(gather(p, "g", s_dim), "r", s_dim)
                    if r > 1:
                        p = p / r
                elif r < self.sharded_count:
                    p = gather(p, "g", s_dim)
            out[name] = p
        return out

    # -- dropless capacity ---------------------------------------------

    def _count_needed(self, gate_params, x2, gate_index, top_k, noise=None,
                      token_mask=None):
        """Tensor scalar: the most tokens any expert receives from any rank
        (the largest over the world: one all-reduce MAX)."""
        with torch.no_grad(), trace.span("tutel.moe.probe"):
            crit, _ = self._routing(gate_params, x2, gate_index, top_k, 1,
                                    noise, token_mask, with_loss=False)
            needed = routing_ops.required_capacity(crit.dispatch_count)
            if self.world_size > 1:
                needed = net.simple_all_reduce(
                    needed.reshape(1), self.world_group, op="max")[0]
        return needed

    def _ragged_bound(self, gate_params, x2, gate_index, top_k, noise=None,
                      slack=1.0):
        """The most rows any rank receives in the ragged exchange
        (:1365-1410), times slack, aligned to 128 and capped at the
        lossless worst case. One all-reduce sums the ranks' per-expert
        counts (a rank receives its experts' totals), one host sync reads
        the bound."""
        with torch.no_grad():
            crit, _ = self._routing(gate_params, x2, gate_index, top_k, 1,
                                    noise, with_loss=False)
            counts = crit.dispatch_count.to(torch.int64)
            if self.world_size > 1:
                counts = net.simple_all_reduce(counts, self.world_group)
            needed = int(counts.reshape(self.world_size, -1).sum(1).max())
        worst = routing_ops.align_capacity(
            self.world_size * top_k * x2.shape[0], 128)
        needed = int(max(needed, 1) * max(slack, 1.0))
        return min(routing_ops.align_capacity(needed, 128), worst)

    def resolve_max_recv(self, params, x, key=None, gate_index=0,
                         top_k=None, training=False, reserve_dims=1,
                         slack=1.0):
        """The ragged receive bound of this routing, aligned to 128, for
        `max_recv` (:1411-1438): x is this rank's rows; every rank calls
        it. The bound is exact for this routing only; for reuse across
        steps pass slack > 1 (the bound is multiplied, re-aligned and
        capped at the lossless worst case) or probe again, since rows past
        max_recv are dropped."""
        gate = self.gates[gate_index]
        top_k = min(int(top_k or gate.top_k), self.num_global_experts)
        x2 = self._flat(x, reserve_dims)
        return self._ragged_bound(
            params["gates"][gate_index], x2, gate_index, top_k,
            self._noise(gate_index, x2.shape[0], training, key, x2.device),
            slack)

    def resolve_capacity(self, params, x, key=None, gate_index=0, top_k=None,
                         training=False, reserve_dims=1,
                         a2a_ffn_overlap_degree=None, megablocks_size=0):
        """Dropless capacity of this input, aligned; pass it back as
        `capacity_override`."""
        gate = self.gates[gate_index]
        top_k = min(int(top_k or gate.top_k), self.num_global_experts)
        x2 = self._flat(x, reserve_dims)
        needed = int(self._count_needed(
            params["gates"][gate_index], x2, gate_index, top_k,
            self._noise(gate_index, x2.shape[0], training, key, x2.device)))
        return routing_ops.align_capacity(max(1, needed), self._alignment(
            a2a_ffn_overlap_degree or self.a2a_ffn_overlap_degree,
            megablocks_size))

    def count_needed_traceable(self, gate_index=0, top_k=None,
                               training=False):
        """fn(params, x2, key=None, token_mask=None) -> tensor scalar: the
        capacity the routing of x2 needs, computed on the device with no
        host sync (the serving engine checks a speculated capacity with
        it after the fact); over a world, the largest over the ranks."""
        gate = self.gates[gate_index]
        tk = min(int(top_k or gate.top_k), self.num_global_experts)

        def fn(params, x2, key=None, token_mask=None):
            return self._count_needed(
                params["gates"][gate_index], x2, gate_index, tk,
                self._noise(gate_index, x2.shape[0], training, key,
                            x2.device), token_mask)
        return fn

    # -- composing under an outer schedule ----------------------------

    def param_specs(self, params):
        """Where `shard_params` puts each parameter, as a tree shaped like
        `params` (:670-710): a tensor's leaf is a tuple with one entry per
        dim (trailing dims may be left out): None where the dim is whole,
        else the mesh axis, or the tuple of axes in mesh order, that the
        dim is split over ('e', 'r', 'g' of the layer's mesh, or 'dcn',
        'ici' under the two-level exchange); a `QuantizedWeight` gives
        such tuples for its values and its scales (a size-1 scale dim
        stays whole), a `FusedFFNStream` for its stream and scales
        (expert dim only). Gates are whole. One rank: everything whole.
        Hand the expert entries to a pipeline as `stage_param_specs` on a
        mesh that holds these axes."""
        def whole(v):
            if isinstance(v, FusedFFNStream):
                return dataclasses.replace(v, wstream=(), sb=())
            if isinstance(v, QuantizedWeight):
                return dataclasses.replace(v, values=(), scales=())
            if isinstance(v, dict):
                return {k: whole(u) for k, u in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(whole(u) for u in v)
            return ()
        if self.world_size == 1:
            return whole(params)
        ep_axes = ("dcn", "ici") if self._flat_2dh() else \
            mesh_lib.MoeMesh.EP_AXES
        sc = self.sharded_count

        def spec(name, ndim):
            e_dim, s_dim = self._shard_axes.get(name, (0, None))
            out = [None] * ndim
            if sc == 1:
                out[e_dim] = ep_axes
            else:
                out[e_dim] = "e"
                if s_dim is not None:
                    out[s_dim] = ("r", "g")
            return tuple(out)

        experts = {}
        for name, v in params["experts"].items():
            if isinstance(v, FusedFFNStream):
                if sc > 1:
                    raise ValueError(
                        "fused weight streams don't support expert-slicing "
                        "TP")
                experts[name] = dataclasses.replace(
                    v, wstream=(ep_axes,), sb=(ep_axes,))
                continue
            self._check_quant_sliceable(
                name, v, self._shard_axes.get(name, (0, None))[1])
            if isinstance(v, QuantizedWeight):
                vs = spec(name, v.values.ndim)
                experts[name] = dataclasses.replace(
                    v, values=vs, scales=tuple(
                        a if v.scales.shape[i] != 1 else None
                        for i, a in enumerate(vs[:v.scales.ndim])))
            else:
                experts[name] = spec(name, v.ndim)
        return {**whole(params), "experts": experts}

    def local_forward(self, gate_index=0, capacity_factor=None, top_k=None,
                      adaptive_r=None, training=False,
                      capacity_override=None):
        """The per-rank body, for composing the layer under an outer
        schedule such as a pipeline stage (:712-780). Returns
        fn(params_local, x_local, key=None) -> (out_local, l_aux): this
        rank's shard of the parameters (`shard_params`) and its rows
        [s, M] in, its rows out, as `__call__` with a capacity fixed by
        `capacity_factor` > 0 or `capacity_override` (an expert-choice
        gate's over the world's pool of s * W tokens). There is no
        dropless probe and no host sync of a capacity; adaptive_r (None:
        the layer's) holds for fn's calls only. As in JAX, the gradient of
        a replicated leaf (the gates) is this rank's part: the outer
        schedule sums it over the ranks that replicate it (the pipelines
        do, from `param_specs`)."""
        gate = self.gates[gate_index]
        tk = min(int(top_k or gate.top_k), self.num_global_experts)
        cf = capacity_factor if capacity_factor is not None \
            else gate.capacity_factor
        r = adaptive_r if adaptive_r is not None else self.adaptive_degree
        if r not in self.valid_rs:
            raise ValueError(f"adaptive_r={r} not within valid candidates "
                             f"{self.valid_rs}")
        if capacity_override is None and not cf > 0:
            raise ValueError(
                "expert-choice needs capacity_factor > 0"
                if self._is_ec(gate_index) else
                "local_forward needs a static capacity: pass "
                "capacity_factor > 0 or capacity_override")
        deg = self.a2a_ffn_overlap_degree

        def fn(params, x_local, key=None):
            x2 = x_local.to(self.dtype)
            samples = x2.shape[0]
            capacity = self._fixed_capacity(gate_index, samples, tk, cf,
                                            capacity_override, 0, deg)
            noise = self._noise(gate_index, samples, training, key,
                                x2.device)
            return self._forward(
                params["gates"][gate_index], params["experts"], x2,
                gate_index, tk, capacity, r, training, noise, None, samples,
                0, 0)
        return fn

    # -- checkpoint format ---------------------------------------------

    def get_parameter_iterator(self, params, param_type):
        if param_type == "gate":
            for gi, g in enumerate(params["gates"]):
                for n, p in g.items():
                    yield f"gates.{gi}.{n}", p
        elif param_type == "local_experts":
            for n, p in params["experts"].items():
                if n == "fused_stream":
                    continue       # derived data: re-prepare after a load
                yield f"experts.{n}", p
        else:
            raise ValueError(
                "Specified parameter type is not recognized: %s. Valid "
                "`param_type` includes: gate, local_experts." % param_type)

    def state_dict(self, params, prefix=""):
        """Flat {name: np.ndarray} with the `_num_global_experts` marker.
        bfloat16 tensors are stored as float32 (numpy has no bfloat16)."""
        def host(p):
            p = p.detach().cpu()
            return (p.float() if p.dtype == torch.bfloat16 else p).numpy()

        out = {prefix + "_num_global_experts":
               np.asarray(self.num_global_experts)}
        for kind in ("gate", "local_experts"):
            for n, p in self.get_parameter_iterator(params, kind):
                out[prefix + n] = host(p)
        return out

    def load_state_dict(self, params, state, prefix="", strict=False):
        """Tolerant load into a params dict: missing entries keep their
        values (with a warning), shape mismatches are resolved by a
        numel-preserving reshape."""
        marker = prefix + "_num_global_experts"
        if marker in state:
            ckpt_e = int(np.asarray(state[marker]))
            if ckpt_e != self.num_global_experts:
                raise ValueError(
                    f"Checkpoint has {ckpt_e} global experts, model expects "
                    f"{self.num_global_experts}.")
        elif strict:
            raise KeyError(marker)
        else:
            logging.warning(
                "Loading a legacy checkpoint without `_num_global_experts`.")

        def fill(name, p):
            key = prefix + name
            if key not in state:
                if strict:
                    raise KeyError(key)
                logging.warning("Missing checkpoint entry %s; keeping "
                                "initialized value.", key)
                return p
            v = to_tensor(state[key], p.device).to(p.dtype)
            if v.shape != p.shape:
                if v.numel() != p.numel():
                    raise ValueError(
                        f"Checkpoint entry {key} has {v.numel()} elements, "
                        f"expected {p.numel()}.")
                v = v.reshape(p.shape)
            return v

        out = {"gates": [], "experts": {}}
        for gi, g in enumerate(params["gates"]):
            out["gates"].append(
                {n: fill(f"gates.{gi}.{n}", p) for n, p in g.items()})
        out["experts"] = {n: fill(f"experts.{n}", p)
                          for n, p in params["experts"].items()}
        return out

    def extra_repr(self):
        return ("Top-K(s) = %s, Total-Experts = %d [managed by %d "
                "device(s)]," % (
                    [f"k={x.top_k}, noise={x.gate_noise}"
                     for x in self.gates],
                    self.num_global_experts, self.world_size))


moe_layer = MOELayer
