"""The MoE layer on one device, inference and training
(counterpart: tutel_tpu/impls/moe_layer.py).

Same calling convention as the JAX layer: `params = layer.init(...)`,
`out, l_aux = layer(params, x, ...)`. Ported: construction and
`global_expert_count` (:77), `init`, the forward with per-call
`capacity_factor` (padded > 0, dropless == 0, capped < 0), `top_k`,
`capacity_override`, scalar `valid_tokens` and `megablocks_size`, the
alignment and static capacity math (:376-395), `resolve_capacity` (:649),
`count_needed_traceable` (:1264, world size 1) and `state_dict` /
`load_state_dict` (:1444-1500).

Training (`training=True`) runs under autograd: the gate noise is drawn
from the `key` Generator (once a call, shared by the dropless capacity
probe and the routing), the dispatch backward is `ops.dispatch`'s, the
gradient of `l_aux` reaches the gate through the scores, megablocks is
off, and `remat_experts=True` recomputes the experts' activations in the
backward (`torch.utils.checkpoint`, as `jax.checkpoint`). When every token
routes to every expert (top_k == E) and nothing is dropped, the layer
takes the dense dispatch (`ops.dispatch.dense_encode` / `dense_decode`),
as the JAX layer does on one device (:592-605).

The JAX layer caches one compiled variant per static configuration; eager
PyTorch switches between configurations per call with no cache. Dropless
capacity is read from a routing probe with one host sync, as in the JAX
layer outside a jit. Expert parallelism belongs to a later slice.
"""

import logging
import math
import re
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch

from .. import experts as experts_registry
from .. import gates as gates_registry
from ..convert import to_tensor
from ..ops import dispatch as dispatch_ops
from ..ops import losses as losses_ops
from ..ops import routing as routing_ops
from ..utils import resolve_device


def _lcm(a, b):
    return a * b // math.gcd(a, b)


class MOELayer:
    """Tutel-capability MoE layer, PyTorch on one device."""

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

    def __init__(self, gate_type, model_dim: int, experts=None, seeds=None,
                 is_postscore=True, batch_prioritized_routing=False,
                 normalize_gate=True, is_gshard_loss=True,
                 dtype=torch.float32, capacity_bucket: int = 0,
                 remat_experts=False, device="cuda", **kwargs):
        if model_dim % 2:
            raise ValueError("model_dim must be even, got %s" % model_dim)
        for k in kwargs:
            raise TypeError(
                "MOELayer got an unrecognized constructor argument: %s" % k)
        self.device = resolve_device(device)
        self.model_dim = model_dim
        self.is_postscore = is_postscore
        self.batch_prioritized_routing = batch_prioritized_routing
        self.normalize_gate = normalize_gate
        self.is_gshard_loss = is_gshard_loss
        self.dtype = dtype
        self.capacity_bucket = capacity_bucket
        self.remat_experts = remat_experts
        self.seeds = seeds

        experts = dict(experts or {})
        self.num_local_experts = experts.pop(
            "count_per_node", experts.pop("num_experts_per_device", 1))
        if self.num_local_experts == -1:
            self.num_local_experts = 1
        self.num_global_experts = MOELayer.global_expert_count(
            self.num_local_experts)
        experts_type = experts.pop("type")
        expert_cls = (experts.pop("module") if experts_type == "custom"
                      else experts_registry.resolve(experts_type))
        self.experts = expert_cls(
            model_dim=self.model_dim,
            num_experts_per_device=self.num_global_experts, **experts)

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

    # -- parameters ----------------------------------------------------

    def init(self, generator=None) -> Dict[str, Any]:
        """Parameters on the layer's device. Without a generator, the gate
        and expert weights come from generators seeded by `seeds`."""
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
        return {"gates": gate_params, "experts": expert_params}

    # -- capacity math -------------------------------------------------

    def _alignment(self, megablocks_size):
        alignment = max(megablocks_size, 1)
        if alignment > 256:
            alignment = (alignment + 127) // 128 * 128
        if self.capacity_bucket:
            alignment = _lcm(alignment, self.capacity_bucket)
        return alignment

    def _static_capacity(self, samples, top_k, capacity_factor,
                         megablocks_size):
        return routing_ops.compute_static_capacity(
            samples, self.num_global_experts, top_k, capacity_factor,
            alignment=self._alignment(megablocks_size))

    # -- forward -------------------------------------------------------

    def _draw_noise(self, shape, key, device):
        """The training gate noise: standard normal float32 values drawn
        from `key` (a torch.Generator; None = the default generator)."""
        return torch.randn(shape, generator=key, device=device,
                           dtype=torch.float32)

    def _noise(self, gate_index, samples, training, key, device):
        """This call's gate noise [samples, E], or None."""
        if not (training and self.gates[gate_index].gate_noise > 0):
            return None
        return self._draw_noise((samples, self.num_global_experts), key,
                                device)

    def _routing(self, gate_params, x, gate_index, top_k, capacity,
                 noise=None, token_mask=None, with_loss=True):
        """logits -> (noised) scores -> extract_critical."""
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
        return routing_ops.extract_critical(
            scores, top_k, capacity=capacity, loss_fn=loss_fn,
            batch_prioritized_routing=self.batch_prioritized_routing,
            normalize_gate=self.normalize_gate, token_mask=token_mask)

    def _flat(self, x, reserve_dims):
        flat_m = 1
        for d in x.shape[-reserve_dims:]:
            flat_m *= int(d)
        return x.reshape(-1, flat_m).to(self.dtype)

    def __call__(self, params, x, key=None, gate_index=0,
                 capacity_factor=None, top_k=None, reserve_dims=1,
                 valid_tokens=None, megablocks_size=0, training=False,
                 capacity_override=None):
        """Forward pass. Returns (output, l_aux).

        key: a torch.Generator for the training gate noise (None = the
        default generator). valid_tokens: rows [0, n) of the flattened
        input are tokens, the tail is padding that takes no expert slot,
        adds nothing to l_aux and comes out as zeros.
        """
        gate = self.gates[gate_index]
        top_k = min(int(top_k or gate.top_k), self.num_global_experts)
        if megablocks_size > 0 and (self.num_local_experts <= 1 or training):
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
        gate_params = params["gates"][gate_index]

        alignment = self._alignment(megablocks_size)
        noise = self._noise(gate_index, samples, training, key, x2.device)
        if capacity_override is not None:
            capacity = routing_ops.align_capacity(int(capacity_override),
                                                  alignment)
        elif cf > 0:
            capacity = self._static_capacity(samples, top_k, cf,
                                             megablocks_size)
        else:
            needed = int(self._count_needed(gate_params, x2, gate_index,
                                            top_k, noise))
            capacity = max(1, needed)
            if cf < 0:
                capacity = min(capacity, routing_ops.capped_capacity_limit(
                    samples, self.num_global_experts, top_k, cf))
            capacity = routing_ops.align_capacity(capacity, alignment)
        capacity = min(capacity, routing_ops.align_capacity(
            top_k * samples, alignment))

        token_mask = None
        if valid_tokens is not None:
            vt = torch.as_tensor(valid_tokens).reshape(-1)
            if vt.numel() != 1:
                raise ValueError("valid_tokens must be a scalar on one "
                                 f"device, got {vt.numel()} values")
            token_mask = (torch.arange(samples, device=x2.device)
                          < int(vt[0]))

        crit, l_aux = self._routing(gate_params, x2, gate_index, top_k,
                                    capacity, noise, token_mask)
        # routed: the rows the experts get, known on the host (the fused
        # kernels plan their grid from it; the counts lie on the device)
        routed = top_k * (samples if valid_tokens is None
                          else min(samples, int(vt[0])))
        ctx = SimpleNamespace(megablocks_size=megablocks_size,
                              dispatch_count=crit.dispatch_count,
                              num_global_experts=self.num_global_experts,
                              routed=routed, training=training)
        # every token at every expert, nothing dropped: a broadcast and a
        # weighted sum take the place of the slot gathers
        dense = (top_k == self.num_global_experts and capacity >= samples
                 and megablocks_size == 0)
        encode, decode = ((dispatch_ops.dense_encode,
                           dispatch_ops.dense_decode) if dense else
                          (dispatch_ops.fast_encode,
                           dispatch_ops.fast_decode))
        y = encode(x2, crit, self.is_postscore)
        y = self._apply_experts(params["experts"], y, ctx)
        out = decode(y, crit, self.is_postscore)
        out = out.reshape(*original_shape[:-reserve_dims],
                          *reserve_shape[:-1], -1)
        return out, l_aux

    def _apply_experts(self, expert_params, y, ctx):
        if self.remat_experts:
            # keep no expert activations for the backward; recompute them
            return torch.utils.checkpoint.checkpoint(
                lambda p, t: self.experts.apply(p, t, ctx), expert_params, y,
                use_reentrant=False)
        return self.experts.apply(expert_params, y, ctx)

    # -- dropless capacity ---------------------------------------------

    def _count_needed(self, gate_params, x2, gate_index, top_k, noise=None,
                      token_mask=None):
        """Tensor scalar: the most tokens any expert receives."""
        with torch.no_grad():
            crit, _ = self._routing(gate_params, x2, gate_index, top_k, 1,
                                    noise, token_mask, with_loss=False)
        return routing_ops.required_capacity(crit.dispatch_count)

    def resolve_capacity(self, params, x, key=None, gate_index=0, top_k=None,
                         training=False, reserve_dims=1, megablocks_size=0):
        """Dropless capacity of this input, aligned; pass it back as
        `capacity_override`."""
        gate = self.gates[gate_index]
        top_k = min(int(top_k or gate.top_k), self.num_global_experts)
        x2 = self._flat(x, reserve_dims)
        needed = int(self._count_needed(
            params["gates"][gate_index], x2, gate_index, top_k,
            self._noise(gate_index, x2.shape[0], training, key, x2.device)))
        return routing_ops.align_capacity(max(1, needed),
                                          self._alignment(megablocks_size))

    def count_needed_traceable(self, gate_index=0, top_k=None,
                               training=False):
        """fn(params, x2, key=None, token_mask=None) -> tensor scalar: the
        capacity the routing of x2 needs, computed on the device with no
        host sync (the serving engine checks a speculated capacity with
        it after the fact)."""
        gate = self.gates[gate_index]
        tk = min(int(top_k or gate.top_k), self.num_global_experts)

        def fn(params, x2, key=None, token_mask=None):
            return self._count_needed(
                params["gates"][gate_index], x2, gate_index, tk,
                self._noise(gate_index, x2.shape[0], training, key,
                            x2.device), token_mask)
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


moe_layer = MOELayer
