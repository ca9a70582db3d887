"""Cosine-similarity top-k gate (counterpart: tutel_tpu/gates/cosine_top.py).

Logits = cosine(proj(x), sim_matrix) * exp(clamp(temperature, max)).
`init(generator, dtype, device) -> params`, `apply(params, x) -> logits`
(float32); parameter names and layouts as in the JAX package.
"""

import dataclasses
import math
from typing import Any, Dict

import torch

from ..utils import initializers, matmul_f32, resolve_device


@dataclasses.dataclass
class CosineTopKGate:
    model_dim: int
    num_global_experts: int
    k: int = 1
    fp32_gate: bool = False
    proj_dim: int = 256
    init_t: float = 0.5
    capacity_factor: float = 1.0
    gate_noise: float = 0.0

    def __post_init__(self):
        self.top_k = min(self.num_global_experts, int(self.k))
        self.clamp_max = math.log(1.0 / 0.01)

    def init(self, generator=None, dtype=torch.float32,
             device="cuda") -> Dict[str, Any]:
        device = resolve_device(device)
        sim = torch.randn((self.proj_dim, self.num_global_experts),
                          generator=generator, device=device) * 0.01
        return {
            "temperature": torch.full([1], math.log(1.0 / self.init_t),
                                      dtype=torch.float32, device=device),
            "proj_w": initializers.linear_uniform(
                (self.model_dim, self.proj_dim), fan_in=self.model_dim,
                dtype=dtype, generator=generator, device=device),
            "proj_b": initializers.linear_uniform(
                (self.proj_dim,), fan_in=self.model_dim, dtype=dtype,
                generator=generator, device=device),
            "sim_matrix": sim.to(dtype),
        }

    def apply(self, params, x):
        proj_w, sim_matrix = params["proj_w"], params["sim_matrix"]
        bias = params["proj_b"]
        if self.fp32_gate:
            x, proj_w, sim_matrix, bias = (
                t.float() for t in (x, proj_w, sim_matrix, bias))
        proj = matmul_f32(x.to(proj_w.dtype), proj_w) + bias
        # L2-normalize the rows of the projection and the columns of
        # sim_matrix
        proj = proj / torch.clamp(
            torch.linalg.vector_norm(proj, dim=1, keepdim=True), min=1e-12)
        sim = sim_matrix / torch.clamp(
            torch.linalg.vector_norm(sim_matrix, dim=0, keepdim=True),
            min=1e-12)
        logits = matmul_f32(proj, sim.to(proj.dtype))
        logit_scale = torch.exp(torch.clamp(
            params["temperature"].float(), max=self.clamp_max))
        return logits * logit_scale


Gate = CosineTopKGate
