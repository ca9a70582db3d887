"""Linear top-k gate (counterpart: tutel_tpu/gates/top.py).

`init(generator, dtype, device) -> params`, `apply(params, x) -> logits`.
`wg` is stored [M, E] (input-major), as in the JAX package.
"""

import dataclasses
import os
from typing import Any, Dict

import torch

from ..utils import initializers, resolve_device


@dataclasses.dataclass
class LinearTopKGate:
    model_dim: int
    num_global_experts: int
    k: int = 1
    fp32_gate: bool = False
    capacity_factor: float = None
    gate_noise: float = 0.0

    def __post_init__(self):
        self.top_k = min(self.num_global_experts, int(self.k))
        if self.capacity_factor is None:
            self.capacity_factor = float(os.environ.get("CAP_FACTOR", 1.0))

    def init(self, generator=None, dtype=torch.float32,
             device="cuda") -> Dict[str, Any]:
        device = resolve_device(device)
        wg_dtype = torch.float32 if self.fp32_gate else dtype
        return {"wg": initializers.linear_uniform(
            (self.model_dim, self.num_global_experts), fan_in=self.model_dim,
            dtype=wg_dtype, generator=generator, device=device)}

    def apply(self, params, x):
        """Logits in float32: x is cast to wg's dtype, then both are
        multiplied in float32 (exact products for bfloat16 inputs, as the
        JAX gate's preferred_element_type=float32 matmul)."""
        wg = params["wg"]
        if self.fp32_gate:
            wg = wg.float()
        x = x.to(wg.dtype)
        return x.float() @ wg.float()


Gate = LinearTopKGate
