"""Expert-choice gate (counterpart: tutel_tpu/gates/expert_choice.py).

A linear router whose selection runs expert-side: each expert picks its
top-C tokens (C = capacity_factor * S / E over the layer's global token
pool). Besides the token-choice gates' protocol fields (top_k, gate_noise,
capacity_factor) it carries `expert_choice = True`, which switches
`MOELayer` into the expert-choice flow (`ops.expert_choice`): gather,
experts, segment-sum combine, router z-loss as the auxiliary.
"""

import dataclasses
from typing import Any, Dict

import torch

from ..utils import initializers, resolve_device


@dataclasses.dataclass
class ExpertChoiceGate:
    model_dim: int
    num_global_experts: int
    capacity_factor: float = 2.0     # average experts a token (C * E / S)
    fp32_gate: bool = False
    gate_noise: float = 0.0
    k: int = 1                       # accepted for config compatibility;
                                     # the selection ignores it
    expert_choice = True             # switches MOELayer to the EC flow
    top_k = 1                        # protocol filler; unused in EC

    def init(self, generator=None, dtype=torch.float32,
             device="cuda") -> Dict[str, Any]:
        device = resolve_device(device)
        wg_dtype = torch.float32 if self.fp32_gate else dtype
        return {"wg": initializers.linear_uniform(
            (self.model_dim, self.num_global_experts), fan_in=self.model_dim,
            dtype=wg_dtype, generator=generator, device=device)}

    def apply(self, params, x):
        """Logits in float32 (x cast to wg's dtype, the product in
        float32, as the JAX gate's preferred_element_type=float32)."""
        wg = params["wg"]
        if self.fp32_gate:
            wg = wg.float()
        x = x.to(wg.dtype)
        return x.float() @ wg.float()


Gate = ExpertChoiceGate
