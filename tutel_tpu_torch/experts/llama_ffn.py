"""Llama-style SwiGLU expert (counterpart: tutel_tpu/experts/llama_ffn.py).

y = (silu(x @ W1) * (x @ W2)) @ W3 per expert, batched over the local
experts; W1, W2 [E, M, H], W3 [E, H, M], no biases. Float weights run
three batched products accumulated in float32 and rounded to x's dtype,
as the JAX einsums with `preferred_element_type=jnp.float32` do.
Quantized weights (`ops.quant.QuantizedWeight`) run the fused kernel K4
(`ops.fused_ffn.fused_swiglu_quant`) when the params carry a stream, and
three calls of kernel K1 (`ops.grouped_gemm_quant.grouped_gemm_quant`)
otherwise, narrowed to ctx.dispatch_count rows per expert.

The JAX expert's `TUTEL_TPU_GMM_BN` knob and its VMEM gate in front of
the fused kernel were TPU devices and are not ported: K4 runs at every
capacity whose row tile fits the card's shared memory. Under expert
slicing (`sharded_count` > 1) the MoE layer slices w1 and w2 on their
hidden dim (2) and w3 on its contraction dim (1) and regathers them for
its adaptive r (`impls.moe_layer.SHARD_AXES`); `init` makes the global
weights and `apply` follows the shapes it is given.
"""

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..ops.activations import silu
from ..ops.fused_ffn import fused_swiglu_quant
from ..ops.grouped_gemm_quant import grouped_gemm_quant
from ..ops.quant import QuantizedWeight
from ..utils import matmul_f32, resolve_device
from .ffn import refuse_training


@dataclasses.dataclass
class LlamaFFNNetwork:
    model_dim: int
    hidden_size_per_expert: int
    num_experts_per_device: int = 1
    sharded_count: int = 1
    activation_fn: Callable = silu
    has_fc1_bias: bool = False
    has_fc2_bias: bool = False

    def __post_init__(self):
        self.hidden_size = self.hidden_size_per_expert
        self.output_dim = self.model_dim

    def init(self, generator=None, dtype=torch.float32,
             device="cuda") -> Dict[str, Any]:
        """N(0, 0.01^2) weights drawn in float32 from `generator` (on
        `device`), then cast to `dtype`."""
        device = resolve_device(device)
        e, m, h = (self.num_experts_per_device, self.model_dim,
                   self.hidden_size_per_expert)

        def normal(shape):
            return (torch.randn(shape, generator=generator, device=device)
                    * 0.01).to(dtype)

        return {"w1": normal((e, m, h)), "w2": normal((e, m, h)),
                "w3": normal((e, h, m))}

    def apply(self, params, x, ctx=None):
        """x: [E, rows, M] -> [E, rows, M]."""
        if isinstance(params["w1"], QuantizedWeight):
            refuse_training(ctx)
            return self._apply_quantized(params, x, ctx)
        w1, w2, w3 = (params[k].to(x.dtype) for k in ("w1", "w2", "w3"))
        y1 = matmul_f32(x, w1).to(x.dtype)
        y2 = matmul_f32(x, w2).to(x.dtype)
        y = self.activation_fn(y1) * y2
        return matmul_f32(y, w3).to(x.dtype)

    def _apply_quantized(self, params, x, ctx=None):
        """Weight-only INT8/INT4: K4 over the fused stream, else three K1
        calls with silu(y1) * y2 in x's dtype between them."""
        counts = getattr(ctx, "dispatch_count", None) if ctx else None
        routed = getattr(ctx, "routed", None)
        stream = params.get("fused_stream")
        if stream is not None:
            return fused_swiglu_quant(x, stream, counts,
                                      activation_fn=self.activation_fn,
                                      routed=routed)
        y1 = grouped_gemm_quant(x, params["w1"], counts, routed=routed)
        y2 = grouped_gemm_quant(x, params["w2"], counts, routed=routed)
        y = self.activation_fn(y1) * y2
        return grouped_gemm_quant(y, params["w3"], counts, routed=routed)


ExpertModule = LlamaFFNNetwork
