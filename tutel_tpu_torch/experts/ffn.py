"""Batched per-expert two-layer FFN (counterpart: tutel_tpu/experts/ffn.py:28-129).

Weights are input-major as in the JAX package: fc1_w [E, M, H],
fc2_w [E, H, O]. Float weights run two batched matmuls (`torch.bmm`, as
the JAX package leaves these to XLA); quantized weights
(`ops.quant.QuantizedWeight`) run `ops.grouped_gemm_quant.quantized_ffn`,
which launches the CUDA kernels K2 or K1 for CUDA tensors, or, with
`activation_bits=8` (W8A8 / W4A8), `ops.w8a8.w8a8_ffn`, which launches K3
or K5. Float weights ignore `activation_bits`, as in the JAX package;
with `ctx.megablocks_size > 0` they take the dropless grouped-GEMM branch
(`ops.grouped_gemm.megablocks_ffn`). The default activation is relu.

`apply_grouped` is the flavour the ragged expert-parallel path calls
(`ops.ragged_ep`; counterpart: tutel_tpu/experts/ffn.py:131-191): rows
[N, M] grouped contiguously by local expert. Float weights run
`ops.grouped_gemm` per layer; quantized weights gather the rows once into
the dense [E, c_max, M] view (`ops.ragged`), run `quantized_ffn` over it
(K2 when the params carry a fused stream that covers the output width,
else K1 twice, each narrowed to the groups' rows) and gather back once:
the numbers of JAX's `grouped_gemm_quant_ragged` /
`fused_ffn_quant_ragged` per layer. A group keeps at most
`ctx.ragged_c_max` rows (default: all N, JAX's rule).

`sharded_count` is the number of ranks that slice one expert's hidden
dim (expert-slicing tensor parallelism); it must divide the hidden size.
`init` always makes the global parameters; `apply` follows the shapes it
is given.

The float path trains under autograd. Quantized weights are for
inference only: a call with `ctx.training` raises (the JAX package's
Pallas calls have no gradient either).
"""

import dataclasses
import types
from typing import Any, Callable, Dict, Optional

import torch

from ..ops.activations import relu
from ..ops.grouped_gemm import (grouped_bias_add, grouped_gemm,
                                megablocks_ffn)
from ..ops.grouped_gemm_quant import quantized_ffn
from ..ops.quant import QuantizedWeight
from ..ops.ragged import dense_to_ragged, ragged_starts, ragged_to_dense
from ..ops.w8a8 import w8a8_ffn
from ..utils import initializers, resolve_device


@dataclasses.dataclass
class FusedExpertsNetwork:
    model_dim: int
    hidden_size_per_expert: int
    num_experts_per_device: int = 1
    sharded_count: int = 1
    activation_fn: Optional[Callable] = None
    output_dim: Optional[int] = None
    has_fc1_bias: bool = True
    has_fc2_bias: bool = True
    activation_bits: int = 0       # 8 = W8A8 integer-domain GEMMs

    def __post_init__(self):
        if self.hidden_size_per_expert % self.sharded_count:
            raise ValueError(
                f"Can't evenly divide hidden_size_per_expert "
                f"({self.hidden_size_per_expert}) to {self.sharded_count} "
                f"slices.")
        self.output_dim = self.output_dim or self.model_dim
        if self.activation_fn is None:
            self.activation_fn = relu

    def init(self, generator=None, dtype=torch.float32,
             device="cuda") -> Dict[str, Any]:
        device = resolve_device(device)
        e, m, h, o = (self.num_experts_per_device, self.model_dim,
                      self.hidden_size_per_expert, self.output_dim)

        def uniform(shape, fan_in):
            return initializers.linear_uniform(
                shape, fan_in=fan_in, dtype=dtype, generator=generator,
                device=device)

        params = {"fc1_w": uniform((e, m, h), m),
                  "fc2_w": uniform((e, h, o), h)}
        if self.has_fc1_bias:
            params["fc1_b"] = uniform((e, h), m)
        if self.has_fc2_bias:
            params["fc2_b"] = uniform((e, o), h)
        return params

    def apply(self, params, x, ctx=None):
        """x: [E, rows, M] -> [E, rows, output_dim]."""
        fc1_w, fc2_w = params["fc1_w"], params["fc2_w"]
        if isinstance(fc1_w, QuantizedWeight):
            refuse_training(ctx)
            ffn = w8a8_ffn if self.activation_bits == 8 else quantized_ffn
            return ffn(x, params, ctx, activation_fn=self.activation_fn,
                       output_dim=self.output_dim)
        if getattr(ctx, "megablocks_size", 0) > 0:
            return megablocks_ffn(x, params, ctx, self.activation_fn,
                                  self.output_dim)
        fc1_b, fc2_b = params.get("fc1_b"), params.get("fc2_b")
        y = torch.bmm(x, fc1_w.to(x.dtype))
        if fc1_b is not None:
            y = y + fc1_b.to(y.dtype)[:, None, :]
        y = self.activation_fn(y)
        y = torch.bmm(y, fc2_w.to(y.dtype))
        if fc2_b is not None:
            bias = fc2_b.to(y.dtype)[:, None, :]
            if bias.shape[-1] != self.output_dim:
                bias = torch.nn.functional.pad(
                    bias, (0, self.output_dim - bias.shape[-1]))
            y = y + bias
        return y

    def apply_grouped(self, params, rows, group_sizes, ctx=None):
        """rows [N, M] grouped by local expert (group_sizes [E]) ->
        [N, output_dim]; rows past sum(group_sizes) take no expert."""
        fc1_w, fc2_w = params["fc1_w"], params["fc2_w"]
        if isinstance(fc1_w, QuantizedWeight):
            refuse_training(ctx)
            # one dense [E, c_max, M] view for both layers: quantized_ffn
            # runs K2 over a fused stream, else K1 twice, on each group's
            # rows; the quantized ragged path ignores activation_bits, as
            # in JAX
            n = rows.shape[0]
            c_max = int(getattr(ctx, "ragged_c_max", 0) or n)
            gs, starts = ragged_starts(group_sizes)
            view = types.SimpleNamespace(
                dispatch_count=torch.clamp(gs, max=c_max), routed=n)
            y = quantized_ffn(ragged_to_dense(rows, gs, starts, c_max),
                              params, view, self.activation_fn,
                              self.output_dim)
            return dense_to_ragged(y, gs, starts, c_max, n)
        y = grouped_gemm(rows, fc1_w, group_sizes)
        if params.get("fc1_b") is not None:
            y = grouped_bias_add(y, params["fc1_b"], group_sizes)
        y = grouped_gemm(self.activation_fn(y), fc2_w, group_sizes)
        if params.get("fc2_b") is not None:
            bias = params["fc2_b"]
            if bias.shape[-1] != self.output_dim:
                bias = torch.nn.functional.pad(
                    bias, (0, self.output_dim - bias.shape[-1]))
            y = grouped_bias_add(y, bias, group_sizes)
        return y


ExpertModule = FusedExpertsNetwork


def refuse_training(ctx):
    """Raise for a training call (`ctx.training`) on quantized weights."""
    if getattr(ctx, "training", False):
        raise ValueError(
            "quantized expert weights are inference-only: their kernels "
            "have no backward; train with float weights and quantize "
            "after")
