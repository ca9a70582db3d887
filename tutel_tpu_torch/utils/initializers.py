"""Parameter initializers (counterpart: tutel_tpu/utils/initializers.py).

Same distributions as the JAX module, drawn from an explicit
`torch.Generator`. The bits differ from `jax.random`'s, so parity with
the JAX package goes through weight conversion (`convert.from_jax_params`),
not through seeds.
"""

import math

import torch


def linear_uniform(shape, fan_in, dtype=torch.float32, generator=None,
                   device="cpu"):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): the standard Linear weight/bias
    init (kaiming-uniform with a=sqrt(5) collapses to this bound). Drawn in
    float32, then cast to `dtype`. The generator must live on `device`."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return (u * (2.0 * bound) - bound).to(dtype)


def normal(shape, std=0.01, dtype=torch.float32, generator=None,
           device="cpu"):
    """N(0, std^2), drawn in float32, then cast to `dtype`. The generator
    must live on `device`."""
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * std).to(dtype)
