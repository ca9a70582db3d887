"""PyTorch + CUDA port of tutel_tpu (counterpart: tutel_tpu/__init__.py).

The JAX package `tutel_tpu` is the reference; this package keeps its
public vocabulary (`moe.moe_layer`, `serving.MoeDecodeEngine`, the ops),
its parameter names and layouts, and swaps every Pallas TPU kernel for a
hand-written CUDA kernel for Hopper (`csrc/*.cu`; `jit` compiles kernels
given at run time). Plain tensor code is PyTorch. Weights and inputs pass
between the two packages through NumPy (`convert.from_jax_params`).

This package never imports jax or tutel_tpu.
"""

from . import jit  # noqa: F401
from . import moe  # noqa: F401
from . import serving  # noqa: F401
