"""PyTorch + CUDA port of tutel_tpu (counterpart: tutel_tpu/__init__.py).

The JAX package `tutel_tpu` is the reference; this package keeps its
public vocabulary (`moe.moe_layer`, `serving.MoeDecodeEngine`, the ops),
its parameter names and layouts, and swaps every Pallas TPU kernel for a
hand-written CUDA kernel for Hopper (`csrc/*.cu`; `jit` compiles kernels
given at run time). Plain tensor code is PyTorch. Weights and inputs pass
between the two packages through NumPy (`convert.from_jax_params`).
Expert parallelism runs over `torch.distributed` process groups
(`system`, `net`, `parallel.mesh`), one process a rank.

This package never imports jax or tutel_tpu.
"""

from . import system  # noqa: F401  (session and process-group bootstrap)
from . import jit  # noqa: F401
from . import moe  # noqa: F401
from . import net  # noqa: F401
from . import serving  # noqa: F401
