"""Expert activations, and their codes in the CUDA kernels.

`gelu` is the tanh approximation, as `jax.nn.gelu` computes by default;
`silu` is x * sigmoid(x), as `jax.nn.silu` computes. A kernel takes an
activation as a code; `kernel_code` raises for any other callable, so a
CUDA call never silently runs another function.
"""

import torch


def relu(x):
    return torch.relu(x)


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def silu(x):
    return x * torch.sigmoid(x)


_KERNEL_CODES = {relu: 0, torch.relu: 0, torch.nn.functional.relu: 0,
                 gelu: 1, silu: 2}


def kernel_code(fn):
    """0 for relu, 1 for tanh-gelu, 2 for silu; ValueError for anything
    else."""
    code = _KERNEL_CODES.get(fn)
    if code is None:
        raise ValueError(
            f"activation {fn!r} has no CUDA kernel; use "
            "tutel_tpu_torch.ops.activations.relu, .gelu or .silu")
    return code
