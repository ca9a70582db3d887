"""CUDA sources of the port's kernels and `build.py`, which compiles them;
the host native library `dispatch_cpu.cpp` and `native.py`, which builds
it with g++ and wraps it (the names of tutel_tpu/csrc/__init__.py)."""

from .native import (available, cumsum_locations,  # noqa: F401
                     dispatch_backward_data, dispatch_backward_gate,
                     dispatch_forward, lib, sample_windows)
