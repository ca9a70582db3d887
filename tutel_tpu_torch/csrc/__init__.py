"""CUDA sources of the port's kernels and `build.py`, which compiles them."""
