"""Elastic checkpointing: save/load and offline world-size mutation
(counterpart: tutel_tpu/checkpoint/). NumPy only: the files are the JAX
package's, byte for byte in layout."""

from . import serial, reshard  # noqa: F401
from .serial import save_state, load_state  # noqa: F401
from .reshard import gather_states, scatter_state  # noqa: F401
