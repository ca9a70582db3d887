"""Public MoE facade (counterpart: tutel_tpu/moe.py)."""

from .impls.moe_layer import moe_layer, MOELayer  # noqa: F401
from .ops.routing import extract_critical, RoutingResult  # noqa: F401
from .ops.dispatch import fast_encode, fast_decode  # noqa: F401
