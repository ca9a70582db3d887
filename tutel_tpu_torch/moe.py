"""Public MoE facade (counterpart: tutel_tpu/moe.py)."""

from .impls.moe_layer import moe_layer, MOELayer  # noqa: F401
from .ops.routing import extract_critical, RoutingResult  # noqa: F401
from .ops.routing import cumsum_sub_one as fast_cumsum_sub_one  # noqa: F401
from .ops.dispatch import fast_encode, fast_decode  # noqa: F401
from .ops.dispatch import fast_dispatcher, TutelMoeFastDispatcher  # noqa: F401
from .ops.expert_choice import (  # noqa: F401
    expert_choice_routing, ec_encode, ec_decode, router_z_loss)


def top_k_routing(scores, top_k, capacity, **kwargs):
    """Alias of `extract_critical` (the reference exports it under this
    name)."""
    return extract_critical(scores, top_k, capacity, **kwargs)
