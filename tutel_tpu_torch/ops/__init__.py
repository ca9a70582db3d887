"""Core MoE compute ops (counterpart: tutel_tpu/ops/__init__.py): routing,
dispatch, losses, quantization and the quantized expert-FFN kernels."""

from . import losses  # noqa: F401
from . import routing  # noqa: F401
from . import dispatch  # noqa: F401
from . import quant  # noqa: F401
from .routing import extract_critical, RoutingResult  # noqa: F401
from .dispatch import fast_encode, fast_decode  # noqa: F401
from .losses import gshard_loss, load_importance_loss  # noqa: F401
from .quant import QuantizedWeight, quantize, dequantize  # noqa: F401
