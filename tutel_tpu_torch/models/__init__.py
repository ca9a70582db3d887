"""Model families built on the MoE layer (counterpart:
tutel_tpu/models/__init__.py): the Transformer-MoE LM and the ViT-MoE
vision model."""

from . import transformer  # noqa: F401
from .transformer import TransformerMoEConfig, TransformerMoE  # noqa: F401
from . import vision  # noqa: F401
from .vision import VisionMoEConfig, VisionMoE  # noqa: F401
