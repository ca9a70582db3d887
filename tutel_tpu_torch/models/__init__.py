"""Model families built on the MoE layer (counterpart:
tutel_tpu/models/__init__.py): the Transformer-MoE LM. The vision family
is a later slice."""

from . import transformer  # noqa: F401
from .transformer import TransformerMoEConfig, TransformerMoE  # noqa: F401
