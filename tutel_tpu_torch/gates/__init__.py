"""Pluggable gate registry (counterpart: tutel_tpu/gates/__init__.py).
Ported: the 'top', 'cosine_top' and 'expert_choice' gates."""

from . import cosine_top  # noqa: F401
from . import expert_choice  # noqa: F401
from . import top  # noqa: F401

_REGISTRY = {
    "top": top.Gate,
    "cosine_top": cosine_top.Gate,
    "expert_choice": expert_choice.Gate,
}


def register(name, gate_cls):
    _REGISTRY[name] = gate_cls


def resolve(name):
    if name not in _REGISTRY:
        raise ValueError("Unrecognized gate_type: %s" % name)
    return _REGISTRY[name]
