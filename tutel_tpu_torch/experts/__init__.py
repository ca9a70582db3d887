"""Pluggable expert registry (counterpart: tutel_tpu/experts/__init__.py).
Ported: the two-layer 'ffn' expert and the SwiGLU 'llama_ffn' expert."""

from . import ffn  # noqa: F401
from . import llama_ffn  # noqa: F401

_REGISTRY = {
    "ffn": ffn.ExpertModule,
    "llama_ffn": llama_ffn.ExpertModule,
}


def register(name, expert_cls):
    _REGISTRY[name] = expert_cls


def resolve(name):
    if name not in _REGISTRY:
        raise ValueError("Builtin expert type is not recognized: %s" % name)
    return _REGISTRY[name]
