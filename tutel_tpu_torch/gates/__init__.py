"""Pluggable gate registry (counterpart: tutel_tpu/gates/__init__.py).
This slice ports the 'top' gate."""

from . import top  # noqa: F401

_REGISTRY = {
    "top": top.Gate,
}


def register(name, gate_cls):
    _REGISTRY[name] = gate_cls


def resolve(name):
    if name not in _REGISTRY:
        raise ValueError("Unrecognized gate_type: %s" % name)
    return _REGISTRY[name]
