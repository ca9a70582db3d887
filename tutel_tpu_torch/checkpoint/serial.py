"""Checkpoint serialization: nested state dicts <-> .npz files
(counterpart: tutel_tpu/checkpoint/serial.py; the same file format, so
either package reads what the other writes).

A state
is a nested dict of str -> (ndarray | nested dict); nesting levels are
joined with '/' on disk (leaf keys keep their own dots, e.g.
'moe.experts.fc1_w'), which is also how the reference's `--namespace`
nesting addresses sub-dicts (reference doc/CHECKPOINT.md:28-45).
"""

import os

import numpy as np

_SEP = "/"


def flatten_state(state, prefix=""):
    flat = {}
    for k, v in state.items():
        key = f"{prefix}{_SEP}{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_state(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_state(flat):
    state = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        d = state
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return state


def save_state(path, state):
    """Write a nested state dict to `path` (.npz)."""
    flat = flatten_state(state)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_state(path):
    """Read a nested state dict from `path`."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_state(flat)


def enter_namespace(state, namespace):
    """Descend into 'a/b/c'-style namespace (reference gather.py:28-31)."""
    for package in (namespace or "").split("/"):
        if package:
            state = state[package]
    return state


def replace_namespace(root, namespace, new_sub):
    """Return root with the namespace subtree replaced (pure)."""
    if not any(p for p in (namespace or "").split("/")):
        return new_sub
    parts = [p for p in namespace.split("/") if p]
    out = dict(root)
    d = out
    for p in parts[:-1]:
        d[p] = dict(d[p])
        d = d[p]
    d[parts[-1]] = new_sub
    return out
