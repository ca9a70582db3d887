"""Weights from the JAX package to the port, through NumPy.

`from_jax_params(tree, device)` walks a parameter tree of the JAX package
(dicts, lists, tuples) and returns the port's tree on `device`: arrays
become tensors of the same dtype (bfloat16 included), a `QuantizedWeight`
becomes the port's `QuantizedWeight` (values, scales, bits, orig_k,
blocks) and a `FusedFFNStream` the port's stream with the same arrays and
tile metadata. The JAX classes are recognised by their fields, so this
module imports nothing of the JAX package.

`take_shard(value, dim, count, index)` is the slice of a global parameter
that one rank holds (the sharded `MOELayer.shard_params` takes it), so the
same global weights sit in both packages.
"""

import dataclasses


import numpy as np
import torch

from .ops.fused_ffn import FusedFFNStream
from .ops.quant import QuantizedWeight
from .utils import resolve_device

_QUANT_FIELDS = ("values", "scales", "bits", "orig_k", "blocks")
_STREAM_FIELDS = ("wstream", "sb", "bits", "k", "h", "n", "t1", "t2", "bw",
                  "kr")


def to_tensor(array, device="cuda"):
    """A tensor holding the array's values, dtype preserved."""
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(resolve_device(device))


def from_jax_params(tree, device="cuda"):
    """The port's parameter tree for a JAX parameter tree (see module doc)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    if all(hasattr(tree, f) for f in _STREAM_FIELDS):
        return FusedFFNStream(
            wstream=to_tensor(tree.wstream, device),
            sb=to_tensor(tree.sb, device),
            **{f: int(getattr(tree, f)) for f in _STREAM_FIELDS[2:]})
    if all(hasattr(tree, f) for f in _QUANT_FIELDS):
        return QuantizedWeight(
            values=to_tensor(tree.values, device),
            scales=to_tensor(tree.scales, device),
            bits=int(tree.bits), orig_k=int(tree.orig_k),
            blocks=int(tree.blocks))
    if tree is None:
        return None
    return to_tensor(tree, device)


def hwio_to_oihw(kernel):
    """A JAX convolution kernel [H, W, in, out] as torch's [out, in, H, W]
    (contiguous)."""
    return kernel.permute(3, 2, 0, 1).contiguous()


def take_shard(value, dim, count, index):
    """The `index`-th of `count` equal slices of `value` along `dim`. A
    `QuantizedWeight` slices its values, and its scales where their dim is
    not 1; a `FusedFFNStream` slices its stream and scales on dim 0 (the
    expert dim) only."""
    if count == 1:
        return value
    if isinstance(value, FusedFFNStream):
        if dim != 0:
            raise ValueError("a fused weight stream shards on the expert "
                             "dim only")
        return dataclasses.replace(
            value, wstream=take_shard(value.wstream, 0, count, index),
            sb=take_shard(value.sb, 0, count, index))
    if isinstance(value, QuantizedWeight):
        scales = value.scales
        if scales.shape[dim] != 1:
            scales = take_shard(scales, dim, count, index)
        return dataclasses.replace(
            value, values=take_shard(value.values, dim, count, index),
            scales=scales)
    if value.shape[dim] % count:
        raise ValueError(f"dim {dim} of {tuple(value.shape)} does not "
                         f"split into {count} shards")
    size = value.shape[dim] // count
    return value.narrow(dim, index * size, size).contiguous()
