"""Meshes of ranks as sets of process groups
(counterpart: tutel_tpu/parallel/mesh.py).

The JAX package lays its devices out as a `jax.sharding.Mesh` with named
axes and runs collectives over axis names. Here the same layouts are sets
of `torch.distributed` process groups over the ranks of a world, laid out
row-major in consecutive order:

  * `MoeMesh`: axes ('e', 'r', 'g') for one MoE layer: e expert groups,
    and (r, g) factoring the `sharded_count` ranks that slice one expert
    (r replicas of the hidden weights, regathered over g);
  * `HierarchicalMesh`: ('dcn', 'ici'), hosts by ranks of one host, for
    the two-level all-to-all.

`ProcessMesh.group(axes)` is the group of this rank's line along `axes`
(one axis name, or a tuple of names in mesh order). Every rank creates
every line's group, in the same order, when a mesh is built; groups are
cached by their ranks and reused by every later mesh (a per-call
`adaptive_r` switch creates none). A line holding every rank of the world
uses the default group. A mesh over some of the world's ranks (the MoE
layer of one pipeline stage, over the 'e' line of a ('pp', 'e') mesh) is
built by its own ranks only: it takes the groups an earlier mesh made and
makes the others among its members (torch's local synchronization), so
the ranks of other stages need not take part.
"""

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

# (default group, ranks of a line) -> process group
_GROUPS = {}


def default_ranks():
    """The ranks of the initialized world, or (0,) without one."""
    if dist.is_available() and dist.is_initialized():
        return tuple(range(dist.get_world_size()))
    return (0,)


def default_devices():
    """The ranks of the initialized world (JAX's `jax.devices()` of the
    same name), or (0,) without one."""
    return default_ranks()


def this_rank():
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _line_group(ranks, local=False):
    """The process group over `ranks` (sorted global ranks), made once;
    local: made by its members only."""
    world = dist.group.WORLD
    if len(ranks) == dist.get_world_size():
        return world
    key = (world, ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks),
                                      use_local_synchronization=local)
    return _GROUPS[key]


class ProcessMesh:
    """`ranks` laid out row-major as `shape`, one axis name a dimension."""

    def __init__(self, ranks: Sequence[int], shape, names):
        self.ranks = tuple(ranks)
        self.shape = tuple(int(s) for s in shape)
        self.names = tuple(names)
        if int(np.prod(self.shape)) != len(self.ranks):
            raise ValueError(f"mesh {dict(zip(self.names, self.shape))} "
                             f"!= {len(self.ranks)} ranks")
        self._grid = grid = np.asarray(self.ranks).reshape(self.shape)
        me = this_rank()
        # a mesh over part of the world makes only its own lines' groups
        part = dist.is_initialized() and \
            len(self.ranks) < dist.get_world_size()
        self._groups = {}
        # every line of every axis and of the whole mesh, in one order on
        # every rank
        combos = [(n,) for n in self.names] + [self.names]
        for axes in combos:
            dims = [self.names.index(a) for a in axes]
            rest = [d for d in range(len(self.shape)) if d not in dims]
            lines = np.moveaxis(grid, dims + rest, list(range(len(
                self.shape)))).reshape(int(np.prod([self.shape[d]
                                                    for d in dims])), -1)
            for col in range(lines.shape[1]):
                line = tuple(sorted(int(r) for r in lines[:, col]))
                if part and me not in line:
                    continue
                # without a process group the world is this one rank
                group = _line_group(line, local=part) \
                    if dist.is_initialized() else None
                if me in line:
                    self._groups[axes] = group

    def _axes(self, axes):
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes):
        """Ranks along `axes`."""
        return int(np.prod([self.shape[self.names.index(a)]
                            for a in self._axes(axes)]))

    def index(self, axes):
        """This rank's flat index along `axes` (row-major in their given
        order): the shard of a dim split over them that it holds."""
        coord = np.argwhere(self._grid == this_rank())[0]
        out = 0
        for a in self._axes(axes):
            d = self.names.index(a)
            out = out * self.shape[d] + int(coord[d])
        return out

    def shard(self, value, spec):
        """This rank's part of `value` under `spec`: one entry a dim (None:
        whole; an axis name or a tuple of them: split over those axes, this
        rank's slice `index(axes)`); trailing dims left out are whole. A
        dataclass value (`QuantizedWeight`, `FusedFFNStream`) takes a spec
        of its own type and splits each tensor field by its entry."""
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            return dataclasses.replace(value, **{
                f.name: self.shard(getattr(value, f.name),
                                   getattr(spec, f.name))
                for f in dataclasses.fields(value)
                if hasattr(getattr(value, f.name), "shape")})
        from ..convert import take_shard
        for dim, axes in enumerate(spec or ()):
            if axes is not None:
                value = take_shard(value, dim, self.size(axes),
                                   self.index(axes))
        return value

    def group(self, axes):
        """The process group of this rank's line along `axes`."""
        axes = self._axes(axes)
        if len(axes) == len(self.names):
            axes = self.names
        return self._groups[axes]


@dataclasses.dataclass(frozen=True)
class MoeMesh:
    """The expert-parallel mesh of one MoE world: ('e', 'r', 'g')."""
    ranks: tuple                        # the world's ranks, canonical order
    num_expert_groups: int              # e axis size
    sharded_count: int                  # r*g ranks sharing one expert
    adaptive_r: int = 1                 # r axis size (weights replicated r x)

    def __post_init__(self):
        w = len(self.ranks)
        if self.num_expert_groups * self.sharded_count != w:
            raise ValueError(f"mesh factoring {self.num_expert_groups}x"
                             f"{self.sharded_count} != {w} ranks")
        if self.adaptive_r and self.sharded_count % self.adaptive_r:
            raise ValueError(f"adaptive_r={self.adaptive_r} does not divide "
                             f"sharded_count={self.sharded_count}")

    @property
    def world_size(self):
        return len(self.ranks)

    @property
    def gather_group_size(self):
        return self.sharded_count // max(self.adaptive_r, 1)

    def with_adaptive_r(self, r: int) -> "MoeMesh":
        """The same ranks refactored with r replicas of each expert's
        weights."""
        return dataclasses.replace(self, adaptive_r=r)

    def build(self) -> ProcessMesh:
        return ProcessMesh(self.ranks, (self.num_expert_groups,
                                       max(self.adaptive_r, 1),
                                       self.gather_group_size),
                           self.EP_AXES)

    # the flat token / EP axis: all three axes, e-major
    EP_AXES = ("e", "r", "g")


@dataclasses.dataclass(frozen=True)
class HierarchicalMesh:
    """('dcn', 'ici') factoring of the same ranks: hosts by the ranks of
    one host, for the two-level all-to-all."""
    ranks: tuple
    num_hosts: int                      # dcn axis size

    def build(self) -> ProcessMesh:
        w = len(self.ranks)
        if w % self.num_hosts:
            raise ValueError(f"{self.num_hosts} hosts do not divide {w} "
                             f"ranks")
        return ProcessMesh(self.ranks, (self.num_hosts, w // self.num_hosts),
                           ("dcn", "ici"))


def infer_num_hosts(ranks: Sequence[int], num_hosts: Optional[int] = None):
    """Hosts among `ranks`: `num_hosts` if given, else from the ranks a host
    runs (LOCAL_WORLD_SIZE, as torchrun sets it), else 1."""
    if num_hosts:
        return int(num_hosts)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    if local > 0:
        return max(1, -(-len(ranks) // local))
    return 1


