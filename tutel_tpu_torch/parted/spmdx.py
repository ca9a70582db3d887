"""Graph IR + program lowering for the parted SPMD partitioner
(counterpart: tutel_tpu/parted/spmdx.py).

The IR is the JAX package's, which is the reference's einsum-like spec
language (reference tutel/parted/spmdx.py:70-119: `"NM = NK, KM+"` — left
of `=` the output dims, comma-separated inputs on the right, trailing `+`
marks a sum reduction over the dims that vanish from the output). Nodes
are data (activations entering per step), params (weights), and ops
(einsum specs or custom functions on torch tensors). Shape and FLOP
inference come from the spec.

Program emission differs from the JAX package's, which puts a sharding
constraint on every node and lets GSPMD insert the collectives. Here
`compile()` lowers a plan to explicit `net` collectives once, as the
reference's codegen did with its primitives (spmdx.py:419-516,
patterns.py:12-129). It walks the graph in topological order and tracks
each value's local layout on this rank: split on dim d (this rank's
slice), replicated, or ZERO (a param's dim-0 slice, all-gathered on use).
An edge from the layout an input has to the one its consumer needs is

  BAR    same layout ..................... nothing
  SPLIT  replicated -> split d ........... this rank's slice (`simple_split`)
  AG     split d -> replicated ........... `simple_all_gather` on d
  A2A    split d -> split d' ............. `all_to_all(x, d, d')`
  ZERO   ZERO -> anything ................ all-gather on dim 0, then SPLIT

and a fn-less `+` op whose every input holding some reduce letter r is
split on r computes a partial sum, which an all-reduce makes replicated
(FAR) or a reduce-scatter splits (RS). Every rank runs the same schedule,
and the collectives' backwards make a `Program` differentiable.

The lowering reads the partial-sum form from the producers' layouts, so
it can emit another program than the one the solver priced: the solver
prices FAR only for a replicated output and prices a split output as a
reshard of each input to the output's letter, where the lowering takes
RS whenever the inputs are already split on the reduce letter (the RS
plan of tests/test_torch_parted.py). The results are the same; the
collectives, and so `compiled_text()`, are not the priced ones.
"""

import collections
import itertools
import math
import time
from typing import Callable, List, Optional, Sequence

import torch

from .. import net


class _Session:
    def __init__(self):
        self.group = None
        self.world = 1
        self.rank = 0
        self.device = None


session = _Session()


def init(group=None, device="cuda"):
    """Start the partitioning session over the ranks of `group` (None: the
    default process group; the world is one rank without one), on
    `device`: the card unless the caller asks for "cpu".

    The counterpart of the JAX `init(devices, axis_name)`, whose 1-D
    device mesh and its axis are here the process group."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("parted.init: no CUDA device (pass device='cpu' "
                           "to run on the CPU)")
    session.group = group
    session.world = net.get_world_size(group)
    session.rank = net.get_world_rank(group)
    session.device = device
    return session


class Parser:
    """Parse `"NM = NK, KM+"` into per-operand dim letters.

    reference spmdx.py:70-119 (Mapper2D/Parser). Reduce markers: `+` is
    sum over the letters present in inputs but absent from the output.
    """

    def __init__(self, ir: str):
        left, rights = ir.split("=")
        left, rights = left.strip(), rights.strip()
        self.reduce_type = ""
        # the reduce marker may trail either side of the '='
        if rights and rights[-1] in "+<>[]":
            rights, self.reduce_type = rights[:-1], rights[-1]
        if left and left[-1] in "+<>[]":
            left, self.reduce_type = left[:-1], left[-1]
        self.out_dims = list(left.strip())
        self.in_dims = [list(r.strip()) for r in rights.split(",")]
        in_letters = set(itertools.chain.from_iterable(self.in_dims))
        self.reduce_axes = sorted(in_letters - set(self.out_dims))
        if self.reduce_axes and not self.reduce_type:
            raise ValueError(
                f"spec '{ir}' drops dims {self.reduce_axes} without a "
                "reduce marker (append '+')")

    def einsum_expr(self):
        lower = {c: c.lower() for c in set(
            itertools.chain.from_iterable(self.in_dims + [self.out_dims]))}
        ins = ",".join("".join(lower[c] for c in d) for d in self.in_dims)
        return f"{ins}->{''.join(lower[c] for c in self.out_dims)}"


class Node:
    def __init__(self, name, op_type, shape, dtype, ir=None, inputs=(),
                 fn: Optional[Callable] = None, split_letters=None):
        self.name = name
        self.op_type = op_type            # 'data' | 'param' | 'op'
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.ir = ir
        self.parser = Parser(ir) if ir else None
        self.inputs: List[Node] = list(inputs)
        self.fn = fn
        self.split_letters = split_letters
        self.consumers: List[Node] = []
        for i in self.inputs:
            i.consumers.append(self)

    @property
    def size(self):
        return math.prod(self.shape)

    def flops(self):
        """2 * prod(all letter extents) for reduce-einsums, else out size."""
        if self.parser is None or not self.parser.reduce_axes:
            return self.size
        extents = dict(self.letter_extents())
        total = 1
        for v in extents.values():
            total *= v
        return 2 * total

    def may_split(self, dim):
        """Whether a state may split the node on `dim`: any dim, unless
        the node declared the letters its fn may be split on."""
        return self.split_letters is None or \
            self.parser.out_dims[dim] in self.split_letters

    def letter_extents(self):
        assert self.parser is not None
        out = {}
        for dims, node in zip(self.parser.in_dims, self.inputs):
            assert len(dims) == len(node.shape), (self.name, dims,
                                                  node.shape)
            for letter, extent in zip(dims, node.shape):
                prev = out.setdefault(letter, int(extent))
                assert prev == int(extent), (
                    f"{self.name}: dim {letter} mismatch {prev} vs {extent}")
        return out

    def __repr__(self):
        return f"Node({self.name}:{self.op_type}{list(self.shape)})"


class Graph:
    def __init__(self, outputs: Sequence[Node]):
        self.outputs = list(outputs)
        self.nodes = self._toposort()

    def _toposort(self):
        seen, order = set(), []

        def visit(n):
            if id(n) in seen:
                return
            seen.add(id(n))
            for i in n.inputs:
                visit(i)
            order.append(n)

        for o in self.outputs:
            visit(o)
        return order


_counter = itertools.count()


def data(shape, dtype="float32", name=None):
    """Per-step input tensor (reference spmdx.py:584 `Tensor`)."""
    return Node(name or f"data{next(_counter)}", "data", shape, dtype)


def param(shape, dtype="float32", name=None):
    """Trainable parameter (ZeRO state -2 becomes legal for these)."""
    return Node(name or f"param{next(_counter)}", "param", shape, dtype)


def custom(ir, inputs, dtype=None, name=None, fn=None, split_letters=None):
    """Op node from an einsum-style spec (reference spmdx.py:183-253
    `Custom`). `fn`, a function on torch tensors, overrides the default
    `torch.einsum` evaluation (it still must match the spec's shapes); it
    runs on each rank's local shards of its inputs, so it must compute a
    slice of its output along a split letter from the same slice of its
    inputs. `split_letters` names the output letters it may be split on
    (None: every letter); the solver offers no other split, and compile
    refuses one: a softmax over H, say, takes `split_letters` without H."""
    parser = Parser(ir)
    if split_letters is not None and not set(split_letters) <= set(
            parser.out_dims):
        raise ValueError(f"spec '{ir}': split_letters {split_letters!r} "
                         "are not all letters of the output")
    extents = {}
    for dims, node in zip(parser.in_dims, inputs):
        for letter, extent in zip(dims, node.shape):
            extents[letter] = int(extent)
    shape = tuple(extents[c] for c in parser.out_dims)
    return Node(name or f"op{next(_counter)}", "op", shape,
                dtype or inputs[0].dtype, ir=ir, inputs=inputs, fn=fn,
                split_letters=split_letters)


# ---------------------------------------------------------------------------
# Sharding states and plan lowering
# ---------------------------------------------------------------------------

REPLICATED = -1
ZERO = -2      # stored sharded on leading dim, gathered on use (params)


class Config(dict):
    """node name -> state (dim index, REPLICATED, or ZERO)."""

    @staticmethod
    def default(graph: Graph):
        return Config({n.name: REPLICATED for n in graph.nodes})


# one collective of a lowered program: `kind` under HLO's name
# (all-gather, all-reduce, all-to-all, reduce-scatter), the node whose
# value it moves, where that value goes (a consumer's name, or "output"),
# and its dims (all-to-all: gathered, then scattered)
Collective = collections.namedtuple("Collective",
                                    ["kind", "tensor", "at", "dims"])
_COLLECTIVES = ("all-gather", "all-reduce", "all-to-all", "reduce-scatter")


def _layout(node: Node, state: int, world: int):
    """The local layout a state gives a node on every rank: REPLICATED, a
    split dim, or ZERO (params only; elsewhere ZERO is a dim-0 split, as
    the JAX package's sharding spec makes it). Raises ValueError for a
    state that is no dim of the node or whose dim does not divide by the
    world (GSPMD would pad), or that splits a node on a letter its fn may
    not be split on."""
    state = int(state)
    if state == REPLICATED:
        return REPLICATED
    dim = 0 if state == ZERO else state
    if not 0 <= dim < len(node.shape):
        raise ValueError(f"{node.name}{list(node.shape)}: state {state} is "
                         "no dim of the node")
    if node.shape[dim] % world:
        raise ValueError(f"{node.name}{list(node.shape)}: dim {dim} does not "
                         f"divide by the world of {world} ranks")
    if not node.may_split(dim):
        raise ValueError(f"{node.name} [{node.ir}]: its fn may be split "
                         f"only on {node.split_letters!r}, not on "
                         f"{node.parser.out_dims[dim]!r}")
    return ZERO if state == ZERO and node.op_type == "param" else dim


def _reshard(have: int, need: int):
    """The primitives that take a value from layout `have` to `need`."""
    if have == need:
        return []                                        # BAR
    if have == ZERO:                                     # gathered on use
        return [("all-gather", 0)] + ([("split", need)] if need >= 0 else [])
    if have == REPLICATED:
        return [("split", need)]                         # SPLIT
    if need == REPLICATED:
        return [("all-gather", have)]                    # AG
    return [("all-to-all", have, need)]                  # A2A


def _partial_letter(op: Node, layouts):
    """The reduce letter r of a fn-less `+` op whose every input holding
    r is split on r's dim (the first such, in the spec's order), or
    None: such an op computes a partial sum on every rank."""
    parser = op.parser
    if op.fn is not None or parser.reduce_type != "+":
        return None
    for r in parser.reduce_axes:
        if all(layouts[inp.name] == dims.index(r)
               for dims, inp in zip(parser.in_dims, op.inputs) if r in dims):
            return r
    return None


def _describe(prim):
    kind = prim[0]
    if kind == "all-to-all":
        return f"all-to-all(dim {prim[1]} -> dim {prim[2]})"
    if kind == "all-reduce":
        return "all-reduce(sum)"
    return f"{kind}(dim {prim[1]})"


def _state_text(layout):
    if layout == REPLICATED:
        return "replicated"
    if layout == ZERO:
        return "zero(dim 0)"
    return f"split(dim {layout})"


def _local_shape(shape, layout, world):
    dim = 0 if layout == ZERO else layout
    if dim < 0:
        return list(shape)
    return [s // world if d == dim else s for d, s in enumerate(shape)]


def compile(outputs, config: Config):
    """Lower the chosen plan to a Program that issues its collectives
    through `net` over the session's group (see the module doc).

    Decided once, here: each value's layout, each edge's primitives, each
    op's local computation (its spec's einsum or its fn on the local
    shards), and the all-reduce or reduce-scatter of a partial sum. Graph
    outputs are all-gathered to full on every rank."""
    from . import solver as solver_mod

    if session.device is None:
        raise RuntimeError("call parted.init() first")
    graph = Graph(outputs if isinstance(outputs, (list, tuple))
                  else [outputs])
    world = session.world
    leaves = [n for n in graph.nodes if n.op_type in ("data", "param")]
    layouts = {}
    steps = []          # (node, [(input, prims)], post prims), ops only
    for node in graph.nodes:
        state = config.get(node.name, REPLICATED)
        if node.op_type != "op":
            layouts[node.name] = _layout(node, state, world)
            continue
        out = _layout(node, state, world)
        dims_of = node.parser.in_dims
        r = _partial_letter(node, layouts)
        if r is not None:
            needs = [dims.index(r) if r in dims else REPLICATED
                     for dims in dims_of]
            post = [("all-reduce",)] if out == REPLICATED else \
                [("reduce-scatter", out)]
        else:
            needs = [solver_mod._required_input_state(node, out, i)
                     for i in range(len(node.inputs))]
            post = []
        edges = [(inp, _reshard(layouts[inp.name], need))
                 for inp, need in zip(node.inputs, needs)]
        steps.append((node, edges, post, r))
        layouts[node.name] = out
    gathers = [(o, _reshard(layouts[o.name], REPLICATED))
               for o in graph.outputs]
    return Program(graph, config, leaves, layouts, steps, gathers)


class Program:
    """Lowered plan (reference spmdx.py:133-176 `Program`): callable with
    the full arrays on every rank, inspectable (`compiled_text`,
    `collectives`), and timeable (`execute`)."""

    def __init__(self, graph, config, leaves, layouts, steps, gathers):
        self.graph = graph
        self.config = config
        self.leaves = leaves
        self.layouts = layouts
        self.steps = steps
        self.gathers = gathers
        self.group = session.group
        self.world = session.world
        self.device = session.device
        self.collectives = []
        for node, edges, post, _ in steps:
            for inp, prims in edges:
                self.collectives += [Collective(p[0], inp.name, node.name,
                                                p[1:]) for p in prims
                                     if p[0] in _COLLECTIVES]
            self.collectives += [Collective(p[0], node.name, node.name,
                                            p[1:]) for p in post]
        for o, prims in gathers:
            self.collectives += [Collective(p[0], o.name, "output", p[1:])
                                 for p in prims]

    def _apply(self, prims, x):
        group = self.group
        for prim in prims:
            kind = prim[0]
            if kind == "split":
                x = net.simple_split(x, group, dim=prim[1])
            elif kind == "all-gather":
                x = net.simple_all_gather(x, group, dim=prim[1])
            elif kind == "all-to-all":
                x = net.all_to_all(x, prim[1], prim[2], group)
            elif kind == "all-reduce":
                x = net.simple_all_reduce(x, group)
            else:
                x = net.simple_reduce_scatter(x, group, dim=prim[1])
        return x

    def __call__(self, *arrays):
        if len(arrays) != len(self.leaves):
            raise ValueError(f"the program takes {len(self.leaves)} arrays "
                             f"({[n.name for n in self.leaves]}), not "
                             f"{len(arrays)}")
        env = {}
        for node, arr in zip(self.leaves, arrays):
            x = torch.as_tensor(arr, device=self.device)
            if tuple(x.shape) != node.shape:
                raise ValueError(f"{node.name}: shape {tuple(x.shape)}, the "
                                 f"graph says {node.shape}")
            # a split leaf (ZERO: a param's dim-0 slice) keeps its slice
            layout = self.layouts[node.name]
            if layout != REPLICATED:
                x = net.simple_split(x, self.group,
                                     dim=0 if layout == ZERO else layout)
            env[node.name] = x
        for node, edges, post, _ in self.steps:
            ins = [self._apply(prims, env[inp.name]) for inp, prims in edges]
            if node.fn is not None:
                val = node.fn(*[t.contiguous() for t in ins])
            else:
                val = torch.einsum(node.parser.einsum_expr(), *ins)
            env[node.name] = self._apply(post, val)
        outs = [self._apply(prims, env[o.name]) for o, prims in self.gathers]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def example_inputs(self, seed=0):
        """One normal(0, 0.1) float32 array a leaf, from a torch.Generator
        on the session's device: the same on every rank (and not the
        numbers of the JAX package's `jax.random`)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return [torch.randn(n.shape, generator=g, device=self.device) * 0.1
                for n in self.leaves]

    def compiled_text(self):
        """The lowered schedule, one line a node (its layout and local
        computation) and one indented line an edge, each collective under
        HLO's name."""
        w = self.world
        lines = [f"parted program: world {w}, device {self.device}"]
        for node in self.leaves:
            layout = self.layouts[node.name]
            lines.append(f"{node.name} = {node.op_type}{list(node.shape)} "
                         f"{node.dtype} : {_state_text(layout)} local "
                         f"{_local_shape(node.shape, layout, w)}")
        for node, edges, post, r in self.steps:
            op = "fn" if node.fn is not None else \
                f"einsum {node.parser.einsum_expr()}"
            if r is not None:
                op += f" (partial sum over {r})"
            layout = self.layouts[node.name]
            lines.append(f"{node.name} = {op} [{node.ir}] : "
                         f"{_state_text(layout)} local "
                         f"{_local_shape(node.shape, layout, w)}")
            for inp, prims in edges:
                lines.append(f"    {inp.name}: " + (", ".join(
                    _describe(p) for p in prims) or "no collective"))
            for p in post:
                lines.append(f"    {node.name}: {_describe(p)}")
        for o, prims in self.gathers:
            lines.append(f"output {o.name}: " + (", ".join(
                _describe(p) for p in prims) or "no collective"))
        return "\n".join(lines)

    def execute(self, steps=5, warmup=2, seed=0):
        """Measured average step time in seconds (reference
        executor.py:47-115's warm-up and average loop, in-process): the
        steps run between two barriers (each after synchronizing the
        card), and the result is the largest over the ranks, so that every
        rank holds the same number."""
        args = self.example_inputs(seed)
        with torch.no_grad():
            for _ in range(warmup):
                self(*args)
            net.barrier(self.group)
            t0 = time.perf_counter()
            for _ in range(steps):
                self(*args)
            net.barrier(self.group)
            seconds = (time.perf_counter() - t0) / steps
        t = torch.tensor([seconds], dtype=torch.float64, device=self.device)
        return float(net.simple_all_reduce(t, self.group, op="max")[0])


def optimize(outputs, top_k=1, measure=False, max_candidates=8):
    """Search sharding plans (reference spmdx.py:528-543 `optimize` +
    solver.solve_partition). Analytical ranking by modeled collective
    bytes; optionally re-rank the best `max_candidates` by measured step
    time of the compiled programs. A fn node is offered a split on every
    letter of its output unless `custom(split_letters=)` names the ones
    its fn allows. Every rank measures each plan's
    largest time over the ranks, and the sort is stable from the
    analytical order, so that every rank ranks alike (ranks that compiled
    different plans would hang in mismatched collectives)."""
    from . import solver as solver_mod

    graph = Graph(outputs if isinstance(outputs, (list, tuple))
                  else [outputs])
    ranked = solver_mod.solve_partition(graph, session.world)
    if measure:
        timed = []
        for cost, cfg in ranked[:max_candidates]:
            prog = compile(graph.outputs, cfg)
            timed.append((prog.execute(), cfg))
        timed.sort(key=lambda t: t[0])
        ranked = timed
    return ranked[:top_k] if top_k else ranked
