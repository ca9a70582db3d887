"""Sharding-state search over a parted graph (counterpart:
tutel_tpu/parted/solver.py, copied so that both packages rank plans
alike; the one addition: a fn node that declares the letters it may be
split on (`spmdx.custom(split_letters=)`) is offered no other split).

Re-conception of the reference solver (reference tutel/parted/solver.py:
19-144): per-node states are an output dim index (partitioned), -1
(replicated) or -2 (ZeRO, params only); nodes with multiple consumers
are enumerated globally and the remaining tree edges are folded by
memoized DP — the reference's articulation-grouping + per-group dynamic
program (spmdx.py:317-378) specialized to the same effect.

Costs are analytical instead of subprocess-measured (measurement is the
optional refinement pass, spmdx.optimize(measure=True)): every edge
(producer state -> state the consumer op requires for an input) is
priced at the bytes the collective the plan implies must move over the
W ranks (`spmdx.compile` issues it through `net`), mirroring the
reference's 7 primitive rules (patterns.py:12-129):

  BAR    same state, no comm ........................ 0
  SPLIT  replicated -> partitioned (local slice) .... 0
  AG     partitioned -> replicated (all-gather) ..... size*(W-1)/W
  A2A    partitioned(i) -> partitioned(j) ........... size/W
  FAR    reduce-axis split -> replicated (all-reduce) 2*size*(W-1)/W
  RS     reduce-axis split -> partitioned (rs) ...... size*(W-1)/W
  ZERO   param stored sharded, gathered on use ...... size*(W-1)/W

Compute is priced as node FLOPs divided by the partition count of its
execution, and every leaf (param or activation) pays an HBM-residency
term per step — full size when replicated, 1/W when sharded — which is
what makes TP/ZeRO states win for giant weights and batch sharding win
for big activations.
"""

import itertools
from typing import Dict, List, Tuple

from .spmdx import Graph, Node, Config, REPLICATED, ZERO

# relative weight of one moved byte vs one FLOP: the JAX package's
# constants, kept unchanged so that both packages rank plans alike (the
# ranking only needs the ratio's order of magnitude).
_BYTE_COST = 200.0
_HBM_BYTE_COST = 20.0
_ITEMSIZE = 4


def _node_states(node: Node, world: int):
    states = [REPLICATED]
    for d, extent in enumerate(node.shape):
        # (the port's one addition: a fn node's declared split letters)
        if extent % world == 0 and node.may_split(d):
            states.append(d)
    if node.op_type == "param" and node.shape \
            and node.shape[0] % world == 0:
        states.append(ZERO)
    return states


def _required_input_state(op: Node, out_state: int, idx: int):
    """State input `idx` must be in for `op` to compute its shard of the
    output locally, or None if the (op-state, input) pair is infeasible
    without resharding the output itself."""
    parser = op.parser
    dims_in = parser.in_dims[idx]
    if out_state == REPLICATED:
        return REPLICATED
    if out_state >= 0:
        letter = parser.out_dims[out_state]
        if letter in dims_in:
            return dims_in.index(letter)
        return REPLICATED
    return REPLICATED


def _reshard_cost(node: Node, have: int, need: int, world: int):
    size = node.size * _ITEMSIZE
    if have == need:
        return 0.0
    if have == ZERO:
        # gathered on use (all-gather of the flat param); after the
        # gather the tensor is replicated, so slicing to ANY partition
        # dim is free — the wire cost is the all-gather alone
        return size * (world - 1) / world
    if have == REPLICATED and need != REPLICATED:
        return 0.0                       # SPLIT: local slice
    if have >= 0 and need == REPLICATED:
        return size * (world - 1) / world  # AG
    if have >= 0 and need >= 0:
        return size / world                # A2A
    return size


def _op_cost(op: Node, out_state: int, world: int):
    """Local compute + any reduction collective the spec implies."""
    flops = op.flops()
    size = op.size * _ITEMSIZE
    if out_state == REPLICATED:
        # (the reduce-split + FAR all-reduce realization of a replicated
        # output is priced separately in the solver loop)
        return flops
    return flops / world


def evaluate_assignment(graph: Graph, world: int, fixed: Dict[str, int]
                        ) -> Tuple[float, Config]:
    """Price one (possibly partial) assignment under the cost model.

    Fixed nodes keep their given state; unfixed op nodes are assigned
    greedily in topological order (cheapest compute + input-reshard at
    that point) and unfixed single-consumer leaves are produced
    directly in the state their consumer needs (locally optimal under
    this model: storing a leaf in its consumer's state dominates every
    alternative, see the residency note below). With ALL op nodes
    fixed, the result is the exact model cost of that plan — which is
    what makes brute-force optimality checks possible
    (tests/test_torch_parted.py::test_solver_matches_bruteforce_small)."""
    ops = [n for n in graph.nodes if n.op_type == "op"]
    state: Dict[str, int] = dict(fixed)
    # Parameter residency: every step streams the local copy of each
    # param from HBM (grads/optimizer touch all of it), so a
    # replicated param costs W times the HBM traffic of a sharded
    # one — what makes TP/ZeRO states win for giant weights while
    # plain replication wins for small ones. Data (activation) leaves
    # get the same treatment: a replicated activation is read in full
    # by every device. Fixed leaves are priced here; free leaves at
    # the moment the greedy assigns them.
    def residency(node, s):
        frac = 1.0 if s == REPLICATED else 1.0 / world
        return _HBM_BYTE_COST * node.size * _ITEMSIZE * frac

    cost = 0.0
    for n in graph.nodes:
        if n.op_type in ("param", "data") and n.name in state:
            cost += residency(n, state[n.name])
    for op in ops:
        out_state = state.get(op.name)
        candidates = ([out_state] if out_state is not None
                      else _node_states(op, world))
        best = None
        for os_ in candidates:
            # realizations: local-per-shard compute; plus, for a
            # reduce-einsum producing a replicated output, the
            # split-reduce + all-reduce form (the FAR primitive)
            realizations = [(_op_cost(op, os_, world), os_, None)]
            if os_ == REPLICATED and op.parser is not None \
                    and op.parser.reduce_axes:
                far = op.flops() / world \
                    + _BYTE_COST * 2 * op.size * _ITEMSIZE \
                    * (world - 1) / world
                realizations.append((far, os_, op.parser.reduce_axes[0]))
            for base, os2, reduce_letter in realizations:
                total = base
                assigns = {}
                for idx, inp in enumerate(op.inputs):
                    if reduce_letter is not None:
                        dims_in = op.parser.in_dims[idx]
                        need = (dims_in.index(reduce_letter)
                                if reduce_letter in dims_in
                                else REPLICATED)
                    else:
                        need = _required_input_state(op, os2, idx)
                    have = state.get(inp.name)
                    if have is None:
                        # free leaf: produce it directly in `need`
                        assigns[inp.name] = need
                        if inp.op_type in ("param", "data"):
                            total += residency(inp, need)
                    else:
                        total += _BYTE_COST * _reshard_cost(
                            inp, have, need, world)
                if best is None or total < best[0]:
                    best = (total, os2, assigns)
        cost += best[0]
        state.setdefault(op.name, best[1])
        for k, v in best[2].items():
            state.setdefault(k, v)
    return cost, Config({n.name: state.get(n.name, REPLICATED)
                         for n in graph.nodes})


def solve_partition(graph: Graph, world: int,
                    max_enumeration: int = 4096
                    ) -> List[Tuple[float, Config]]:
    """Rank sharding plans for the graph. Returns [(cost, Config)].

    Search strategy, by graph size: enumerate the states of EVERY op
    node when the combination count fits `max_enumeration` (exact
    under the cost model — single-consumer leaves are locally optimal,
    see `evaluate_assignment`); otherwise enumerate only the
    multi-consumer/output nodes with a greedy topological fill (the
    round-3 behavior — can be suboptimal on the unenumerated tail);
    beyond that, outputs only."""
    if world <= 1:
        return [(0.0, Config.default(graph))]

    multi = [n for n in graph.nodes
             if len(n.consumers) > 1 or n in graph.outputs]
    ops = [n for n in graph.nodes if n.op_type == "op"]
    every_op = list(dict.fromkeys(multi + ops))   # stable order, dedup

    def combos(nodes):
        c = 1
        for n in nodes:
            c *= len(_node_states(n, world))
        return c

    if combos(every_op) <= max_enumeration:
        choices = [(n, _node_states(n, world)) for n in every_op]
    elif combos(multi) <= max_enumeration:
        choices = [(n, _node_states(n, world)) for n in multi]
    else:
        # fall back: enumerate outputs only
        choices = [(n, _node_states(n, world)) for n in graph.outputs]

    results = []
    for assignment in itertools.product(*[s for _, s in choices]):
        fixed = {n.name: st for (n, _), st in zip(choices, assignment)}
        results.append(evaluate_assignment(graph, world, fixed))
    # dedupe identical configs, keep cheapest
    seen = {}
    for cost, cfg in results:
        key = tuple(sorted(cfg.items()))
        if key not in seen or cost < seen[key][0]:
            seen[key] = (cost, cfg)
    ranked = sorted(seen.values(), key=lambda t: t[0])
    return ranked
