"""Port parity: parted (`tutel_tpu_torch.parted`: the spec IR, the solver
and the lowering to explicit `net` collectives) against the JAX package's
`tutel_tpu.parted`, after tests/test_parted.py's 9 tests.

Every graph is built with explicit node names in both packages, and both
programs run on the same numpy inputs (seeded `np.random.default_rng`):

  (a) the Parser (all five reduce markers, the ValueError), shapes and
      flops equal JAX's;
  (b) `solve_partition`'s whole ranked list equals JAX's, configs and costs
      with ==, at W = 2, 4 and 8, over the graphs of JAX's tests and two
      graphs that reach the multi-consumer and the outputs-only branch;
  (c) the brute-force optimality check on the port's own solver;
  (d) at W = 2 and 4 gloo ranks (`testing.RankPool`), against the JAX
      program on W of the 8 virtual CPU devices: the top-4 plans of the
      MLP within 2e-5; the forced FAR, ZERO, A2A and RS plans within 2e-4,
      each naming its collective in `compiled_text()`; every run issues
      exactly the `net` collectives that `collectives` lists; measured
      `optimize` ranks alike on every rank; the sum over ranks of each
      leaf's gradient of (out * g).sum(), divided by W, within 2e-4 of
      `jax.grad`; a state that does not divide by W raises ValueError;
      a fn node declared splittable on N only (a softmax over H) is never
      split on H, by the solver or by compile, and its plans match JAX's;
      the RS plan, where the lowering sums a partial and the solver
      priced a reshard, pinned on both sides;
  (e) at world 1 with no group: the default plan and the identity
      collectives.

The ranks import this module, so jax is imported only inside the
functions the pytest process calls (`_jax`).
"""

import collections
import contextlib
import itertools

import numpy as np
import pytest
import torch

from tutel_tpu_torch import net, parted
from tutel_tpu_torch.parted import solver, spmdx
from tutel_tpu_torch.parted.spmdx import REPLICATED, ZERO
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

TOP = dict(rtol=2e-5, atol=2e-5)          # tests/test_parted.py's
FORCED = dict(rtol=2e-4, atol=2e-4)
GRADS = dict(rtol=2e-4, atol=2e-4)
COLLECTIVES = ("all-gather", "all-reduce", "all-to-all", "reduce-scatter")


def _jax():
    import jax
    import jax.numpy as jnp
    from tutel_tpu import parted as jparted
    from tutel_tpu.parted import solver as jsolver
    from tutel_tpu.parted import spmdx as jspmdx
    return jax, jnp, jparted, jspmdx, jsolver


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(w):
        if w not in made:
            made[w] = RankPool(w, str(tmp_path_factory.mktemp(f"ranks{w}")))
        return made[w]
    yield get
    for p in made.values():
        p.close()


# ---------------------------------------------------------------------------
# The graphs, built alike in both packages
# ---------------------------------------------------------------------------

def _relu(side):
    return torch.relu if side == "torch" else _jax()[0].nn.relu


def _mod(side):
    return spmdx if side == "torch" else _jax()[3]


def _mlp(side, n=512, k=64, m=64, h=128):
    """tests/test_parted.py's `_mlp_graph`."""
    mod = _mod(side)
    x = mod.data((n, k), name="x")
    w1 = mod.param((k, h), name="w1")
    w2 = mod.param((h, m), name="w2")
    y1 = mod.custom("NH = NK, KH+", [x, w1], name="y1")
    act = mod.custom("NH = NH", [y1], name="act", fn=_relu(side))
    return mod.custom("NM = NH, HM+", [act, w2], name="y2")


def _matmul(side, n, k, m):
    mod = _mod(side)
    x = mod.data((n, k), name="x")
    w = mod.param((k, m), name="w")
    return mod.custom("NM = NK, KM+", [x, w], name="y")


def _two_branches(side):
    """x feeds two matmuls whose sum is the output (multi-consumer)."""
    mod = _mod(side)
    x = mod.data((256, 64), name="x")
    wa = mod.param((64, 64), name="wa")
    wb = mod.param((64, 64), name="wb")
    a = mod.custom("NM = NK, KM+", [x, wa], name="a")
    b = mod.custom("NM = NK, KM+", [x, wb], name="b")
    return mod.custom("NM = NM, NM", [a, b], name="s",
                      fn=lambda u, v: u + v)


def _residual(side, blocks):
    """h <- h + h @ w_i, `blocks` times: every h feeds two ops, so with 4
    blocks the ops outnumber the enumeration (the multi-consumer branch)
    and with 8 the multi-consumer nodes do too (the outputs-only
    branch)."""
    mod = _mod(side)
    h = mod.data((64, 64), name="x")
    for i in range(blocks):
        w = mod.param((64, 64), name=f"w{i}")
        f = mod.custom("NM = NK, KM+", [h, w], name=f"f{i}")
        h = mod.custom("NM = NM, NM", [h, f], name=f"h{i}",
                       fn=lambda u, v: u + v)
    return h


def _softmax_mlp(side):
    """The MLP with a softmax over H as its activation. The port declares
    that it may be split on N only; JAX's program is right for any plan."""
    mod = _mod(side)
    x = mod.data((256, 64), name="x")
    w1 = mod.param((64, 128), name="w1")
    w2 = mod.param((128, 64), name="w2")
    y1 = mod.custom("NH = NK, KH+", [x, w1], name="y1")
    if side == "torch":
        act = mod.custom("NH = NH", [y1], name="act", split_letters="N",
                         fn=lambda v: torch.softmax(v, -1))
    else:
        act = mod.custom("NH = NH", [y1], name="act",
                         fn=lambda v: _jax()[0].nn.softmax(v, axis=-1))
    return mod.custom("NM = NH, HM+", [act, w2], name="y2")


GRAPHS = {
    "mlp": lambda s: _mlp(s),
    "softmax": _softmax_mlp,
    "mlp_big_batch": lambda s: _mlp(s, n=4096, k=64, m=64, h=128),
    "mlp_giant_weights": lambda s: _mlp(s, n=8, k=1024, m=1024, h=4096),
    "mlp_small": lambda s: _mlp(s, n=256, k=32, m=32, h=64),
    "two_branches": _two_branches,
    "giant_weight": lambda s: _matmul(s, 8, 1024, 4096),
    "k_split": lambda s: _matmul(s, 64, 512, 64),
    "square": lambda s: _matmul(s, 64, 64, 64),
    "residual4": lambda s: _residual(s, 4),
    "residual8": lambda s: _residual(s, 8),
    "odd": lambda s: _matmul(s, 16, 9, 8),
}


def _graph(side, name):
    return _mod(side).Graph([GRAPHS[name](side)])


def _inputs(graph, seed):
    """One array a leaf, in the program's leaf order: data normal(0, 1),
    params normal(0, 0.1)."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n.shape) * (1.0 if n.op_type == "data"
                                             else 0.1)).astype(np.float32)
            for n in graph.nodes if n.op_type in ("data", "param")]


def _branch(graph, world):
    """Which of solve_partition's three enumerations the graph takes."""
    multi = [n for n in graph.nodes
             if len(n.consumers) > 1 or n in graph.outputs]
    ops = [n for n in graph.nodes if n.op_type == "op"]

    def combos(nodes):
        return np.prod([len(solver._node_states(n, world)) for n in nodes])
    if combos(list(dict.fromkeys(multi + ops))) <= 4096:
        return "every_op"
    return "multi" if combos(multi) <= 4096 else "outputs"


# ---------------------------------------------------------------------------
# (a) The IR
# ---------------------------------------------------------------------------

SPECS = ["NM = NK, KM+", "NM+ = NK, KM", "NM = NK, KM<", "NM = NK, KM>",
         "NM = NK, KM[", "NM = NK, KM]", "N = NKJ, KJ+", "NH = NH",
         "BNM = BNK, KM+"]


@pytest.mark.parametrize("spec", SPECS)
def test_parser_matches_jax(spec):
    mine, ref = spmdx.Parser(spec), _jax()[3].Parser(spec)
    for attr in ("out_dims", "in_dims", "reduce_type", "reduce_axes"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert mine.einsum_expr() == ref.einsum_expr()


def test_parser_refuses_a_dropped_dim_without_marker():
    with pytest.raises(ValueError):
        spmdx.Parser("NM = NK, KM")
    with pytest.raises(ValueError):
        _jax()[3].Parser("NM = NK, KM")


def test_custom_refuses_split_letters_not_of_the_output():
    y1 = spmdx.custom("NH = NK, KH+", [spmdx.data((8, 4)),
                                       spmdx.param((4, 6))])
    with pytest.raises(ValueError):
        spmdx.custom("NH = NH", [y1], fn=torch.relu, split_letters="K")
    act = spmdx.custom("NH = NH", [y1], fn=torch.relu, split_letters="N")
    assert act.may_split(0) and not act.may_split(1) and y1.may_split(1)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_shapes_and_flops_match_jax(name):
    mine, ref = _graph("torch", name), _graph("jax", name)
    assert [n.name for n in mine.nodes] == [n.name for n in ref.nodes]
    for a, b in zip(mine.nodes, ref.nodes):
        assert (a.op_type, a.shape, a.size, a.flops()) == \
            (b.op_type, b.shape, b.size, b.flops()), a.name
        assert [c.name for c in a.consumers] == [c.name for c in b.consumers]
    y = spmdx.custom("NM = NK, KM+", [spmdx.data((64, 32)),
                                      spmdx.param((32, 16))])
    assert y.shape == (64, 16) and y.flops() == 2 * 64 * 32 * 16


# ---------------------------------------------------------------------------
# (b) The solver's rankings, (c) its optimality
# ---------------------------------------------------------------------------

SOLVER_GRAPHS = ["mlp", "mlp_big_batch", "mlp_giant_weights", "two_branches",
                 "giant_weight", "residual4", "residual8"]


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("name", SOLVER_GRAPHS)
def test_solver_ranking_equals_jax(name, world):
    mine = solver.solve_partition(_graph("torch", name), world)
    ref = _jax()[4].solve_partition(_graph("jax", name), world)
    assert len(mine) == len(ref)
    assert [(c, dict(cfg)) for c, cfg in mine] == \
        [(c, dict(cfg)) for c, cfg in ref]


@pytest.mark.parametrize("world", [2, 4, 8])
def test_solver_keeps_a_fn_to_its_split_letters(world):
    """A fn node that may be split on N only: the port ranks JAX's plans
    less those that split it on H, in JAX's order and at JAX's costs."""
    mine = solver.solve_partition(_graph("torch", "softmax"), world)
    ref = _jax()[4].solve_partition(_graph("jax", "softmax"), world)
    assert any(cfg["act"] == 1 for _, cfg in ref)
    assert [(c, dict(cfg)) for c, cfg in mine] == \
        [(c, dict(cfg)) for c, cfg in ref if cfg["act"] != 1]


@pytest.mark.parametrize("world", [2, 4, 8])
def test_solver_reaches_every_branch(world):
    assert _branch(_graph("torch", "mlp"), world) == "every_op"
    assert _branch(_graph("torch", "residual4"), world) == "multi"
    assert _branch(_graph("torch", "residual8"), world) == "outputs"


def test_solver_prefers_data_parallel_for_big_batch():
    (cost, cfg), = solver.solve_partition(
        _graph("torch", "mlp_big_batch"), 8)[:1]
    assert cfg["x"] == 0 and cfg["y1"] == 0 and cfg["y2"] == 0, cfg
    assert cfg["w1"] in (REPLICATED, ZERO) and cfg["w2"] in (REPLICATED,
                                                            ZERO), cfg


def test_solver_shards_giant_weights():
    (cost, cfg), = solver.solve_partition(
        _graph("torch", "mlp_giant_weights"), 8)[:1]
    assert cfg["w1"] != REPLICATED and cfg["w2"] != REPLICATED, cfg


@pytest.mark.parametrize("world", [2, 8])
@pytest.mark.parametrize("name", ["mlp", "two_branches", "giant_weight"])
def test_solver_matches_bruteforce_small(name, world):
    """tests/test_parted.py's optimality check on the port's solver: the
    best plan prices exactly at the brute-force minimum of its own cost
    model, every node's state enumerated."""
    graph = _graph("torch", name)
    best = None
    for states in itertools.product(*[solver._node_states(n, world)
                                       for n in graph.nodes]):
        fixed = {n.name: s for n, s in zip(graph.nodes, states)}
        cost, cfg = solver.evaluate_assignment(graph, world, fixed)
        if best is None or cost < best[0]:
            best = (cost, cfg)
    ranked = solver.solve_partition(graph, world)
    assert ranked[0][0] <= best[0] + 1e-9, (ranked[0], best)
    np.testing.assert_allclose(ranked[0][0], best[0], rtol=1e-12)


# ---------------------------------------------------------------------------
# (d) Programs over W gloo ranks against the JAX program on W devices
# ---------------------------------------------------------------------------

# name: (graph, config, the collective its compiled_text must name, the
# kinds its run issues)
FORCED_PLANS = {
    "far": ("k_split", {"x": 1, "w": 0, "y": REPLICATED}, "all-reduce",
            ["all-reduce"]),
    "zero": ("square", {"x": 0, "w": ZERO, "y": 0}, "all-gather",
             ["all-gather", "all-gather"]),
    "a2a": ("mlp", {"x": 0, "w1": REPLICATED, "y1": 0, "act": 1, "w2": 0,
                    "y2": REPLICATED}, "all-to-all",
            ["all-to-all", "all-reduce"]),
    "rs": ("mlp", {"x": 1, "w1": 0, "y1": 0, "act": 0, "w2": REPLICATED,
                   "y2": 0}, "reduce-scatter",
           ["reduce-scatter", "all-gather"]),
}

_WRAPPED = {"simple_all_gather": "all-gather",
            "simple_all_reduce": "all-reduce", "all_to_all": "all-to-all",
            "simple_reduce_scatter": "reduce-scatter"}


@contextlib.contextmanager
def _counting(calls):
    """Count the calls of net's four collectives by kind."""
    saved = {name: getattr(net, name) for name in _WRAPPED}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls[_WRAPPED[name]] += 1
            return fn(*args, **kwargs)
        return counted
    try:
        for name, fn in saved.items():
            setattr(net, name, wrap(name, fn))
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(net, name, fn)


def _rank_programs(name, configs, arrays, cotangent):
    """In every rank: each config's program on the full arrays, its output,
    the net collectives its run issued, its listed collectives and text,
    and the gradient of (out * cotangent).sum() of each leaf."""
    parted.init(device="cpu")
    out = GRAPHS[name]("torch")
    results = []
    for cfg in configs:
        prog = parted.compile_graph(out, spmdx.Config(cfg))
        leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
        calls = collections.Counter()
        with _counting(calls):
            y = prog(*leaves)
        (y * torch.from_numpy(cotangent)).sum().backward()
        results.append({
            "out": y.detach().numpy(), "calls": dict(calls),
            "listed": [c.kind for c in prog.collectives],
            "text": prog.compiled_text(),
            "grads": [t.grad.numpy() for t in leaves]})
    return {"world": parted.session.world, "rank": parted.session.rank,
            "results": results}


def _rank_optimize(name, top_k, measure):
    parted.init(device="cpu")
    ranked = parted.optimize(GRAPHS[name]("torch"), top_k=top_k,
                             measure=measure, max_candidates=top_k)
    return [(t, dict(cfg)) for t, cfg in ranked]


def _rank_schedule(name, cfg):
    parted.init(device="cpu")
    prog = parted.compile_graph(GRAPHS[name]("torch"), spmdx.Config(cfg))
    return [tuple(c) for c in prog.collectives]


def _rank_refuses(name, cfg):
    parted.init(device="cpu")
    try:
        parted.compile_graph(GRAPHS[name]("torch"), spmdx.Config(cfg))
    except ValueError as exc:
        return str(exc)
    return None


def _jax_programs(name, configs, arrays, cotangent, world):
    """The JAX program of each config on `world` devices: (out, grads)."""
    jax, jnp, jparted, jspmdx, _ = _jax()
    jparted.init(jax.devices()[:world])
    out = GRAPHS[name]("jax")
    refs = []
    for cfg in configs:
        prog = jspmdx.compile(out, jspmdx.Config(cfg))
        args = [jnp.asarray(a) for a in arrays]
        g = jnp.asarray(cotangent)
        grads = jax.grad(lambda *a: jnp.sum(prog(*a) * g),
                         argnums=tuple(range(len(args))))(*args)
        refs.append((np.asarray(prog(*args)), [np.asarray(t) for t in grads]))
    return refs


def _check_programs(got, refs, world, out_tol):
    assert [r["world"] for r in got] == [world] * world
    assert [r["rank"] for r in got] == list(range(world))
    for i, (ref_out, ref_grads) in enumerate(refs):
        per_rank = [r["results"][i] for r in got]
        for res in per_rank:
            np.testing.assert_allclose(res["out"], ref_out, **out_tol)
            # the run issued exactly the collectives the program lists
            assert res["calls"] == dict(collections.Counter(res["listed"]))
        for j, ref_g in enumerate(ref_grads):
            total = sum(res["grads"][j] for res in per_rank) / world
            np.testing.assert_allclose(total, ref_g, **GRADS,
                                       err_msg=f"plan {i}, leaf {j}")


@pytest.mark.parametrize("world", [2, 4])
def test_top_plans_match_jax(pools, world):
    """tests/test_parted.py::test_compiled_program_matches_unsharded at W
    ranks: the four best plans, their outputs and gradients against the
    JAX program's."""
    graph = _graph("torch", "mlp")
    ranked = solver.solve_partition(graph, world)[:4]
    jranked = _jax()[4].solve_partition(_graph("jax", "mlp"), world)[:4]
    assert [dict(c) for _, c in ranked] == [dict(c) for _, c in jranked]
    configs = [dict(c) for _, c in ranked]
    arrays = _inputs(graph, seed=world)
    g = np.random.default_rng(world + 10).standard_normal(
        graph.outputs[0].shape).astype(np.float32)
    got = pools(world).run(_rank_programs, "mlp", configs, arrays, g)
    _check_programs(got, _jax_programs("mlp", configs, arrays, g, world),
                    world, TOP)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("plan", sorted(FORCED_PLANS))
def test_forced_plan_matches_jax(pools, plan, world):
    """The FAR plan of test_gspmd_inserts_allreduce_for_k_split, the ZERO
    plan of test_zero_param_allgathers_on_use, and the A2A and RS plans on
    the MLP: outputs and gradients against JAX's, and the collective each
    one is named for in its compiled_text, issued as listed."""
    name, cfg, named, kinds = FORCED_PLANS[plan]
    graph = _graph("torch", name)
    arrays = _inputs(graph, seed=len(plan) + world)
    g = np.random.default_rng(world).standard_normal(
        graph.outputs[0].shape).astype(np.float32)
    got = pools(world).run(_rank_programs, name, [cfg], arrays, g)
    _check_programs(got, _jax_programs(name, [cfg], arrays, g, world),
                    world, FORCED)
    for r in got:
        res = r["results"][0]
        assert res["listed"] == kinds, res["text"]
        assert named in res["text"], res["text"]
        assert all(k in COLLECTIVES for k in res["listed"])


@pytest.mark.parametrize("world", [2, 4])
def test_fn_split_letters_plans_match_jax(pools, world):
    """The softmax MLP's four best plans (none splits the softmax on H)
    against the JAX program's; a forced split on H is refused."""
    configs = [dict(c) for _, c in solver.solve_partition(
        _graph("torch", "softmax"), world)[:4]]
    graph = _graph("torch", "softmax")
    arrays = _inputs(graph, seed=world + 20)
    g = np.random.default_rng(world + 30).standard_normal(
        graph.outputs[0].shape).astype(np.float32)
    got = pools(world).run(_rank_programs, "softmax", configs, arrays, g)
    _check_programs(got, _jax_programs("softmax", configs, arrays, g,
                                       world), world, TOP)
    msgs = pools(world).run(_rank_refuses, "softmax", {"x": 0, "y1": 0,
                                                       "act": 1})
    assert all(m is not None and "may be split only on 'N'" in m
               for m in msgs), msgs


def test_lowering_sums_a_partial_where_the_solver_priced_a_reshard(pools):
    """The RS plan at W = 2: the solver prices y1 (split on N) as an A2A
    of x and an AG of w1; the lowering sums y1's partial over K and
    reduce-scatters it, since x and w1 are already split on K. Both sides
    are pinned here, so that a change to either shows."""
    name, cfg, _, _ = FORCED_PLANS["rs"]
    graph = _graph("torch", name)
    y1 = next(n for n in graph.nodes if n.name == "y1")
    needs = [solver._required_input_state(y1, cfg["y1"], i)
             for i in range(len(y1.inputs))]
    assert needs == [0, REPLICATED]
    assert [solver._reshard_cost(inp, cfg[inp.name], need, 2)
            for inp, need in zip(y1.inputs, needs)] == \
        [inp.size * 4 / 2 for inp in y1.inputs]      # A2A of x, AG of w1
    got = pools(2).run(_rank_schedule, name, cfg)
    assert got == [[("reduce-scatter", "y1", "y1", (0,)),
                    ("all-gather", "y2", "output", (0,))]] * 2


@pytest.mark.parametrize("world", [2, 4])
def test_measured_optimize_ranks_alike(pools, world):
    """optimize(measure=True): every rank holds each plan's largest time
    over the ranks, so every rank ranks the same plans in the same order."""
    got = pools(world).run(_rank_optimize, "mlp_small", 3, True)
    assert all(r == got[0] for r in got), got
    times = [t for t, _ in got[0]]
    assert len(times) == 3 and times == sorted(times)
    assert all(t > 0 for t in times)
    top3 = [dict(c) for _, c in solver.solve_partition(
        _graph("torch", "mlp_small"), world)[:3]]
    assert sorted(map(str, (c for _, c in got[0]))) == \
        sorted(map(str, top3))


@pytest.mark.parametrize("world", [2, 4])
def test_state_that_does_not_divide_raises(pools, world):
    """GSPMD pads such a state; the port refuses it at compile time."""
    got = pools(world).run(_rank_refuses, "odd", {"x": 1, "w": 0,
                                                  "y": REPLICATED})
    assert all(m is not None and "does not divide" in m for m in got), got
    assert pools(world).run(_rank_refuses, "odd", {"x": 0, "w": REPLICATED,
                                                   "y": 0}) == [None] * world


# ---------------------------------------------------------------------------
# (e) One rank, no group
# ---------------------------------------------------------------------------

def test_world1_default_plan_and_identity_collectives():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            parted.init()
    parted.init(device="cpu")
    assert parted.session.world == 1 and parted.session.rank == 0
    graph = _graph("torch", "mlp")
    ranked = parted.optimize(graph.outputs[0], top_k=0)
    jranked = _jax()[4].solve_partition(_graph("jax", "mlp"), 1)
    assert [(c, dict(cfg)) for c, cfg in ranked] == \
        [(c, dict(cfg)) for c, cfg in jranked] == \
        [(0.0, {n.name: REPLICATED for n in graph.nodes})]
    arrays = [torch.from_numpy(a) for a in _inputs(graph, seed=1)]
    ref = torch.relu(arrays[0] @ arrays[1]) @ arrays[2]
    for cfg in [ranked[0][1]] + [FORCED_PLANS[p][1] for p in ("a2a", "rs")]:
        prog = parted.compile_graph(graph.outputs[0], spmdx.Config(cfg))
        calls = collections.Counter()
        with _counting(calls):
            out = prog(*arrays)
        assert dict(calls) == dict(collections.Counter(
            c.kind for c in prog.collectives))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOP)
    (t, cfg), = parted.optimize(graph.outputs[0], top_k=3, measure=True)
    assert t > 0 and cfg == ranked[0][1]
    prog = parted.compile_graph(graph.outputs[0], cfg)
    a, b = prog.example_inputs(3), prog.example_inputs(3)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert [tuple(u.shape) for u in a] == [n.shape for n in prog.leaves]
