"""Port parity: the GPipe and 1F1B pipelines (`parallel.pipeline`,
`parallel.pipeline_1f1b`), `MOELayer.local_forward` / `param_specs` and
the pipeline examples, at 2 and 4 gloo ranks (`testing.RankPool`) against
the JAX package on the same number of virtual CPU devices, from the same
parameters and input.

Cases: an MLP stage at 2 and 4 stages (outputs and gradients of GPipe,
with remat and an n_micro that is no multiple of the stages; 1F1B's loss
and gradients), a MoE stage with its aux (GPipe forward and aux, 1F1B loss
and gradients), PP x EP on a (pp 2, e 2) mesh of 4 ranks whose stages run
`local_forward` of a MoE layer over their 'e' line (top-2 and expert
choice; GPipe outputs, aux and gradients, 1F1B loss and gradients), PP x
DP on a (pp 2, d 2) mesh, the validations, `param_specs` against
`shard_params` leaf by leaf (and against JAX's specs), and the losses of
helloworld_pipeline, helloworld_1f1b and helloworld_expert_choice against
the JAX examples.

Tolerances: outputs, losses and gradients within 3e-5 (absolute and
relative); the examples' losses within 1e-5 relative.

The ranks import this module, so jax is imported only inside the
functions the pytest process calls (`_jax`).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.parallel import (MoeMesh, ProcessMesh,
                                      local_stage_params, pipeline,
                                      pipeline_1f1b, stack_stage_params)
from tutel_tpu_torch.testing import RankPool
from tutel_tpu_torch.utils import tree_leaves, tree_replace

torch.set_num_threads(1)

TOL = dict(rtol=3e-5, atol=3e-5)


def _jax():
    import importlib
    import jax
    import jax.numpy as jnp
    # the module (the package's __init__ binds the name to the function)
    jpipe = importlib.import_module("tutel_tpu.parallel.pipeline")
    return jax, jnp, jpipe


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


def _np(tree):
    return [np.asarray(t) for t in tree_leaves(tree)]


def _close(got, ref, what=""):
    for g, r in zip(_np(got), _np(ref)):
        np.testing.assert_allclose(g, r, err_msg=what, **TOL)


# ---------------------------------------------------------------------------
# An MLP stage
# ---------------------------------------------------------------------------

def _mlp_stage(p, x):
    return x + torch.nn.functional.gelu(x @ p["w1"]) @ p["w2"]


def _jax_mlp_stage(p, x):
    jax, _, _ = _jax()
    return x + jax.nn.gelu(x @ p["w1"], approximate=False) @ p["w2"]


def _jax_mlp(n_stages, dim, hidden, seed):
    jax, _, jpipe = _jax()
    ks = jax.random.split(jax.random.PRNGKey(seed), n_stages)
    per = [{"w1": jax.random.normal(k, (dim, hidden)) * 0.1,
            "w2": jax.random.normal(jax.random.fold_in(k, 1),
                                    (hidden, dim)) * 0.1} for k in ks]
    return jpipe.stack_stage_params(per)


def _mesh(w, names=("pp",), shape=None):
    return ProcessMesh(range(w), shape or (w,), names)


def _rank_mlp(s, nm, remat, stacked, x, cot):
    mesh = _mesh(s)
    local = local_stage_params(stacked, mesh)
    leaves = [p.requires_grad_(True) for p in tree_leaves(local)]
    y = pipeline(_mlp_stage, s, mesh, n_micro=nm, remat=remat)(local, x)
    grads = torch.autograd.grad((y * cot).sum(), leaves)
    loss, g1 = pipeline_1f1b(_mlp_stage, lambda yy: (yy ** 2).sum(), s, mesh,
                             n_micro=nm)(
        tree_replace(local, [p.detach() for p in leaves]), x)
    return (y.detach().numpy(), [g.numpy() for g in grads], float(loss),
            [g.numpy() for g in tree_leaves(g1)])


@pytest.mark.parametrize("s,nm,remat", [(2, 4, False), (2, 5, True),
                                        (4, 8, False), (4, 5, True)])
def test_mlp_pipelines_match_jax(pools, s, nm, remat):
    """GPipe's outputs and gradients, 1F1B's loss and gradients, against
    JAX's schedules on s devices (which equal the sequential run there)."""
    jax, jnp, jpipe = _jax()
    dim, hidden = 8, 16
    stacked = _jax_mlp(s, dim, hidden, s + nm)
    rng = np.random.default_rng(nm)
    x = rng.standard_normal((nm * 3, dim)).astype(np.float32)
    cot = rng.standard_normal((nm * 3, dim)).astype(np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:s]), ("pp",))
    fn = jpipe.pipeline(_jax_mlp_stage, s, mesh, n_micro=nm, remat=remat)
    y_ref = jax.jit(fn)(stacked, jnp.asarray(x))
    g_ref = jax.jit(jax.grad(lambda p: jnp.sum(fn(p, jnp.asarray(x)) * cot)))(
        stacked)
    l_ref, g1_ref = jax.jit(jpipe.pipeline_1f1b(
        _jax_mlp_stage, lambda yy: jnp.sum(yy ** 2), s, mesh,
        n_micro=nm))(stacked, jnp.asarray(x))
    got = pools(s).run(_rank_mlp, s, nm, remat,
                       convert.from_jax_params(stacked, "cpu"),
                       torch.from_numpy(x), torch.from_numpy(cot))
    for rank, (y, grads, loss, g1) in enumerate(got):
        np.testing.assert_allclose(y, np.asarray(y_ref), **TOL)
        _close(grads, [np.asarray(v)[rank:rank + 1]
                       for v in tree_leaves(g_ref)], "gpipe")
        np.testing.assert_allclose(loss, float(l_ref), **TOL)
        _close(g1, [np.asarray(v)[rank:rank + 1]
                    for v in tree_leaves(g1_ref)], "1f1b")


def test_validations():
    """Without a process group a mesh is this one rank: the checks run
    before any exchange."""
    mesh = _mesh(2)
    for make in (lambda s: pipeline(_mlp_stage, s, mesh, n_micro=4),
                 lambda s: pipeline_1f1b(_mlp_stage, torch.sum, s, mesh,
                                         n_micro=4)):
        with pytest.raises(ValueError, match="not divisible"):
            make(2)({"w1": torch.zeros(1, 8, 8), "w2": torch.zeros(1, 8, 8)},
                    torch.zeros(10, 8))
        with pytest.raises(ValueError, match="mesh axis"):
            make(3)


# ---------------------------------------------------------------------------
# MoE stages
# ---------------------------------------------------------------------------

D = 16


def _moe_kwargs(gate="top"):
    g = ({"type": "top", "k": 2, "capacity_factor": 1.0, "gate_noise": 0.0}
         if gate == "top" else
         {"type": "expert_choice", "capacity_factor": 2.0, "gate_noise": 0.0})
    return dict(gate_type=g, experts={"type": "ffn",
                                      "num_experts_per_device": 4,
                                      "hidden_size_per_expert": 32},
                model_dim=D, seeds=(1, 1, 1))


def _jax_moe_params(n_stages, w=1, gate="top"):
    jax, _, jpipe = _jax()
    from tutel_tpu import moe as jmoe
    kw = _moe_kwargs(gate)
    kw["experts"] = {**kw["experts"], "num_experts_per_device": 4 // w}
    layer = jmoe.moe_layer(group=jax.devices()[:w], **kw)
    per = [layer.init(jax.random.PRNGKey(10 + i)) for i in range(n_stages)]
    return layer, per, jpipe.stack_stage_params(per)


def _loss_sum(y):
    return (y ** 2).sum()


def _rank_moe(nm, stacked, x):
    mesh = _mesh(2)
    layer = tmoe.moe_layer(group=[dist.get_rank()], device="cpu",
                           **_moe_kwargs())

    def stage(p, h):
        out, l_aux = layer(p, h)
        return h + out, l_aux
    local = local_stage_params(stacked, mesh)
    with torch.no_grad():
        y, aux = pipeline(stage, 2, mesh, n_micro=nm, has_aux=True)(local, x)
    loss, grads = pipeline_1f1b(stage, _loss_sum, 2, mesh, n_micro=nm,
                                has_aux=True)(local, x)
    return y.numpy(), float(aux), float(loss), _np(grads)


def test_moe_stage_with_aux_matches_jax(pools):
    jax, jnp, jpipe = _jax()
    layer, _, stacked = _jax_moe_params(2)
    key = jax.random.PRNGKey(42)

    def stage(p, h):
        out, l_aux = layer(p, h, key=key)
        return h + out, l_aux
    x = np.array(jax.random.normal(jax.random.PRNGKey(6), (12, D)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("pp",))
    y_ref, aux_ref = jax.jit(jpipe.pipeline(stage, 2, mesh, n_micro=3,
                                            has_aux=True))(stacked,
                                                           jnp.asarray(x))
    l_ref, g_ref = jax.jit(jpipe.pipeline_1f1b(
        stage, lambda yy: jnp.sum(yy ** 2), 2, mesh, n_micro=3,
        has_aux=True))(stacked, jnp.asarray(x))
    got = pools(2).run(_rank_moe, 3, convert.from_jax_params(stacked, "cpu"),
                       torch.from_numpy(x))
    for rank, (y, aux, loss, grads) in enumerate(got):
        np.testing.assert_allclose(y, np.asarray(y_ref), **TOL)
        np.testing.assert_allclose(aux, float(aux_ref), **TOL)
        np.testing.assert_allclose(loss, float(l_ref), **TOL)
        _close(grads, [np.asarray(v)[rank:rank + 1]
                       for v in tree_leaves(g_ref)])


# ---------------------------------------------------------------------------
# PP x EP and PP x DP on 4 ranks
# ---------------------------------------------------------------------------

PPEP = ("pp", "e", "r", "g")


def _ppep_stage(gate):
    """This rank's stage body: local_forward of a layer over its 'e'
    line, and the stage's param specs."""
    mesh = _mesh(4, PPEP, (2, 2, 1, 1))
    kw = _moe_kwargs(gate)
    kw["experts"] = {**kw["experts"], "num_experts_per_device": 2}
    layer = tmoe.moe_layer(group=mesh.group("e"), device="cpu", **kw)
    local_fn = layer.local_forward()

    def stage(p, h):
        out, l_aux = local_fn(p, h)
        return h + out, l_aux
    return mesh, layer, stage


def _rank_ppep(gate, nm, stacked, x, cot, wt):
    mesh, layer, stage = _ppep_stage(gate)
    specs = layer.param_specs(tree_replace(stacked, [
        p[0] for p in tree_leaves(stacked)]))
    local = local_stage_params(stacked, mesh, stage_param_specs=specs)
    leaves = [p.requires_grad_(True) for p in tree_leaves(local)]
    kw = dict(n_micro=nm, has_aux=True, data_spec=("e",),
              stage_param_specs=specs)
    y, aux = pipeline(stage, 2, mesh, **kw)(local, x)
    rows = cot.reshape(nm, 2, -1, D)[:, mesh.index("e")]
    # this rank's share of the global loss: its rows, and the replicated
    # aux over the 'e' size
    share = (y * rows.reshape(-1, D)).sum() + wt * aux / 2
    grads = torch.autograd.grad(share, leaves)
    loss, g1 = pipeline_1f1b(stage, _loss_sum, 2, mesh, **kw)(
        tree_replace(local, [p.detach() for p in leaves]), x)
    return (mesh.index("pp"), mesh.index("e"), y.detach().numpy(),
            float(aux), [g.numpy() for g in grads], float(loss), _np(g1),
            specs)


@pytest.mark.parametrize("gate", ["top", "expert_choice"])
def test_pp_ep_matches_jax(pools, gate):
    """2 stages x 2-rank EP rows: each stage's experts split over its 'e'
    line by param_specs, its body local_forward; against JAX's pipelines
    on the same ('pp', 'e', 'r', 'g') mesh of 4 devices."""
    jax, jnp, jpipe = _jax()
    from jax.sharding import PartitionSpec as P
    layer, per, stacked = _jax_moe_params(2, w=2, gate=gate)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1, 1),
                             PPEP)
    local = layer.local_forward()
    key = jax.random.PRNGKey(42)

    def stage(p, h):
        out, l_aux = local(p, h, key)
        return h + out, l_aux
    specs = {"gates": jax.tree.map(lambda _: None, per[0]["gates"]),
             "experts": jax.tree.map(lambda _: P("e"), per[0]["experts"])}
    nm, wt = 3, 0.01
    rng = np.random.default_rng(6)
    x = rng.standard_normal((48, D)).astype(np.float32)
    cot = rng.standard_normal((48, D)).astype(np.float32)
    kw = dict(n_micro=nm, has_aux=True, data_spec=P("e"),
              stage_param_specs=specs)
    fn = jpipe.pipeline(stage, 2, mesh, **kw)
    y_ref, aux_ref = jax.jit(fn)(stacked, jnp.asarray(x))

    def share(p):
        y, aux = fn(p, jnp.asarray(x))
        return jnp.sum(y * cot) + wt * aux
    g_ref = jax.jit(jax.grad(share))(stacked)
    l_ref, g1_ref = jax.jit(jpipe.pipeline_1f1b(
        stage, lambda yy: jnp.sum(yy ** 2), 2, mesh, **kw))(
        stacked, jnp.asarray(x))
    g_ref, g1_ref = jax.device_get(g_ref), jax.device_get(g1_ref)
    got = pools(4).run(_rank_ppep, gate, nm,
                       convert.from_jax_params(jax.device_get(stacked),
                                               "cpu"),
                       torch.from_numpy(x), torch.from_numpy(cot), wt)
    y_ref = np.asarray(y_ref).reshape(nm, 2, -1, D)
    for pp, e, y, aux, grads, loss, g1, specs_t in got:
        np.testing.assert_allclose(y.reshape(nm, -1, D), y_ref[:, e], **TOL)
        np.testing.assert_allclose(aux, float(aux_ref), **TOL)
        np.testing.assert_allclose(loss, float(l_ref), **TOL)
        tmesh = _FakeMesh({"pp": (2, pp), "e": (2, e), "r": (1, 0),
                           "g": (1, 0)})
        for ref_tree, mine in ((g_ref, grads), (g1_ref, g1)):
            ref = local_stage_params(convert.from_jax_params(ref_tree, "cpu"),
                                     tmesh, stage_param_specs=specs_t)
            _close(mine, ref, gate)


class _FakeMesh(ProcessMesh):
    """A mesh seen from one given rank, for slicing references in the
    pytest process: {axis: (size, this rank's index)}."""

    def __init__(self, axes):
        self.names = tuple(axes)
        self.shape = tuple(s for s, _ in axes.values())
        self._at = {a: i for a, (_, i) in axes.items()}

    def index(self, axes):
        out = 0
        for a in self._axes(axes):
            out = out * self.shape[self.names.index(a)] + self._at[a]
        return out


def _rank_ppdp(stacked, x):
    mesh = _mesh(4, ("pp", "d"), (2, 2))
    specs = {"w1": None, "w2": None}
    local = local_stage_params(stacked, mesh, stage_param_specs=specs)
    loss, grads = pipeline_1f1b(_mlp_stage, _loss_sum, 2, mesh, n_micro=3,
                                data_spec=("d",), stage_param_specs=specs)(
        local, x)
    return mesh.index("pp"), float(loss), _np(grads)


def test_pp_dp_1f1b_matches_jax(pools):
    jax, jnp, jpipe = _jax()
    stacked = _jax_mlp(2, 8, 16, 0)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (24, 8)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("pp", "d"))
    from jax.sharding import PartitionSpec as P
    l_ref, g_ref = jax.jit(jpipe.pipeline_1f1b(
        _jax_mlp_stage, lambda yy: jnp.sum(yy ** 2), 2, mesh, n_micro=3,
        data_spec=P("d"), stage_param_specs={"w1": None, "w2": None}))(
        stacked, jnp.asarray(x))
    got = pools(4).run(_rank_ppdp, convert.from_jax_params(stacked, "cpu"),
                       torch.from_numpy(x))
    for pp, loss, grads in got:
        np.testing.assert_allclose(loss, float(l_ref), **TOL)
        _close(grads, [np.asarray(v)[pp:pp + 1]
                       for v in tree_leaves(jax.device_get(g_ref))])


# ---------------------------------------------------------------------------
# param_specs against shard_params
# ---------------------------------------------------------------------------

SPEC_CASES = {"ep": ({}, 0, False), "ep_fused": ({"hidden": 128}, 4, True),
              "sliced": ({"nle": -2}, 0, False),
              "sliced_int4": ({"nle": -2, "bias": False}, 4, False),
              "sliced_int8": ({"nle": -2}, 8, False),
              "ep_2dh": ({"use_2dh": True, "num_hosts": 2}, 0, False)}


def _spec_kwargs(spec, w):
    spec = dict(spec)
    bias = spec.pop("bias", True)
    return dict(gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
                experts={"type": "ffn",
                         "num_experts_per_device": spec.pop("nle", 8 // w),
                         "hidden_size_per_expert": spec.pop("hidden", 64),
                         "has_fc1_bias": bias, "has_fc2_bias": bias},
                model_dim=32, **spec)


def _rank_specs(spec, params):
    w = dist.get_world_size()
    layer = tmoe.moe_layer(device="cpu", **_spec_kwargs(spec, w))
    specs = layer.param_specs(params)
    if layer._flat_2dh():
        from tutel_tpu_torch.parallel import HierarchicalMesh
        mesh = HierarchicalMesh(layer.ranks, layer.num_hosts).build()
    else:
        mesh = MoeMesh(layer.ranks, w // layer.sharded_count,
                       layer.sharded_count).build()
    by_spec = _walk_specs(lambda v, s: mesh.shard(v, s), params, specs)
    placed = layer.shard_params(params)
    equal = [torch.equal(a, b) for a, b in zip(_tensors(by_spec),
                                               _tensors(placed))]
    return equal, len(_tensors(placed)), _spec_leaves(specs)


def _walk_specs(fn, params, specs):
    if isinstance(params, dict):
        return {k: _walk_specs(fn, params[k], specs[k]) for k in params}
    if isinstance(params, list):
        return [_walk_specs(fn, p, s) for p, s in zip(params, specs)]
    return fn(params, specs)


def _tensors(tree):
    """Every tensor of a tree, dataclass fields included, in one order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "values") and hasattr(tree, "scales"):
        return [tree.values, tree.scales]
    if hasattr(tree, "wstream"):
        return [tree.wstream, tree.sb]
    return [tree]


def _spec_leaves(specs):
    return [tuple(s) for s in _tensors(specs)]


@pytest.mark.parametrize("w,case", [
    (w, c) for c in sorted(SPEC_CASES) for w in (2, 4)
    if c != "ep_2dh" or w == 4])          # 2DH: two hosts of two ranks
def test_param_specs_match_shard_params(pools, w, case):
    """Each leaf taken by its spec (`ProcessMesh.shard`, i.e.
    `convert.take_shard` a dim) equals the leaf `shard_params` places, and
    the specs equal JAX's PartitionSpecs entry for entry."""
    spec, bits, fused = SPEC_CASES[case]
    jax, _, _ = _jax()
    from tutel_tpu import moe as jmoe
    jl = jmoe.moe_layer(group=jax.devices()[:w], **_spec_kwargs(spec, w))
    jp = jl.init(jax.random.PRNGKey(0))
    if bits:
        from tutel_tpu.ops import fused_ffn_pallas, quant as jq
        jp = {**jp, "experts": jq.quantize_expert_params(
            jp["experts"], bits=bits,
            sharded_count=jl.sharded_count if bits == 4 else 1)}
        if fused:
            jp = {**jp, "experts": fused_ffn_pallas.prepare_fused_ffn_params(
                jp["experts"])}
    jspecs = jl.param_specs(jp)
    ref = [tuple(s) for s in _tensors(jspecs)]
    got = pools(w).run(_rank_specs, spec, convert.from_jax_params(jp, "cpu"))
    for equal, n, specs in got:
        assert len(equal) == n and all(equal), equal
        assert specs == ref


def _rank_fused_sliced_raises(params):
    layer = tmoe.moe_layer(device="cpu", **_spec_kwargs({"nle": -2}, 2))
    try:
        layer.param_specs(params)
    except ValueError as e:
        return str(e)
    return None


def test_param_specs_refuse_a_sliced_fused_stream(pools):
    from tutel_tpu_torch.ops import fused_ffn, quant
    layer = tmoe.moe_layer(device="cpu", group=[0], **_spec_kwargs(
        {"nle": 1, "hidden": 128}, 1))
    p = layer.init(torch.Generator().manual_seed(0))
    stream = fused_ffn.prepare_fused_ffn_params(
        quant.quantize_expert_params(p["experts"], 4))["fused_stream"]
    got = pools(2).run(_rank_fused_sliced_raises,
                       {**p, "experts": {"fused_stream": stream}})
    assert all(m and "expert-slicing" in m for m in got), got


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------

def _rank_example(name, argv, params, x):
    import importlib
    mod = importlib.import_module(f"tutel_tpu_torch.examples.{name}")
    return mod.run(mod.build_args(argv), log=lambda *_: None, params=params,
                   x=x)


def _jax_pipeline_inputs(args):
    jax, _, jpipe = _jax()
    from tutel_tpu import moe as jmoe
    layer = jmoe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0,
                   "gate_noise": 0.0},
        experts={"type": "ffn", "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=jax.devices()[:1])
    stacked = jpipe.stack_stage_params(
        [layer.init(jax.random.PRNGKey(i)) for i in range(args.num_stages)])
    x = jax.random.normal(jax.random.PRNGKey(1), (args.batch,
                                                  args.model_dim))
    return stacked, x


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", ["helloworld_pipeline", "helloworld_1f1b"])
def test_pipeline_examples_match_jax(pools, name, s):
    import importlib
    jex = importlib.import_module(f"tutel_tpu.examples.{name}")
    argv = ["--device", "cpu", "--num_stages", str(s)]
    jargs = jex.build_args(argv)
    ref = jex.run(jargs, log=lambda *_: None)
    stacked, x = _jax_pipeline_inputs(jargs)
    got = pools(s).run(_rank_example, name, argv,
                       convert.from_jax_params(stacked, "cpu"),
                       convert.to_tensor(x, "cpu"))
    for losses in got:
        np.testing.assert_allclose(losses, ref, rtol=1e-5)


@pytest.mark.parametrize("w", [1, 2])
def test_expert_choice_example_matches_jax(pools, w):
    jax, _, _ = _jax()
    from tutel_tpu import moe as jmoe
    from tutel_tpu.examples import helloworld_expert_choice as jex
    argv = ["--device", "cpu", "--num_devices", str(w)]
    jargs = jex.build_args(argv)
    ref = jex.run(jargs, log=lambda *_: None)
    layer = jmoe.moe_layer(
        gate_type={"type": "expert_choice", "capacity_factor": 2.0,
                   "gate_noise": 0.0},
        experts={"type": "ffn", "num_experts_per_device": 4,
                 "hidden_size_per_expert": jargs.hidden_size},
        model_dim=jargs.model_dim, seeds=(1, 1, 1), group=jax.devices()[:w])
    params = convert.from_jax_params(layer.init(jax.random.PRNGKey(1)),
                                     "cpu")
    x = convert.to_tensor(jax.random.normal(
        jax.random.PRNGKey(0), (jargs.batch * jargs.num_tokens,
                                jargs.model_dim)), "cpu")
    if w == 1:
        got = [_rank_example("helloworld_expert_choice", argv, params, x)]
    else:
        got = pools(w).run(_rank_example, "helloworld_expert_choice", argv,
                           params, x)
    for losses in got:
        np.testing.assert_allclose(losses, ref, rtol=1e-5)
