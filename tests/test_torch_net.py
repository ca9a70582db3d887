"""Port parity: every collective of tutel_tpu_torch.net at W = 2 and 4
gloo ranks (one spawned process a rank, `testing.RankPool`) against the
JAX package's tutel_tpu.net under shard_map on W of the 8 virtual CPU
devices, on the same numpy inputs: the dim convention of all_to_all
(every dim pair), the simple prims, the variable-length exchanges (even,
uneven, with zeros) and all_gather_v, the two-level exchanges against
JAX's, the expert permutes, the ZeRO helpers, and the gradients of the
all-to-all, zero_gather and the all-reduce pair against jax.grad; the
reference facade's spatial_split, all_gather, reduce_scatter and
create_standalone_group; and the
session (`system.init_data_model_parallel`, its meshes) with the
process groups of each mesh axis against the device lines of the JAX
mesh of the same layout, and the system helpers.
Data movement is exact: results are compared for equality (float32).

The ranks import this module to find their functions, so jax is imported
only inside the functions the pytest process calls (`_jax`).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tutel_tpu_torch import net
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

WORLDS = (2, 4)


def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from tutel_tpu import net as jnet
    return jax, jnp, Mesh, P, jnet


def _shard_map(body, w, n_in, n_out, *args, names=("x",), shape=None):
    """body under shard_map over W devices: every input and output split
    on dim 0 over all the mesh axes."""
    jax, jnp, Mesh, P, _ = _jax()
    devs = np.asarray(jax.devices()[:w]).reshape(shape or (w,))
    spec = P(names if len(names) > 1 else names[0])
    f = jax.jit(jax.shard_map(body, mesh=Mesh(devs, names),
                              in_specs=(spec,) * n_in,
                              out_specs=(spec,) * n_out, check_vma=False))
    out = f(*[jnp.asarray(a) for a in args])
    return [np.asarray(o) for o in out]


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


def _mine(blocks):
    """This rank's block of a per-rank stack."""
    return torch.from_numpy(np.ascontiguousarray(blocks[dist.get_rank()]))


# -- the dim convention -------------------------------------------------------

def _rank_all_to_all(blocks, pairs):
    x = _mine(blocks)
    out = []
    for i, o in pairs:
        y = net.all_to_all(x, i, o)
        out.append((y.numpy(), net.all_to_all(y, o, i).numpy()))
    return out


PAIRS = [(1, 0), (0, 1), (2, 0), (0, 2), (2, 1), (1, 2)]


@pytest.mark.parametrize("w", WORLDS)
def test_all_to_all_every_dim_pair(pools, w):
    jax, jnp, _, _, jnet = _jax()
    blocks = np.arange(w * 8 * 4 * 4, dtype=np.float32).reshape(w, 8, 4, 4)
    got = pools(w).run(_rank_all_to_all, blocks, PAIRS)
    for k, (i, o) in enumerate(PAIRS):
        ref, = _shard_map(lambda xs: (jnet.all_to_all(xs[0], i, o, "x")[None],),
                          w, 1, 1, blocks)
        for r in range(w):
            np.testing.assert_array_equal(got[r][k][0], ref[r])
            np.testing.assert_array_equal(got[r][k][1], blocks[r])
    # test_net.py:22's oracle: rank d gets every source's chunk d along C
    y10 = [got[r][0][0] for r in range(w)]
    for d in range(w):
        want = np.concatenate([blocks[s, d * 8 // w:(d + 1) * 8 // w]
                               for s in range(w)], axis=1)
        np.testing.assert_array_equal(y10[d], want)


# -- the simple prims ---------------------------------------------------------

def _rank_prims(blocks):
    x = _mine(blocks)
    return {"sum": net.simple_all_reduce(x).numpy(),
            "max": net.simple_all_reduce(x, op="max").numpy(),
            "min": net.simple_all_reduce(x, op="min").numpy(),
            "a2a": net.simple_all_to_all(x).numpy(),
            "single": net.all_to_all_single(x).numpy(),
            "split": net.simple_split(x, dim=1).numpy(),
            "rs": net.simple_reduce_scatter(x, dim=1).numpy(),
            "ag": net.simple_all_gather(x, dim=1).numpy(),
            "fwd": net.allreduce_forward(x).numpy(),
            "bwd": net.allreduce_backward(x).numpy(),
            "size": net.get_world_size(), "rank": net.get_world_rank()}


@pytest.mark.parametrize("w", WORLDS)
def test_simple_prims(pools, w):
    jax, jnp, _, _, jnet = _jax()
    blocks = np.random.default_rng(w).standard_normal(
        (w, 8, 4)).astype(np.float32)
    got = pools(w).run(_rank_prims, blocks)

    def body(xs):
        x = xs[0]
        return tuple(v[None] for v in (
            jnet.simple_all_reduce(x, "x"),
            jnet.simple_all_reduce(x, "x", "max"),
            jnet.simple_all_reduce(x, "x", "min"),
            jnet.simple_all_to_all(x, "x"), jnet.all_to_all_single(x, "x"),
            jnet.simple_split(x, "x", dim=1),
            jnet.simple_reduce_scatter(x, "x", dim=1),
            jnet.simple_all_gather(x, "x", dim=1),
            jnet.allreduce_forward(x, "x"), jnet.allreduce_backward(x, "x")))
    ref = _shard_map(body, w, 1, 10, blocks)
    names = ["sum", "max", "min", "a2a", "single", "split", "rs", "ag",
             "fwd", "bwd"]
    for r in range(w):
        assert got[r]["size"] == w and got[r]["rank"] == r
        for name, want in zip(names, ref):
            tol = 1e-6 if name in ("sum", "rs", "fwd") else 0
            np.testing.assert_allclose(got[r][name], want[r], rtol=tol,
                                       atol=tol, err_msg=name)


def _rank_facade(blocks):
    x = _mine(blocks)
    me, w = dist.get_rank(), dist.get_world_size()
    # every rank makes every group, in one order
    singles = [net.create_standalone_group([r]) for r in range(w)]
    world = net.create_standalone_group()
    pair = net.create_standalone_group([0, w - 1])
    mine = singles[me]
    return {"spatial": net.spatial_split(x, dim=1).numpy(),
            "ag": net.all_gather(x, dim=1).numpy(),
            "rs": net.reduce_scatter(x, dim=1).numpy(),
            "single_size": net.get_world_size(mine),
            "single_sum": net.simple_all_reduce(x, mine).numpy(),
            "world_sum": net.simple_all_reduce(x, world).numpy(),
            "pair": (dist.get_process_group_ranks(pair)
                     if me in (0, w - 1) else None)}


def test_facade_names(pools):
    """spatial_split, the differentiable aliases all_gather and
    reduce_scatter, and create_standalone_group (a group over the ranks
    given; JAX's is a mesh over the devices given) at W = 2."""
    jax, jnp, _, _, jnet = _jax()
    w = 2
    blocks = np.random.default_rng(9).standard_normal(
        (w, 8, 4)).astype(np.float32)
    got = pools(w).run(_rank_facade, blocks)

    def body(xs):
        x = xs[0]
        return tuple(v[None] for v in (
            jnet.spatial_split(x, "x", dim=1), jnet.all_gather(x, "x", dim=1),
            jnet.reduce_scatter(x, "x", dim=1),
            jnet.simple_all_reduce(x, "x")))
    ref = _shard_map(body, w, 1, 4, blocks)
    for r in range(w):
        np.testing.assert_array_equal(got[r]["spatial"], ref[0][r])
        np.testing.assert_array_equal(got[r]["ag"], ref[1][r])
        np.testing.assert_allclose(got[r]["rs"], ref[2][r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got[r]["world_sum"], ref[3][r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[r]["single_sum"], blocks[r])
        assert got[r]["single_size"] == jnet.create_standalone_group(
            jax.devices()[r:r + 1]).size == 1
        assert got[r]["pair"] == [0, w - 1]
    assert jnet.create_standalone_group(jax.devices()[:w]).size == w


# -- variable-length exchanges ------------------------------------------------

def _rank_a2a_v(blocks, counts, output_size):
    out, recv = net.batch_all_to_all_v([_mine(blocks), 2 * _mine(blocks)],
                                       _mine(counts),
                                       output_size=output_size)
    return [o.numpy() for o in out], recv.numpy()


def _jax_a2a_v(w, blocks, counts, output_size):
    _, _, _, _, jnet = _jax()

    def body(xs, cs):
        out, recv = jnet.batch_all_to_all_v(xs[0], cs[0], "x",
                                            output_size=output_size,
                                            native=False)
        return out[None], recv[None]
    return _shard_map(body, w, 2, 2, blocks, counts)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("kind", ["even", "uneven", "skewed"])
def test_batch_all_to_all_v(pools, w, kind):
    rng = np.random.default_rng(w + len(kind))
    n, m = 16, 3
    if kind == "even":
        counts = np.full((w, w), n // w, np.int32)
    elif kind == "uneven":                       # rank d sends d+1 a peer
        counts = np.repeat(np.arange(1, w + 1, dtype=np.int32)[:, None], w, 1)
    else:                                        # zeros, one hot peer
        counts = np.zeros((w, w), np.int32)
        counts[:, w - 1] = 5
        counts[0, 0] = 3
    blocks = rng.standard_normal((w, n, m)).astype(np.float32)
    output_size = 24
    got = pools(w).run(_rank_a2a_v, blocks, counts, output_size)
    out, recv = _jax_a2a_v(w, blocks, counts, output_size)
    for r in range(w):
        np.testing.assert_array_equal(got[r][1], recv[r])
        np.testing.assert_array_equal(got[r][0][0], out[r])
        np.testing.assert_array_equal(got[r][0][1], 2 * out[r])
        np.testing.assert_array_equal(got[r][1], counts[:, r])


def _rank_all_gather_v(blocks, counts, output_size):
    out, cnts = net.batch_all_gather_v(_mine(blocks),
                                       int(counts[dist.get_rank()]),
                                       output_size=output_size)
    return out.numpy(), cnts.numpy()


@pytest.mark.parametrize("w", WORLDS)
def test_batch_all_gather_v(pools, w):
    _, _, _, _, jnet = _jax()
    rng = np.random.default_rng(3)
    blocks = rng.standard_normal((w, 8, 2)).astype(np.float32)
    counts = np.arange(1, w + 1, dtype=np.int32)
    got = pools(w).run(_rank_all_gather_v, blocks, counts, 16)

    def body(xs, cs):
        out, c = jnet.batch_all_gather_v(xs[0], cs[0], "x", output_size=16)
        return out[None], c[None]
    out, cnts = _shard_map(body, w, 2, 2, blocks, counts)
    for r in range(w):
        np.testing.assert_array_equal(got[r][0], out[r])
        np.testing.assert_array_equal(got[r][1], cnts[r])


# -- the two-level exchanges ---------------------------------------------------

def _rank_2dh(blocks, counts, outer, output_size):
    from tutel_tpu_torch.parallel import HierarchicalMesh, default_ranks
    mesh = HierarchicalMesh(default_ranks(), outer).build()
    x = _mine(blocks)
    og, ig = mesh.group("dcn"), mesh.group("ici")
    y = net.all_to_all_2dh(x, 1, 0, og, ig)
    flat = net.all_to_all(x, 1, 0)
    back = net.all_to_all_2dh(y, 0, 1, og, ig)
    rows = x.reshape(-1, x.shape[-1])
    hier, rch = net.batch_all_to_all_v_2dh(rows, _mine(counts), og, ig,
                                           output_size=output_size)
    return (y.numpy(), flat.numpy(), back.numpy(), hier.numpy(),
            rch.numpy())


@pytest.mark.parametrize("w,outer", [(2, 2), (4, 2)])
def test_two_level_exchanges_match_jax_and_flat(pools, w, outer):
    jax, jnp, _, _, jnet = _jax()
    rng = np.random.default_rng(w * 10 + outer)
    inner = w // outer
    blocks = rng.standard_normal((w, 8, 2, 3)).astype(np.float32)
    counts = rng.integers(0, 4, size=(w, w)).astype(np.int32)
    got = pools(w).run(_rank_2dh, blocks, counts, outer, 16)

    def body(xs, cs):
        y = jnet.all_to_all_2dh(xs[0], 1, 0, "dcn", "ici")
        rows = xs[0].reshape(-1, xs.shape[-1])
        hier, rc = jnet.batch_all_to_all_v_2dh(rows, cs[0], "dcn", "ici",
                                               output_size=16, native=False)
        return y[None], hier[None], rc[None]
    y, hier, rc = _shard_map(body, w, 2, 3, blocks, counts,
                             names=("dcn", "ici"), shape=(outer, inner))
    for r in range(w):
        np.testing.assert_array_equal(got[r][0], y[r])
        np.testing.assert_array_equal(got[r][0], got[r][1])   # 2DH == flat
        np.testing.assert_array_equal(got[r][2], blocks[r])
        np.testing.assert_array_equal(got[r][4], rc[r])
        np.testing.assert_array_equal(got[r][3], hier[r])


# -- local helpers ---------------------------------------------------------------

def test_pre_post_expert_permute_match_jax():
    _, jnp, _, _, jnet = _jax()
    rng = np.random.default_rng(0)
    for w, l, d1, rest in ((4, 6, 3, (5,)), (2, 8, 4, ()), (8, 2, 1, (2, 3))):
        x = rng.standard_normal((w * l, d1) + rest).astype(np.float32)
        y = net.pre_expert_permute(torch.from_numpy(x), w)
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(jnet.pre_expert_permute(jnp.asarray(x), w)))
        back = net.post_expert_permute(y, w)
        np.testing.assert_array_equal(back.numpy(), x)
    t = torch.ones(4, 3)
    assert net.pre_expert_permute(t, 1) is t
    assert net.post_expert_permute(t, 1) is t


def test_zero_shard_shape_and_one_rank_identities():
    _, _, _, _, jnet = _jax()
    for shape, w in (((3, 4), 5), ((7,), 2), ((2, 3, 4), 8)):
        assert net.zero_shard_shape(shape, w) == jnet.zero_shard_shape(
            shape, w)
    # no process group: a world of one rank, every collective the identity
    x = torch.arange(12.0).reshape(4, 3)
    assert net.get_world_size() == 1 and net.get_world_rank() == 0
    assert torch.equal(net.all_to_all(x, 1, 0), x)
    assert torch.equal(net.zero_gather(x.reshape(-1), full_shape=(4, 3)), x)
    shard, numel = net.zero_scatter(x)
    assert numel == 12 and torch.equal(shard, x.reshape(-1))


# -- ZeRO helpers and gradients ----------------------------------------------------

def _rank_zero(blocks, full_shape):
    x = _mine(blocks)
    gathered = net.zero_gather(x.reshape(-1), full_shape=full_shape)
    shard, numel = net.zero_scatter(gathered)
    return gathered.numpy(), shard.numpy(), numel


@pytest.mark.parametrize("w", WORLDS)
def test_zero_gather_scatter(pools, w):
    _, jnp, _, _, jnet = _jax()
    full = (3, 5)                          # 15 values, padded to divide W
    per = net.zero_shard_shape(full, w)
    flat = np.zeros(per * w, np.float32)
    flat[:15] = np.arange(15, dtype=np.float32) + 1
    blocks = flat.reshape(w, per)
    got = pools(w).run(_rank_zero, blocks, full)

    def body(xs):
        g = jnet.zero_gather(xs[0], "x", full_shape=full)
        return g[None], jnet.zero_scatter(g, "x")[0][None]
    g, s = _shard_map(body, w, 1, 2, blocks)
    for r in range(w):
        np.testing.assert_array_equal(got[r][0], g[r])
        np.testing.assert_array_equal(got[r][1], s[r])
        assert got[r][2] == 15


def _rank_grads(blocks, cots, full_shape):
    """Per rank: grads of sum(all_to_all(x, 1, 0) * R), of
    sum(zero_gather(x) * R'), and of the all-reduce pair."""
    r = dist.get_rank()
    out = {}
    x = _mine(blocks).requires_grad_(True)
    y = net.all_to_all(x, 1, 0)
    (y * torch.from_numpy(cots["a2a"][r])).sum().backward()
    out["a2a"] = x.grad.numpy()
    x = _mine(blocks).reshape(-1)[:8].clone().requires_grad_(True)
    g = net.zero_gather(x, full_shape=full_shape)
    (g * torch.from_numpy(cots["zero"][r])).sum().backward()
    out["zero"] = x.grad.numpy()
    for name, fn in (("fwd", net.allreduce_forward),
                     ("bwd", net.allreduce_backward),
                     ("sum", net.simple_all_reduce)):
        x = _mine(blocks).requires_grad_(True)
        (fn(x) * torch.from_numpy(cots["a2a"][r].reshape(
            x.shape))).sum().backward()
        out[name] = x.grad.numpy()
    return out


@pytest.mark.parametrize("w", WORLDS)
def test_gradients_match_jax_grad(pools, w):
    jax, jnp, Mesh, P, jnet = _jax()
    rng = np.random.default_rng(w)
    blocks = rng.standard_normal((w, 8, 4, 2)).astype(np.float32)
    full = (w * 8 - 3,)
    cots = {"a2a": rng.standard_normal((w, 8 // w, 4 * w, 2)).astype(
        np.float32), "zero": rng.standard_normal((w,) + full).astype(
        np.float32)}
    got = pools(w).run(_rank_grads, blocks, cots, full)
    mesh = Mesh(np.asarray(jax.devices()[:w]), ("x",))

    def grad_of(body, x, cot):
        f = jax.shard_map(body, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                          check_vma=False)
        return np.asarray(jax.grad(lambda v: jnp.sum(
            f(v) * jnp.asarray(cot)))(jnp.asarray(x)))

    a2a = grad_of(lambda xs: jnet.all_to_all(xs[0], 1, 0, "x")[None],
                  blocks, cots["a2a"])
    zero_in = blocks.reshape(w, -1)[:, :8]
    zero = grad_of(lambda xs: jnet.zero_gather(xs[0], "x",
                                               full_shape=full)[None],
                   zero_in, cots["zero"])
    cot_x = cots["a2a"].reshape(blocks.shape)
    pair = {name: grad_of(lambda xs, f=f: f(xs[0], "x")[None], blocks, cot_x)
            for name, f in (("fwd", jnet.allreduce_forward),
                            ("bwd", jnet.allreduce_backward),
                            ("sum", jnet.simple_all_reduce))}
    for r in range(w):
        np.testing.assert_array_equal(got[r]["a2a"], a2a[r])
        np.testing.assert_allclose(got[r]["zero"], zero[r], rtol=1e-6,
                                   atol=1e-6)
        for name, ref in pair.items():
            np.testing.assert_allclose(got[r][name], ref[r], rtol=1e-6,
                                       atol=1e-6, err_msg=name)


# -- the session and the meshes ------------------------------------------------------

def _line(arr, names, rank, axes):
    """Device ids of the line through device `rank` along `axes` of a JAX
    mesh's device array."""
    ids = np.vectorize(lambda d: d.id)(arr)
    coords = [int(c[0]) for c in np.nonzero(ids == rank)]
    index = tuple(slice(None) if n in axes else c
                  for n, c in zip(names, coords))
    return sorted(int(i) for i in np.asarray(ids[index]).reshape(-1))


def _rank_session(w, layouts):
    from tutel_tpu_torch import system
    from tutel_tpu_torch.parallel import MoeMesh, ProcessMesh
    env = system.init_data_model_parallel(group_count=-2, device="cpu")
    out = {"env": (env.global_size, env.group_count, env.model_size,
                   env.global_rank, env.backend, env.is_distributed)}
    for e in (1, 2, w, 2 * w):
        mm = env.moe_mesh(e)
        out[f"moe_mesh_{e}"] = (mm.num_expert_groups, mm.sharded_count,
                                mm.adaptive_r, mm.gather_group_size)
    for shape, names in layouts:
        mesh = ProcessMesh(env.ranks, shape, names)
        axes = [(n,) for n in names] + [tuple(names)]
        out[(shape, names)] = {a: dist.get_process_group_ranks(mesh.group(a))
                               for a in axes}
    moe = MoeMesh(env.ranks, 1, w, 2).build()
    out["moe_sizes"] = (moe.size("g"), moe.size(("r", "g")))
    out["session"] = system.get_local_session() is env
    return out


@pytest.mark.parametrize("w", WORLDS)
def test_session_and_meshes_match_jax(pools, w):
    jax, _, Mesh, _, _ = _jax()
    from tutel_tpu import system as jsystem
    from tutel_tpu.parallel import mesh as jmesh
    layouts = [((1, w // 2, 2), ("e", "r", "g")), ((w, 1, 1),
                                                   ("e", "r", "g")),
               ((2, w // 2), ("dcn", "ici"))]
    got = pools(w).run(_rank_session, w, layouts)
    jenv = jsystem.init_data_model_parallel(group_count=-2,
                                            devices=jax.devices()[:w])
    for r in range(w):
        assert got[r]["env"] == (jenv.global_size, jenv.group_count,
                                 jenv.model_size, r, "gloo", True)
        assert got[r]["session"]
        for e in (1, 2, w, 2 * w):
            jm = jenv.moe_mesh(e)
            assert got[r][f"moe_mesh_{e}"] == (
                jm.num_expert_groups, jm.sharded_count, jm.adaptive_r,
                jm.gather_group_size)
        assert got[r]["moe_sizes"] == (w // 2, w)
    for shape, names in layouts:
        arr = np.asarray(jax.devices()[:w], dtype=object).reshape(shape)
        Mesh(arr, names)                        # a valid JAX mesh
        for r in range(w):
            for axes, ranks in got[r][(shape, names)].items():
                assert ranks == _line(arr, names, r, axes), axes
    assert jmesh.infer_num_hosts(jax.devices()[:w]) == 1


def test_system_helpers_match_jax(tmp_path, monkeypatch):
    from tutel_tpu import system as jsystem
    from tutel_tpu_torch import system
    from tutel_tpu_torch.parallel import infer_num_hosts
    for pattern, rank, size in (("ck-{rank}-of-{size}", 3, 8),
                                ("ck", 0, 1)):
        assert system.apply_rank_size_from_pattern(pattern, rank, size) == \
            jsystem.apply_rank_size_from_pattern(pattern, rank, size)
    for mod in (system, jsystem):
        with pytest.raises(ValueError, match="rank"):
            mod.apply_rank_size_from_pattern("ck", 0, 2)
    system.cache_clear()
    assert system.cache("k", [1]) == [1] and system.cache("k", [2]) == [1]
    assert system.cache_set("k", 5) == 5 and system.cache("k") == 5
    system.cache_clear()
    assert system.cache("k") is None
    t = torch.arange(6.0).reshape(2, 3).to(torch.bfloat16)
    system.save(t, str(tmp_path / "d" / "t"))
    back = system.load(str(tmp_path / "d" / "t.npy"))
    assert torch.equal(back, t.float())
    np.testing.assert_array_equal(np.asarray(jsystem.load(
        str(tmp_path / "d" / "t"))), back.numpy())
    assert infer_num_hosts(range(8)) == 1
    assert infer_num_hosts(range(8), num_hosts=4) == 4
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert infer_num_hosts(range(8)) == 4
    assert system.init_affinity_at_program_beginning() is None
    assert system.record_time() > 0
    env = system.init_data_model_parallel(device="cpu")   # no group
    assert (env.global_size, env.backend, env.ranks) == (1, None, (0,))
    with pytest.raises(ValueError, match="divide"):
        system.init_data_model_parallel(group_count=3, device="cpu")
