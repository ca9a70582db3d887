"""Port parity: ragged expert parallelism (`use_ragged_ep=True`, the port's
`ops.ragged_ep`) at W = 2 and 4 gloo ranks (`testing.RankPool`) against
the JAX MOELayer's ragged path under shard_map on W of the 8 virtual CPU
devices, from the same global parameters and input (each rank its shard
and its rows).

Cases: both `is_postscore` settings; imbalanced routing with a generous
max_recv and full-collapse routing with the default probe; the probe
(`resolve_max_recv`) equal to JAX's; an explicit max_recv that drops rows,
forward and gradients; gradients of the gate and the experts against
jax.grad; INT8 and INT4 experts (JAX's Pallas kernels in interpret mode,
the port's K1 twin over the dense view), and INT4 with a fused stream (the
port's K2 twin); the two-level exchange (2 hosts); the guard rails.

Tolerances: outputs within 5e-5 absolute (values of order 1), quantized
experts within 1e-4 of max |jax|; gradients within 2e-4 relative and 2e-5
absolute. Gate noise is 0.

The ranks import this module, so jax is imported only inside the
functions the pytest process calls (`_jax`).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

M, H, ROWS = 32, 64, 16           # model dim, hidden, rows a rank


def _jax():
    import jax
    import jax.numpy as jnp
    from tutel_tpu import moe as jmoe
    return jax, jnp, jmoe


def _kwargs(spec):
    spec = dict(spec)
    return dict(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        experts={"type": "ffn",
                 "num_experts_per_device": spec.pop("nle", 2),
                 "hidden_size_per_expert": spec.pop("hidden", H)},
        model_dim=M, **spec)


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


def _rows(x):
    n = x.shape[0] // dist.get_world_size()
    return x[dist.get_rank() * n:(dist.get_rank() + 1) * n]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _params(w, spec, key=0, bias=0.0, bits=0, fused=False):
    """The JAX layer and its global params (numpy-converted for the
    port): gate column 0 raised by `bias`, experts quantized to `bits`
    (with a fused stream when `fused`)."""
    jax, jnp, jmoe = _jax()
    jl = jmoe.moe_layer(seeds=(1, 1, 1), group=jax.devices()[:w],
                        **_kwargs(spec))
    jp = jl.init(jax.random.PRNGKey(key))
    if bias:
        g0 = dict(jp["gates"][0])
        g0["wg"] = g0["wg"].at[:, 0].add(bias)
        jp = {**jp, "gates": [g0]}
    if bits:
        from tutel_tpu.ops import fused_ffn_pallas, quant as jq
        ex = jq.quantize_expert_params(jp["experts"], bits=bits)
        if fused:
            ex = fused_ffn_pallas.prepare_fused_ffn_params(ex)
            assert "fused_stream" in ex
        jp = {**jp, "experts": ex}
    return jl, jp


def _x(w, seed):
    return np.random.default_rng(seed).standard_normal(
        (w * ROWS, M)).astype(np.float32)


def _rank_forward(spec, call, params, x):
    layer = tmoe.moe_layer(device="cpu", **_kwargs(spec))
    local = layer.shard_params(params)
    with torch.no_grad():
        out, l_aux = layer(local, _rows(x), use_ragged_ep=True, **call)
    return out.numpy(), float(l_aux)


def _check_forward(pools, w, spec, call, x, jl, jp, tol=5e-5, rel=False):
    _, jnp, _ = _jax()
    ref, ref_aux = jl(jl.shard_params(jp), jnp.asarray(x),
                      use_ragged_ep=True, **call)
    ref = np.asarray(ref)
    got = pools(w).run(_rank_forward, spec, call,
                       convert.from_jax_params(jp, "cpu"),
                       torch.from_numpy(x))
    out = np.concatenate([g[0] for g in got])
    err = np.max(np.abs(out - ref))
    assert err <= tol * (np.max(np.abs(ref)) if rel else 1.0), err
    for g in got:
        assert abs(g[1] - float(ref_aux)) <= 1e-6


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("postscore", [True, False])
def test_ragged_forward_matches_jax(pools, w, postscore):
    spec = {"is_postscore": postscore}
    jl, jp = _params(w, spec)
    _check_forward(pools, w, spec, {}, _x(w, 1), jl, jp)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("routing", ["imbalanced", "collapse"])
def test_ragged_skewed_routing_matches_jax(pools, w, routing):
    """A gate biased to expert 0 with a generous max_recv, and a gate
    collapsed onto expert 0 with the default probe, which must not drop a
    row."""
    bias, call = ((3.0, {"max_recv": 1024}) if routing == "imbalanced"
                  else (30.0, {}))
    jl, jp = _params(w, {}, bias=bias)
    _check_forward(pools, w, {}, call, _x(w, 2), jl, jp)


def _rank_max_recv(spec, params, x, slack):
    layer = tmoe.moe_layer(device="cpu", **_kwargs(spec))
    return layer.resolve_max_recv(layer.shard_params(params), _rows(x),
                                  slack=slack)


@pytest.mark.parametrize("w", [2, 4])
def test_resolve_max_recv_equals_jax(pools, w):
    _, jnp, _ = _jax()
    for bias, slack in ((0.0, 1.0), (30.0, 1.0), (0.0, 3.0)):
        jl, jp = _params(w, {}, bias=bias)
        x = _x(w, 3)
        ref = jl.resolve_max_recv(jl.shard_params(jp), jnp.asarray(x),
                                  slack=slack)
        got = pools(w).run(_rank_max_recv, {}, convert.from_jax_params(
            jp, "cpu"), torch.from_numpy(x), slack)
        assert got == [ref] * w, (bias, slack, got, ref)


def _rank_grads(spec, call, params, x, cot, wt, jgrads):
    layer = tmoe.moe_layer(device="cpu", **_kwargs(spec))
    local = layer.shard_params(params)
    named = _flat(local)
    for t in named.values():
        t.requires_grad_(True)
    out, l_aux = layer(local, _rows(x), training=True, use_ragged_ep=True,
                       **call)
    loss = (out * _rows(cot)).sum() + wt * l_aux / dist.get_world_size()
    loss.backward()
    ref = _flat(layer.shard_params(jgrads))
    return out.detach().numpy(), {
        n: (t.grad.numpy(), ref[n].numpy()) for n, t in named.items()}


def _check_grads(pools, w, spec, call, seed, wt):
    jax, jnp, _ = _jax()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((w * ROWS, M)).astype(np.float32)
    cot = rng.standard_normal((w * ROWS, M)).astype(np.float32)
    jl, jp = _params(w, spec)
    sp = jl.shard_params(jp)

    def loss(p):
        out, l_aux = jl(p, jnp.asarray(x), training=True,
                        use_ragged_ep=True, **call)
        return jnp.sum(out * jnp.asarray(cot)) + wt * l_aux, out
    (_, ref_out), grads = jax.value_and_grad(loss, has_aux=True)(sp)
    got = pools(w).run(
        _rank_grads, spec, call,
        convert.from_jax_params(jax.device_get(jp), "cpu"),
        torch.from_numpy(x), torch.from_numpy(cot), wt,
        convert.from_jax_params(jax.device_get(grads), "cpu"))
    np.testing.assert_allclose(np.concatenate([g[0] for g in got]),
                               np.asarray(ref_out), atol=5e-5, rtol=0)
    for _, rank in got:
        for name, (g, ref) in rank.items():
            np.testing.assert_allclose(g, ref, rtol=2e-4, atol=2e-5,
                                       err_msg=name)
    return ref_out


@pytest.mark.parametrize("w", [2, 4])
def test_ragged_gradients_match_jax(pools, w):
    _check_grads(pools, w, {}, {}, 10 + w, 0.01)


@pytest.mark.parametrize("w", [2, 4])
def test_truncating_max_recv_forward_and_backward(pools, w):
    """An explicit max_recv below the rows a rank receives drops rows (they
    come back as zeros, and their gradients are zero), as in JAX."""
    out = _check_grads(pools, w, {}, {"max_recv": ROWS}, 20 + w, 0.0)
    assert np.count_nonzero(np.abs(np.asarray(out)).sum(1) == 0) > 0


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("bits,fused,max_recv",
                         [(8, False, 1024), (4, False, 1024),
                          (4, True, 1024), (4, False, ROWS),
                          (4, True, ROWS)],
                         ids=["int8", "int4", "int4_fused",
                              "int4_truncating", "int4_fused_truncating"])
def test_ragged_quantized_experts_match_jax(pools, w, bits, fused, max_recv):
    """Quantized experts through the dense view: the port's K1 twin twice,
    or its K2 twin over a fused stream (its hidden a multiple of 128, the
    stream's tile), against JAX's ragged path; with a max_recv that drops
    rows too (the groups' counts then pass the received rows)."""
    spec = {"hidden": 128} if fused else {}
    jl, jp = _params(w, spec, bits=bits, fused=fused)
    _check_forward(pools, w, spec, {"max_recv": max_recv}, _x(w, 4), jl,
                   jp, tol=1e-4, rel=True)


def test_ragged_two_level_exchange_matches_jax(pools):
    spec = {"nle": 1, "use_2dh": True, "num_hosts": 2}
    jl, jp = _params(4, spec)
    _check_forward(pools, 4, spec, {}, _x(4, 5), jl, jp)


def _rank_guard_rails(params, x):
    msgs = []
    layer = tmoe.moe_layer(device="cpu", **_kwargs({}))
    local = layer.shard_params(params)
    for call in ({"capacity_factor": 1.0}, {"capacity_factor": -1.0},
                 {"valid_tokens": 3}):
        try:
            layer(local, _rows(x), use_ragged_ep=True, **call)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    one = tmoe.moe_layer(device="cpu", group=[dist.get_rank()],
                         **_kwargs({}))
    try:
        one(one.init(torch.Generator().manual_seed(0)), _rows(x),
            use_ragged_ep=True)
        msgs.append(None)
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def test_ragged_guard_rails(pools):
    _, jp = _params(2, {})
    got = pools(2).run(_rank_guard_rails, convert.from_jax_params(jp, "cpu"),
                       torch.from_numpy(_x(2, 6)))
    for msgs in got:
        assert all(m and "dropless" in m for m in msgs[:3]), msgs
        assert msgs[3] and "pure-EP" in msgs[3], msgs
