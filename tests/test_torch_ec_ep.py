"""Port parity: expert-choice routing over a process group, at W = 2 and 4
gloo ranks (`testing.RankPool`), against the JAX layer on W of the 8
virtual CPU devices, from the same global parameters and input (each rank
its shard and its rows).

Cases: pure expert parallelism (post- and prescore; also with the
combine the card runs, the inverse-map gather), expert slicing
(`num_local_experts=-2`: adaptive_r 2, 1 and 0, and parallel types data
and model) in float32 and with INT8 and per-block INT4 experts (the port's
K1 twin), adaptive_r = 0 under pure EP (the weights gathered, no
activation on the wire), the two-level exchange (2 hosts), valid_tokens
as a per-rank vector, gradients of x, the gate and the experts against
jax.grad (pure EP and slicing), and the EC LM over the group on a token
count that needs padding (zero rows tie in every expert's top-C).

Tolerances: float32 outputs within 1e-5 absolute (values of order 1);
quantized experts within 1e-4 of max |jax|; gradients and the LM within
1e-5 of max |jax|.

The ranks import this module, so jax is imported only inside the
functions the pytest process calls (`_jax`).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

M, H, ROWS = 32, 64, 16           # model dim, hidden, rows a rank


def _jax():
    import jax
    import jax.numpy as jnp
    from tutel_tpu import moe as jmoe
    return jax, jnp, jmoe


def _kwargs(spec, w):
    spec = dict(spec)
    return dict(
        gate_type={"type": "expert_choice", "capacity_factor":
                   spec.pop("cf", 2.0), "gate_noise": 0.0},
        experts={"type": "ffn",
                 "num_experts_per_device": spec.pop("nle", 8 // w),
                 "hidden_size_per_expert": H, **spec.pop("experts", {})},
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


def _params(w, spec, bits=0):
    jax, _, jmoe = _jax()
    jl = jmoe.moe_layer(seeds=(1, 1, 1), group=jax.devices()[:w],
                        **_kwargs(spec, w))
    jp = jl.init(jax.random.PRNGKey(0))
    if bits:
        from tutel_tpu.ops import quant as jq
        sc = jl.sharded_count
        jp = {**jp, "experts": jq.quantize_expert_params(
            jp["experts"], bits=bits,
            sharded_count=sc if bits == 4 else 1)}
    return jl, jp


def _x(w, seed):
    return np.random.default_rng(seed).standard_normal(
        (w * ROWS, M)).astype(np.float32)


def _rank_forward(spec, calls, params, x, card_combine=False):
    """The layer's outputs and z-losses on this rank's rows; card_combine:
    with the combine the card runs (the inverse-map gather)."""
    from tutel_tpu_torch.ops import expert_choice as tec
    layer = tmoe.moe_layer(device="cpu", **_kwargs(spec,
                                                   dist.get_world_size()))
    local = layer.shard_params(params)
    out, plain = [], tec.combine_rows
    if card_combine:
        tec.combine_rows = lambda *a, **k: plain(*a, **{**k, "native": True})
    try:
        with torch.no_grad():
            for call in calls:
                o, z = layer(local, _rows(x), **call)
                out.append((o.numpy(), float(z)))
    finally:
        tec.combine_rows = plain
    return out


def _check(pools, w, spec, calls, seed, bits=0, card_combine=False):
    _, jnp, _ = _jax()
    jl, jp = _params(w, spec, bits)
    x = _x(w, seed)
    sp = jl.shard_params(jp)
    refs = [jl(sp, jnp.asarray(x), **call) for call in calls]
    got = pools(w).run(_rank_forward, spec, calls,
                       convert.from_jax_params(jp, "cpu"),
                       torch.from_numpy(x), card_combine)
    for i, (ref, rz) in enumerate(refs):
        ref = np.asarray(ref)
        out = np.concatenate([g[i][0] for g in got])
        tol = 1e-4 * np.max(np.abs(ref)) if bits else 1e-5
        assert np.max(np.abs(out - ref)) <= tol, (calls[i], np.max(np.abs(
            out - ref)))
        for g in got:
            assert abs(g[i][1] - float(rz)) <= 1e-5 * abs(float(rz))
    return got


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("postscore", [True, False])
def test_ec_ep_matches_jax(pools, w, postscore):
    _check(pools, w, {"is_postscore": postscore},
           [{}, {"adaptive_r": 0}, {"capacity_override": 7}], 1)


@pytest.mark.parametrize("w", [2, 4])
def test_ec_card_combine_matches_jax(pools, w):
    """The combine the card runs (`_combine_fanin`, J = the slices that can
    pick a token) on the CPU, through the exchange and through the
    adaptive_r = 0 branch, under pure EP and expert slicing."""
    _check(pools, w, {}, [{}, {"adaptive_r": 0}], 6, card_combine=True)
    _check(pools, w, {"nle": -2, "parallel_type": "adaptive:2"},
           [{"adaptive_r": 2}, {"adaptive_r": 1}], 7, card_combine=True)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_ec_expert_slicing_matches_jax(pools, w, bits):
    """num_local_experts=-2: each expert sliced over 2 ranks; every
    adaptive_r (2: model-parallel slices whose partial sums meet on the
    token's owner, 1: the hidden regathered, duplicates scaled by 1/2, 0:
    everything gathered); quantized experts without biases, INT4 packed
    per shard block."""
    spec = {"nle": -2, "parallel_type": "adaptive:2"}
    if bits:
        spec["experts"] = {"has_fc1_bias": False, "has_fc2_bias": False}
    _check(pools, w, spec, [{"adaptive_r": 2}, {"adaptive_r": 1},
                            {"adaptive_r": 0}], 2, bits)


@pytest.mark.parametrize("ptype", ["data", "model"])
def test_ec_expert_slicing_parallel_types(pools, ptype):
    _check(pools, 4, {"nle": -2, "parallel_type": ptype}, [{}], 3)


def test_ec_two_level_exchange_matches_jax(pools):
    _check(pools, 4, {"nle": 2, "use_2dh": True, "num_hosts": 2},
           [{}], 4)


@pytest.mark.parametrize("w", [2, 4])
def test_ec_valid_tokens_matches_jax(pools, w):
    """A per-rank count vector (a global prefix fill); masked rows give
    zeros."""
    vt = [ROWS, ROWS // 2] + [0] * (w - 2) if w > 2 else [ROWS, 5]
    got = _check(pools, w, {"cf": 1.0}, [{"valid_tokens": np.asarray(vt)}],
                 5)
    for rank, n in enumerate(vt):
        assert np.all(got[rank][0][0][n:] == 0)


def _rank_grads(spec, call, params, x, cot, wt, jgrads):
    w = dist.get_world_size()
    layer = tmoe.moe_layer(device="cpu", **_kwargs(spec, w))
    local = layer.shard_params(params)
    named = _flat(local)
    for t in named.values():
        t.requires_grad_(True)
    xr = _rows(x).clone().requires_grad_(True)
    out, z = layer(local, xr, training=True, **call)
    # this rank's share of the global loss: its rows, and the replicated
    # z-loss divided by W
    loss = (out * _rows(cot)).sum() + wt * z / w
    loss.backward()
    ref = _flat(layer.shard_params(jgrads["p"]))
    return xr.grad.numpy(), {n: (t.grad.numpy(), ref[n].numpy())
                             for n, t in named.items()}


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("spec", [{}, {"nle": -2,
                                       "parallel_type": "adaptive:2"}],
                         ids=["ep", "sliced"])
def test_ec_gradients_match_jax(pools, w, spec):
    jax, jnp, _ = _jax()
    rng = np.random.default_rng(10 + w)
    x = rng.standard_normal((w * ROWS, M)).astype(np.float32)
    cot = rng.standard_normal((w * ROWS, M)).astype(np.float32)
    jl, jp = _params(w, spec)
    sp = jl.shard_params(jp)

    def loss(p, xx):
        out, z = jl(p, xx, training=True)
        return jnp.sum(out * jnp.asarray(cot)) + 0.01 * z
    gp, gx = jax.grad(loss, argnums=(0, 1))(sp, jnp.asarray(x))
    got = pools(w).run(
        _rank_grads, spec, {}, convert.from_jax_params(jp, "cpu"),
        torch.from_numpy(x), torch.from_numpy(cot), 0.01,
        {"p": convert.from_jax_params(jax.device_get(gp), "cpu")})
    gx = np.asarray(gx)
    assert np.max(np.abs(np.concatenate([g[0] for g in got]) - gx)) <= \
        1e-5 * np.max(np.abs(gx))
    for _, rank in got:
        for name, (g, ref) in rank.items():
            assert np.max(np.abs(g - ref)) <= 1e-5 * np.max(np.abs(ref)), \
                name


LM_CFG = dict(vocab_size=61, max_len=32, model_dim=32, num_heads=2,
              num_layers=2, ffn_hidden=64, moe_every=2, num_local_experts=1,
              top_k=2, capacity_factor=2.0, expert_hidden=48,
              gate_type="expert_choice")


def _rank_lm(params, tokens, jgrads):
    model = TransformerMoE(TransformerMoEConfig(**LM_CFG), device="cpu")
    local = model.shard_params(params)
    with torch.no_grad():
        logits, z = model.apply(local, tokens)
    leaves = _flat(local)
    for v in leaves.values():
        v.requires_grad_(True)
    loss, _ = model.loss(local, tokens, l_aux_wt=0.01)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    ref = _flat(model.shard_params(jgrads))
    return (logits.numpy(), float(z), float(loss),
            {n: (g.numpy(), ref[n].numpy()) for n, g in zip(leaves, grads)})


@pytest.mark.parametrize("w", [2, 4])
def test_ec_lm_over_group_matches_jax(pools, w):
    """3 x 5 tokens do not divide W: the port pads with zero rows (masked
    by valid_tokens), which tie in every expert's scores."""
    jax, jnp, _ = _jax()
    from tutel_tpu.models import transformer as jtr
    jm = jtr.TransformerMoE(jtr.TransformerMoEConfig(**LM_CFG),
                            group=jax.devices()[:w])
    jp = jm.init(jax.random.PRNGKey(w))
    tokens = np.random.default_rng(w).integers(0, 61, (3, 5))
    jt = jnp.asarray(tokens, jnp.int32)
    ref_logits, ref_z = jax.jit(jm.apply)(jp, jt)
    (ref_loss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jt, l_aux_wt=0.01), has_aux=True))(jp)
    got = pools(w).run(_rank_lm, convert.from_jax_params(jp, "cpu"),
                       torch.from_numpy(tokens),
                       convert.from_jax_params(jax.device_get(jg), "cpu"))
    for logits, z, loss, grads in got:
        for a, b in ((logits, ref_logits), (z, ref_z), (loss, ref_loss)):
            b = np.asarray(b, np.float64)
            assert np.max(np.abs(np.asarray(a) - b)) <= \
                1e-5 * max(np.max(np.abs(b)), 1e-30)
        for name, (g, ref) in grads.items():
            assert np.max(np.abs(g - ref)) <= \
                1e-5 * max(np.max(np.abs(ref)), 1e-30), name
