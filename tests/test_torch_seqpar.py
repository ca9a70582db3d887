"""Port parity: sequence parallelism (`TransformerMoE.apply_seqpar` /
`loss_seqpar` / `seqpar_specs`, Ulysses and ring attention) and the
`seqpar_lm` example, at W = 2 and 4 gloo ranks (`testing.RankPool`),
against the JAX model's sequence-parallel forward on W of the 8 virtual
CPU devices, from the same global parameters (JAX's `init`, through
`convert.from_jax_params`) and tokens.

Cases (after tests/test_seqpar.py's 11): logits and l_aux of
`apply_seqpar`, and the loss, nll and every gradient leaf of `loss_seqpar`
(l_aux weighted 0.01, so the gate's gradient also carries the aux term),
for Ulysses and ring under MHA, Ulysses under GQA (2 and 4 KV heads at W =
2, 4 at W = 4), the ring past Ulysses' head bound (4 heads, 2 KV heads at
W = 4), expert slicing (`num_local_experts=-2`, adaptive_r 2), expert
choice, and the max_len + 1 dataset; T / P = 4 in the gradient cases, so a
wrong shift at a shard boundary moves a quarter of the targets. Also the
validations, the one-rank fallback (`apply` / `loss`, bit for bit),
`seqpar_specs` against JAX's and against `param_specs`, and the example's
losses against the JAX example's.

Tolerances (JAX's own tests): logits 2e-4, nll 1e-5, gradients 3e-4
relative and 3e-5 absolute; the example's losses 1e-4.

The ranks import this module, so jax is imported only inside the
functions the pytest process calls (`_jax`).
"""

import argparse

import numpy as np
import pytest
import torch

from tutel_tpu_torch import convert
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.testing import RankPool
from tutel_tpu_torch.utils import tree_leaves, tree_replace

torch.set_num_threads(1)

LOGITS = dict(rtol=2e-4, atol=2e-4)
NLL = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=3e-4, atol=3e-5)
BASE = dict(vocab_size=61, max_len=64, model_dim=32, num_heads=8,
            num_layers=2, ffn_hidden=64, moe_every=2, num_local_experts=1,
            top_k=2, capacity_factor=0.0, expert_hidden=64)
L_AUX_WT = 0.01


def _jax():
    import jax
    import jax.numpy as jnp
    from tutel_tpu.models import TransformerMoE as JModel
    from tutel_tpu.models import TransformerMoEConfig as JConfig
    return jax, jnp, JModel, JConfig


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


def _jax_models(w, cfg, parallel_type="adaptive:1"):
    """(JAX model over W devices, the one-device model with the same global
    expert count)."""
    jax, _, JModel, JConfig = _jax()
    devs = jax.devices()[:w]
    sp = JModel(JConfig(**cfg), group=devs, parallel_type=parallel_type)
    e_global = next(iter(sp.moe_layers.values())).num_global_experts
    ref = JModel(JConfig(**{**cfg, "num_local_experts": e_global}),
                 group=devs[:1])
    return sp, ref


def _jax_shard(model, params):
    return {**params, "blocks": [
        {**blk, "moe": model.moe_layers[i].shard_params(blk["moe"])}
        if "moe" in blk else blk for i, blk in enumerate(params["blocks"])]}


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, cfg["vocab_size"], (b, t)).astype(np.int32)


def _jax_case(w, cfg, parallel_type, tokens, mode, ov, grads, seed=0):
    """JAX's sequence-parallel logits and l_aux, and (grads) its loss, nll
    and gradients: (global params, results)."""
    jax, jnp, _, _ = _jax()
    sp, ref = _jax_models(w, cfg, parallel_type)
    params = ref.init(jax.random.PRNGKey(seed))
    sp_params = _jax_shard(sp, params)
    toks = jnp.asarray(tokens)
    logits, l_aux = jax.jit(lambda p, t: sp.apply_seqpar(
        p, t, moe_overrides=ov, attn_mode=mode))(sp_params, toks)
    out = {"logits": np.asarray(logits), "l_aux": float(l_aux)}
    if grads:
        def f(p):
            loss, (nll, _) = sp.loss_seqpar(
                p, toks, l_aux_wt=L_AUX_WT, training=True, moe_overrides=ov,
                attn_mode=mode)
            return loss, nll
        (loss, nll), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            sp_params)
        out.update(loss=float(loss), nll=float(nll),
                   grads=convert.from_jax_params(g, "cpu"))
    return convert.from_jax_params(params, "cpu"), out


def _rank_case(cfg, parallel_type, params, tokens, mode, ov, jax_grads):
    """One rank's apply_seqpar logits and l_aux and, with `jax_grads`, its
    loss_seqpar loss, nll and gradients beside its shard of JAX's."""
    model = TransformerMoE(TransformerMoEConfig(**cfg),
                           parallel_type=parallel_type, device="cpu")
    local = model.shard_params(params)
    with torch.no_grad():
        logits, l_aux = model.apply_seqpar(local, tokens, moe_overrides=ov,
                                           attn_mode=mode)
    out = {"logits": logits.numpy(), "l_aux": float(l_aux)}
    if jax_grads is not None:
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
        loss, (nll, _) = model.loss_seqpar(
            tree_replace(local, leaves), tokens, l_aux_wt=L_AUX_WT,
            training=True, moe_overrides=ov, attn_mode=mode)
        grads = torch.autograd.grad(loss, leaves)
        out.update(loss=float(loss), nll=float(nll),
                   grads=[g.numpy() for g in grads],
                   ref=[g.numpy() for g in tree_leaves(
                       model.shard_params(jax_grads))],
                   names=_leaf_names(local))
    return out


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


# name: (config changes, parallel_type, attn_mode, W, T a rank, gradients)
CASES = {
    "ulysses_mha_w2": ({}, "adaptive:1", "ulysses", 2, 4, True),
    "ulysses_mha_w4": ({}, "adaptive:1", "ulysses", 4, 4, True),
    "ring_mha_w2": ({}, "adaptive:1", "ring", 2, 4, True),
    "ring_mha_w4": ({}, "adaptive:1", "ring", 4, 4, True),
    "ulysses_gqa2_w2": ({"num_kv_heads": 2}, "adaptive:1", "ulysses", 2, 4,
                        True),
    "ulysses_gqa4_w2": ({"num_kv_heads": 4}, "adaptive:1", "ulysses", 2, 4,
                        True),
    "ulysses_gqa4_w4": ({"num_kv_heads": 4}, "adaptive:1", "ulysses", 4, 4,
                        True),
    # 4 heads and 2 KV heads on 4 ranks: past Ulysses' bound
    "ring_heads4_kv2_w4": ({"num_heads": 4, "num_kv_heads": 2},
                           "adaptive:1", "ring", 4, 4, True),
    # each expert sliced over 2 ranks
    "ulysses_slicing_w2": ({"num_local_experts": -2}, "adaptive:2",
                           "ulysses", 2, 8, True),
    "ulysses_slicing_w4": ({"num_local_experts": -2}, "adaptive:2",
                           "ulysses", 4, 4, True),
    "ulysses_expert_choice_w2": ({"gate_type": "expert_choice",
                                  "capacity_factor": 2.0}, "adaptive:1",
                                 "ulysses", 2, 16, False),
    "ring_expert_choice_w4": ({"gate_type": "expert_choice",
                               "capacity_factor": 2.0}, "adaptive:1",
                              "ring", 4, 8, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_seqpar_matches_jax(pools, name):
    changes, ptype, mode, w, tl, grads = CASES[name]
    cfg = {**BASE, **changes}
    b, t = 2, w * tl
    tokens = _tokens(cfg, b, t, seed=len(name))
    # the worst case: no layout drops a token
    ov = {} if cfg.get("gate_type") == "expert_choice" else \
        {"capacity_override": b * t}
    params, ref = _jax_case(w, cfg, ptype, tokens, mode, ov, grads)
    got = pools(w).run(_rank_case, cfg, ptype, params,
                       torch.from_numpy(tokens), mode, ov,
                       ref.get("grads"))
    for r in got:
        np.testing.assert_allclose(r["logits"], ref["logits"], **LOGITS)
        np.testing.assert_allclose(r["l_aux"], ref["l_aux"], **NLL)
        if grads:
            np.testing.assert_allclose(r["nll"], ref["nll"], **NLL)
            np.testing.assert_allclose(r["loss"], ref["loss"], **NLL)
            assert len(r["grads"]) == len(r["ref"])
            for n, g, rg in zip(r["names"], r["grads"], r["ref"]):
                np.testing.assert_allclose(g, rg, err_msg=n, **GRADS)


def test_loss_seqpar_max_len_plus_one_matches_jax(pools):
    """A dataset of max_len + 1 tokens: the sliced forward, (T - 1) % P ==
    0, T / P = 4 per rank; nll and gradients against JAX's."""
    jax, jnp, _, _ = _jax()
    cfg = {**BASE, "max_len": 16}
    b, t, w = 2, 17, 4
    tokens = _tokens(cfg, b, t, seed=5)
    ov = {"capacity_override": b * (t - 1)}
    sp, ref_model = _jax_models(w, cfg)
    params = ref_model.init(jax.random.PRNGKey(0))

    def f(p):
        loss, (nll, _) = sp.loss_seqpar(p, jnp.asarray(tokens),
                                        l_aux_wt=L_AUX_WT, moe_overrides=ov)
        return loss, nll
    (loss, nll), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        _jax_shard(sp, params))
    got = pools(w).run(_rank_max_len, cfg, convert.from_jax_params(
        params, "cpu"), torch.from_numpy(tokens), ov,
        convert.from_jax_params(g, "cpu"))
    for r_loss, r_nll, grads, refs in got:
        np.testing.assert_allclose(r_nll, float(nll), **NLL)
        np.testing.assert_allclose(r_loss, float(loss), **NLL)
        for gg, rg in zip(grads, refs):
            np.testing.assert_allclose(gg, rg, **GRADS)


def _rank_max_len(cfg, params, tokens, ov, jax_grads):
    model = TransformerMoE(TransformerMoEConfig(**cfg), device="cpu")
    local = model.shard_params(params)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
    loss, (nll, _) = model.loss_seqpar(tree_replace(local, leaves), tokens,
                                       l_aux_wt=L_AUX_WT, moe_overrides=ov)
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss), float(nll), [g.numpy() for g in grads],
            [g.numpy() for g in tree_leaves(model.shard_params(jax_grads))])


def _rank_validations(cfg):
    """The messages of each refused call, in order."""
    model = TransformerMoE(TransformerMoEConfig(**cfg), device="cpu")
    params = model.shard_params(model.init())
    gqa = TransformerMoE(TransformerMoEConfig(**{**cfg, "num_kv_heads": 1}),
                         device="cpu")
    no_moe = TransformerMoE(TransformerMoEConfig(**{**cfg, "moe_every": 0}),
                            device="cpu")
    ok = torch.zeros((2, 16), dtype=torch.long)
    ov = {"capacity_override": 32}
    calls = [
        lambda: model.apply_seqpar(params, torch.zeros((2, 13),
                                                       dtype=torch.long),
                                   moe_overrides=ov),
        lambda: gqa.apply_seqpar(params, ok, moe_overrides=ov),
        lambda: no_moe.apply_seqpar(params, ok),
        lambda: model.apply_seqpar(params, ok, moe_overrides=ov,
                                   attn_mode="flash"),
        lambda: model.loss_seqpar(params, ok),          # capacity_factor 0
    ]
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except ValueError as exc:
            out.append(str(exc))
    return out


def test_seqpar_validations(pools):
    """JAX's checks and messages: T % P, Ulysses' num_kv_heads % P, a model
    without MoE, an unknown attn_mode, and a capacity no static rule fixes
    (capacity_factor 0 without an override)."""
    got = pools(2).run(_rank_validations, BASE)
    for msgs in got:
        assert "must divide the 2-device SP world" in msgs[0]
        assert "use 'ring'" in msgs[1]
        assert "has none (moe_every=0)" in msgs[2]
        assert "expected 'ulysses' or 'ring'" in msgs[3]
        assert "static capacity" in msgs[4]


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_one_rank_falls_back_to_apply(mode):
    """At one rank apply_seqpar is apply and loss_seqpar is loss, bit for
    bit, and both equal JAX's one-device fallback."""
    jax, jnp, JModel, JConfig = _jax()
    cfg = {**BASE, "num_local_experts": 4, "capacity_factor": 1.25}
    jm = JModel(JConfig(**cfg), group=jax.devices()[:1])
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = _tokens(cfg, 2, 16, seed=1)
    ref, _ = jm.apply_seqpar(jp, jnp.asarray(tokens), attn_mode=mode)
    model = TransformerMoE(TransformerMoEConfig(**cfg), device="cpu")
    params = convert.from_jax_params(jp, "cpu")
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        a, aux_a = model.apply(params, toks)
        s, aux_s = model.apply_seqpar(params, toks, attn_mode=mode)
        la, (na, _) = model.loss(params, toks)
        ls, (ns, _) = model.loss_seqpar(params, toks, attn_mode=mode)
    assert torch.equal(a, s) and torch.equal(aux_a, aux_s)
    assert torch.equal(la, ls) and torch.equal(na, ns)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref), **LOGITS)


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_seqpar_body_at_one_rank_matches_apply(mode):
    """The per-rank body the card runs at P = 1 (`_seqpar_local`,
    `_loss_seqpar_local`) against apply / loss: logits 1e-5, the loss and
    nll 1e-5, and every gradient leaf."""
    cfg = {**BASE, "num_local_experts": 4, "capacity_factor": 1.25,
           "num_kv_heads": 2}
    model = TransformerMoE(TransformerMoEConfig(**cfg), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=2)).long()
    with torch.no_grad():
        ref, _ = model.apply(params, toks)
        got, _ = model._seqpar_local(params, toks, attn_mode=mode)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    results = []
    for fn in (model.loss, lambda p, t: model._loss_seqpar_local(
            p, t, attn_mode=mode)):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, (nll, _) = fn(tree_replace(params, leaves), toks)
        results.append((float(loss), float(nll),
                        torch.autograd.grad(loss, leaves)))
    (loss, nll, grads), (sloss, snll, sgrads) = results
    np.testing.assert_allclose(snll, nll, **NLL)
    np.testing.assert_allclose(sloss, loss, **NLL)
    for g, r in zip(sgrads, grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **GRADS)


def _rank_specs(cfg, parallel_type):
    model = TransformerMoE(TransformerMoEConfig(**cfg),
                           parallel_type=parallel_type, device="cpu")
    params = model.init()
    group, axes, pspec, tspec, lspec = model.seqpar_specs(params)
    moe = {i: model.moe_layers[i].param_specs(params["blocks"][i]["moe"])
           for i in model.moe_layers}
    same = all(pspec["blocks"][i]["moe"] == moe[i] for i in moe)
    return (axes, tspec, lspec, same,
            [tuple(s) for s in _spec_leaves(pspec)])


def _spec_leaves(spec):
    if isinstance(spec, dict):
        return [s for k in sorted(spec) for s in _spec_leaves(spec[k])]
    if isinstance(spec, list):
        return [s for v in spec for s in _spec_leaves(v)]
    return [spec]


@pytest.mark.parametrize("w,changes,ptype", [
    (2, {}, "adaptive:1"), (4, {"num_local_experts": -2}, "adaptive:2")])
def test_seqpar_specs_match_jax(pools, w, changes, ptype):
    """seqpar_specs: every leaf's spec equals JAX's PartitionSpec entry
    for entry, each MoE block's is its layer's param_specs, and the
    tokens and logits split along T over the expert axes."""
    jax, _, JModel, JConfig = _jax()
    cfg = {**BASE, **changes}
    sp, ref = _jax_models(w, cfg, ptype)
    params = ref.init(jax.random.PRNGKey(0))
    _, jaxes, jspec, jlspec = sp.seqpar_specs(params)
    want = [tuple(s) for s in jax.tree.leaves(
        jspec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    for axes, tspec, lspec, same, leaves in pools(w).run(_rank_specs, cfg,
                                                         ptype):
        assert axes == tuple(jaxes) == ("e", "r", "g")
        assert tspec == (None, axes) and lspec == tuple(jlspec)
        assert same and leaves == want


def _example_args(**kw):
    base = dict(batch=2, seq_len=32, model_dim=32, num_heads=8, num_layers=2,
                experts_per_device=1, steps=3, lr=1e-3, attn="ulysses",
                num_kv_heads=0)
    return argparse.Namespace(**{**base, **kw})


def _rank_example(args, params):
    from tutel_tpu_torch.examples import seqpar_lm
    return seqpar_lm.run(args, log=lambda *_: None, params=params)


@pytest.mark.parametrize("attn,kvh", [("ulysses", 0), ("ring", 4)])
def test_seqpar_lm_example_matches_jax(pools, attn, kvh):
    """examples/seqpar_lm.py at 2 ranks against the JAX example on the 8
    virtual devices: the same 8 global experts, parameters from the JAX
    example's init, the same token batches; each step's loss within
    1e-4."""
    jax, _, JModel, JConfig = _jax()
    from tutel_tpu.examples import seqpar_lm as jex
    ref = jex.run(_example_args(device="cpu", attn=attn, num_kv_heads=kvh),
                  log=lambda *_: None)
    args = _example_args(device="cpu", attn=attn, num_kv_heads=kvh,
                         experts_per_device=4)
    cfg = JConfig(vocab_size=256, max_len=args.seq_len,
                  model_dim=args.model_dim, num_heads=args.num_heads,
                  num_layers=args.num_layers, ffn_hidden=2 * args.model_dim,
                  moe_every=2, num_local_experts=8, top_k=2,
                  capacity_factor=2.0, expert_hidden=2 * args.model_dim,
                  num_kv_heads=kvh)
    params = JModel(cfg, group=jax.devices()[:1]).init(jax.random.PRNGKey(0))
    for losses in pools(2).run(_rank_example, args,
                               convert.from_jax_params(params, "cpu")):
        np.testing.assert_allclose(losses, ref, rtol=1e-4, atol=1e-4)

