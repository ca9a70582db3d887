"""Port parity: the LM and the serving engines over a process group, at
W = 2 and 4 gloo ranks (`testing.RankPool`).

* `TransformerMoE(cfg, group=...)`: `apply` and `loss` (with its
  gradients) on token counts that do not divide W, against the JAX model
  with its MoE layers over W of the 8 virtual CPU devices (the port pads
  each MoE call to a multiple of W, masks the padding with a scalar
  valid_tokens, and all-gathers the rows): within 1e-5 of max |jax|.
* `LmDecodeEngine` over that model (one expert a rank): the greedy tokens
  equal to the same engine over a one-rank model holding every expert
  (tests/test_serving.py::test_lm_engine_multi_device_ep), with and
  without the speculative capacity, which turns itself off over several
  ranks; and equal to JAX's engine over the JAX model on W devices, on
  the same parameters and requests.
* `MoeDecodeEngine` at W = 4 (tests/test_serving.py::
  test_speculative_capacity_multi_device_ep at 4 ranks instead of 8): the
  per-rank worst and speculated capacities equal to JAX's engine's, and
  under a gate collapsed onto one expert the speculated chunk must replay;
  outputs equal to the worst-case engine's within 1e-5, and every rank's
  outputs, speculated and worst-case, within 1e-5 of max |jax| of JAX's
  engine over 4 devices on the same states.

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
from tutel_tpu_torch.serving import (LmDecodeEngine, LmRequest,
                                     MoeDecodeEngine, Request)
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

CFG = dict(vocab_size=61, max_len=32, model_dim=32, num_heads=2,
           num_layers=2, ffn_hidden=64, moe_every=2, num_local_experts=1,
           top_k=2, capacity_factor=0.0, expert_hidden=48)


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


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


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _flat(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _flat(t, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _rank_lm(params, tokens, jgrads):
    model = TransformerMoE(TransformerMoEConfig(**CFG), device="cpu")
    local = model.shard_params(params)
    with torch.no_grad():
        logits, l_aux = model.apply(local, tokens)
    leaves = _flat(local)
    for v in leaves.values():
        v.requires_grad_(True)
    loss, (nll, aux) = model.loss(local, tokens, l_aux_wt=0.01)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    ref = _flat(model.shard_params(jgrads))
    return (logits.numpy(), float(l_aux), float(loss), float(nll),
            float(aux),
            {n: (g.numpy(), ref[n].numpy()) for n, g in zip(leaves, grads)})


def _close(got, ref, what):
    ref = np.asarray(ref, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - ref))
    assert err <= 1e-5 * max(np.max(np.abs(ref)), 1e-30), (what, err)


@pytest.mark.parametrize("w", [2, 4])
def test_lm_apply_and_loss_match_jax(pools, w):
    jax, jnp = _jax()
    from tutel_tpu.models import transformer as jtr
    jm = jtr.TransformerMoE(jtr.TransformerMoEConfig(**CFG),
                            group=jax.devices()[:w])
    assert jm.moe_layers[1].world_size == w
    jp = jm.init(jax.random.PRNGKey(w))
    tokens = np.random.default_rng(w).integers(0, CFG["vocab_size"], (3, 5))
    assert tokens.size % w
    jt = jnp.asarray(tokens, jnp.int32)
    # under jit the JAX layer's dropless capacity is the worst case:
    # the same values as the probed one
    ref_logits, ref_aux = jax.jit(jm.apply)(jp, jt)

    def jloss(p):
        return jm.loss(p, jt, l_aux_wt=0.01)
    (ref_loss, (ref_nll, ref_l)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    got = pools(w).run(_rank_lm, convert.from_jax_params(jp, "cpu"),
                       torch.from_numpy(tokens),
                       convert.from_jax_params(jax.device_get(jg), "cpu"))
    for logits, l_aux, loss, nll, aux, grads in got:
        _close(logits, ref_logits, "logits")
        for a, b, name in ((l_aux, ref_aux, "l_aux"), (loss, ref_loss, "loss"),
                           (nll, ref_nll, "nll"), (aux, ref_l, "aux")):
            _close(a, b, name)
        for name, (g, ref) in grads.items():
            _close(g, ref, name)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG["vocab_size"], 5).astype(np.int32)
            for _ in range(6)]


def _rank_lm_engine(params):
    w = dist.get_world_size()
    cfg = TransformerMoEConfig(**CFG)
    m_ep = TransformerMoE(cfg, device="cpu")
    m_1 = TransformerMoE(TransformerMoEConfig(**{**CFG,
                                                 "num_local_experts": w}),
                         group=[dist.get_rank()], device="cpu")
    prompts = _prompts()

    def mk():
        return [LmRequest(uid=i, prompt=p.copy(), max_new_tokens=8)
                for i, p in enumerate(prompts)]
    ov = {"capacity_factor": 8.0}
    out1 = LmDecodeEngine(m_1, params, max_batch=4,
                          moe_overrides=ov).run(mk(), chunk=4)
    outep = LmDecodeEngine(m_ep, m_ep.shard_params(params), max_batch=4,
                           moe_overrides=ov).run(mk(), chunk=4)
    eng_s = LmDecodeEngine(m_ep, m_ep.shard_params(params), max_batch=4,
                           moe_overrides={"capacity_factor": 0.0},
                           speculative_capacity=4.0)
    outs = eng_s.run(mk(), chunk=4)
    return ({k: list(v) for k, v in out1.items()},
            {k: list(v) for k, v in outep.items()},
            {k: list(v) for k, v in outs.items()}, eng_s.speculative_capacity)


@pytest.mark.parametrize("w", [2, 4])
def test_lm_engine_multi_device_ep(pools, w):
    jax, _ = _jax()
    from tutel_tpu.models import transformer as jtr
    from tutel_tpu.serving import LmDecodeEngine as JLmEngine
    from tutel_tpu.serving import LmRequest as JLmRequest
    jp = jtr.TransformerMoE(
        jtr.TransformerMoEConfig(**{**CFG, "num_local_experts": w}),
        group=jax.devices()[:1]).init(jax.random.PRNGKey(0))
    jm = jtr.TransformerMoE(jtr.TransformerMoEConfig(**CFG),
                            group=jax.devices()[:w])
    ref = JLmEngine(jm, jp, max_batch=4,
                    moe_overrides={"capacity_factor": 8.0}).run(
        [JLmRequest(uid=i, prompt=p, max_new_tokens=8)
         for i, p in enumerate(_prompts())], chunk=4)
    ref = {k: [int(t) for t in v] for k, v in ref.items()}
    got = pools(w).run(_rank_lm_engine, convert.from_jax_params(jp, "cpu"))
    for out1, outep, outs, spec in got:
        assert len(out1) == 6 and out1 == outep == outs
        assert spec == 0.0
        assert {k: [int(t) for t in v] for k, v in outep.items()} == ref
    assert all(g[1] == got[0][1] for g in got)


def _layer_kwargs():
    return dict(gate_type={"type": "top", "k": 1, "capacity_factor": 0.0},
                experts={"type": "ffn", "num_experts_per_device": 2,
                         "hidden_size_per_expert": 64},
                model_dim=32, seeds=(1, 1, 1))


def _rank_moe_engine(params, states):
    layer = tmoe.moe_layer(device="cpu", **_layer_kwargs())
    local = layer.shard_params(params)

    def drive(spec):
        layer.__dict__.pop("_serving_spec_hints", None)
        eng = MoeDecodeEngine(layer, local, max_batch=32,
                              speculative_capacity=spec, capacity_bucket=1)
        reqs = [Request(uid=i, state=states[i], remaining=6)
                for i in range(32)]
        return eng, eng.run(reqs, chunk=3)
    probe = MoeDecodeEngine(layer, local, max_batch=32,
                            speculative_capacity=1.0, capacity_bucket=1)
    caps = [(probe._worst_cap(n), probe._spec_cap(n, probe._worst_cap(n)))
            for n in (1, 5, 8, 9, 20, 32)]
    eng_s, out_s = drive(1.0)
    eng_w, out_w = drive(0.0)
    err = max(float((out_s[u] - out_w[u]).abs().max()) for u in out_w)
    scale = max(float(out_w[u].abs().max()) for u in out_w)
    return (caps, eng_s.stats["spec_retries"], eng_w.stats["spec_retries"],
            err / scale, len(out_w),
            {u: (out_s[u].numpy(), out_w[u].numpy()) for u in out_w})


def test_speculative_capacity_multi_device_ep(pools):
    """capacity_override is a per-(expert, source-rank) buffer: at 32 slots
    over 4 ranks a rank holds 8 rows, so the worst case is 8, and margin 1
    gives ceil(8 / 8) = 1, which a gate collapsed onto expert 0 must
    overflow and replay."""
    jax, jnp = _jax()
    from tutel_tpu import moe as jmoe
    from tutel_tpu.serving import MoeDecodeEngine as JEngine
    w = 4
    jl = jmoe.moe_layer(group=jax.devices()[:w], **_layer_kwargs())
    jp = jl.init(jax.random.PRNGKey(0))
    skew = dict(jp)
    g0 = dict(skew["gates"][0])
    wg = np.zeros(np.asarray(g0["wg"]).shape, np.float32)
    wg[:, 0] = 10.0                       # every token -> global expert 0
    g0["wg"] = jnp.asarray(wg)
    skew["gates"] = [g0]
    states = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (32, 32)).astype(np.float32))
    jeng = JEngine(jl, jl.shard_params(jp), max_batch=32,
                   speculative_capacity=1.0, capacity_bucket=1)
    ref_caps = [(jeng._worst_cap(n), jeng._spec_cap(n, jeng._worst_cap(n)))
                for n in (1, 5, 8, 9, 20, 32)]
    assert ref_caps[-1] == (8, 1)
    for p, expect_retry in ((jp, False), (skew, True)):
        jl.__dict__.pop("_serving_spec_hints", None)
        ref = JEngine(jl, jl.shard_params(p), max_batch=32,
                      speculative_capacity=0.0, capacity_bucket=1).run(
            [Request(uid=i, state=states[i].numpy(), remaining=6)
             for i in range(32)], chunk=3, key=jax.random.PRNGKey(2))
        ref = {u: np.asarray(v, np.float64) for u, v in ref.items()}
        scale = max(np.max(np.abs(v)) for v in ref.values())
        got = pools(w).run(_rank_moe_engine,
                           convert.from_jax_params(p, "cpu"), states)
        for caps, retries_s, retries_w, err, n, outs in got:
            assert caps == ref_caps
            assert retries_w == 0 and n == 32
            if expect_retry:
                assert retries_s > 0
            assert err <= 1e-5, err
            assert sorted(outs) == sorted(ref)
            for u, pair in outs.items():
                for o in pair:
                    assert np.max(np.abs(o - ref[u])) <= 1e-5 * scale, u
