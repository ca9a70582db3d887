"""Port parity: expert-choice routing (`ops.expert_choice`, the
`expert_choice` gate and the layer's one-rank EC flow) against the JAX
package on the same numpy inputs.

Cases: the top-C with tied scores (equal columns, zero rows), masked
tokens and C past the valid tokens (JAX's `lax.top_k` order: the lower
token index first); encode and decode, post- and prescore; the three
combine realizations against the scatter (duplicates, the sentinel, a
fan-in past J); the z-loss; the layer (float32, prescore, valid_tokens,
capacity_override, the capacity clamp, INT8 / INT4 experts and a fused
INT4 stream through the kernels' twins) and its gradients against
jax.grad, also with the combine the card runs (the inverse-map gather);
local_forward and param_specs at one rank; the ragged-EP and
capacity refusals; the EC TransformerMoE loss and gradients; the engines
(speculation off, the MoE engine's C = every valid token).

Tolerances: float32 outputs within 1e-5 absolute (values of order 1),
gradients within 1e-5 * max |jax gradient|; quantized experts within 1e-4
of max |jax|; routing indices equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu import moe as jmoe
from tutel_tpu.ops import expert_choice as jec
from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.ops import expert_choice as tec

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _scores(rng, s, e):
    x = rng.standard_normal((s, e)).astype(np.float32)
    x = np.exp(x - x.max(axis=1, keepdims=True))
    return (x / x.sum(axis=1, keepdims=True)).astype(np.float32)


def _score_cases():
    rng = np.random.default_rng(0)
    plain = _scores(rng, 24, 4)
    equal = np.repeat(_scores(rng, 24, 1) * 0 + 0.25, 4, axis=1)
    ties = _scores(rng, 24, 4)
    ties[::3] = 0.25                       # zero pad rows: all experts tie
    ties[5, :] = ties[6, :]
    return {"plain": (plain, None, 6), "equal_columns": (equal, None, 7),
            "tied_rows": (ties, None, 9),
            "masked": (plain, np.arange(24) < 17, 6),
            "capacity_past_valid": (ties, np.arange(24) < 5, 12),
            "capacity_clamped": (plain, None, 40)}


@pytest.mark.parametrize("case", ["capacity_clamped", "capacity_past_valid",
                                  "equal_columns", "masked", "plain",
                                  "tied_rows"])
def test_routing_matches_jax(case):
    scores, mask, cap = _score_cases()[case]
    ref = jec.expert_choice_routing(
        jnp.asarray(scores), cap,
        None if mask is None else jnp.asarray(mask))
    got = tec.expert_choice_routing(_t(scores), cap,
                                    None if mask is None else _t(mask))
    assert got.capacity == ref.capacity == min(cap, 24)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(got.gates.numpy(), np.asarray(ref.gates))


@pytest.mark.parametrize("postscore", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_encode_decode_match_jax(postscore, masked):
    rng = np.random.default_rng(1)
    scores = _scores(rng, 16, 3)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    mask = np.arange(16) < 6 if masked else None
    jr = jec.expert_choice_routing(
        jnp.asarray(scores), 16, None if mask is None else jnp.asarray(mask))
    tr = tec.expert_choice_routing(_t(scores), 16,
                                   None if mask is None else _t(mask))
    jy = jec.ec_encode(jnp.asarray(x), jr, postscore)
    ty = tec.ec_encode(_t(x), tr, postscore)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    # a biased expert: dead slots must not reach their tokens
    ref = jec.ec_decode(jy + 0.37, jr, 16, postscore, native=False)
    got = tec.ec_decode(ty + 0.37, tr, 16, postscore)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    if masked:
        assert np.all(got.numpy()[6:] == 0)


def _rows_ids():
    rng = np.random.RandomState(0)
    rows = rng.randn(40, 16).astype(np.float32)
    return {"duplicates_and_sentinel": (rows[:24], rng.randint(
        0, 11, size=24).astype(np.int64), 10),
        "fan_in_13": (rows, np.r_[np.zeros(13), np.arange(1, 28)].astype(
            np.int64), 28)}


@pytest.mark.parametrize("case", ["duplicates_and_sentinel", "fan_in_13"])
@pytest.mark.parametrize("how", ["onehot", "fanin", "native"])
def test_combine_realizations_match_scatter(case, how):
    """Each realization against JAX's scatter oracle (combine_rows with
    native=False); the fan-in with J at the largest fan-in, and its
    overflow flag below it."""
    rows, ids, s = _rows_ids()[case]
    ref = np.asarray(jec.combine_rows(jnp.asarray(rows),
                                      jnp.asarray(ids, jnp.int32), s,
                                      native=False))
    np.testing.assert_allclose(
        tec.combine_rows(_t(rows), _t(ids), s).numpy(), ref,
        rtol=1e-6, atol=1e-6)                      # the CPU's scatter
    if how == "onehot":
        got = tec._combine_onehot(_t(rows), _t(ids), s)
    elif how == "fanin":
        got, over = tec._combine_fanin(_t(rows), _t(ids), s, 13)
        assert not bool(over)
        _, over8 = tec._combine_fanin(_t(rows), _t(ids), s, 8)
        _, jover8 = jec._combine_fanin(jnp.asarray(rows),
                                       jnp.asarray(ids, jnp.int32), s)
        assert bool(over8) == bool(jover8)
    else:
        got = tec.combine_rows(_t(rows), _t(ids), s, native=True,
                               max_fanin=13)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_combine_fanin_gradient_is_a_gather():
    rows, ids, s = _rows_ids()["duplicates_and_sentinel"]
    r = _t(rows).requires_grad_(True)
    tec._combine_fanin(r, _t(ids), s, 24)[0].sum().backward()
    want = ((ids >= 0) & (ids < s)).astype(np.float32)[:, None]
    np.testing.assert_array_equal(r.grad.numpy(),
                                  np.broadcast_to(want, rows.shape))


@pytest.mark.parametrize("masked", [False, True])
def test_z_loss_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((20, 5)).astype(np.float32) * 3
    mask = np.arange(20) < 13 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    for got, ref in ((tec.router_z_loss(_t(logits), tm),
                      jec.router_z_loss(jnp.asarray(logits), jm)),
                     (tec.router_z_loss_parts(_t(logits), tm)[0],
                      jec.router_z_loss_parts(jnp.asarray(logits), jm)[0]),
                     (tec.router_z_loss_parts(_t(logits), tm)[1],
                      jec.router_z_loss_parts(jnp.asarray(logits), jm)[1])):
        assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


def test_expert_choice_forward_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((32, 4)).astype(np.float32)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8, 8)).astype(np.float32)
    jscores = jax.nn.softmax(jnp.asarray(logits), axis=1)
    ref, rz = jec.expert_choice_forward(
        jscores, jnp.asarray(logits), jnp.asarray(x),
        lambda y: jnp.einsum("ecm,emn->ecn", y, jnp.asarray(w)), 16)
    got, tz = tec.expert_choice_forward(
        torch.softmax(_t(logits), 1), _t(logits), _t(x),
        lambda y: torch.bmm(y, _t(w)), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert abs(float(tz) - float(rz)) <= 1e-6 * float(rz)


def test_facade_and_gate():
    for name in ("expert_choice_routing", "ec_encode", "ec_decode",
                 "router_z_loss"):
        assert getattr(tmoe, name) is getattr(tec, name)
    layer = _layers({})[1]
    gate = layer.gates[0]
    assert gate.expert_choice is True and gate.top_k == 1
    assert gate.capacity_factor == 2.0 and gate.k == 1
    params = layer.init(torch.Generator().manual_seed(0))
    assert params["gates"][0]["wg"].shape == (32, 4)


# ---------------------------------------------------------------------------
# The layer at one rank
# ---------------------------------------------------------------------------

M, E, H = 32, 4, 64


def _kwargs(spec):
    spec = dict(spec)
    return dict(
        gate_type={"type": "expert_choice",
                   "capacity_factor": spec.pop("cf", 2.0),
                   "gate_noise": 0.0},
        experts={"type": "ffn", "num_experts_per_device": spec.pop("e", E),
                 "hidden_size_per_expert": spec.pop("hidden", H),
                 **spec.pop("experts", {})},
        model_dim=M, seeds=(1, 1, 1), **spec)


def _layers(spec):
    return (jmoe.moe_layer(group=jax.devices()[:1], **_kwargs(spec)),
            tmoe.moe_layer(device="cpu", **_kwargs(spec)))


def _quantized(jp, bits, fused):
    from tutel_tpu.ops import fused_ffn_pallas, quant as jq
    ex = jq.quantize_expert_params(jp["experts"], bits=bits)
    if fused:
        ex = fused_ffn_pallas.prepare_fused_ffn_params(ex)
        assert "fused_stream" in ex
    return {**jp, "experts": ex}


LAYER_CASES = {
    "float": ({}, {}, 64, 0, False),
    "prescore": ({"is_postscore": False}, {}, 64, 0, False),
    "valid_tokens": ({}, {"valid_tokens": 41}, 64, 0, False),
    "capacity_override": ({}, {"capacity_override": 5}, 64, 0, False),
    "capacity_clamp": ({"cf": 100.0}, {}, 16, 0, False),
    "call_cf": ({}, {"capacity_factor": 0.75}, 64, 0, False),
    "int8": ({"experts": {"has_fc1_bias": False}}, {}, 64, 8, False),
    "int4": ({}, {}, 64, 4, False),
    "int4_fused": ({"hidden": 128}, {}, 64, 4, True),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    spec, call, s, bits, fused = LAYER_CASES[case]
    jl, tl = _layers(spec)
    jp = jl.init(jax.random.PRNGKey(0))
    if bits:
        jp = _quantized(jp, bits, fused)
    x = np.random.default_rng(1).standard_normal((s, M)).astype(np.float32)
    ref, rz = jl(jp, jnp.asarray(x), **call)
    got, tz = tl(convert.from_jax_params(jp, "cpu"), _t(x), **call)
    ref = np.asarray(ref)
    tol = 1e-4 * np.max(np.abs(ref)) if bits else 1e-5
    assert np.max(np.abs(got.numpy() - ref)) <= tol
    assert abs(float(tz) - float(rz)) <= 1e-5 * abs(float(rz))
    if "valid_tokens" in call:
        assert np.all(got.numpy()[41:] == 0)


@pytest.mark.parametrize("case", ["float", "prescore", "valid_tokens"])
def test_layer_card_combine_matches_jax(monkeypatch, case):
    """The layer with the combine the card runs (the inverse-map gather,
    J = E slots) on the CPU."""
    spec, call, s, _, _ = LAYER_CASES[case]
    plain = tec.combine_rows
    monkeypatch.setattr(tec, "combine_rows", lambda *a, **k: plain(
        *a, **{**k, "native": True}))
    jl, tl = _layers(spec)
    jp = jl.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((s, M)).astype(np.float32)
    ref, _ = jl(jp, jnp.asarray(x), **call)
    got, _ = tl(convert.from_jax_params(jp, "cpu"), _t(x), **call)
    assert np.max(np.abs(got.numpy() - np.asarray(ref))) <= 1e-5


@pytest.mark.parametrize("postscore", [True, False])
def test_layer_gradients_match_jax(postscore):
    jl, tl = _layers({"is_postscore": postscore})
    jp = jl.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, M)).astype(np.float32)
    cot = rng.standard_normal((64, M)).astype(np.float32)

    def jloss(p, xx):
        out, z = jl(p, xx, training=True)
        return jnp.sum(out * jnp.asarray(cot)) + 0.01 * z
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = convert.from_jax_params(jp, "cpu")
    leaves = {"wg": tp["gates"][0]["wg"], **tp["experts"]}
    for v in leaves.values():
        v.requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    out, z = tl(tp, tx, training=True)
    (torch.sum(out * _t(cot)) + 0.01 * z).backward()
    refs = {"wg": jg["gates"][0]["wg"], **jg["experts"], "x": jgx}
    for name, v in {**leaves, "x": tx}.items():
        ref = np.asarray(refs[name])
        assert np.max(np.abs(v.grad.numpy() - ref)) <= \
            1e-5 * np.max(np.abs(ref)), name


def test_local_forward_and_param_specs_at_one_rank():
    jl, tl = _layers({})
    jp = jl.init(jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jp, "cpu")
    x = np.random.default_rng(4).standard_normal((64, M)).astype(np.float32)
    ref, rz = jl.local_forward(capacity_factor=2.0)(
        jp, jnp.asarray(x), jax.random.PRNGKey(0))
    got, tz = tl.local_forward(capacity_factor=2.0)(tp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert abs(float(tz) - float(rz)) <= 1e-6 * float(rz)
    whole, got_tc = tl(tp, _t(x))
    assert torch.equal(whole, got)
    specs = tl.param_specs(tp)
    assert specs == {"gates": [{"wg": ()}], "experts": dict.fromkeys(
        tp["experts"], ())}


def test_refusals():
    _, tl = _layers({})
    tp = tl.init(torch.Generator().manual_seed(0))
    x = torch.zeros(16, M)
    with pytest.raises(ValueError, match="exactly-sized"):
        tl(tp, x, use_ragged_ep=True, max_recv=64)
    with pytest.raises(ValueError, match="capacity_factor > 0"):
        tl(tp, x, capacity_factor=0.0)
    with pytest.raises(ValueError, match="capacity_factor > 0"):
        tl.local_forward(capacity_factor=0.0)
    top = tmoe.moe_layer(**{**_kwargs({}), "gate_type": {
        "type": "top", "k": 2, "capacity_factor": 0.0}}, device="cpu")
    with pytest.raises(ValueError, match="static capacity"):
        top.local_forward(capacity_factor=0.0)


# ---------------------------------------------------------------------------
# The EC TransformerMoE and the engines
# ---------------------------------------------------------------------------

LM_CFG = dict(vocab_size=61, max_len=32, model_dim=32, num_heads=2,
              num_layers=2, ffn_hidden=64, moe_every=1, num_local_experts=4,
              top_k=2, expert_hidden=64, gate_type="expert_choice")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _flat(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _flat(t, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("t", [32, 20])
def test_ec_transformer_loss_and_grads_match_jax(t):
    from tutel_tpu.models import transformer as jtr
    from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
    jm = jtr.TransformerMoE(jtr.TransformerMoEConfig(**LM_CFG),
                            group=jax.devices()[:1])
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerMoE(TransformerMoEConfig(**LM_CFG), device="cpu")
    tokens = np.random.default_rng(t).integers(0, 61, (4, t))
    (jl, (jn, ja)), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens, jnp.int32),
                          key=jax.random.PRNGKey(1), training=True),
        has_aux=True))(jp)
    tp = convert.from_jax_params(jp, "cpu")
    leaves = _flat(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    tl, (tn, ta) = tm.loss(tp, _t(tokens), key=torch.Generator().manual_seed(
        1), training=True)
    grads = torch.autograd.grad(tl, list(leaves.values()))
    for got, ref in ((tl, jl), (tn, jn), (ta, ja)):
        assert abs(float(got.detach()) - float(ref)) <= \
            1e-5 * abs(float(ref))
    jflat = _flat(jg)
    for name, g in zip(leaves, grads):
        ref = np.asarray(jflat[name], np.float64)
        assert np.max(np.abs(g.numpy() - ref)) <= \
            1e-5 * max(np.max(np.abs(ref)), 1e-30), name


def test_ec_lm_engine_matches_jax_engine():
    """Speculation is off for an EC model in both engines (asked for here);
    the greedy tokens equal JAX's, and a decode step runs at C = cf * S /
    E."""
    from tutel_tpu.models import transformer as jtr
    from tutel_tpu.serving import LmDecodeEngine as JLm
    from tutel_tpu.serving import LmRequest as JReq
    from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
    from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest
    cfg = {**LM_CFG, "moe_every": 2, "capacity_factor": 2.0}
    jm = jtr.TransformerMoE(jtr.TransformerMoEConfig(**cfg),
                            group=jax.devices()[:1])
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerMoE(TransformerMoEConfig(**cfg), device="cpu")
    prompts = [np.random.default_rng(i).integers(0, 61, 3 + i) for i in
               range(5)]
    jeng = JLm(jm, jp, max_batch=4, speculative_capacity=4.0)
    teng = LmDecodeEngine(tm, convert.from_jax_params(jp, "cpu"),
                          max_batch=4, speculative_capacity=4.0)
    assert jeng.speculative_capacity == teng.speculative_capacity == 0.0
    ref = jeng.run([JReq(uid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)], chunk=3)
    got = teng.run([LmRequest(uid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)], chunk=3)
    assert {u: list(v) for u, v in got.items()} == \
        {u: list(map(int, v)) for u, v in ref.items()}


def test_ec_moe_engine_matches_jax_engine():
    """The MoE engine passes the worst case as capacity_override, which the
    EC rule takes as C: every expert takes every valid token, in both
    packages."""
    from tutel_tpu.serving import MoeDecodeEngine as JEngine
    from tutel_tpu.serving import Request as JRequest
    from tutel_tpu_torch.serving import MoeDecodeEngine, Request
    jl, tl = _layers({})
    jp = jl.init(jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jp, "cpu")
    states = np.random.default_rng(7).standard_normal((10, M)).astype(
        np.float32)
    kw = dict(max_batch=8, speculative_capacity=8.0,
              state_update="residual_norm")
    jeng, teng = JEngine(jl, jp, **kw), MoeDecodeEngine(tl, tp, **kw)
    assert jeng.speculative_capacity == teng.speculative_capacity == 0.0
    ref = jeng.run([JRequest(uid=i, state=states[i], remaining=1 + i % 3)
                    for i in range(10)], chunk=2)
    got = teng.run([Request(uid=i, state=states[i], remaining=1 + i % 3)
                    for i in range(10)], chunk=2)
    for uid in ref:
        np.testing.assert_allclose(got[uid].numpy(), np.asarray(ref[uid]),
                                   atol=1e-5)
    # C = the bucketed valid count: each expert takes every valid token
    assert tl._ec_capacity(8, 2.0, teng._worst_cap(5), 1) == 8
