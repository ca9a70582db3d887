"""Port parity: the float megablocks branch and the sorted-ragged layout
against the JAX package on the CPU, on the same numpy inputs (float32,
max |port - jax| <= 1e-5 * max |jax|): `ops.grouped_gemm`'s grouped_gemm
(rows past the groups are zeros), grouped_bias_add and megablocks_ffn
(zeros past the rounded counts, where the padded bmm leaves bias-only
rows), `ops.ragged`'s make_ragged / encode_ragged / decode_ragged, and the
MoE layer with megablocks_size 4 and 8 (and valid_tokens), whose JAX
counterpart takes its megablocks branch; the port's branch also equals
its own padded path on the live rows."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu import moe as jmoe
from tutel_tpu.ops import grouped_gemm as jgg
from tutel_tpu.ops import ragged as jragged
from tutel_tpu.ops import routing as jrouting
from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.ops import grouped_gemm as tgg
from tutel_tpu_torch.ops import ragged as tragged
from tutel_tpu_torch.ops import routing as trouting

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-12)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("sizes", [[3, 0, 5, 2], [0, 0, 7, 0], [4, 4, 4, 4]])
def test_grouped_gemm_and_bias_match_jax(sizes):
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    t, k, n = 16, 12, 10
    lhs = rng.standard_normal((t, k)).astype(np.float32)
    rhs = rng.standard_normal((4, k, n)).astype(np.float32)
    bias = rng.standard_normal((4, n)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    ref = jgg.grouped_gemm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs))
    got = tgg.grouped_gemm(_t(lhs), _t(rhs), _t(gs))
    _close(got.numpy(), ref)
    assert not got.numpy()[gs.sum():].any()          # zeros past the groups
    _close(tgg.grouped_bias_add(got, _t(bias), _t(gs)).numpy(),
           jgg.grouped_bias_add(ref, jnp.asarray(bias), jnp.asarray(gs)))


@pytest.mark.parametrize("mega,counts", [(4, [5, 0, 8, 3]), (8, [1, 2, 0, 8]),
                                         (1, [2, 7, 4, 0]), (4, None)])
@pytest.mark.parametrize("bias", [True, False])
def test_megablocks_ffn_matches_jax(mega, counts, bias):
    rng = np.random.default_rng(mega)
    e, c, m, h = 4, 8, 16, 24
    x = rng.standard_normal((e, c, m)).astype(np.float32)
    p = {"fc1_w": rng.standard_normal((e, m, h)).astype(np.float32),
         "fc2_w": rng.standard_normal((e, h, m)).astype(np.float32)}
    if bias:
        p["fc1_b"] = rng.standard_normal((e, h)).astype(np.float32)
        p["fc2_b"] = rng.standard_normal((e, m)).astype(np.float32)
    cnt = None if counts is None else np.asarray(counts, np.int32)
    jctx = SimpleNamespace(megablocks_size=mega, dispatch_count=None
                           if cnt is None else jnp.asarray(cnt))
    tctx = SimpleNamespace(megablocks_size=mega, dispatch_count=None
                           if cnt is None else _t(cnt))
    ref = jgg.megablocks_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                              p.items()}, jctx,
                             jax.nn.relu, m)
    got = tgg.megablocks_ffn(_t(x), {k: _t(v) for k, v in p.items()}, tctx,
                             torch.relu, m)
    _close(got.numpy(), ref)
    rounded = np.full(e, c) if cnt is None else \
        np.minimum((cnt + mega - 1) // mega * mega, c)
    for i in range(e):                   # zeros past the rounded counts
        assert not got.numpy()[i, rounded[i]:].any()


@pytest.mark.parametrize("k,postscore", [(1, True), (2, True), (2, False)])
def test_ragged_layout_matches_jax(k, postscore):
    rng = np.random.default_rng(k)
    s, e, m = 12, 4, 6
    scores = rng.random((s, e)).astype(np.float32)
    scores /= scores.sum(1, keepdims=True)
    data = rng.standard_normal((s, m)).astype(np.float32)
    jcrit, _ = jrouting.extract_critical(jnp.asarray(scores), k, capacity=s)
    tcrit, _ = trouting.extract_critical(_t(scores), k, capacity=s)
    jrd = jragged.make_ragged(jcrit)
    trd = tragged.make_ragged(tcrit)
    np.testing.assert_array_equal(trd.sort_order.numpy(), jrd.sort_order)
    np.testing.assert_array_equal(trd.inverse_order.numpy(),
                                  jrd.inverse_order)
    np.testing.assert_array_equal(trd.group_sizes.numpy(), jrd.group_sizes)
    assert trd.top_k == k and trd.num_global_experts == e
    rows = tragged.encode_ragged(_t(data), trd, postscore)
    _close(rows.numpy(), jragged.encode_ragged(jnp.asarray(data), jrd,
                                               postscore))
    y = rows * 2 + 1
    _close(tragged.decode_ragged(y, trd, postscore).numpy(),
           jragged.decode_ragged(jnp.asarray(y.numpy()), jrd, postscore))


def _layers(model_dim, hidden, e, cf):
    gate = {"type": "top", "k": 2, "capacity_factor": cf}
    experts = {"type": "ffn", "num_experts_per_device": e,
               "hidden_size_per_expert": hidden}
    j = jmoe.moe_layer(gate_type=dict(gate), experts=dict(experts),
                       model_dim=model_dim, seeds=(1, 1, 1),
                       group=jax.devices()[:1])
    t = tmoe.moe_layer(gate_type=dict(gate), experts=dict(experts),
                       model_dim=model_dim, device="cpu")
    return j, t


@pytest.mark.parametrize("mega,cf,valid", [(4, 0.0, None), (8, 0.0, None),
                                           (4, 1.0, 21), (8, 0.0, 13),
                                           (8, -1.0, None)])
def test_layer_megablocks_matches_jax(mega, cf, valid):
    jl, tl = _layers(32, 48, 4, cf)
    jp = jl.init(jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jp, "cpu")
    x = np.random.default_rng(mega + 1).standard_normal(
        (2, 16, 32)).astype(np.float32)
    ref, rl = jl(jp, jnp.asarray(x), valid_tokens=valid, megablocks_size=mega)
    got, gl = tl(tp, _t(x), valid_tokens=valid, megablocks_size=mega)
    _close(got.numpy(), ref)
    _close(gl, rl)
    if cf == 0.0:       # dropless: the padded bmm routes the same tokens
        padded, _ = tl(tp, _t(x), valid_tokens=valid)
        _close(padded.numpy(), got.numpy())


def test_megablocks_off_for_one_expert_and_training():
    """The layer takes the padded bmm for one local expert and for
    training, as JAX does."""
    _, tl = _layers(32, 48, 1, 0.0)
    tp = tl.init(torch.Generator().manual_seed(0))
    x = torch.randn(24, 32, generator=torch.Generator().manual_seed(1))
    a, _ = tl(tp, x, megablocks_size=8)
    b, _ = tl(tp, x)
    assert torch.equal(a, b)
    _, tl = _layers(32, 48, 4, 0.0)
    tp = tl.init(torch.Generator().manual_seed(0))
    a, _ = tl(tp, x, megablocks_size=8, training=True)
    b, _ = tl(tp, x, training=True)
    assert torch.equal(a, b)
