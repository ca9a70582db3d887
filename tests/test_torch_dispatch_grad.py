"""Port parity: the dispatch backward (tutel_tpu_torch.ops.dispatch) against
`jax.vjp` of the JAX package's fast_encode / fast_decode (its custom VJPs),
on the same routing, data and cotangents: top-1 and top-2, both
is_postscore values, dropped tokens (capacity below the busiest expert's
count) and masked tokens (location -1). Also the dense top_k == E ops and
the three forward oracles against JAX's, and TutelMoeFastDispatcher.

Tolerances: float32, max |port - jax| <= 1e-6 * max |jax| (sums of at
most K products, and float32 dot products over M in another order);
bfloat16 data, d_data within one bfloat16 step of JAX's at every element
(the same products rounded once or, where the sum order differs, one step
apart) and bwd_gate, accumulated in float32 on both sides, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.ops import dispatch as jd
from tutel_tpu.ops.routing import RoutingResult as JRouting
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.convert import to_tensor
from tutel_tpu_torch.ops import dispatch as td
from tutel_tpu_torch.ops.routing import RoutingResult as TRouting

torch.set_num_threads(1)

S, E, M = 24, 4, 16


def _routing(k, capacity, masked, seed):
    """Both packages' RoutingResult for a random top-k routing: distinct
    experts per token, locations by the k-major cumsum, `masked` tokens
    at location -1 (taking no slot), gates in (0.1, 1)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(S)], axis=1)
    mask = np.ones(S, bool)
    mask[rng.permutation(S)[:masked]] = False
    loc = np.full((k, S), -1, np.int64)
    seen = np.zeros(E, np.int64)
    for kk in range(k):
        for s in range(S):
            if mask[s]:
                loc[kk, s] = seen[idx[kk, s]]
                seen[idx[kk, s]] += 1
    gates = rng.uniform(0.1, 1.0, (k, S)).astype(np.float32) * mask
    counts = seen.astype(np.int32)
    j = JRouting(E, jnp.asarray(idx, jnp.int32), jnp.asarray(loc, jnp.int32),
                 jnp.asarray(gates), capacity, jnp.asarray(counts))
    t = TRouting(E, torch.from_numpy(idx), torch.from_numpy(loc),
                 torch.from_numpy(gates), capacity, torch.from_numpy(counts))
    return j, t, int(seen.max())


def _close(got, ref, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-30)


def _within_one_bf16_step(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= step)


def _vjp(jfn, tfn, j, t, data, cot, dtype):
    """(JAX (out, d_data, d_gates), port (out, d_data, d_gates))."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jdata = jnp.asarray(data).astype(jdt)
    out, pull = jax.vjp(lambda d, g: jfn(d, j._replace(gates=g)), jdata,
                        j.gates)
    jcot = jnp.asarray(cot).astype(jdt)
    jdd, jdg = pull(jcot)
    tdata = torch.from_numpy(data).to(dtype).requires_grad_(True)
    tg = t.gates.clone().requires_grad_(True)
    tout = tfn(tdata, t._replace(gates=tg))
    tdd, tdg = torch.autograd.grad(tout, (tdata, tg),
                                   torch.from_numpy(cot).to(dtype))
    as_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return ((as_np(out), as_np(jdd), as_np(jdg)),
            (tout.detach().float().numpy(), tdd.float().numpy(),
             tdg.float().numpy()))


CASES = [  # (top_k, capacity below / at the busiest count, masked tokens)
    (1, "drop", 0), (1, "fit", 3), (2, "drop", 3), (2, "fit", 0),
    (2, "drop", 0)]


def _case(k, cap, masked, seed):
    j, t, busiest = _routing(k, 1, masked, seed)
    c = max(1, busiest - 2) if cap == "drop" else busiest
    return j._replace(capacity=c), t._replace(capacity=c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("postscore", [True, False])
@pytest.mark.parametrize("k,cap,masked", CASES)
@pytest.mark.parametrize("op", ["encode", "decode"])
def test_dispatch_grads_match_jax(op, k, cap, masked, postscore, dtype):
    seed = 10 * k + masked + (cap == "drop")
    j, t = _case(k, cap, masked, seed)
    rng = np.random.default_rng(seed + 100)
    if op == "encode":
        data = rng.standard_normal((S, M)).astype(np.float32)
        cot = rng.standard_normal((E, j.capacity, M)).astype(np.float32)
        jfn = lambda d, c: jd.fast_encode(d, c, postscore)  # noqa: E731
        tfn = lambda d, c: td.fast_encode(d, c, postscore)  # noqa: E731
    else:
        data = rng.standard_normal((E, j.capacity, M)).astype(np.float32)
        cot = rng.standard_normal((S, M)).astype(np.float32)
        jfn = lambda d, c: jd.fast_decode(d, c, postscore)  # noqa: E731
        tfn = lambda d, c: td.fast_decode(d, c, postscore)  # noqa: E731
    (jo, jdd, jdg), (to, tdd, tdg) = _vjp(jfn, tfn, j, t, data, cot, dtype)
    gates_applied = postscore == (op == "decode")
    if dtype == torch.float32:
        _close(to, jo, 1e-6)
        _close(tdd, jdd, 1e-6)
    else:
        _within_one_bf16_step(to, jo)
        _within_one_bf16_step(tdd, jdd)
    if gates_applied:
        _close(tdg, jdg, 1e-6 if dtype == torch.float32 else 1e-5)
    else:
        assert not np.any(tdg) and not np.any(jdg)


def test_backward_is_gathers_only(monkeypatch):
    """The backward passes never scatter-add: index_add_ / index_add /
    scatter_add raise if called during them."""
    j, t = _case(2, "drop", 3, 7)
    data = torch.randn(S, M, requires_grad=True)
    gates = t.gates.clone().requires_grad_(True)
    crit = t._replace(gates=gates)
    y = td.fast_encode(data, crit, False)
    out = td.fast_decode(y * 2.0, crit, True)

    def refuse(*_, **__):
        raise AssertionError("scatter-add in the dispatch backward")
    for name in ("index_add_", "index_add", "scatter_add_", "scatter_add"):
        monkeypatch.setattr(torch.Tensor, name, refuse, raising=False)
    monkeypatch.setattr(torch, "index_add", refuse)
    monkeypatch.setattr(torch, "scatter_add", refuse)
    out.sum().backward()
    assert data.grad is not None and gates.grad is not None


def test_forward_without_grad_is_unchanged():
    """With and without autograd the forward gives the same bits."""
    j, t = _case(2, "drop", 3, 11)
    data = torch.randn(S, M)
    for ps in (True, False):
        a = td.fast_encode(data, t, ps)
        b = td.fast_encode(data.clone().requires_grad_(True), t, ps)
        assert torch.equal(a, b.detach())
        ya = torch.randn(E, t.capacity, M)
        c = td.fast_decode(ya, t, ps)
        d = td.fast_decode(ya.clone().requires_grad_(True), t, ps)
        assert torch.equal(c, d.detach())


@pytest.mark.parametrize("postscore", [True, False])
def test_dense_ops_match_jax(postscore):
    j, t = _case(E, "fit", 2, 21)              # top_k == E, capacity S
    j = j._replace(capacity=S)
    t = t._replace(capacity=S)
    _close(td.dense_gates(t).numpy(), jd.dense_gates(j), 1e-7)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((S, M)).astype(np.float32)
    w = rng.standard_normal((E, M, M)).astype(np.float32)
    cot = rng.standard_normal((S, M)).astype(np.float32)

    def jf(xx, g):
        c = j._replace(gates=g)
        return jd.dense_decode(jnp.einsum("esm,emn->esn", jd.dense_encode(
            xx, c, postscore), jnp.asarray(w)), c, postscore)
    out, pull = jax.vjp(jf, jnp.asarray(x), j.gates)
    jdx, jdg = pull(jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = t.gates.clone().requires_grad_(True)
    c = t._replace(gates=tg)
    tout = td.dense_decode(torch.bmm(td.dense_encode(tx, c, postscore),
                                     torch.from_numpy(w)), c, postscore)
    tdx, tdg = torch.autograd.grad(tout, (tx, tg), torch.from_numpy(cot))
    _close(tout.detach().numpy(), out, 1e-6)
    _close(tdx.numpy(), jdx, 1e-6)
    _close(tdg.numpy(), jdg, 1e-6)
    # the dense path gives the sparse path's values
    sparse = td.fast_decode(torch.bmm(td.fast_encode(
        torch.from_numpy(x), t, postscore), torch.from_numpy(w)), t,
        postscore)
    _close(tout.detach().numpy(), sparse.numpy(), 1e-6)


@pytest.mark.parametrize("postscore", [True, False])
def test_dense_encode_gives_contiguous_rows(postscore):
    """The quantized experts' kernels take only contiguous buffers, so the
    dense encode hands them one, equal to JAX's broadcast."""
    j, t = _case(E, "fit", 2, 23)
    j, t = j._replace(capacity=S), t._replace(capacity=S)
    x = np.random.default_rng(6).standard_normal((S, M)).astype(np.float32)
    got = td.dense_encode(torch.from_numpy(x), t, postscore)
    assert got.is_contiguous() and got.shape == (E, S, M)
    _close(got.numpy(), jd.dense_encode(jnp.asarray(x), j, postscore), 1e-7)


@pytest.mark.parametrize("postscore", [True, False])
@pytest.mark.parametrize("k,cap,masked", CASES)
def test_oracles_match_jax(k, cap, masked, postscore):
    j, t = _case(k, cap, masked, 31 + k + masked)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((S, M)).astype(np.float32)
    y = rng.standard_normal((E, j.capacity, M)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for tfn, jfn, arg, jarg in (
            (td.fast_encode_scatter, jd.fast_encode_scatter, tx, x),
            (td.fast_encode_onehot, jd.fast_encode_onehot, tx, x),
            (td.fast_decode_gather, jd.fast_decode_gather, ty, y)):
        _close(tfn(arg, t, postscore).numpy(),
               jfn(jnp.asarray(jarg), j, postscore), 1e-6)
    # and the hot path equals its oracles
    assert torch.equal(td.fast_encode(tx, t, postscore),
                       td.fast_encode_scatter(tx, t, postscore))
    _close(td.fast_decode(ty, t, postscore).numpy(),
           td.fast_decode_gather(ty, t, postscore).numpy(), 1e-7)


def test_dispatcher_round_trip_and_dtype():
    """update() installs a routing; encode/decode apply it; a
    dispatch_dtype compresses the payload and decode restores the
    caller's dtype (tests/test_dispatch.py's case), with JAX's values."""
    d = tmoe.fast_dispatcher(num_global_experts=4, capacity=4, model_dim=8,
                             dispatch_dtype=torch.bfloat16)
    d.update(indices_=[[0, 1, 2, 3]], locations_=[[0, 0, 0, 0]],
             gates_=[[1.0, 1.0, 1.0, 1.0]])
    x = torch.ones(4, 8)
    enc = d.encode(x)
    assert enc.dtype == torch.bfloat16
    out = d.decode(enc)
    assert out.dtype == torch.float32 and torch.equal(out, x)

    rng = np.random.default_rng(3)
    ind = np.stack([rng.permutation(4)[:2] for _ in range(6)], 1)
    loc = np.array([[0, 0, 1, 0, 1, 1], [0, 1, 0, 2, 1, 2]])
    g = rng.uniform(0.1, 1, (2, 6)).astype(np.float32)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    jdisp = jd.TutelMoeFastDispatcher(4, 2, 8)
    tdisp = tmoe.TutelMoeFastDispatcher(4, 2, 8)
    for disp, arr in ((jdisp, jnp.asarray), (tdisp, torch.from_numpy)):
        disp.update(arr(ind), arr(loc), arr(g), is_postscore=False)
    ref = jdisp.decode(jdisp.encode(jnp.asarray(x)))
    got = tdisp.decode(tdisp.encode(to_tensor(x, "cpu")))
    _close(got.numpy(), ref, 1e-6)
    with pytest.raises(RuntimeError, match="update"):
        tmoe.fast_dispatcher(4, 2, 8).encode(torch.zeros(6, 8))
