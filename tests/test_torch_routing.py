"""Port parity: aux losses, routing (extract_critical and the capacity
math) and dispatch (fast_encode / fast_decode) of tutel_tpu_torch against
the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.ops import dispatch as jd
from tutel_tpu.ops import losses as jl
from tutel_tpu.ops import routing as jr
from tutel_tpu_torch.ops import dispatch as td
from tutel_tpu_torch.ops import losses as tl
from tutel_tpu_torch.ops import routing as tr

torch.set_num_threads(1)


def _scores(seed, s, e):
    """Tie-free softmax scores (torch.topk and lax.top_k may order ties
    differently)."""
    logits = np.random.default_rng(seed).standard_normal((s, e)) * 2.0
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.max(np.abs(ref)), 1e-12)
    assert np.max(np.abs(got - ref)) / scale <= tol


def test_losses_match_jax():
    sc = _scores(0, 24, 6)
    top = np.argsort(-sc, axis=1)[:, :2]
    _close(tl.gshard_loss(torch.from_numpy(sc), torch.from_numpy(top)),
           jl.gshard_loss(jnp.asarray(sc), jnp.asarray(top)))
    logits = np.random.default_rng(1).standard_normal((24, 6)).astype(
        np.float32)
    topl = np.take_along_axis(logits, top, axis=1)
    _close(tl.load_importance_loss(torch.from_numpy(sc),
                                   torch.from_numpy(topl), 6, 1.0),
           jl.load_importance_loss(jnp.asarray(sc), jnp.asarray(topl), 6,
                                   1.0))
    with pytest.raises(ValueError):
        tl.load_importance_loss(torch.from_numpy(sc), torch.from_numpy(topl),
                                6, 0.0)


def _route_both(sc, top_k, capacity, mask=None, **kw):
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    got, gl = tr.extract_critical(torch.from_numpy(sc), top_k, capacity,
                                  token_mask=tm, **kw)
    ref, rl = jr.extract_critical(jnp.asarray(sc), top_k, capacity,
                                  token_mask=jm, **kw)
    return got, gl, ref, rl


@pytest.mark.parametrize("top_k,capacity,bpr,normalize,masked", [
    (1, 4, False, True, False),
    (2, 3, True, True, True),       # drops, batch-prioritized, padding
    (2, 16, False, False, True),
    (3, 2, True, True, False),
])
def test_extract_critical_matches_jax(top_k, capacity, bpr, normalize,
                                      masked):
    s, e = 20, 5
    sc = _scores(top_k * 7 + capacity, s, e)
    mask = (np.arange(s) < 13) if masked else None
    got, gl, ref, rl = _route_both(sc, top_k, capacity, mask,
                                   batch_prioritized_routing=bpr,
                                   normalize_gate=normalize)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.locations.numpy(),
                                  np.asarray(ref.locations))
    np.testing.assert_array_equal(got.dispatch_count.numpy(),
                                  np.asarray(ref.dispatch_count))
    _close(got.gates.numpy(), ref.gates)
    _close(gl, rl)
    assert got.capacity == ref.capacity and got.top_k == top_k
    assert int(tr.required_capacity(got.dispatch_count)) == \
        int(jr.required_capacity(ref.dispatch_count))


def test_capacity_helpers_match_jax():
    for args in [(37, 8, 2, 1.25, 1), (256, 128, 2, 2.0, 8), (5, 4, 1, 0.5, 4)]:
        assert tr.compute_static_capacity(*args) == \
            jr.compute_static_capacity(*args)
    for args in [(37, 8, 2, -1.5), (256, 128, 2, -2.0)]:
        assert tr.capped_capacity_limit(*args) == jr.capped_capacity_limit(*args)
    assert tr.align_capacity(13, 8) == jr.align_capacity(13, 8) == 16
    with pytest.raises(ValueError):
        tr.extract_critical(torch.from_numpy(_scores(0, 4, 2)), 1, 0)


@pytest.mark.parametrize("postscore", [True, False])
def test_encode_decode_match_jax_with_drops(postscore):
    s, e, m, cap = 16, 4, 8, 3                  # capacity 3 drops tokens
    sc = _scores(11, s, e)
    mask = np.arange(s) < 12
    got, _, ref, _ = _route_both(sc, 2, cap, mask)
    assert int(np.asarray(ref.dispatch_count).max()) > cap
    x = np.random.default_rng(12).standard_normal((s, m)).astype(np.float32)
    enc = td.fast_encode(torch.from_numpy(x), got, postscore)
    jenc = jd.fast_encode(jnp.asarray(x), ref, postscore)
    _close(enc.numpy(), jenc)
    y = np.random.default_rng(13).standard_normal((e, cap, m)).astype(
        np.float32)
    _close(td.fast_decode(torch.from_numpy(y), got, postscore).numpy(),
           jd.fast_decode(jnp.asarray(y), ref, postscore))
    with pytest.raises(ValueError):
        td.fast_decode(torch.zeros(e, cap + 1, m), got)


def _one_hot_locations(indices, e, mask=None, order=None):
    """The old interface's formula, written out: the exclusive cumsum over
    the k-major [K*S, E] one-hot, in the order's ranking within every k;
    masked tokens take no slot and get -1."""
    k, s = indices.shape
    flat = (indices.reshape(-1)[:, None] == np.arange(e)).astype(np.int64)
    if mask is not None:
        flat *= np.tile(mask, k)[:, None]
    perm = np.arange(k * s) if order is None else \
        (order[None, :] + (np.arange(k) * s)[:, None]).reshape(-1)
    csum = np.empty_like(flat)
    csum[perm] = np.cumsum(flat[perm], axis=0) - 1
    loc = np.sum(csum * flat, axis=1).reshape(k, s)
    if mask is not None:
        loc = np.where(mask[None, :], loc, -1)
    return loc, flat.sum(axis=0).astype(np.int32)


@pytest.mark.parametrize("k,s,e", [(1, 7, 3), (2, 20, 5), (3, 33, 6),
                                   (8, 64, 64), (2, 50, 1)])
@pytest.mark.parametrize("masked,ordered", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_compute_locations_matches_one_hot_and_jax(k, s, e, masked,
                                                   ordered):
    rng = np.random.default_rng(k * 100 + s + e)
    # top-k ids: k distinct experts a token (e >= k), or repeats (e < k)
    ids = np.stack([rng.permutation(e)[:k] if e >= k else
                    rng.integers(0, e, k) for _ in range(s)], axis=1)
    mask = rng.random(s) < 0.7 if masked else None
    order = rng.permutation(s) if ordered else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    # a transposed view, as extract_critical hands the sort's ids on
    ids_t = torch.from_numpy(np.ascontiguousarray(ids.T)).t()
    loc, counts = tr.compute_locations(ids_t, e, t(mask), t(order))
    assert loc.dtype == torch.int64 and counts.dtype == torch.int32
    want_loc, want_counts = _one_hot_locations(ids, e, mask, order)
    np.testing.assert_array_equal(loc.numpy(), want_loc)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    onehot = (ids[:, :, None] == np.arange(e)).astype(np.int32)
    if masked:
        onehot *= mask[None, :, None].astype(np.int32)
    jloc, jcounts = jr.compute_locations(
        jnp.asarray(onehot), None if order is None else jnp.asarray(order))
    jloc = np.asarray(jloc)
    if masked:
        jloc = np.where(mask[None, :], jloc, -1)
    np.testing.assert_array_equal(loc.numpy(), jloc)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert tr.scan_tiles(ids_t) == 0
