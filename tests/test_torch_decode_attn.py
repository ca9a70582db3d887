"""Port parity: the attention twins of kernels K6 (`decode_attn`) and K7
(`prefill_attn`) in tutel_tpu_torch.ops.decode_attn against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs:
float, INT8 and INT4 caches, grouped-query attention, positions at chunk
boundaries, `attn_len` windows, fresh-row injection and a traced start.
Tolerance 1e-5 (relative to the largest output) in float32: the same
arithmetic in another summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.models import TransformerMoE as JModel
from tutel_tpu.ops import decode_attn_pallas as jattn
from tutel_tpu_torch.ops import decode_attn as tattn

torch.set_num_threads(1)
TOL = 1e-5


def _close(got, ref, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12)
    assert err <= tol, err


def _quantize(x, bits):
    """Rows [B, T, KVH, HD] -> the cache's stored form, as the model
    stores it: (values [B, T, row], scales [B, KVH, T])."""
    b, t = x.shape[:2]
    fn = JModel._kv_quantize if bits == 8 else JModel._kv_quantize4
    vals, scales = fn(jnp.asarray(x.reshape(b * t, *x.shape[2:])))
    return (np.asarray(vals).reshape(b, t, -1),
            np.asarray(scales).reshape(b, t, -1).transpose(0, 2, 1).copy())


def _cache(rng, b, t, kvh, hd, bits):
    """(k, v, k_scale, v_scale) as numpy, in the cache's stored form."""
    kf = rng.standard_normal((b, t, kvh, hd)).astype(np.float32)
    vf = rng.standard_normal((b, t, kvh, hd)).astype(np.float32)
    if bits == 0:
        return kf.reshape(b, t, -1), vf.reshape(b, t, -1), None, None
    (kq, ks), (vq, vs) = _quantize(kf, bits), _quantize(vf, bits)
    return kq, vq, ks, vs


def _both(*arrays):
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.from_numpy(np.array(a))
             for a in arrays])


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("nh,kvh", [(4, 4), (4, 2), (8, 2)])
def test_decode_attn_matches_pallas(bits, nh, kvh):
    rng = np.random.default_rng(bits + nh + kvh)
    b, t, hd = 6, 256, 32
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, t, kvh, hd, bits)
    # chunk boundaries of the Pallas kernel (wc=128) and the window edge
    pos = np.asarray([0, 15, 127, 128, 129, 199], np.int32)
    (jq, jk, jv, jks, jvs, jp), (tq, tk, tv, tks, tvs, tp) = _both(
        q, k, v, ks, vs, pos)
    ref = jattn.decode_attn(jq, jk, jv, jp, k_scale=jks, v_scale=jvs,
                            attn_len=200, wc=128, kv_bits=bits or 8,
                            interpret=True)
    got = tattn.decode_attn(tq, tk, tv, tp, k_scale=tks, v_scale=tvs,
                            attn_len=200, kv_bits=bits or 8)
    _close(got, ref)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_decode_attn_fresh_row_matches_pallas(bits):
    """k_new/v_new: position pos[b] is not read from the (stale) cache;
    the fresh row seeds the softmax."""
    rng = np.random.default_rng(10 + bits)
    b, t, nh, kvh, hd = 4, 128, 4, 2, 32
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, t, kvh, hd, bits)
    kn, vn, kns, vns = _cache(rng, b, 1, kvh, hd, bits)
    kn, vn = kn[:, 0], vn[:, 0]
    kns = None if kns is None else kns[:, :, 0].copy()
    vns = None if vns is None else vns[:, :, 0].copy()
    pos = np.asarray([0, 1, 64, 127], np.int32)
    (jq, jk, jv, jks, jvs, jp, jkn, jvn, jkns, jvns), \
        (tq, tk, tv, tks, tvs, tp, tkn, tvn, tkns, tvns) = _both(
            q, k, v, ks, vs, pos, kn, vn, kns, vns)
    ref = jattn.decode_attn(jq, jk, jv, jp, k_scale=jks, v_scale=jvs,
                            kv_bits=bits or 8, interpret=True, k_new=jkn,
                            v_new=jvn, k_new_scale=jkns, v_new_scale=jvns)
    got = tattn.decode_attn(tq, tk, tv, tp, k_scale=tks, v_scale=tvs,
                            kv_bits=bits or 8, k_new=tkn, v_new=tvn,
                            k_new_scale=tkns, v_new_scale=tvns)
    _close(got, ref)
    # the stale cache row at pos is not read: overwriting it changes nothing
    tk2 = tk.clone()
    tk2[torch.arange(b), torch.from_numpy(pos).long()] = 3
    again = tattn.decode_attn(tq, tk2, tv, tp, k_scale=tks, v_scale=tvs,
                              kv_bits=bits or 8, k_new=tkn, v_new=tvn,
                              k_new_scale=tkns, v_new_scale=tvns)
    assert torch.equal(again, got)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("start", [0, 8, 120])
def test_prefill_attn_matches_pallas(bits, start):
    rng = np.random.default_rng(20 + bits + start)
    b, tq, nh, kvh, hd, t = 2, 8, 8, 2, 128, 256
    q = rng.standard_normal((b, tq, nh, hd)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, t, kvh, hd, bits)
    window = 128 if start + tq <= 128 else 256
    (jq, jk, jv, jks, jvs), (tq_, tk, tv, tks, tvs) = _both(q, k, v, ks, vs)
    ref = jattn.prefill_attn(jq, jk, jv, start, k_scale=jks, v_scale=jvs,
                             attn_len=window, kv_bits=bits or 8, wc=128,
                             interpret=True)
    got = tattn.prefill_attn(tq_, tk, tv, start, k_scale=tks, v_scale=tvs,
                             attn_len=window, kv_bits=bits or 8)
    _close(got, ref)


def test_prefill_attn_traced_start_and_decode_agree():
    """The JAX kernel under jit with a traced start; the port takes the
    start as a plain int. A chunk of one query is a decode step."""
    rng = np.random.default_rng(30)
    b, tq, nh, kvh, hd, t = 2, 4, 4, 2, 128, 128
    q = rng.standard_normal((b, tq, nh, hd)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, t, kvh, hd, 8)
    (jq, jk, jv, jks, jvs), (tq_, tk, tv, tks, tvs) = _both(q, k, v, ks, vs)
    run = jax.jit(lambda s: jattn.prefill_attn(
        jq, jk, jv, s, k_scale=jks, v_scale=jvs, attn_len=t, wc=128,
        interpret=True))
    for start in (0, 60, 124):
        got = tattn.prefill_attn(tq_, tk, tv, start, k_scale=tks,
                                 v_scale=tvs, attn_len=t)
        _close(got, run(jnp.int32(start)))
        one = tattn.decode_attn(tq_[:, 0], tk, tv,
                                torch.full((b,), start), k_scale=tks,
                                v_scale=tvs, attn_len=t)
        _close(one, got[:, 0].numpy())


def test_bfloat16_rounds_like_the_pallas_kernels():
    """In bfloat16 the twins follow the Pallas rounding order (softmax
    weights rounded to bf16 before the combine)."""
    rng = np.random.default_rng(40)
    b, t, nh, kvh, hd = 2, 128, 4, 2, 128
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, t, kvh, hd, 8)
    pos = np.asarray([50, 127], np.int32)
    jq = jnp.asarray(q, jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    ref = jattn.decode_attn(jq, jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), k_scale=jnp.asarray(ks),
                            v_scale=jnp.asarray(vs), wc=128, interpret=True)
    got = tattn.decode_attn(tq, torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(pos), k_scale=torch.from_numpy(ks),
                            v_scale=torch.from_numpy(vs))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(ref, np.float32), tol=1e-2)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("start", [0, 120])
def test_prefill_attn_bfloat16_matches_pallas(bits, start):
    """K7's bfloat16 queries run its tensor-core kernel, whose oracle on
    the card is the bf16 twin; here that twin follows the Pallas kernel in
    bf16 (interpret mode): q and a float cache in bf16, float32 scores and
    sums, softmax weights rounded to bf16 before the combine. Tolerance
    1e-2 of max |ref|: both sides round the weights to bf16, the Pallas
    kernel against the running max of its 128-position chunks and the
    twin against the row's max, so a weight can land on the neighbouring
    bf16 value (2^-8 apart), and the output is rounded to bf16 (2^-9)."""
    rng = np.random.default_rng(60 + bits + start)
    b, tq, nh, kvh, hd, t = 2, 8, 8, 2, 128, 256
    q = rng.standard_normal((b, tq, nh, hd)).astype(np.float32)
    k, v, ks, vs = _cache(rng, b, t, kvh, hd, bits)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _both(k, v, ks, vs)
    if bits == 0:                          # a float cache is of q's type
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    ref = jattn.prefill_attn(jnp.asarray(q, jnp.bfloat16), jk, jv, start,
                             k_scale=jks, v_scale=jvs, attn_len=t,
                             kv_bits=bits or 8, wc=128, interpret=True)
    got = tattn.prefill_attn(torch.from_numpy(q).to(torch.bfloat16), tk, tv,
                             start, k_scale=tks, v_scale=tvs, attn_len=t,
                             kv_bits=bits or 8)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(ref, np.float32), tol=1e-2)


def test_unpack_int4_matches_the_model_packing():
    rng = np.random.default_rng(50)
    x = rng.standard_normal((5, 2, 64)).astype(np.float32)
    packed, scales = JModel._kv_quantize4(jnp.asarray(x))
    got = tattn.unpack_int4(torch.from_numpy(np.asarray(packed)))
    vals = np.clip(np.round(x / np.asarray(scales)[..., None]), -7, 7)
    np.testing.assert_array_equal(got.numpy(), vals.reshape(5, -1))


def test_wrappers_reject_what_they_do_not_take():
    q = torch.zeros(2, 4, 32, device="meta")
    k = torch.zeros(2, 16, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tattn.decode_attn(q, k, k, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):
        tattn.prefill_attn(torch.zeros(1, 4, 2, 32), torch.zeros(1, 16, 64),
                           torch.zeros(1, 16, 64), 14)
    with pytest.raises(ValueError, match="query heads"):
        tattn.decode_attn(torch.zeros(1, 3, 32), torch.zeros(1, 8, 64),
                          torch.zeros(1, 8, 64), torch.zeros(1))
