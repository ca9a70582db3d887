"""Port parity: the Transformer-MoE LM (tutel_tpu_torch.models) against the
JAX model on the same parameters (converted with convert.from_jax_params)
and the same token ids: the full forward, chained decode steps with the
KV cache (float, INT8 and INT4 caches, GQA, the capacity probe), and the
chunked-parallel prefill against the JAX prefill and against the port's
own loop-of-decode oracle. The JAX model runs its default CPU path.
Tolerance 1e-4 (relative to the largest logit) in float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.models import TransformerMoE as JModel
from tutel_tpu.models import TransformerMoEConfig as JConfig
from tutel_tpu.ops import quant as jquant
from tutel_tpu.ops.fused_ffn_pallas import prepare_fused_ffn_params
from tutel_tpu_torch import convert
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.ops import decode_attn as tattn
from tutel_tpu_torch.ops import fused_ffn, quant

torch.set_num_threads(1)
TOL = 1e-4
SMALL = dict(vocab_size=61, max_len=48, model_dim=32, num_heads=4,
             num_layers=2, ffn_hidden=64, moe_every=2, num_local_experts=4,
             top_k=2, expert_hidden=64, capacity_factor=8.0)


def _models(**kw):
    cfg = dict(SMALL, **kw)
    jm = JModel(JConfig(**cfg), group=jax.devices()[:1])
    tm = TransformerMoE(TransformerMoEConfig(**cfg), device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, convert.from_jax_params(jp, "cpu")


def _close(got, ref, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12)
    assert err <= tol, err


def _cache_close(got, ref, kv_bits):
    """Caches agree: float entries and scales within TOL; stored integers
    within one rounding step (the same values quantized from inputs that
    differ in the last float bits may round the other way)."""
    got = torch.as_tensor(np.array(got))
    ref = torch.as_tensor(np.array(ref))
    if got.dtype != torch.int8:
        return _close(got, ref.numpy())
    if kv_bits == 4:
        got, ref = tattn.unpack_int4(got), tattn.unpack_int4(ref)
    assert int((got.int() - ref.int()).abs().max()) <= 1


def _tokens(shape, seed=1, vocab=61):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("kvh", [0, 2])
def test_apply_matches_jax(kvh):
    jm, tm, jp, tp = _models(num_kv_heads=kvh)
    toks = _tokens((2, 16))
    ref, ref_aux = jm.apply(jp, jnp.asarray(toks))
    got, aux = tm.apply(tp, torch.from_numpy(toks))
    _close(got, ref)
    _close(aux, ref_aux)


@pytest.mark.parametrize("kv_bits,kvh", [(0, 0), (8, 2), (4, 2), (8, 4)])
def test_decode_chain_matches_jax(kv_bits, kvh):
    """Chained apply_decode steps (fresh-row injection and one batched
    cache write per step in the port; write-then-read in the JAX model's
    CPU path) give the same logits, the same capacity probe and the same
    cache."""
    jm, tm, jp, tp = _models(kv_bits=kv_bits, num_kv_heads=kvh)
    b, t = 3, 10
    toks = _tokens((b, t), seed=2)
    jc, tc = jm.init_cache(b), tm.init_cache(b)
    ov = {"capacity_factor": 0.0}
    for i in range(t):
        pos = np.full((b,), i, np.int32)
        pos[0] = min(i + 3, t)              # rows at different positions
        lg, jc, _, need = jm.apply_decode(jp, jnp.asarray(toks[:, i]), jc,
                                          jnp.asarray(pos), moe_overrides=ov,
                                          capacity_probe=True, attn_len=16)
        got, tc, _, tneed = tm.apply_decode(
            tp, torch.from_numpy(toks[:, i]), tc, torch.from_numpy(pos),
            moe_overrides=ov, capacity_probe=True, attn_len=16)
        _close(got, lg)
        assert int(tneed) == int(need)
    for jl, tl in zip(jc, tc):
        for key in jl:
            _cache_close(tl[key], jl[key], kv_bits)


def test_decode_matches_full_apply():
    """Chained decode reproduces the port's own full forward."""
    _, tm, _, tp = _models(num_kv_heads=2)
    toks = torch.from_numpy(_tokens((2, 12), seed=3))
    full, _ = tm.apply(tp, toks)
    cache = tm.init_cache(2)
    for i in range(12):
        lg, cache, _ = tm.apply_decode(tp, toks[:, i], cache,
                                       torch.full((2,), i))
        _close(lg, full[:, i].numpy())


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_parallel_prefill_matches_jax_and_the_loop(kv_bits):
    """Chunked-parallel prefill (a chunk size that does not divide the
    prompt, so a padded tail, and per-row prompt_lens) against the JAX
    parallel prefill, and against the port's loop-of-decode oracle."""
    jm, tm, jp, tp = _models(kv_bits=kv_bits, num_kv_heads=2)
    b, tp_len = 2, 11
    prompts = _tokens((b, tp_len), seed=4)
    ov = {"capacity_factor": 8.0}
    lj, cj = jm._prefill_parallel(jp, jnp.asarray(prompts),
                                  jm.init_cache(b), jax.random.PRNGKey(0), ov,
                                  tc=4)
    lt, ct = tm._prefill_parallel(tp, torch.from_numpy(prompts).long(),
                                  tm.init_cache(b), ov, tc=4)
    _close(lt, lj)
    ls, cs = tm.prefill(tp, torch.from_numpy(prompts), tm.init_cache(b),
                        moe_overrides=ov, parallel=False)
    _close(lt, ls.numpy())
    for a, c, j in zip(cs, ct, cj):
        for key in a:
            sl = (slice(None), slice(None, tp_len)) if key in ("k", "v") \
                else (slice(None), slice(None), slice(None, tp_len))
            _cache_close(c[key][sl], a[key][sl], kv_bits)
            _cache_close(c[key][sl], j[key][sl], kv_bits)
    # per-row lengths inside a padded bucket
    lens = np.asarray([7, 11], np.int32)
    lj2, _ = jm.prefill(jp, jnp.asarray(prompts), jm.init_cache(b),
                        prompt_lens=jnp.asarray(lens))
    lt2, _ = tm.prefill(tp, torch.from_numpy(prompts), tm.init_cache(b),
                        prompt_lens=torch.from_numpy(lens))
    _close(lt2, lj2)


def test_prefill_windows_span_segments():
    """A prompt of 5 chunks of 128 runs in 4 segments with growing
    windows; the result equals the same prefill in one chunk per 8."""
    cfg = dict(SMALL, max_len=768, vocab_size=61, kv_bits=8, num_kv_heads=2)
    tm = TransformerMoE(TransformerMoEConfig(**cfg), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(_tokens((1, 600), seed=5))
    ov = {"capacity_factor": 8.0}
    big, cb = tm.prefill(tp, prompts, tm.init_cache(1), moe_overrides=ov)
    small, cs = tm._prefill_parallel(tp, prompts.long(), tm.init_cache(1),
                                     ov, tc=8)
    _close(big, small.numpy())
    for a, c in zip(cb, cs):
        for key in a:
            _cache_close(a[key][..., :600] if key.endswith("_s")
                         else a[key][:, :600],
                         c[key][..., :600] if key.endswith("_s")
                         else c[key][:, :600], 8)


def test_kv_quantizers_match_jax():
    """The cache's stored form: INT8 and INT4 quantizers and the INT4
    window dequantizer against the JAX model's, exactly."""
    x = np.random.default_rng(7).standard_normal((6, 2, 32)).astype(
        np.float32)
    for bits in (8, 4):
        jfn = JModel._kv_quantize if bits == 8 else JModel._kv_quantize4
        tfn = (TransformerMoE._kv_quantize if bits == 8
               else TransformerMoE._kv_quantize4)
        (jq, js), (tq, ts) = jfn(jnp.asarray(x)), tfn(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    packed = np.asarray(jq).reshape(2, 3, -1)
    scales = np.asarray(js).reshape(2, 3, 2).transpose(0, 2, 1).copy()
    ref = JModel._kv_dequant4(jnp.asarray(packed), jnp.asarray(scales), 2,
                              32, 2)
    got = TransformerMoE._kv_dequant4(torch.from_numpy(packed),
                                      torch.from_numpy(scales), 2, 32, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int4_experts_decode_matches_jax():
    """INT4 experts with the fused stream (kernel K2's twin) inside the
    decode step."""
    jm, tm, jp, _ = _models(model_dim=64, expert_hidden=128, kv_bits=8,
                            num_kv_heads=2)
    blocks = []
    for blk in jp["blocks"]:
        if "moe" in blk:
            blk = dict(blk)
            ex = jquant.quantize_expert_params(blk["moe"]["experts"], bits=4)
            blk["moe"] = {**blk["moe"], "experts": prepare_fused_ffn_params(ex)}
        blocks.append(blk)
    jp = {**jp, "blocks": blocks}
    tp = convert.from_jax_params(jp, "cpu")
    assert isinstance(tp["blocks"][1]["moe"]["experts"]["fused_stream"],
                      fused_ffn.FusedFFNStream)
    b = 2
    toks = _tokens((b, 4), seed=6, vocab=61)
    jc, tc = jm.init_cache(b), tm.init_cache(b)
    ov = {"capacity_factor": 0.0}
    for i in range(4):
        pos = jnp.full((b,), i, jnp.int32)
        lg, jc, _ = jm.apply_decode(jp, jnp.asarray(toks[:, i]), jc, pos,
                                    moe_overrides=ov)
        got, tc, _ = tm.apply_decode(tp, torch.from_numpy(toks[:, i]), tc,
                                     torch.full((b,), i), moe_overrides=ov)
        _close(got, lg)


def test_convert_carries_a_whole_model_tree():
    """convert.from_jax_params maps the JAX model's tree, with its blocks
    list and each MoE block's QuantizedWeight and FusedFFNStream, to the
    port's tree: same structure, same arrays."""
    jm, _, jp, _ = _models(model_dim=64, expert_hidden=128)
    blk = dict(jp["blocks"][1])
    ex = jquant.quantize_expert_params(blk["moe"]["experts"], bits=4)
    blk["moe"] = {**blk["moe"], "experts": prepare_fused_ffn_params(ex)}
    jp = {**jp, "blocks": [jp["blocks"][0], blk]}
    tp = convert.from_jax_params(jp, "cpu")
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    assert set(tp["blocks"][0]) == {"ln1", "ln2", "wqkv", "wo", "ffn"}
    tex = tp["blocks"][1]["moe"]["experts"]
    assert isinstance(tex["fc1_w"], quant.QuantizedWeight)
    assert tex["fc1_w"].bits == 4
    assert isinstance(tex["fused_stream"], fused_ffn.FusedFFNStream)
    np.testing.assert_array_equal(tex["fused_stream"].wstream.numpy(),
                                  np.asarray(blk["moe"]["experts"]["fused_stream"].wstream))
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    np.testing.assert_array_equal(
        tp["blocks"][1]["moe"]["gates"][0]["wg"].numpy(),
        np.asarray(blk["moe"]["gates"][0]["wg"]))


def test_bfloat16_dense_ffn_matches_jax():
    """A bfloat16 model's dense FFN keeps both products in float32 through
    the bias (and the gelu) and rounds once, as the JAX model does
    (tutel_tpu/models/transformer.py:236-241). The block then differs from
    the JAX formula only where a float32 sum taken in another order rounds
    to the other bfloat16 neighbour: 1e-4 of max |reference|. Rounding the
    products to bfloat16 first misses by 5e-3. The logits of a whole bf16
    model also differ at the other bf16 rounding points of attention, so
    they are held to one bfloat16 step (2^-7) of the largest logit at
    most, and to 2e-3 in the mean relative to the mean |logit| (about
    5.5e-3 with the products rounded first)."""
    cfg = dict(SMALL, model_dim=64, ffn_hidden=256)
    jm = JModel(JConfig(**cfg, dtype=jnp.bfloat16), group=jax.devices()[:1])
    tm = TransformerMoE(TransformerMoEConfig(**cfg, dtype=torch.bfloat16),
                        device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    f = {k: jnp.asarray(rng.standard_normal(np.shape(v))
                        * (0.1 if k[0] == "b" else 0.2), jnp.bfloat16)
         for k, v in jp["blocks"][0]["ffn"].items()}
    h = jnp.asarray(rng.standard_normal((2, 16, 64)), jnp.bfloat16)
    hdn = jnp.einsum("btd,dh->bth", h, f["w1"],
                     preferred_element_type=jnp.float32)
    hdn = jax.nn.gelu(hdn + f["b1"]).astype(jnp.bfloat16)
    o = jnp.einsum("bth,hd->btd", hdn, f["w2"],
                   preferred_element_type=jnp.float32)
    ref = (o + f["b2"]).astype(jnp.bfloat16)
    got = tm._ffn(convert.from_jax_params(f, "cpu"),
                  convert.to_tensor(h, "cpu"))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(ref, np.float32))
    toks = _tokens((2, 16))
    lj, _ = jm.apply(jp, jnp.asarray(toks))
    lt, _ = tm.apply(convert.from_jax_params(jp, "cpu"),
                     torch.from_numpy(toks))
    lj, lt = np.asarray(lj, np.float64), lt.double().numpy()
    _close(lt, lj, tol=2.0 ** -7)
    assert np.mean(np.abs(lt - lj)) <= 2e-3 * np.mean(np.abs(lj))


def test_bfloat16_model_runs_and_rejects_bad_configs():
    cfg = TransformerMoEConfig(**dict(SMALL, dtype=torch.bfloat16,
                                      kv_bits=8))
    tm = TransformerMoE(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    lg, cache = tm.prefill(tp, torch.from_numpy(_tokens((1, 5))),
                           tm.init_cache(1))
    assert lg.dtype == torch.bfloat16 and torch.isfinite(lg.float()).all()
    lg, cache, _ = tm.apply_decode(tp, lg.argmax(-1), cache,
                                   torch.full((1,), 5))
    assert lg.shape == (1, 61) and torch.isfinite(lg.float()).all()
    with pytest.raises(ValueError, match="kv_bits"):
        TransformerMoE(dataclasses.replace(cfg, kv_bits=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TransformerMoE(cfg)
