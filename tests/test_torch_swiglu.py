"""Port parity for the SwiGLU (Llama/Mixtral-style) expert: the fused
stream's preparation, the plain twin of the CUDA kernel K4
(`fused_swiglu_quant`) against the JAX package's Pallas kernel in
interpret mode, `LlamaFFNNetwork` (float, three-call quantized and fused),
a `TransformerMoE(expert_type="llama_ffn")` and its serving engine, each
against the JAX package on the same numpy inputs.

Tolerances, relative to max |reference| over live rows: 1e-5 for the
kernel twin and the expert in float32 (the products are summed in another
order); 1e-4 for model logits, as for the two-layer experts; greedy tokens
identical. In bfloat16 the hidden is rounded twice; the twin then holds to
2e-2, the bound the kernels are held to in bfloat16, since one hidden value
rounded the other way moves the output by up to a bfloat16 step.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.experts import llama_ffn as jllama
from tutel_tpu.models import TransformerMoE as JModel
from tutel_tpu.models import TransformerMoEConfig as JConfig
from tutel_tpu.ops import fused_ffn_pallas as jfp
from tutel_tpu.ops import quant as jq
from tutel_tpu.serving import LmDecodeEngine as JEngine
from tutel_tpu.serving import LmRequest as JRequest
from tutel_tpu_torch import convert
from tutel_tpu_torch.experts import llama_ffn as tllama
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.ops import fused_ffn, grouped_gemm_quant, quant
from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest

torch.set_num_threads(1)


def _live_err(got, ref, counts):
    """max |got - ref| / max |ref| over rows < counts[e]."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    live = np.arange(ref.shape[1])[None, :, None] < counts[:, None, None]
    scale = np.max(np.abs(np.where(live, ref, 0)))
    assert scale > 0
    return np.max(np.where(live, np.abs(got - ref), 0)) / scale


def _weights(seed, bits, e, k, h, n):
    rng = np.random.default_rng(seed)
    return [jq.quantize(jnp.asarray(
        rng.standard_normal(s).astype(np.float32) * 0.05), bits)
        for s in ((e, k, h), (e, k, h), (e, h, n))]


@pytest.mark.parametrize("bits,shape,bw", [
    (4, (2, 256, 512, 384), None), (8, (3, 256, 256, 256), None),
    (4, (2, 128, 256, 192), 128)])
def test_prepare_fused_swiglu_is_byte_identical_to_jax(bits, shape, bw):
    """Both packages pick the same tile width and lay the stream out byte
    for byte; a JAX stream converts through convert.from_jax_params."""
    e, k, h, n = shape
    jw = _weights(bits + k, bits, e, k, h, n)
    jst = jfp.prepare_fused_swiglu(*jw, bw=bw)
    tw = convert.from_jax_params(jw, "cpu")
    st = fused_ffn.prepare_fused_swiglu(*tw, bw=bw)
    conv = convert.from_jax_params(jst, "cpu")
    for got in (st, conv):
        assert isinstance(got, fused_ffn.FusedFFNStream)
        for f in ("bits", "k", "h", "n", "t1", "t2", "bw", "kr"):
            assert getattr(got, f) == getattr(jst, f), f
        np.testing.assert_array_equal(got.wstream.numpy(),
                                      np.asarray(jst.wstream))
        np.testing.assert_array_equal(got.sb.numpy(), np.asarray(jst.sb))
    # the dispatch of prepare_fused_ffn_params on w1/w3
    p = fused_ffn.prepare_fused_ffn_params(dict(zip(("w1", "w2", "w3"), tw)),
                                           bw=bw)
    np.testing.assert_array_equal(p["fused_stream"].wstream.numpy(),
                                  np.asarray(jst.wstream))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(3, 16, 256, 256, 256),
                                   (2, 8, 256, 512, 384)])
def test_fused_swiglu_twin_matches_pallas(bits, shape):
    """The two shapes of the JAX package's test_fused_swiglu (N != H in
    the second), with row counts and an empty expert."""
    e, c, k, h, n = shape
    rng = np.random.default_rng(bits + e)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    jst = jfp.prepare_fused_swiglu(*_weights(bits * e, bits, e, k, h, n),
                                   bw=128)
    counts = rng.integers(1, c + 1, e).astype(np.int32)
    counts[0] = 0
    ref = jfp.fused_swiglu_quant(jnp.asarray(x), jst, jnp.asarray(counts),
                                 interpret=True)
    got = fused_ffn.fused_swiglu_quant(torch.from_numpy(x),
                                       convert.from_jax_params(jst, "cpu"),
                                       torch.from_numpy(counts))
    assert _live_err(got.numpy(), ref, counts) <= 1e-5
    dead = np.arange(c)[None, :, None] >= counts[:, None, None]
    assert not np.any(np.where(dead, got.numpy(), 0))


def test_fused_swiglu_twin_matches_pallas_bfloat16():
    e, c, k, h, n = 2, 16, 256, 512, 384
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((e, c, k)), jnp.bfloat16)
    jst = jfp.prepare_fused_swiglu(*_weights(9, 4, e, k, h, n), bw=128)
    counts = np.array([16, 11], np.int32)
    ref = jfp.fused_swiglu_quant(x, jst, jnp.asarray(counts), interpret=True)
    got = fused_ffn.fused_swiglu_quant(convert.to_tensor(x, "cpu"),
                                       convert.from_jax_params(jst, "cpu"),
                                       torch.from_numpy(counts))
    assert got.dtype == torch.bfloat16
    assert _live_err(got.float().numpy(), np.asarray(ref, np.float32),
                     counts) <= 2e-2


def _nets(e=3, m=64, h=128):
    kw = dict(model_dim=m, hidden_size_per_expert=h, num_experts_per_device=e)
    return jllama.LlamaFFNNetwork(**kw), tllama.LlamaFFNNetwork(**kw)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_llama_ffn_float_matches_jax(dtype):
    jnet, tnet = _nets()
    jp = jnet.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.default_rng(4).standard_normal((3, 5, 64)),
                    dtype)
    ref = jnet.apply(jp, x)
    got = tnet.apply(convert.from_jax_params(jp, "cpu"),
                     convert.to_tensor(x, "cpu"))
    assert got.dtype == convert.to_tensor(ref, "cpu").dtype
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    assert _live_err(got.float().numpy(), np.asarray(ref, np.float32),
                     np.full(3, 5)) <= tol
    tp = tnet.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert 0.009 < float(torch.cat([v.flatten() for v in tp.values()]).std()) \
        < 0.011                                    # N(0, 0.01^2)
    # expert slicing: the global weights still (the layer slices them;
    # tests/test_torch_quant_tp.py)
    sliced = tllama.LlamaFFNNetwork(model_dim=64, hidden_size_per_expert=128,
                                    num_experts_per_device=3, sharded_count=2)
    assert {k: tuple(v.shape) for k, v in sliced.init(
        torch.Generator().manual_seed(0), device="cpu").items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


@pytest.mark.parametrize("bits,fused", [(4, True), (4, False), (8, True)])
def test_llama_ffn_quantized_matches_jax(bits, fused):
    """Weight-only INT4/INT8: the fused stream (K4's twin) or three K1
    calls, narrowed to ctx.dispatch_count rows per expert."""
    jnet, tnet = _nets(e=2, m=256, h=512)
    jp = jq.quantize_expert_params(jnet.init(jax.random.PRNGKey(1)), bits=bits)
    if fused:
        jp = jfp.prepare_fused_ffn_params(jp)
        assert "fused_stream" in jp
    tp = convert.from_jax_params(jp, "cpu")
    counts = np.array([9, 16], np.int32)
    x = np.random.default_rng(13).standard_normal((2, 16, 256)).astype(
        np.float32)
    ref = jnet.apply(jp, jnp.asarray(x),
                     SimpleNamespace(dispatch_count=jnp.asarray(counts)))
    before = (fused_ffn.fused_swiglu_quant.launches,
              grouped_gemm_quant.grouped_gemm_quant.launches)
    got = tnet.apply(tp, torch.from_numpy(x),
                     SimpleNamespace(dispatch_count=torch.from_numpy(counts)))
    assert _live_err(got.numpy(), ref, counts) <= 1e-5
    assert (fused_ffn.fused_swiglu_quant.launches,
            grouped_gemm_quant.grouped_gemm_quant.launches) == before


SMALL = dict(vocab_size=61, max_len=48, model_dim=64, num_heads=4,
             num_kv_heads=2, num_layers=2, ffn_hidden=128, moe_every=2,
             num_local_experts=4, top_k=2, expert_hidden=128,
             capacity_factor=8.0, expert_type="llama_ffn")


def _models(bits=0, **kw):
    cfg = dict(SMALL, **kw)
    jm = JModel(JConfig(**cfg), group=jax.devices()[:1])
    tm = TransformerMoE(TransformerMoEConfig(**cfg), device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    if bits:
        jp = {**jp, "blocks": [
            {**b, "moe": {**b["moe"], "experts": jfp.prepare_fused_ffn_params(
                jq.quantize_expert_params(b["moe"]["experts"], bits=bits))}}
            if "moe" in b else b for b in jp["blocks"]]}
    return jm, tm, jp, convert.from_jax_params(jp, "cpu")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("bits", [0, 4])
def test_llama_transformer_apply_and_decode_match_jax(bits):
    """`apply` logits and a chain of `apply_decode` steps (INT8 KV cache,
    GQA) of a SwiGLU-expert LM, float experts or INT4 with the fused
    stream."""
    jm, tm, jp, tp = _models(bits, kv_bits=8)
    experts = tp["blocks"][1]["moe"]["experts"]
    assert set(experts) == ({"w1", "w2", "w3", "fused_stream"} if bits
                            else {"w1", "w2", "w3"})
    toks = np.random.default_rng(1).integers(0, 61, (2, 12)).astype(np.int32)
    ref, _ = jm.apply(jp, jnp.asarray(toks))
    got, _ = tm.apply(tp, torch.from_numpy(toks))
    assert _rel(got.numpy(), ref) <= 1e-4
    jc, tc = jm.init_cache(2), tm.init_cache(2)
    ov = {"capacity_factor": 0.0}
    for i in range(5):
        pos = np.full((2,), i, np.int32)
        lg, jc, _ = jm.apply_decode(jp, jnp.asarray(toks[:, i]), jc,
                                    jnp.asarray(pos), moe_overrides=ov)
        got, tc, _ = tm.apply_decode(tp, torch.from_numpy(toks[:, i]), tc,
                                     torch.from_numpy(pos), moe_overrides=ov)
        assert _rel(got.numpy(), lg) <= 1e-4


def test_swiglu_lm_engine_greedy_tokens_match_jax():
    """Continuous batching over a SwiGLU LM with INT4 experts: the engine
    attaches the SwiGLU stream to every MoE block (auto_fuse), and its
    greedy tokens equal the JAX engine's at float32."""
    jm, tm, _, _ = _models()
    jp = jm.init(jax.random.PRNGKey(0))
    jp = {**jp, "blocks": [
        {**b, "moe": {**b["moe"], "experts": jq.quantize_expert_params(
            b["moe"]["experts"], bits=4)}} if "moe" in b else b
        for b in jp["blocks"]]}
    tp = convert.from_jax_params(jp, "cpu")
    prompts = [np.random.default_rng(i).integers(0, 61, 3 + i % 3).astype(
        np.int32) for i in range(6)]
    kw = dict(max_batch=3, moe_overrides={"capacity_factor": 8.0})
    jeng = JEngine(jm, jp, **kw)
    teng = LmDecodeEngine(tm, tp, **kw)
    for i in tm.moe_layers:
        st = teng.params["blocks"][i]["moe"]["experts"]["fused_stream"]
        assert st.t1 * st.bw == SMALL["expert_hidden"]
    ref = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=2 + i % 3)
                    for i, p in enumerate(prompts)], chunk=2)
    got = teng.run([LmRequest(uid=i, prompt=p, max_new_tokens=2 + i % 3)
                    for i, p in enumerate(prompts)], chunk=2)
    assert {u: t.tolist() for u, t in got.items()} == \
        {u: t.tolist() for u, t in ref.items()}


def test_quantize_expert_params_covers_the_swiglu_weights():
    _, tnet = _nets()
    tp = tnet.init(torch.Generator().manual_seed(0), device="cpu")
    qp = quant.quantize_expert_params(tp, bits=4)
    assert all(isinstance(qp[k], quant.QuantizedWeight)
               for k in ("w1", "w2", "w3"))
    st = fused_ffn.prepare_fused_ffn_params(qp)["fused_stream"]
    assert (st.t1, st.t2, st.kr) == (1, 1, 64)
