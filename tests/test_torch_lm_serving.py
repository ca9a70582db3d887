"""Port parity: the LM serving engine (tutel_tpu_torch.serving.LmDecodeEngine)
against the JAX engine on the same parameters and prompts. Greedy tokens
must be identical: continuous batching with more requests than slots, a
quantized KV cache with GQA and INT4 experts, stop tokens, fetch=False
chunks, speculative capacity with replay, bucketed admission. Sampled runs
are deterministic for a seed and keep every token inside the top-k /
top-p set of the model's logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.models import TransformerMoE as JModel
from tutel_tpu.models import TransformerMoEConfig as JConfig
from tutel_tpu.ops import quant as jquant
from tutel_tpu.serving import LmDecodeEngine as JEngine
from tutel_tpu.serving import LmRequest as JRequest
from tutel_tpu_torch import convert
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.ops import decode_attn, fused_ffn, kv_write
from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest

torch.set_num_threads(1)
SMALL = dict(vocab_size=61, max_len=48, model_dim=32, num_heads=2,
             num_layers=2, ffn_hidden=64, moe_every=2, num_local_experts=4,
             top_k=2, expert_hidden=64, capacity_factor=8.0)


def _models(int4_experts=False, **kw):
    cfg = dict(SMALL, **kw)
    jm = JModel(JConfig(**cfg), group=jax.devices()[:1])
    tm = TransformerMoE(TransformerMoEConfig(**cfg), device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    if int4_experts:
        jp = {**jp, "blocks": [
            {**b, "moe": {**b["moe"], "experts": jquant.quantize_expert_params(
                b["moe"]["experts"], bits=4)}} if "moe" in b else b
            for b in jp["blocks"]]}
    return jm, tm, jp, convert.from_jax_params(jp, "cpu")


def _prompts(n, lengths, seed, vocab=61):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lengths[i % len(lengths)]).astype(np.int32)
            for i in range(n)]


def _serve(engine_cls, request_cls, model, params, prompts, budgets,
           chunk=2, stops=None, **kw):
    eng = engine_cls(model, params, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=budgets[i],
                        stop_token=None if stops is None else stops[i])
            for i, p in enumerate(prompts)]
    out = eng.run(reqs, chunk=chunk)
    return eng, {u: t.tolist() for u, t in out.items()}


@pytest.mark.parametrize("kv_bits,kvh,int4", [(0, 0, False), (8, 1, True)])
def test_continuous_batching_matches_jax(kv_bits, kvh, int4):
    """7 requests through 3 slots, staggered prompt lengths and budgets."""
    jm, tm, jp, tp = _models(int4_experts=int4, kv_bits=kv_bits,
                             num_kv_heads=kvh,
                             **({"model_dim": 64, "expert_hidden": 128}
                                if int4 else {}))
    prompts = _prompts(7, [3, 4, 5], seed=0)
    budgets = [2 + i % 4 for i in range(7)]
    kw = dict(max_batch=3, moe_overrides={"capacity_factor": 8.0})
    before = [decode_attn.decode_attn.launches, kv_write.write_step.launches,
              fused_ffn.fused_ffn_quant.launches]
    jeng, ref = _serve(JEngine, JRequest, jm, jp, prompts, budgets, **kw)
    teng, got = _serve(LmDecodeEngine, LmRequest, tm, tp, prompts, budgets,
                       **kw)
    assert got == ref
    for key in ("steps", "tokens", "joined", "finished"):
        assert teng.stats[key] == jeng.stats[key], key
    assert ("fused_stream" in teng.params["blocks"][1]["moe"]["experts"]) \
        == int4
    # CPU tensors run the plain twins: no kernel launch is counted
    assert [decode_attn.decode_attn.launches, kv_write.write_step.launches,
            fused_ffn.fused_ffn_quant.launches] == before


def test_stop_token_matches_jax():
    jm, tm, jp, tp = _models()
    prompts = _prompts(4, [4], seed=5)
    _, full = _serve(LmDecodeEngine, LmRequest, tm, tp, prompts, [10] * 4,
                     chunk=4, max_batch=4,
                     moe_overrides={"capacity_factor": 8.0})
    stops = [full[i][4] for i in range(4)]
    kw = dict(max_batch=2, moe_overrides={"capacity_factor": 8.0})
    teng, got = _serve(LmDecodeEngine, LmRequest, tm, tp, prompts, [10] * 4,
                       chunk=3, stops=stops, **kw)
    _, ref = _serve(JEngine, JRequest, jm, jp, prompts, [10] * 4, chunk=3,
                    stops=stops, **kw)
    assert got == ref
    for i in range(4):
        assert got[i] == full[i][:full[i].index(stops[i]) + 1]
    assert teng.stats["finished"] == 4 and teng.stats["tokens"] < 40


def test_fetch_false_keeps_device_state():
    """A fetch=False chunk returns nothing but advances the cache and the
    positions: the next fetched chunk gives the JAX engine's tokens."""
    jm, tm, jp, tp = _models()
    prompts = _prompts(2, [4], seed=1)
    ov = {"capacity_factor": 8.0}
    engines = [JEngine(jm, jp, max_batch=2, moe_overrides=ov),
               LmDecodeEngine(tm, tp, max_batch=2, moe_overrides=ov)]
    for eng, req in zip(engines, (JRequest, LmRequest)):
        for i, p in enumerate(prompts):
            eng.try_add(req(uid=i, prompt=p, max_new_tokens=7))
    jeng, teng = engines
    assert teng.step_chunk(3, fetch=False) == {}
    jeng.step_chunk(3, fetch=False)
    assert teng.stats["tokens"] == jeng.stats["tokens"]
    assert teng.step_chunk(3) == jeng.step_chunk(3)


def _skewed(jp):
    """Every token routes to experts 0 and 3: the MoE blocks' LayerNorm
    bias makes every token's sum positive, and the gate's columns are
    constant and distinct (no ties for the top-k to break)."""
    blocks = []
    for blk in jp["blocks"]:
        if "moe" in blk:
            w = np.zeros(np.asarray(blk["moe"]["gates"][0]["wg"]).shape,
                         np.float32)
            w[:] = [10.0, 0.1, 0.2, 0.3]
            blk = {**blk, "moe": {**blk["moe"],
                                  "gates": [{"wg": jnp.asarray(w)}]},
                   "ln2": {**blk["ln2"],
                           "bias": jnp.full_like(blk["ln2"]["bias"], 0.5)}}
        blocks.append(blk)
    return {**jp, "blocks": blocks}


def test_speculative_replay_matches_jax_and_the_worst_case():
    jm, tm, jp, _ = _models()
    jp = _skewed(jp)
    tp = convert.from_jax_params(jp, "cpu")
    prompts = _prompts(12, [4], seed=3)
    kw = dict(max_batch=12, moe_overrides={"capacity_factor": 0.0},
              capacity_bucket=2)

    def drive(cls, req, model, params, margin):
        model.__dict__.pop("_serving_spec_hints", None)
        return _serve(cls, req, model, params, prompts, [9] * 12, chunk=3,
                      speculative_capacity=margin, **kw)

    spec, got = drive(LmDecodeEngine, LmRequest, tm, tp, 1.5)
    assert spec.stats["spec_retries"] > 0
    worst, base = drive(LmDecodeEngine, LmRequest, tm, tp, 1e9)
    assert worst.stats["spec_retries"] == 0
    _, ref = drive(JEngine, JRequest, jm, jp, 1.5)
    assert got == base == ref
    tm.__dict__.pop("_serving_spec_hints", None)
    blind = LmDecodeEngine(tm, tp, speculative_capacity=1.5, **kw)
    for i, p in enumerate(prompts):
        blind.try_add(LmRequest(uid=i, prompt=p, max_new_tokens=9))
    assert blind.step_chunk(2, fetch=False) == {}
    assert blind.spec_overflow is True


def test_prefill_bucket_matches_exact_admission_and_jax():
    jm, tm, jp, tp = _models()
    prompts = _prompts(6, [3, 4, 5, 7, 9, 12], seed=3)
    runs = []
    for bucket in (0, 8):
        runs.append(_serve(LmDecodeEngine, LmRequest, tm, tp, prompts,
                           [4] * 6, max_batch=6, prefill_bucket=bucket)[1])
    _, ref = _serve(JEngine, JRequest, jm, jp, prompts, [4] * 6, max_batch=6,
                    prefill_bucket=8)
    assert runs[0] == runs[1] == ref


def test_sampling_is_seeded_and_stays_in_the_top_k_top_p_set():
    _, tm, _, tp = _models()
    prompts = _prompts(3, [4], seed=3)

    def gen(sampler):
        return _serve(LmDecodeEngine, LmRequest, tm, tp, prompts, [8] * 3,
                      chunk=4, max_batch=4, sampler=sampler)[1]

    greedy = gen(None)
    for degenerate in ({"top_k": 1}, {"top_p": 1e-9}, {"temperature": 0.0}):
        assert gen(degenerate) == greedy, degenerate
    for sampler, top_k, top_p in (({"top_k": 3, "seed": 7}, 3, None),
                                  ({"top_p": 0.5, "seed": 7}, None, 0.5)):
        a, b = gen(sampler), gen(sampler)
        assert a == b, "a fixed seed must be deterministic"
        assert gen({**sampler, "seed": 8}) != a
        for uid, toks in a.items():
            seq = list(prompts[uid]) + toks
            logits, _ = tm.apply(tp, torch.tensor([seq[:-1]]))
            for j, tok in enumerate(toks):
                lg = logits[0, len(prompts[uid]) - 1 + j]
                order = torch.argsort(lg, descending=True)
                if top_k:
                    allowed = order[:top_k]
                else:
                    p = torch.softmax(lg[order], dim=0)
                    allowed = order[(torch.cumsum(p, 0) - p) < top_p]
                assert tok in allowed.tolist(), (uid, j, tok)
