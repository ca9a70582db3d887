"""Port parity: the continuous-batching decode engine
(tutel_tpu_torch.serving.MoeDecodeEngine) against the JAX engine on the
same requests and parameters, with residual_norm state updates, auto-fused
INT4 experts, speculative capacity with replay, and chunked scheduling."""

import jax
import numpy as np
import pytest
import torch

from tutel_tpu import moe as jmoe
from tutel_tpu.ops import quant as jq
from tutel_tpu.serving import MoeDecodeEngine as JEngine
from tutel_tpu.serving import Request as JRequest
from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.ops import fused_ffn, grouped_gemm_quant, quant
from tutel_tpu_torch.serving import MoeDecodeEngine, Request

torch.set_num_threads(1)


def _layers(e, m, h, k=2):
    gate = {"type": "top", "k": k, "capacity_factor": 0.0}
    experts = {"type": "ffn", "num_experts_per_device": e,
               "hidden_size_per_expert": h}
    return (jmoe.moe_layer(gate_type=gate, experts=dict(experts),
                           model_dim=m, seeds=(1, 1, 1),
                           group=jax.devices()[:1]),
            tmoe.moe_layer(gate_type=gate, experts=dict(experts),
                           model_dim=m, device="cpu"))


def _states(n, m, seed=7):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.float32)


def _lengths(n):
    return [1 + i % 4 for i in range(n)]                 # at most 4 steps


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-12)


@pytest.mark.parametrize("quantized,spec", [(False, 8.0), (True, 8.0),
                                            (False, 0.0)])
def test_engine_matches_jax_engine(quantized, spec):
    e, m, h = (4, 128, 256) if quantized else (8, 32, 64)
    jl, tl = _layers(e, m, h)
    jp = jl.init(jax.random.PRNGKey(0))
    if quantized:
        jp = dict(jp)
        jp["experts"] = jq.quantize_expert_params(jp["experts"], bits=4)
    tp = convert.from_jax_params(jp, "cpu")
    states, lengths = _states(10, m), _lengths(10)
    kw = dict(max_batch=4, speculative_capacity=spec,
              state_update="residual_norm")
    jeng, teng = JEngine(jl, jp, **kw), MoeDecodeEngine(tl, tp, **kw)
    assert ("fused_stream" in teng.params["experts"]) == quantized
    ref = jeng.run([JRequest(uid=i, state=states[i], remaining=n)
                    for i, n in enumerate(lengths)], chunk=2)
    got = teng.run([Request(uid=i, state=states[i], remaining=n)
                    for i, n in enumerate(lengths)], chunk=2)
    assert set(got) == set(ref) == set(range(10))
    for uid in ref:
        _close(got[uid].numpy(), ref[uid])
    for key in ("steps", "tokens", "joined", "finished"):
        assert teng.stats[key] == jeng.stats[key], key


def test_speculative_retry_replays_to_the_worst_case_result():
    """A gate that sends every token to expert 0 overflows the speculated
    buffer; the chunk replays and matches the worst-case engine and the
    JAX engine."""
    jl, tl = _layers(8, 32, 64, k=1)
    jp = dict(jl.init(jax.random.PRNGKey(0)))
    w = _states(32, 8, seed=4) * 0.01
    w[:, 0] = 10.0
    jp["gates"] = [{"wg": jax.numpy.asarray(w)}]
    tp = convert.from_jax_params(jp, "cpu")
    states = np.abs(_states(16, 32, seed=3))    # positive: expert 0 wins

    def reqs(cls):
        return [cls(uid=i, state=states[i], remaining=4) for i in range(16)]

    kw = dict(max_batch=16, state_update="residual_norm")
    spec = MoeDecodeEngine(tl, tp, speculative_capacity=2.0, **kw)
    assert spec._spec_cap(16, 16) < 16
    got = spec.run(reqs(Request), chunk=4)
    assert spec.stats["spec_retries"] > 0
    tl._serving_spec_hints.clear()
    worst = MoeDecodeEngine(tl, tp, speculative_capacity=0.0, **kw)
    base = worst.run(reqs(Request), chunk=4)
    ref = JEngine(jl, jp, speculative_capacity=2.0, **kw).run(
        reqs(JRequest), chunk=4)
    for uid in ref:
        _close(got[uid].numpy(), base[uid].numpy(), tol=1e-6)
        _close(got[uid].numpy(), ref[uid])

    tl._serving_spec_hints.clear()
    blind = MoeDecodeEngine(tl, tp, speculative_capacity=2.0, **kw)
    for r in reqs(Request):
        blind.try_add(r)
    assert blind.step_chunk(2, fetch=False) == {}
    assert blind.spec_overflow is True


def test_chunked_run_matches_stepwise():
    _, tl = _layers(4, 32, 64)
    tp = tl.init(torch.Generator().manual_seed(0))
    states = _states(6, 32, seed=11)

    def run(chunk):
        eng = MoeDecodeEngine(tl, tp, max_batch=4,
                              state_update="residual_norm")
        out = eng.run([Request(uid=i, state=torch.from_numpy(states[i]),
                               remaining=3 + i % 3) for i in range(6)],
                      chunk=chunk)
        return eng, out

    e1, f1 = run(1)
    e4, f4 = run(4)
    assert e4.stats["finished"] == e1.stats["finished"] == 6
    assert e4.stats["tokens"] == e1.stats["tokens"]
    for uid in f1:
        _close(f4[uid].numpy(), f1[uid].numpy(), tol=1e-6)
    rms = np.sqrt(np.mean(np.stack([f.numpy() for f in f4.values()]) ** 2,
                          axis=-1))
    assert rms.min() > 0.9 and rms.max() < 1.1      # residual_norm manifold


def test_auto_fuse_selects_the_kernel_path():
    _, tl = _layers(4, 128, 256)
    tp = tl.init(torch.Generator().manual_seed(1))
    tp["experts"] = quant.quantize_expert_params(tp["experts"], bits=4)
    assert "fused_stream" in MoeDecodeEngine(tl, tp, 8).params["experts"]
    eng = MoeDecodeEngine(tl, tp, 8, auto_fuse=False)
    assert "fused_stream" not in eng.params["experts"]
    eng.try_add(Request(uid="a", state=np.zeros(128, np.float32),
                        remaining=1))
    counters = (grouped_gemm_quant.grouped_gemm_quant, fused_ffn.fused_ffn_quant)
    before = [f.launches for f in counters]
    assert list(eng.step()) == ["a"]
    # CPU tensors run the plain twins: no kernel launch is counted
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="state_update"):
        MoeDecodeEngine(tl, tp, 8, state_update="sum")
