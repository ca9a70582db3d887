"""Slice 6c, second half, on the GPU: K6 (`decode_attn`) and K7
(`prefill_attn`) at head_dim 16 and 32 against their plain twins in every
cache mode and query type, the `serving_decode` example on the card
against the same example on the CPU, and `tune_moe`'s candidates agreeing
on the card.

These tests need an NVIDIA GPU and nvcc and skip without them (a CUDA
kernel has no CPU mode). This file imports no JAX; on a machine without
JAX run it as `python -m pytest --noconftest tests/test_torch_slice6c_gpu.py`.
"""

import pytest
import torch

from tutel_tpu_torch.models import TransformerMoE
from tutel_tpu_torch.ops import decode_attn as da

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MODES = ["float", "int8", "int4"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _cache(g, b, t, kvh, hd, mode, dtype, dev):
    """(k, v, k_scale, v_scale) in the cache's stored form."""
    def one():
        x = torch.randn(b * t, kvh, hd, generator=g, device=dev)
        if mode == "float":
            return x.reshape(b, t, -1).to(dtype), None
        fn = (TransformerMoE._kv_quantize if mode == "int8"
              else TransformerMoE._kv_quantize4)
        vals, s = fn(x)
        return (vals.reshape(b, t, -1).contiguous(),
                s.reshape(b, t, kvh).transpose(1, 2).contiguous())
    (k, ks), (v, vs) = one(), one()
    return k, v, ks, vs


# (nh, kvh, hd): serving_decode's LM (4 heads of 16, one group each); GQA
# at 2, 4 and 8 heads a group (smaller runs a lane); one group, so an
# INT4 row's 16 values straddle its halves; an odd KVH (8-byte rows)
SMALL_HD = [(4, 4, 16), (8, 4, 16), (8, 2, 16), (8, 1, 16), (3, 1, 16),
            (6, 3, 16), (4, 4, 32), (8, 2, 32), (8, 1, 32), (3, 3, 32)]


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("nh,kvh,hd", SMALL_HD)
def test_decode_attn_small_head_dim_matches_twin(cuda, mode, dtype, fresh,
                                                 nh, kvh, hd, split):
    g = torch.Generator(device=cuda).manual_seed(hd + nh + kvh)
    b, t = 5, 128
    q = torch.randn(b, nh, hd, generator=g, device=cuda).to(dtype)
    k, v, ks, vs = _cache(g, b, t, kvh, hd, mode, dtype, cuda)
    pos = torch.tensor([0, 31, 32, 77, 95], device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, attn_len=96,
              kv_bits=4 if mode == "int4" else 8)
    if fresh:
        kn, vn, kns, vns = _cache(g, b, 1, kvh, hd, mode, dtype, cuda)
        kw.update(k_new=kn[:, 0].contiguous(), v_new=vn[:, 0].contiguous(),
                  k_new_scale=None if kns is None else kns[..., 0].contiguous(),
                  v_new_scale=None if vns is None else vns[..., 0].contiguous())
    before = da.decode_attn.launches
    got = da.decode_attn(q, k, v, pos, split=split, **kw)
    again = da.decode_attn(q, k, v, pos, split=split, **kw)
    torch.cuda.synchronize()
    assert da.decode_attn.launches == before + 2
    assert torch.equal(got, again)                  # bitwise repeatable
    ref = da.decode_attn_reference(q, k, v, pos, **kw)
    assert got.dtype == dtype and _rel_err(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh,hd,tq,start", [
    (4, 4, 16, 80, 0), (8, 2, 16, 37, 20), (3, 1, 16, 64, 30),
    (6, 3, 16, 16, 100), (4, 4, 32, 80, 0), (8, 1, 32, 50, 60)])
def test_prefill_attn_small_head_dim_matches_twin(cuda, mode, dtype, nh, kvh,
                                                  hd, tq, start):
    g = torch.Generator(device=cuda).manual_seed(7 * tq + start + hd)
    b, t = 3, 256
    q = torch.randn(b, tq, nh, hd, generator=g, device=cuda).to(dtype)
    k, v, ks, vs = _cache(g, b, t, kvh, hd, mode, dtype, cuda)
    kw = dict(k_scale=ks, v_scale=vs, attn_len=start + tq + 40,
              kv_bits=4 if mode == "int4" else 8)
    before = da.prefill_attn.launches
    got = da.prefill_attn(q, k, v, start, **kw)
    torch.cuda.synchronize()
    assert da.prefill_attn.launches == before + 1
    ref = da.prefill_attn_reference(q, k, v, start, **kw)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert _rel_err(got, ref) <= TOL[dtype]


def test_serving_decode_on_gpu_matches_cpu(cuda):
    """The example at its defaults on the card: every request of both
    engines finishes, the MoE engine's final states match the same engine
    on the CPU, and the LM decodes through K6, K7 and K8 (head_dim 16)."""
    from tutel_tpu_torch.examples import serving_decode
    from tutel_tpu_torch.ops import kv_write
    cpu = serving_decode.run(serving_decode.build_args(["--device", "cpu"]),
                             log=lambda *_: None)
    before = (da.decode_attn.launches, da.prefill_attn.launches,
              kv_write.write_step.launches)
    moe_stats, lm_stats, finals, timing = serving_decode.run(
        serving_decode.build_args([]), log=lambda *_: None)
    torch.cuda.synchronize()
    assert moe_stats["finished"] == 48 and lm_stats["finished"] == 12
    assert da.decode_attn.launches > before[0]
    assert da.prefill_attn.launches > before[1]
    assert kv_write.write_step.launches > before[2]
    for uid, v in cpu[2].items():
        assert torch.allclose(finals[uid].float().cpu(), v.float(),
                              rtol=1e-4, atol=1e-4), uid
    assert timing["tokens_per_s"] > 0


def test_tune_moe_candidates_agree_on_gpu(cuda):
    """Every candidate tune_moe times gives the default call's output on
    the card (the candidates are equal configs), and the winner is one of
    them."""
    from tutel_tpu_torch import moe
    from tutel_tpu_torch.autotune import moe_candidates, tune_moe
    layer = moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": 4,
                 "hidden_size_per_expert": 512},
        model_dim=512, seeds=(1, 1, 1), group=[0], device=cuda)
    params = layer.init(torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn(1024, 512, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    with torch.no_grad():
        ref, _ = layer(params, x, adaptive_r=1, a2a_ffn_overlap_degree=1)
        for cfg in moe_candidates(layer):
            out, _ = layer(params, x, **cfg)
            assert torch.allclose(out, ref, rtol=1e-5, atol=1e-5), cfg
    result = tune_moe(layer, params, x, iters=3)
    assert result["best"] in result["timings"]
    assert all(t > 0 for t in result["timings"].values())
