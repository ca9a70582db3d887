"""Slice 5b on the GPU: the ragged wrappers of K1 and K2
(`grouped_gemm_quant_ragged`, `fused_ffn_quant_ragged`: rows grouped by
expert, gathered into the dense view, one kernel call, gathered back)
against their plain twins on the same inputs, including a group cut at
c_max and rows past the groups; K1 on INT4 weights packed in 2 and 4
K-blocks (the layout the r == 0 regather of K-sliced weights gives)
against its twin; and the ragged expert-parallel forward at world size 1
(no process group: the exchanges are copies) against the padded layer.

These tests need an NVIDIA GPU and nvcc and skip without them (a CUDA
kernel has no CPU mode). This file imports no JAX; on a machine without
JAX run it as `python -m pytest --noconftest tests/test_torch_slice5b_gpu.py`.

Tolerances: float32 within 1e-5 of max |twin|, bfloat16 within 2e-2
(tests/test_torch_kernels_gpu.py's).
"""

import pytest
import torch

from tutel_tpu_torch import moe
from tutel_tpu_torch.ops import activations, fused_ffn, grouped_gemm_quant
from tutel_tpu_torch.ops import quant, ragged, ragged_ep

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _ragged_case(device, dtype, e=6, k=256, h=512, n=256, bits=4):
    g = torch.Generator(device=device).manual_seed(bits)
    gs = torch.tensor([3, 0, 17, 9, 1, 30], dtype=torch.int32,
                      device=device)[:e]
    rows = torch.randn(int(gs.sum()) + 5, k, generator=g,
                       device=device).to(dtype)   # 5 rows past the groups
    w1 = quant.quantize(torch.randn(e, k, h, generator=g, device=device)
                        * 0.05, bits)
    w2 = quant.quantize(torch.randn(e, h, n, generator=g, device=device)
                        * 0.05, bits)
    b1 = torch.randn(e, h, generator=g, device=device) * 0.1
    b2 = torch.randn(e, n, generator=g, device=device) * 0.1
    return rows, gs, w1, w2, b1, b2


def _twin(rows, gs, c_max, fn):
    gs64, starts = ragged.ragged_starts(gs)
    dense = ragged.ragged_to_dense(rows, gs64, starts, c_max)
    return ragged.dense_to_ragged(fn(dense, gs64.clamp(max=c_max)), gs64,
                                  starts, c_max, rows.shape[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_max", [64, 16])      # 16 cuts one group
@pytest.mark.parametrize("bits", [4, 8])
def test_grouped_gemm_quant_ragged_matches_twin(cuda, dtype, c_max, bits):
    rows, gs, w1, _, _, _ = _ragged_case(cuda, dtype, bits=bits)
    before = grouped_gemm_quant.grouped_gemm_quant.launches
    got = grouped_gemm_quant.grouped_gemm_quant_ragged(rows, w1, gs, c_max)
    assert grouped_gemm_quant.grouped_gemm_quant.launches == before + 1
    ref = _twin(rows, gs, c_max, lambda d, c:
                grouped_gemm_quant.grouped_gemm_quant_reference(d, w1, c))
    assert got.shape == (rows.shape[0], w1.shape[2])
    assert _rel(got, ref) <= TOL[dtype]
    assert not got[int(gs.sum()):].any()           # rows past the groups


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_max", [64, 16])
def test_fused_ffn_quant_ragged_matches_twin(cuda, dtype, c_max):
    rows, gs, w1, w2, b1, b2 = _ragged_case(cuda, dtype)
    stream = fused_ffn.prepare_fused_ffn(w1, w2, b1, b2)
    before = fused_ffn.fused_ffn_quant.launches
    got = fused_ffn.fused_ffn_quant_ragged(rows, stream, gs, c_max,
                                           activation_fn=activations.gelu)
    assert fused_ffn.fused_ffn_quant.launches == before + 1
    ref = _twin(rows, gs, c_max, lambda d, c:
                fused_ffn.fused_ffn_quant_reference(d, stream, c,
                                                    activations.gelu))
    assert _rel(got, ref) <= TOL[dtype]
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [2, 4])
def test_grouped_gemm_quant_int4_blocks_match_twin(cuda, dtype, blocks):
    g = torch.Generator(device=cuda).manual_seed(blocks)
    e, c, k, n = 8, 32, 2048, 512
    x = torch.randn(e, c, k, generator=g, device=cuda).to(dtype)
    qw = quant.quantize(torch.randn(e, k, n, generator=g, device=cuda)
                        * 0.02, 4, shard_blocks=blocks)
    counts = torch.tensor([0, 32, 5, 17, 1, 32, 9, 3], dtype=torch.int32,
                          device=cuda)
    got = grouped_gemm_quant.grouped_gemm_quant(x, qw, counts, routed=99)
    again = grouped_gemm_quant.grouped_gemm_quant(x, qw, counts, routed=99)
    ref = grouped_gemm_quant.grouped_gemm_quant_reference(x, qw, counts)
    assert torch.equal(got, again)
    assert _rel(got, ref) <= TOL[dtype]


def test_ragged_ep_forward_at_one_rank_matches_padded(cuda):
    """Without a process group the exchanges are copies: the ragged path
    with INT4 experts (K1 twice, then K2 once with a fused stream) gives the
    padded dropless layer's tokens."""
    layer = moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        model_dim=256, device="cuda",
        experts={"type": "ffn", "num_experts_per_device": 8,
                 "hidden_size_per_expert": 512})
    params = layer.init(torch.Generator(device="cuda").manual_seed(0))
    params["experts"] = quant.quantize_expert_params(params["experts"], 4)
    x = torch.randn(96, 256, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    cap = layer.resolve_capacity(params, x)
    with torch.no_grad():
        ref = layer(params, x, capacity_override=cap)[0]
        crit, _ = layer._routing(params["gates"][0], x, 0, 2, cap,
                                 with_loss=False)
        for experts, kernel in (
                (params["experts"], grouped_gemm_quant.grouped_gemm_quant),
                (fused_ffn.prepare_fused_ffn_params(params["experts"]),
                 fused_ffn.fused_ffn_quant)):
            before = kernel.launches
            out = ragged_ep.ragged_ep_forward(
                x, crit, experts, layer.experts.apply_grouped, None, 192)
            assert kernel.launches > before
            assert _rel(out, ref) <= 1e-5


def test_ragged_ep_truncating_bf16_float_experts_match_cpu(cuda):
    """A max_recv below the routed rows, with bfloat16 float experts: the
    groups' counts then pass the received rows, and the grouped GEMM
    (`torch._grouped_mm` over the groups' end offsets) must stop at the
    buffer's last row. The card's tokens against the CPU's from the same
    routing, dropped rows zero on both."""
    layer = moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        model_dim=256, device="cpu",
        experts={"type": "ffn", "num_experts_per_device": 8,
                 "hidden_size_per_expert": 512})
    params = layer.init(torch.Generator().manual_seed(0))
    x = torch.randn(96, 256, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        crit, _ = layer._routing(params["gates"][0], x, 0, 2,
                                 layer.resolve_capacity(params, x),
                                 with_loss=False)
        outs = {}
        for dev in ("cpu", "cuda"):
            experts = {k: v.to(dev, torch.bfloat16)
                       for k, v in params["experts"].items()}
            c = crit._replace(**{f: getattr(crit, f).to(dev) for f in (
                "indices", "locations", "gates", "dispatch_count")})
            outs[dev] = ragged_ep.ragged_ep_forward(
                x.to(dev, torch.bfloat16), c, experts,
                layer.experts.apply_grouped, None, 100)   # of 192 rows
    got, ref = outs["cuda"].cpu(), outs["cpu"]
    assert torch.isfinite(got).all()
    assert torch.equal(got.float().abs().sum(1) == 0,
                       ref.float().abs().sum(1) == 0)
    assert (ref.float().abs().sum(1) == 0).any()      # rows were dropped
    assert _rel(got, ref) <= TOL[torch.bfloat16]
