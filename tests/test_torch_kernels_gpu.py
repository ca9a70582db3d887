"""The CUDA kernels K1 (`grouped_gemm_quant`) and K2 (`fused_ffn_quant`)
against their plain PyTorch twins on the GPU, and the decode engine on the
GPU against the same engine on the CPU.

These tests need an NVIDIA GPU and nvcc and skip without them (a CUDA
kernel has no CPU mode). This file imports no JAX; on a machine without
JAX run it as `python -m pytest --noconftest tests/test_torch_kernels_gpu.py`.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tutel_tpu_torch import moe
from tutel_tpu_torch.csrc import build
from tutel_tpu_torch.ops import activations, fused_ffn, grouped_gemm_quant
from tutel_tpu_torch.ops import quant
from tutel_tpu_torch.serving import MoeDecodeEngine, Request

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, ref, counts):
    live = (torch.arange(ref.shape[1], device=ref.device)[None, :, None]
            < counts[:, None, None])
    diff = torch.where(live, (got.float() - ref.float()).abs(), 0.0)
    scale = torch.where(live, ref.float().abs(), 0.0).max()
    return float(diff.max() / scale)


def _counts(e, c, device, seed):
    counts = np.random.default_rng(seed).integers(0, c + 1, e)
    counts[0] = 0                                   # an empty expert
    counts[-1] = c                                  # a full one
    return torch.tensor(counts, dtype=torch.int32, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,blocks", [(4, 1), (8, 1), (4, 2)])
def test_grouped_gemm_quant_kernel_matches_twin(cuda, dtype, bits, blocks):
    g = torch.Generator(device=cuda).manual_seed(bits + blocks)
    e, c, k, n = 4, 20, 256, 640                    # 2 row tiles, 2 strips
    x = torch.randn(e, c, k, generator=g, device=cuda).to(dtype)
    w = torch.randn(e, k, n, generator=g, device=cuda) * 0.05
    qw = quant.quantize(w, bits, shard_blocks=blocks)
    counts = _counts(e, c, cuda, bits)
    before = grouped_gemm_quant.grouped_gemm_quant.launches
    got = grouped_gemm_quant.grouped_gemm_quant(x, qw, counts)
    torch.cuda.synchronize()
    assert grouped_gemm_quant.grouped_gemm_quant.launches == before + 1
    ref = grouped_gemm_quant.grouped_gemm_quant_reference(x, qw, counts)
    assert got.dtype == dtype and _rel_err(got, ref, counts) <= TOL[dtype]
    dead = (torch.arange(c, device=cuda)[None, :, None]
            >= counts[:, None, None])
    assert not torch.any(torch.where(dead, got.float(), 0.0))


# the tensor-core body's shapes (bits, blocks, K, N): N past a 128-column
# strip (16-byte loads) or past a 32-column one (N % 16 != 0: 4-byte
# loads); x staged with 16-byte loads or one value at a time (INT4 blocks
# of 132 packed rows, INT8 K % 16 != 0); an INT8 k-step half past K
TC_SHAPES = [(4, 1, 256, 656), (4, 2, 320, 656), (4, 1, 264, 200),
             (8, 1, 256, 200), (8, 1, 200, 656)]
# live rows 0, 1, 7, 8, 9, 16, 17 and C: one and two n-blocks, two tiles
TC_COUNTS = [0, 1, 7, 8, 9, 16, 17, 20]


# routed rows: 0 plans 8-row tiles in one group, None (every row live) 16-row
# tiles in two groups (`tc_plan`)
@pytest.mark.parametrize("routed", [0, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,blocks,k,n", TC_SHAPES)
def test_grouped_gemm_quant_bodies_match_twin(cuda, dtype, bits, blocks, k, n,
                                              routed):
    """bfloat16 x runs the tensor-core body with either plan, float32 x
    the CUDA-core body (which takes no tile), against the twin; rows past
    the counts are zeros; two calls are bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(bits + blocks + k)
    e, c = len(TC_COUNTS), TC_COUNTS[-1]
    x = torch.randn(e, c, k, generator=g, device=cuda).to(dtype)
    w = torch.randn(e, k, n, generator=g, device=cuda) * 0.05
    qw = quant.quantize(w, bits, shard_blocks=blocks)
    counts = torch.tensor(TC_COUNTS, dtype=torch.int32, device=cuda)
    before = grouped_gemm_quant.grouped_gemm_quant.launches
    got = grouped_gemm_quant.grouped_gemm_quant(x, qw, counts, routed=routed)
    again = grouped_gemm_quant.grouped_gemm_quant(x, qw, counts,
                                                  routed=routed)
    torch.cuda.synchronize()
    assert grouped_gemm_quant.grouped_gemm_quant.launches == before + 2
    ref = grouped_gemm_quant.grouped_gemm_quant_reference(x, qw, counts)
    assert got.dtype == dtype and _rel_err(got, ref, counts) <= TOL[dtype]
    assert torch.equal(got, again)
    dead = (torch.arange(c, device=cuda)[None, :, None]
            >= counts[:, None, None])
    assert not torch.any(torch.where(dead, got.float(), 0.0))


@pytest.mark.parametrize("k", [8192, 14336])
@pytest.mark.parametrize("bits,blocks", [(4, 1), (4, 2), (8, 1)])
def test_grouped_gemm_quant_wide_k_in_16_row_tiles(cuda, bits, blocks, k):
    """fc2 of a wide hidden (K = 8192, 14336) in bfloat16 with every row
    live: 16-row tiles whose x is staged a chunk at a time, against the
    twin; two calls bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(bits + k)
    counts_list = [0, 9, 17, 32]
    e, c, n = len(counts_list), 32, 256
    assert grouped_gemm_quant.tc_plan(e, c)[0] == 16
    x = torch.randn(e, c, k, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(e, k, n, generator=g, device=cuda) * 0.02
    qw = quant.quantize(w, bits, shard_blocks=blocks)
    counts = torch.tensor(counts_list, dtype=torch.int32, device=cuda)
    got = grouped_gemm_quant.grouped_gemm_quant(x, qw, counts)
    again = grouped_gemm_quant.grouped_gemm_quant(x, qw, counts)
    ref = grouped_gemm_quant.grouped_gemm_quant_reference(x, qw, counts)
    assert _rel_err(got, ref, counts) <= TOL[torch.bfloat16]
    assert torch.equal(got, again)


def test_k1_and_k3_libraries_run_on_tensor_cores(cuda):
    """Every instance of K1's tensor-core kernel holds HMMA (bf16 mma.sync)
    and every K3 kernel IMMA (int8 mma.sync), read from the SASS of the
    built libraries with cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, stem, op in (("grouped_gemm_quant", "gmm_quant_kernel_tc",
                            "HMMA"),
                           ("fused_ffn_w8a8", "fused_w8a8_kernel", "IMMA")):
        build.load(name)
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        parts = [p for p in re.split(r"\n\s*Function : ", sass)[1:]
                 if stem in p.split(None, 1)[0]]
        assert parts and all(f"{op}." in p for p in parts), name


@pytest.mark.parametrize("c", [20, 1100])
@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,use_bias,act,k,n,bw", [
    (4, True, activations.gelu, 128, 96, 128),      # K < H, N < bw
    (4, False, activations.relu, 256, 192, 128),    # n < t2 * bw
    (8, True, activations.relu, 128, 192, 128),
    (8, False, activations.gelu, 256, 96, 128),
    (4, True, activations.relu, 128, 96, 8),        # bw % 16: 4-byte loads
])
def test_fused_ffn_quant_kernel_matches_twin(cuda, dtype, bits, use_bias,
                                             act, k, n, bw, split, c):
    """K2 with its hidden split pinned to 1, 2 or 8 slices (the slices'
    combine kernel for 2 and 8) against the twin; an empty expert, odd live
    counts, a full expert, 4-row tiles at 20 rows an expert (16-byte loads
    of a packed row, 4-byte where the tile width is not a multiple of 16)
    and 16-row tiles (with 4, 8 and 16 live rows) at 1100; two calls
    bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(bits * 2 + k)
    e, h = 4, 512
    x = torch.randn(e, c, k, generator=g, device=cuda).to(dtype)
    w1 = torch.randn(e, k, h, generator=g, device=cuda) * 0.05
    w2 = torch.randn(e, h, n, generator=g, device=cuda) * 0.05
    b1 = torch.randn(e, h, generator=g, device=cuda) * 0.1 if use_bias else None
    b2 = torch.randn(e, n, generator=g, device=cuda) * 0.1 if use_bias else None
    st = fused_ffn.prepare_fused_ffn(quant.quantize(w1, bits),
                                     quant.quantize(w2, bits), b1, b2, bw=bw)
    counts = _counts(e, c, cuda, k)
    counts[1] = 7                                   # an odd live count
    counts[2] = c - 11              # 1089: a 16-row tile with one row
    ref = fused_ffn.fused_ffn_quant_reference(x, st, counts, act)
    before = fused_ffn.fused_ffn_quant.launches
    got = fused_ffn.fused_ffn_quant(x, st, counts, activation_fn=act,
                                    split=split)
    again = fused_ffn.fused_ffn_quant(x, st, counts, activation_fn=act,
                                      split=split)
    torch.cuda.synchronize()
    assert fused_ffn.fused_ffn_quant.launches == before + 2
    assert got.shape == (e, c, n)
    assert _rel_err(got, ref, counts) <= TOL[dtype]
    assert torch.equal(got, again)
    dead = (torch.arange(c, device=cuda)[None, :, None]
            >= counts[:, None, None])
    assert not torch.any(torch.where(dead, got.float(), 0.0))
    with pytest.raises(ValueError, match="no CUDA kernel"):
        fused_ffn.fused_ffn_quant(x, st, counts, activation_fn=torch.tanh)


@pytest.mark.parametrize("auto_fuse", [True, False])
def test_engine_on_gpu_matches_cpu(cuda, auto_fuse):
    kw = dict(gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
              experts={"type": "ffn", "num_experts_per_device": 8,
                       "hidden_size_per_expert": 256,
                       "has_fc1_bias": False, "has_fc2_bias": False},
              model_dim=128)
    cpu_layer = moe.moe_layer(device="cpu", **kw)
    gpu_layer = moe.moe_layer(device=cuda, **kw)
    params = cpu_layer.init(torch.Generator().manual_seed(0))
    params["experts"] = quant.quantize_expert_params(params["experts"], 4)
    gpu_params = {"gates": [{"wg": params["gates"][0]["wg"].to(cuda)}],
                  "experts": {k: v.to(cuda)
                              for k, v in params["experts"].items()}}
    states = np.random.default_rng(1).standard_normal((12, 128)).astype(
        np.float32)
    outs = []
    for layer, p in ((cpu_layer, params), (gpu_layer, gpu_params)):
        eng = MoeDecodeEngine(layer, p, max_batch=8, auto_fuse=auto_fuse,
                              state_update="residual_norm")
        outs.append(eng.run([Request(uid=i, state=states[i], remaining=3)
                             for i in range(12)], chunk=2))
    for uid, ref in outs[0].items():
        err = (outs[1][uid].float() - ref).abs().max() / ref.abs().max()
        assert float(err) <= 1e-4, uid
