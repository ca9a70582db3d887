"""The CUDA kernels K3 (`fused_ffn_w8a8`), K4 (`fused_swiglu_quant`) and K5
(`grouped_gemm_w8a8`) against their plain PyTorch twins on the GPU, in
float32 and bfloat16, and the W4A8 decode engine and a SwiGLU LM engine on
the GPU against the same engines on the CPU.

These tests need an NVIDIA GPU and nvcc and skip without them (a CUDA
kernel has no CPU mode). This file imports no JAX; on a machine without
JAX run it as `python -m pytest --noconftest tests/test_torch_w8a8_gpu.py`.

Tolerances, max |kernel - twin| / max |twin| over live rows:
  * K5 0 in both types (`torch.equal`): the kernel quantizes x with the
    twin's arithmetic, the integer sums are exact and it makes the twin's
    two float32 products in the same order, so the results are equal;
  * K3 1e-6 with relu, for the same reason (the hidden and its
    re-quantization are equal too); with gelu or silu the kernel's tanhf
    or expf may differ from torch's by an ulp, which can move one int8
    hidden value by one step: 5e-3 in float32;
  * K4 1e-5 in float32 (float32 sums in another order);
  * every kernel 2e-2 in bfloat16, where the output (and K4's hidden) is
    rounded to bfloat16, a step of 2^-8 relative;
  * the W4A8 engine 2e-3: a last-bit difference of a state between the
    devices can move one int8 activation by one step in a later step.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tutel_tpu_torch import moe
from tutel_tpu_torch.csrc import build
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.ops import activations, fused_ffn, quant, w8a8
from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest
from tutel_tpu_torch.serving import MoeDecodeEngine, Request

pytestmark = pytest.mark.cuda
BF16_TOL = 2e-2


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


def _dead_rows_zero(got, counts):
    dead = (torch.arange(got.shape[1], device=got.device)[None, :, None]
            >= counts[:, None, None])
    return not torch.any(torch.where(dead, got.float(), 0.0))


def _counts(e, c, device, seed):
    counts = np.random.default_rng(seed).integers(0, c + 1, e)
    counts[0] = 0                                   # an empty expert
    counts[-1] = c                                  # a full one
    return torch.tensor(counts, dtype=torch.int32, device=device)


def _device_events(fn):
    """Names of the device events of one call of fn, from torch.profiler
    (traced again, up to 4 times, while a trace holds none: the profiler
    now and then loses a trace)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(e.device_type).endswith("CUDA")]
        if names:
            return names
    return []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_activations_on_gpu_is_bitwise_cpu(cuda, dtype):
    """The activation quantizer gives the same int8 values and scales on
    both devices (and so the JAX function's, which the CPU tests hold)."""
    x = torch.randn(64, 33, 2048, generator=torch.Generator().manual_seed(3))
    x[5, 7] = 0.0
    x = x.to(dtype)
    q, s = quant.quantize_activations(x)
    qg, sg = quant.quantize_activations(x.to(cuda))
    assert torch.equal(qg.cpu(), q) and torch.equal(sg.cpu(), s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,blocks", [(4, 1), (8, 1), (4, 2)])
def test_grouped_gemm_w8a8_kernel_matches_twin(cuda, dtype, bits, blocks):
    g = torch.Generator(device=cuda).manual_seed(bits + blocks)
    e, c, k, n = 4, 20, 768, 640            # 2 row tiles, 3 chunks, 2 strips
    x = torch.randn(e, c, k, generator=g, device=cuda).to(dtype)
    w = torch.randn(e, k, n, generator=g, device=cuda) * 0.05
    qw = quant.quantize(w, bits, shard_blocks=blocks)
    counts = _counts(e, c, cuda, bits + blocks)
    before = w8a8.grouped_gemm_w8a8.launches
    got = w8a8.grouped_gemm_w8a8(x, qw, counts)
    torch.cuda.synchronize()
    assert w8a8.grouped_gemm_w8a8.launches == before + 1
    ref = w8a8.grouped_gemm_w8a8_reference(x, qw, counts)
    assert got.dtype == dtype and torch.equal(got, ref)
    assert _dead_rows_zero(got, counts)
    # one kernel a call, x quantized inside it; block-packed INT4 is
    # unpacked to INT8 by torch ops before it
    names = _device_events(lambda: w8a8.grouped_gemm_w8a8(x, qw, counts))
    assert sum("gmm_w8a8_kernel" in name for name in names) == 1
    assert blocks != 1 or len(names) == 1, names


# live rows 0, 1, 7, 8, 9, 16, 17 and 20: one and two n-blocks of the mma
# in a 16-row tile, a second tile, empty and full experts
W8A8_COUNTS = [0, 1, 7, 8, 9, 16, 17, 20]


@pytest.mark.parametrize("routed", [0, None])
@pytest.mark.parametrize("k,n", [
    (768, 640),                     # 5 strips; 6 k-steps a warp at INT4
    (2048, 2048),                   # the MoE decode widths
    (14336, 640),                   # x quantized in several chunks a warp
    (776, 200),                     # N % 16 != 0: 4-byte loads, 32-column
])                                  # strips; a partial last k-step
@pytest.mark.parametrize("bits,blocks", [(4, 1), (4, 2), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_w8a8_tensor_cores_equal_twin(cuda, dtype, bits, blocks,
                                                   k, n, routed):
    """K5's int8 mmas, with x quantized inside the kernel, against the twin
    bit for bit, in 8-row tiles (routed 0) and in 16-row tiles with two
    row-tile groups (routed None); one launch a call, two calls equal,
    rows past the counts zeros."""
    g = torch.Generator(device=cuda).manual_seed(bits + blocks + k + n)
    e, c = len(W8A8_COUNTS), W8A8_COUNTS[-1]
    x = torch.randn(e, c, k, generator=g, device=cuda).to(dtype)
    x[2, 3] = 0.0                                   # a row of zeros: scale 1
    qw = quant.quantize(torch.randn(e, k, n, generator=g, device=cuda) * 0.05,
                        bits, shard_blocks=blocks)
    counts = torch.tensor(W8A8_COUNTS, dtype=torch.int32, device=cuda)
    before = w8a8.grouped_gemm_w8a8.launches
    got = w8a8.grouped_gemm_w8a8(x, qw, counts, routed=routed)
    again = w8a8.grouped_gemm_w8a8(x, qw, counts, routed=routed)
    torch.cuda.synchronize()
    assert w8a8.grouped_gemm_w8a8.launches == before + 2
    ref = w8a8.grouped_gemm_w8a8_reference(x, qw, counts)
    assert got.shape == (e, c, n) and got.dtype == dtype
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert _dead_rows_zero(got, counts)


@pytest.mark.parametrize("k", [768, 14336])
@pytest.mark.parametrize("strips", [1, 2, 3])
def test_grouped_gemm_w8a8_strips_per_block_equal_twin(cuda, strips, k):
    """A block walking 1, 2 or 3 strips of columns (the last group of
    strips partial at N = 640), with x quantized once for all of them
    (K = 768) or again each chunk (K = 14336), bit for bit the twin."""
    g = torch.Generator(device=cuda).manual_seed(strips + k)
    e, c, n = len(W8A8_COUNTS), W8A8_COUNTS[-1], 640
    x = torch.randn(e, c, k, generator=g, device=cuda).to(torch.bfloat16)
    qw = quant.quantize(torch.randn(e, k, n, generator=g, device=cuda) * 0.05,
                        4)
    counts = torch.tensor(W8A8_COUNTS, dtype=torch.int32, device=cuda)
    ref = w8a8.grouped_gemm_w8a8_reference(x, qw, counts)
    for rows, groups in ((16, 2), (8, 1)):
        got = w8a8._launch(x, qw, counts, (rows, groups, strips))
        assert torch.equal(got, ref), (rows, groups)


def test_grouped_gemm_w8a8_library_runs_on_tensor_cores(cuda):
    """Every instance of K5's kernel holds IMMA (int8 mma.sync), read from
    the SASS of the built library with cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    build.load("grouped_gemm_w8a8")
    sass = subprocess.run(
        [tool, "-sass", str(build.library_path("grouped_gemm_w8a8"))],
        capture_output=True, text=True, check=True).stdout
    parts = [p for p in re.split(r"\n\s*Function : ", sass)[1:]
             if "gmm_w8a8_kernel" in p.split(None, 1)[0]]
    assert len(parts) == 16 and all("IMMA." in p for p in parts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,bias,act,k", [
    (4, True, activations.relu, 128),               # K < H
    (8, True, activations.relu, 256),
    (4, False, activations.gelu, 256),
    (8, True, activations.silu, 128),
])
def test_fused_ffn_w8a8_kernel_matches_twin(cuda, dtype, bits, bias, act, k):
    g = torch.Generator(device=cuda).manual_seed(bits * 3 + k)
    e, c, h, n = 4, 20, 256, 192                    # n < t2 * bw
    x = torch.randn(e, c, k, generator=g, device=cuda).to(dtype)
    w1 = torch.randn(e, k, h, generator=g, device=cuda) * 0.05
    w2 = torch.randn(e, h, n, generator=g, device=cuda) * 0.05
    b1 = torch.randn(e, h, generator=g, device=cuda) * 0.1 if bias else None
    b2 = torch.randn(e, n, generator=g, device=cuda) * 0.1 if bias else None
    st = fused_ffn.prepare_fused_ffn(quant.quantize(w1, bits),
                                     quant.quantize(w2, bits), b1, b2, bw=128)
    counts = _counts(e, c, cuda, k)
    before = fused_ffn.fused_ffn_w8a8.launches
    got = fused_ffn.fused_ffn_w8a8(x, st, counts, activation_fn=act)
    torch.cuda.synchronize()
    assert fused_ffn.fused_ffn_w8a8.launches == before + 1
    ref = fused_ffn.fused_ffn_w8a8_reference(x, st, counts, act)
    tol = (BF16_TOL if dtype == torch.bfloat16
           else 1e-6 if act is activations.relu else 5e-3)
    assert got.shape == (e, c, n) and _rel_err(got, ref, counts) <= tol
    assert _dead_rows_zero(got, counts)


# live rows 0, 1, 7, 8, 9, 16, 17 and 20: one and two n-blocks of K3's
# mmas in a 16-row block, and a second block
TC_COUNTS = [0, 1, 7, 8, 9, 16, 17, 20]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,act,k,h,n,bw", [
    (4, activations.relu, 256, 256, 192, 128),      # N past a strip
    (8, activations.gelu, 128, 256, 192, 128),      # K < H
    (4, activations.silu, 128, 256, 96, 8),         # 4-byte loads
    (8, activations.relu, 256, 256, 160, 32),
    (4, activations.relu, 2048, 2048, 2048, 2048),  # the MoE decode widths
])
def test_fused_ffn_w8a8_tensor_cores_equal_twin(cuda, dtype, bits, act, k, h,
                                                n, bw):
    """K3's int8 mmas against the twin: bit for bit with relu (the integer
    sums are exact and the rescales the twin's); with gelu or silu the
    kernel's tanhf or expf may move one int8 hidden value by one step
    (5e-3 in float32, one bfloat16 step in bfloat16). Rows past the counts
    are zeros; two calls are bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(bits * 7 + k + bw)
    e, c = len(TC_COUNTS), TC_COUNTS[-1]
    x = torch.randn(e, c, k, generator=g, device=cuda).to(dtype)
    w1 = torch.randn(e, k, h, generator=g, device=cuda) * 0.05
    w2 = torch.randn(e, h, n, generator=g, device=cuda) * 0.05
    b1 = torch.randn(e, h, generator=g, device=cuda) * 0.1
    b2 = torch.randn(e, n, generator=g, device=cuda) * 0.1
    st = fused_ffn.prepare_fused_ffn(quant.quantize(w1, bits),
                                     quant.quantize(w2, bits), b1, b2, bw=bw)
    counts = torch.tensor(TC_COUNTS, dtype=torch.int32, device=cuda)
    got = fused_ffn.fused_ffn_w8a8(x, st, counts, activation_fn=act)
    again = fused_ffn.fused_ffn_w8a8(x, st, counts, activation_fn=act)
    torch.cuda.synchronize()
    ref = fused_ffn.fused_ffn_w8a8_reference(x, st, counts, act)
    if act is activations.relu:
        assert torch.equal(got, ref)
    else:
        tol = BF16_TOL if dtype == torch.bfloat16 else 5e-3
        assert _rel_err(got, ref, counts) <= tol
    assert torch.equal(got, again) and _dead_rows_zero(got, counts)


@pytest.mark.parametrize("routed", [0, None])
@pytest.mark.parametrize("bits,k,h,n,bw", [
    (4, 200, 2048, 200, 128),       # 16 tiles, a partial k-step
    (8, 136, 512, 300, 256),        # a partial k-step, fc2 past n
    (8, 256, 4096, 256, 2048),      # K < H, 8-row tiles
    (4, 256, 7168, 128, 128),       # 4-row tiles over 56 tiles
])
def test_fused_ffn_w8a8_edges(cuda, bits, k, h, n, bw, routed):
    """K3 at its edges against the twin, bit for bit (relu): many tiles,
    k-steps past the phase's rows, fc2 columns past n, 4-row tiles at a
    7168-wide hidden (the widest a prepared stream takes is 7,264); two
    calls bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(bits + k + h)
    e, c = 3, 20
    x = torch.randn(e, c, k, generator=g, device=cuda).to(torch.bfloat16)
    w1 = torch.randn(e, k, h, generator=g, device=cuda) * 0.05
    w2 = torch.randn(e, h, n, generator=g, device=cuda) * 0.05
    b1 = torch.randn(e, h, generator=g, device=cuda) * 0.1
    b2 = torch.randn(e, n, generator=g, device=cuda) * 0.1
    st = fused_ffn.prepare_fused_ffn(quant.quantize(w1, bits),
                                     quant.quantize(w2, bits), b1, b2, bw=bw)
    counts = torch.tensor([0, 9, 20], dtype=torch.int32, device=cuda)
    got = fused_ffn.fused_ffn_w8a8(x, st, counts,
                                   activation_fn=activations.relu,
                                   routed=routed)
    again = fused_ffn.fused_ffn_w8a8(x, st, counts,
                                     activation_fn=activations.relu,
                                     routed=routed)
    ref = fused_ffn.fused_ffn_w8a8_reference(x, st, counts, activations.relu)
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert _dead_rows_zero(got, counts)


# (bits, (E, C, K, H, N), bw): the C given is replaced by 20 and 1100
SWIGLU_SHAPES = [
    (4, (4, 20, 256, 512, 384), 128),               # N != H
    (8, (3, 20, 128, 256, 256), 128),               # K < H
    (4, (3, 20, 128, 256, 256), 128),
    (4, (3, 20, 128, 512, 96), 128),                # N < bw
    (4, (3, 20, 128, 512, 96), 8),                  # bw % 16: 4-byte loads
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,shape,bw,split,c", [
    (bits, shape, bw, split, c) for bits, shape, bw in SWIGLU_SHAPES
    for split in (1, 2, 8) for c in (20, 1100)
    # H = 256 at INT4: 128 packed rows hold at most 4 slices
    if split <= (shape[3] // 2 if bits == 4 else shape[3]) // 32])
def test_fused_swiglu_kernel_matches_twin(cuda, dtype, bits, shape, bw,
                                          split, c):
    """K4 with its hidden split pinned to 1, 2 or 8 slices against the
    twin; an empty expert, an odd live count, a full expert, 4-row tiles
    at 20 rows an expert (16-byte loads, 4-byte where the tile width is
    not a multiple of 16) and 16-row tiles at 1100 (an odd count of 1089
    leaves a 16-row tile one row); two calls bitwise equal."""
    e, _, k, h, n = shape
    g = torch.Generator(device=cuda).manual_seed(bits + k)
    x = torch.randn(e, c, k, generator=g, device=cuda).to(dtype)
    ws = [quant.quantize(torch.randn(*s, generator=g, device=cuda) * 0.05,
                         bits) for s in ((e, k, h), (e, k, h), (e, h, n))]
    st = fused_ffn.prepare_fused_swiglu(*ws, bw=bw)
    counts = _counts(e, c, cuda, h)
    counts[1] = 7 if c == 20 else c - 11            # an odd live count
    ref = fused_ffn.fused_swiglu_quant_reference(x, st, counts)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
    before = fused_ffn.fused_swiglu_quant.launches
    got = fused_ffn.fused_swiglu_quant(x, st, counts, split=split)
    again = fused_ffn.fused_swiglu_quant(x, st, counts, split=split)
    torch.cuda.synchronize()
    assert fused_ffn.fused_swiglu_quant.launches == before + 2
    assert got.shape == (e, c, n) and _rel_err(got, ref, counts) <= tol
    assert torch.equal(got, again)
    assert _dead_rows_zero(got, counts)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        fused_ffn.fused_swiglu_quant(x, st, counts, activation_fn=torch.tanh)


@pytest.mark.parametrize("auto_fuse", [True, False])
def test_w4a8_engine_on_gpu_matches_cpu(cuda, auto_fuse):
    kw = dict(gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
              experts={"type": "ffn", "num_experts_per_device": 8,
                       "hidden_size_per_expert": 256, "activation_bits": 8},
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
    counter = (fused_ffn.fused_ffn_w8a8 if auto_fuse
               else w8a8.grouped_gemm_w8a8)
    outs = []
    for layer, p in ((cpu_layer, params), (gpu_layer, gpu_params)):
        before = counter.launches
        eng = MoeDecodeEngine(layer, p, max_batch=8, auto_fuse=auto_fuse,
                              state_update="residual_norm")
        outs.append(eng.run([Request(uid=i, state=states[i], remaining=3)
                             for i in range(12)], chunk=2))
    assert counter.launches > before                # the GPU run launched
    for uid, ref in outs[0].items():
        err = (outs[1][uid].float().cpu() - ref).abs().max() / ref.abs().max()
        assert float(err) <= 2e-3, uid


def test_swiglu_lm_engine_on_gpu_matches_cpu(cuda):
    cfg = TransformerMoEConfig(
        vocab_size=97, max_len=128, model_dim=128, num_heads=2,
        num_kv_heads=1, num_layers=2, ffn_hidden=256, moe_every=2,
        num_local_experts=4, top_k=2, capacity_factor=0.0, expert_hidden=256,
        kv_bits=8, expert_type="llama_ffn")
    models = [TransformerMoE(cfg, device=d) for d in ("cpu", cuda)]
    params = models[0].init(torch.Generator().manual_seed(0))
    moe_p = params["blocks"][1]["moe"]
    moe_p["experts"] = quant.quantize_expert_params(moe_p["experts"], 4)

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cuda(v) for v in tree]
        return tree.to(cuda)

    gparams = to_cuda(params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, n).astype(np.int32)
               for n in (5, 40, 17, 9)]
    toks = []
    before = fused_ffn.fused_swiglu_quant.launches
    for model, p in zip(models, (params, gparams)):
        eng = LmDecodeEngine(model, p, max_batch=2)
        toks.append(eng.run([LmRequest(uid=i, prompt=pr, max_new_tokens=6)
                             for i, pr in enumerate(prompts)], chunk=3))
    assert fused_ffn.fused_swiglu_quant.launches > before
    for uid, ref in toks[0].items():
        assert toks[1][uid].tolist() == ref.tolist(), uid
