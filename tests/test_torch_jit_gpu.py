"""The runtime kernels K9 (`jit.inject_kernel`) and K10 (`jit.pallas_kernel`)
on the GPU: against their plain twins at the shapes of chip_smoke.py, the
build cache, and the errors a launch or a build reports.

These tests need an NVIDIA GPU and nvcc and skip without them (a CUDA
kernel has no CPU mode). This file imports no JAX; on a machine without
JAX run it as `python -m pytest --noconftest tests/test_torch_jit_gpu.py`.
"""

import numpy as np
import pytest
import torch

from tutel_tpu_torch import jit
from tutel_tpu_torch.csrc import build
from tutel_tpu_torch.experts import ffn
from tutel_tpu_torch.ops import fused_ffn, grouped_gemm_quant, quant

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.float16: 1e-2, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def scale_source(rows, cols, tile_rows=128, threads=256):
    """`o = x * s[0] + 1` over [rows, cols] float32, one tile of tile_rows
    rows per block, 16-byte loads."""
    return f"""
// [thread_extent] blockIdx.x = {rows // tile_rows}
// [thread_extent] threadIdx.x = {threads}
__global__ void __launch_bounds__({threads})
scale_plus_one(const float4* __restrict__ x, const float* __restrict__ s,
               float4* __restrict__ o) {{
  const float k = s[0];
  const long long base = (long long)blockIdx.x * {tile_rows * cols // 4};
  for (int i = threadIdx.x; i < {tile_rows * cols // 4}; i += blockDim.x) {{
    float4 v = x[base + i];
    v.x = v.x * k + 1.f; v.y = v.y * k + 1.f;
    v.z = v.z * k + 1.f; v.w = v.w * k + 1.f;
    o[base + i] = v;
  }}
}}
"""


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.parametrize("rows,cols,tile", [(256, 128, 128),
                                            (16384, 2048, 16)])
def test_inject_kernel_matches_twin(cuda, rows, cols, tile):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, cols, generator=g, device=cuda)
    s = torch.full((1, 1), 3.0, device=cuda)
    f = jit.inject_kernel(scale_source(rows, cols, tile),
                          out_shape=lambda a, b: (a.shape, a.dtype),
                          plain=lambda a, b: a * b[0, 0] + 1)
    before = jit.inject_kernel.launches
    got = f(x, s)
    torch.cuda.synchronize()
    assert f.launches == 1 and jit.inject_kernel.launches == before + 1
    assert _rel(got, f(x.cpu(), s.cpu()).to(cuda)) <= TOL[torch.float32]


def test_grid_override_and_dynamic_shared_memory(cuda):
    src = """
// [thread_extent] blockIdx.x = 2
// [thread_extent] threadIdx.x = 1
__global__ void grid_size(const float* x, float* o) {
  o[blockIdx.x] = (float)gridDim.x;
}
"""
    x = torch.zeros(1, device=cuda)
    two = jit.inject_kernel(src, out_shape=((2,), torch.float32))(x)
    four = jit.inject_kernel(src, out_shape=((4,), torch.float32),
                             grid=4)(x)
    assert two.tolist() == [2.0] * 2 and four.tolist() == [4.0] * 4
    # 64 KB of dynamic shared memory: above the default 48 KB limit
    shared = """
// [thread_extent] blockIdx.x = 4
// [thread_extent] threadIdx.x = 1024
__global__ void through_shared(const float* x, float* o) {
  extern __shared__ float buf[];
  const int n = 16384, base = blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    o[base + i] = buf[n - 1 - i];
}
"""
    x = torch.randn(4, 16384, device=cuda)
    got = jit.inject_kernel(shared, out_shape=((4, 16384), torch.float32),
                            scratch_bytes=65536)(x)
    assert torch.equal(got, x.flip(1))


def test_a_second_call_does_not_rebuild(cuda, monkeypatch):
    src = scale_source(256, 128)
    x, s = torch.randn(256, 128, device=cuda), torch.ones(1, 1, device=cuda)
    first = jit.inject_kernel(src, out_shape=((256, 128), torch.float32))(
        x, s)
    lift = jit.pallas_kernel(lambda v: torch.relu(v) ** 2)
    lift(x)

    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc ran again for a source already built")
    monkeypatch.setattr(build.subprocess, "Popen", no_nvcc)
    again = jit.inject_kernel(src, out_shape=((256, 128), torch.float32))
    assert torch.equal(again(x, s), first) and again.launches == 1
    assert torch.equal(jit.pallas_kernel(lambda v: torch.relu(v) ** 2)(x),
                       lift(x))
    assert (build.BUILD_DIR / f"{build.source_name(again.source)}.so").exists()


def test_refused_launch_and_failed_build_raise(cuda):
    x = torch.zeros(8, device=cuda)
    too_many = jit.inject_kernel(
        "// [thread_extent] blockIdx.x = 1\n"
        "// [thread_extent] threadIdx.x = 2048\n"
        "__global__ void k(const float* x, float* o) { o[0] = x[0]; }",
        out_shape=((1,), torch.float32))
    with pytest.raises(RuntimeError, match="CUDA error"):
        too_many(x)
    assert too_many.launches == 0
    # the error is cleared: the next launch runs
    ok = jit.inject_kernel(scale_source(256, 128),
                           out_shape=((256, 128), torch.float32))
    ok(torch.ones(256, 128, device=cuda), torch.ones(1, 1, device=cuda))
    torch.cuda.synchronize()
    broken = jit.inject_kernel(
        "// [thread_extent] blockIdx.x = 1\n"
        "// [thread_extent] threadIdx.x = 1\n"
        "__global__ void k(const float* x, float* o) { o[0] = nothing; }",
        out_shape=((1,), torch.float32))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        broken(x)
    with pytest.raises(ValueError, match="takes 3 pointers"):
        ok(x)


SQUARED_RELU = jit.pallas_kernel(lambda v: torch.relu(v) ** 2)
GELU_TANH = jit.pallas_kernel(lambda v: 0.5 * v * (1 + torch.tanh(
    0.7978845608 * (v + 0.044715 * v ** 3))))


@pytest.mark.parametrize("shape,dtype", [
    ((128, 32, 2048), torch.bfloat16),          # the decode server's hidden
    ((32, 8192, 2048), torch.bfloat16),         # an LM prefill chunk's
    ((128, 32, 2048), torch.float32),
    ((3, 1001), torch.float16),                 # a tail past the vectors
    ((5, 999), torch.bfloat16),
])
@pytest.mark.parametrize("kernel", [SQUARED_RELU, GELU_TANH],
                         ids=["squared_relu", "gelu_tanh"])
def test_pallas_kernel_matches_twin(cuda, kernel, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(len(shape))
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    before = (kernel.launches, jit.pallas_kernel.launches)
    got = kernel(x)
    torch.cuda.synchronize()
    assert (kernel.launches, jit.pallas_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == x.shape and got.dtype == dtype
    assert _rel(got, kernel.fn(x)) <= TOL[dtype]
    # one rounding: the kernel is the float32 statements rounded once
    exact = kernel.lifted.evaluate(x).to(dtype)
    assert _rel(got, exact) <= (TOL[torch.float32] if dtype == torch.float32
                                else 1e-2)


def test_pallas_kernel_unaligned_input(cuda):
    buf = torch.randn(4099, device=cuda).to(torch.bfloat16)
    x = buf[1:]                                  # 2 bytes off 16
    assert x.data_ptr() % 16
    got = SQUARED_RELU(x)
    assert _rel(got, SQUARED_RELU.fn(x)) <= TOL[torch.bfloat16]
    with pytest.raises(ValueError, match="contiguous"):
        SQUARED_RELU(torch.randn(64, 64, device=cuda).t())


def test_lifted_activation_on_the_expert_paths(cuda):
    """The two-call INT4 FFN and the float FFN run K10 between their
    products and agree with the CPU; the fused kernel takes only relu or
    gelu codes and refuses a lifted activation (as does the JAX fused
    kernel, which would nest a pallas_call in its body)."""
    rng = np.random.default_rng(5)
    e, c, m, h = 4, 16, 128, 256
    x = torch.from_numpy(rng.standard_normal((e, c, m)).astype(np.float32))
    params = {"fc1_w": torch.from_numpy(
                  rng.standard_normal((e, m, h)).astype(np.float32) * 0.05),
              "fc2_w": torch.from_numpy(
                  rng.standard_normal((e, h, m)).astype(np.float32) * 0.05)}
    net = ffn.FusedExpertsNetwork(model_dim=m, hidden_size_per_expert=h,
                                  num_experts_per_device=e,
                                  activation_fn=SQUARED_RELU,
                                  has_fc1_bias=False, has_fc2_bias=False)
    qparams = quant.quantize_expert_params(params, 4)
    counts = torch.tensor([16, 0, 5, 9], dtype=torch.int32)
    gemm = grouped_gemm_quant.grouped_gemm_quant
    for p, gemms in ((params, 0), (qparams, 2)):
        ctx = type("Ctx", (), {"dispatch_count": counts})()
        ref = net.apply(p, x, ctx)
        before = (SQUARED_RELU.launches, gemm.launches)
        got = net.apply({k: v.to(cuda) for k, v in p.items()}, x.to(cuda),
                        ctx)
        assert (SQUARED_RELU.launches, gemm.launches) == (
            before[0] + 1, before[1] + gemms)
        assert _rel(got.cpu(), ref) <= 1e-4
    stream = fused_ffn.prepare_fused_ffn(
        *(qparams[k].to(cuda) for k in ("fc1_w", "fc2_w")))
    with pytest.raises(ValueError, match="no CUDA kernel"):
        fused_ffn.fused_ffn_quant(x.to(cuda), stream,
                                  activation_fn=SQUARED_RELU)


# -- the launch path: one packed record per call -----------------------------

def test_launches_replay_in_a_cuda_graph(cuda):
    """A K9 and a K10 launch captured in a CUDA graph, replayed on new data
    copied into the captured inputs, equal their twins each time."""
    f = jit.inject_kernel(scale_source(256, 128),
                          out_shape=((256, 128), torch.float32),
                          plain=lambda a, b: a * b[0, 0] + 1)
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(256, 128, generator=g, device=cuda)
    s = torch.full((1, 1), 3.0, device=cuda)
    h = torch.randn(4, 32, 2048, generator=g, device=cuda).to(torch.bfloat16)
    side = torch.cuda.Stream()       # warm up beside the capture's stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        f(x, s)
        GELU_TANH(h)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (f.launches, GELU_TANH.launches)
    with torch.cuda.graph(graph):
        y, z = f(x, s), GELU_TANH(h)
    # the capture launched each once; a replay goes around the wrappers
    assert (f.launches, GELU_TANH.launches) == (before[0] + 1, before[1] + 1)
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=g, device=cuda))
        h.copy_(torch.randn(h.shape, generator=g, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert _rel(y, x * 3 + 1) <= TOL[torch.float32]
        assert _rel(z, GELU_TANH.fn(h)) <= TOL[torch.bfloat16]
        assert _rel(z, GELU_TANH.lifted.evaluate(h).to(torch.bfloat16)) \
            <= 1e-2


SPIN = """
// [thread_extent] blockIdx.x = 1
// [thread_extent] threadIdx.x = 1
__global__ void spin(const long long* cycles, long long* o) {
  const long long start = clock64();
  while (clock64() - start < cycles[0]) {}
  o[0] = 1;
}
"""


def test_a_launch_runs_on_the_current_stream(cuda):
    """Inside `torch.cuda.stream(side)` K9 and K10 launch on `side`: behind
    a spinning kernel on `side` and a copy queued after it, they read the
    copied data, and the default stream stays idle meanwhile."""
    spin = jit.inject_kernel(SPIN, out_shape=((1,), torch.int64))
    cycles = torch.tensor([200_000_000], device=cuda)      # about 0.1 s
    f = jit.inject_kernel(scale_source(256, 128),
                          out_shape=((256, 128), torch.float32))
    src = torch.randn(256, 128, device=cuda)
    x, s = torch.zeros(256, 128, device=cuda), torch.ones(1, 1, device=cuda)
    hsrc = torch.randn(8, 1024, device=cuda).to(torch.bfloat16)
    h = torch.zeros_like(hsrc)
    spin(torch.zeros_like(cycles))               # built and loaded first
    f(x, s)
    SQUARED_RELU(h)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        done = spin(cycles)
        x.copy_(src)
        h.copy_(hsrc)
        y, z = f(x, s), SQUARED_RELU(h)
    assert not side.query() and torch.cuda.default_stream().query()
    side.synchronize()
    assert done.item() == 1
    assert _rel(y, src + 1) <= TOL[torch.float32]
    assert torch.equal(z, SQUARED_RELU.lifted.evaluate(hsrc).to(
        torch.bfloat16))


def test_interleaved_injected_kernels_keep_their_arguments(cuda):
    plus = jit.inject_kernel(scale_source(256, 128),
                             out_shape=((256, 128), torch.float32))
    tiles = jit.inject_kernel(scale_source(512, 128, tile_rows=64),
                              out_shape=((512, 128), torch.float32))
    g = torch.Generator(device=cuda).manual_seed(12)
    calls = []
    for i in range(6):
        f, rows = (plus, 256) if i % 2 == 0 else (tiles, 512)
        x = torch.randn(rows, 128, generator=g, device=cuda)
        s = torch.full((1, 1), float(i), device=cuda)
        calls.append((f(x, s), x, s))
    torch.cuda.synchronize()
    for got, x, s in calls:
        assert _rel(got, x * s[0, 0] + 1) <= TOL[torch.float32]
    assert (plus.launches, tiles.launches) == (3, 3)


SHARED_PROBE = """
// [thread_extent] blockIdx.x = 2
// [thread_extent] threadIdx.x = 256
__global__ void shared_probe(const float* x, float* o) {
  extern __shared__ float buf[];
  unsigned bytes;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(bytes));
  const int n = bytes / 4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[0] + i;
  __syncthreads();
  if (threadIdx.x == 0) {
    o[2 * blockIdx.x] = (float)bytes;
    o[2 * blockIdx.x + 1] = buf[n - 1];
  }
}
"""


def test_dynamic_shared_memory_grows_between_launches(cuda):
    """One kernel asking for 64 KB, then 96 KB, then 64 KB again: the
    trampoline raises the limit when a launch asks for more than the
    device allows it, and every launch runs."""
    x = torch.full((1,), 0.5, device=cuda)
    for kb in (64, 96, 64):
        f = jit.inject_kernel(SHARED_PROBE, out_shape=((4,), torch.float32),
                              scratch_bytes=kb * 1024)
        got = f(x).tolist()
        n = kb * 1024 // 4
        assert got == [kb * 1024.0, 0.5 + n - 1] * 2, kb


def test_a_launch_keeps_the_callers_device(cuda):
    f = jit.inject_kernel(scale_source(256, 128),
                          out_shape=((256, 128), torch.float32))
    for index in range(min(torch.cuda.device_count(), 2)):
        x = torch.randn(256, 128, device=f"cuda:{index}")
        s = torch.ones(1, 1, device=f"cuda:{index}")
        for current in range(min(torch.cuda.device_count(), 2)):
            torch.cuda.set_device(current)
            y = f(x, s)
            assert torch.cuda.current_device() == current
            assert y.device == x.device
            assert _rel(y, x + 1) <= TOL[torch.float32]
            SQUARED_RELU(x)
            assert torch.cuda.current_device() == current
    torch.cuda.set_device(0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pallas_kernel_grid_from_occupancy(cuda, dtype):
    """The grid: at most the lifted body's occupancy times the SMs while
    the output fits in the 50 MB L2 (a 20-40 MB tensor takes several grid
    steps, the last one partial), one block per step past it (60-120 MB).
    K10 matches its float32 statements exactly on both, aligned and one
    element off."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for size in (10_000_011, 30_000_011):
        buf = torch.randn(size, device=cuda).to(dtype)
        for x in (buf[:-1], buf[1:]):
            got = SQUARED_RELU(x)
            launcher, per_block, blocks, in_l2, device = \
                SQUARED_RELU._geometry[(dtype, 0)]
            occupancy = launcher.occupancy(jit._THREADS, 0, 0)
            assert 1 <= occupancy <= 2048 // jit._THREADS
            assert blocks == occupancy * sms and device == 0
            assert per_block == \
                jit._THREADS * jit._UNROLL * 16 // x.element_size()
            fits = x.numel() <= in_l2
            assert fits == (size == 10_000_011)
            if fits:
                assert x.numel() > per_block * blocks   # several grid steps
            assert torch.equal(got, SQUARED_RELU.lifted.evaluate(x).to(dtype))
