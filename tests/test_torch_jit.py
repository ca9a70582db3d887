"""Port parity: tutel_tpu_torch.jit against tutel_tpu.jit on the CPU.

K9 (`inject_kernel`) runs its `plain=` twin here and K10 (`pallas_kernel`)
runs `fn(x)`; the JAX functions run their Pallas kernels in interpret
mode. The CUDA text cannot be compiled here, so the parts around it are
tested instead: the parsing of the launch geometry and the kernel's
signature, the generated trampoline, and the tracer, whose float32
statements (`Lifted.evaluate`, the kernel's arithmetic in PyTorch) are
held against fn(x) op by op. The kernels themselves are held against
their twins on the GPU (tests/test_torch_jit_gpu.py, chip_smoke.py).
"""

import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tutel_tpu import jit as jjit
from tutel_tpu import moe as jmoe
from tutel_tpu.ops import quant as jq
from tutel_tpu_torch import convert, jit
from tutel_tpu_torch import moe as tmoe

torch.set_num_threads(1)
F = torch.nn.functional

# test_facade's tiled `x * s + 1` as CUDA: two blocks, each a 128 x 128 tile
SCALE_SRC = """
// [thread_extent] blockIdx.x = 2
// [thread_extent] threadIdx.x = 256
__global__ void __launch_bounds__(256)
scale_plus_one(const float* __restrict__ x, const float* __restrict__ s,
               float* __restrict__ o) {
  const int base = blockIdx.x * 128 * 128;      // this block's tile
  for (int i = threadIdx.x; i < 128 * 128; i += blockDim.x)
    o[base + i] = x[base + i] * s[0] + 1.f;
}
"""


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_compile_returns_the_function():
    def f(v):
        return v + 1
    assert jit.compile(f) is f


def test_thread_extent_and_kernel_name_parsing():
    assert jit.thread_extents(SCALE_SRC) == ((2, 1, 1), (256, 1, 1))
    src = ("// [thread_extent] threadIdx.x = 32\n"
           "//[thread_extent] threadIdx.y=4\n"
           "// [thread_extent] blockIdx.z = 3\n")
    assert jit.thread_extents(src) == ((1, 1, 3), (32, 4, 1))
    assert jit.thread_extents("__global__ void k() {}") == (None, None)
    with pytest.raises(ValueError, match="two"):
        jit.thread_extents(src + "// [thread_extent] threadIdx.y = 8\n")
    assert jit.kernel_signature(SCALE_SRC) == ("scale_plus_one", 3)
    assert jit.kernel_signature(
        'extern "C" __global__ void k(void) {}') == ("k", 0)
    assert jit.kernel_signature(
        "// a __global__ in a comment\n/* __global__ void no(int a) */\n"
        "__global__ __launch_bounds__(128, 2) void k2(Pair<int, 2>* p,\n"
        "    const float (*t)[4], int n) {}") == ("k2", 3)
    for bad in ("__device__ void k(float* x) {}",
                "__global__ void a(float* x) {}\n__global__ void b() {}",
                "template <int N> __global__ void t(float* x) {}"):
        with pytest.raises(ValueError, match="exactly one __global__"):
            jit.kernel_signature(bad)


def test_generated_trampoline():
    text = jit.trampoline("scale_plus_one", 3)
    assert 'extern "C" int tt_jit_launch(const void* data)' in text
    assert "if (r.nargs != 3) return (int)cudaErrorInvalidValue;" in text
    assert "void* params[3];" in text
    assert "cudaLaunchKernel((const void*)scale_plus_one," in text
    assert "reinterpret_cast<cudaStream_t>(r.stream)" in text
    # the device: switched only when the caller's differs, then restored
    assert "caller != r.device" in text and "cudaSetDevice(caller)" in text
    # the shared memory limit: raised only past what the device allows
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in text
    assert "if (err == cudaSuccess && r.smem > 48 * 1024)" in text
    assert "if (smem <= allowed.load(std::memory_order_acquire))" in text
    assert "cudaGetLastError()" in text and "tt_error_string" in text
    # the occupancy query only where asked for (K10's text)
    assert "tt_jit_occupancy" not in text
    query = jit.trampoline("scale_plus_one", 3, occupancy=True)
    assert 'extern "C" int tt_jit_occupancy(int threads, int smem' in query
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in query
    f = jit.inject_kernel(SCALE_SRC, out_shape=((256, 128), torch.float32))
    assert f.source == SCALE_SRC + text and f.launches == 0
    # the K10 text: the template behind its four definitions (the block
    # shape from jit.py), K9's trampoline with the occupancy query
    k = jit.pallas_kernel(lambda v: torch.relu(v) ** 2)
    src = k.cuda_source(torch.bfloat16)
    assert src.startswith(
        f"#define TT_DTYPE 1\n#define TT_THREADS {jit._THREADS}\n"
        f"#define TT_UNROLL {jit._UNROLL}\n"
        "#define TT_BODY const float t0 = tt_relu(v); "
        "const float t1 = tt_powi(t0, 2); return t1;\n")
    assert jit.ELEMENTWISE.read_text() in src
    assert src.endswith(jit.trampoline("tt_elementwise", 3, occupancy=True))
    # a kernel without parameters keeps one unused slot
    assert "unsigned long long args[1];" in jit.trampoline("k", 0)
    assert "if (r.nargs != 0)" in jit.trampoline("k", 0)


_FIELD = re.compile(r"static_assert\(offsetof\(tt_jit_record, (\w+)\) == "
                    r"(\d+), ")
_SIZE = re.compile(r"static_assert\(sizeof\(tt_jit_record\) == "
                   r"(\d+) \+ (\d+) \* (\d+), ")


@pytest.mark.parametrize("arity", [0, 1, 3, 7])
def test_launch_record_layout_matches_the_trampoline(arity):
    """The record `_Launcher.pack` builds, read back at the offsets the
    trampoline's static_asserts give the C struct (which nvcc checks), so
    that the Python and C layouts cannot drift apart."""
    params = ", ".join(f"float* p{i}" for i in range(arity))
    launcher = jit._Launcher(f"__global__ void k({params}) {{}}")
    text = jit.trampoline("k", arity)
    assert launcher.text.endswith(text)
    offsets = {name: int(at) for name, at in _FIELD.findall(text)}
    assert sorted(offsets) == ["args", "block", "device", "grid", "nargs",
                               "smem", "stream"]
    head, slot, slots = map(int, _SIZE.search(text).groups())
    args = [0x7F00_0000_0000 + 256 * i for i in range(arity)]
    if arity:
        args[-1] = 2 ** 63 - 1                  # a 64-bit int (K10's n)
    grid, block = (1000, 3, 2), (256, 4, 1)
    stream = 0x5555_AAAA_0000_1234
    record = launcher.pack(args, grid, block, 98304, 5, stream)
    assert len(record) == head + slot * slots == launcher.record.size
    assert slots == max(arity, 1)

    def at(name, fmt, i=0):
        return struct.unpack_from("<" + fmt, record,
                                  offsets[name] + i * struct.calcsize(fmt))
    assert at("nargs", "q") == (arity,)
    assert at("stream", "Q") == (stream,)
    assert at("grid", "3i") == grid and at("block", "3i") == block
    assert at("smem", "i") == (98304,) and at("device", "i") == (5,)
    assert [at("args", "Q", i)[0] for i in range(slots)] == (args or [0])
    with pytest.raises(struct.error):           # one slot per argument
        launcher.pack(args + [1], grid, block, 0, 0, stream)


def test_a_second_call_neither_relifts_nor_reparses(monkeypatch):
    k = jit.pallas_kernel(lambda v: torch.relu(v) ** 2)
    x = torch.randn(8, 4)
    first = k(x)
    lifted, launcher = k.lifted, k._launcher(torch.bfloat16)
    f = jit.inject_kernel(SCALE_SRC, out_shape=((256, 128), torch.float32),
                          plain=lambda a, b: a * b[0, 0] + 1)
    a, s = torch.randn(256, 128), torch.ones(1, 1)
    f(a, s)

    def refuse(*args, **kwargs):
        raise AssertionError("traced or parsed again")
    for name in ("lift", "kernel_signature", "thread_extents", "_out_specs"):
        monkeypatch.setattr(jit, name, refuse)
    monkeypatch.setattr(jit.torch.fx, "symbolic_trace", refuse)
    assert torch.equal(k(x), first) and k.lifted is lifted
    assert k._launcher(torch.bfloat16) is launcher
    assert torch.equal(f(a, s), a + 1)
    assert k.launches == 0 and f.launches == 0


def _facade_jax(out_shape):
    def body(x_ref, s_ref, o_ref):
        o_ref[...] = x_ref[...] * s_ref[0, 0] + 1.0
    return jjit.inject_kernel(
        body, out_shape=out_shape, grid=(2,),
        in_specs=[pl.BlockSpec((128, 128), lambda i: (i, 0)),
                  pl.BlockSpec((1, 1), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((128, 128), lambda i: (i, 0)),
        interpret=True)


@pytest.mark.parametrize("form", ["pair", "callable"])
def test_inject_kernel_plain_matches_jax(form):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    s = np.full((1, 1), 3.0, np.float32)
    if form == "pair":
        jshape = jax.ShapeDtypeStruct((256, 128), jnp.float32)
        tshape = ((256, 128), torch.float32)
    else:
        def jshape(a, b):
            return jax.ShapeDtypeStruct(a.shape, a.dtype)

        def tshape(a, b):
            return (a.shape, a.dtype)
    ref = _facade_jax(jshape)(jnp.asarray(x), jnp.asarray(s))
    before = jit.inject_kernel.launches
    f = jit.inject_kernel(SCALE_SRC, out_shape=tshape,
                          plain=lambda a, b: a * b[0, 0] + 1)
    got = f(torch.from_numpy(x), torch.from_numpy(s))
    assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-6
    got2 = f(torch.from_numpy(x) * 2, torch.from_numpy(s))   # re-invoked
    assert _rel(got2, np.asarray(x) * 6 + 1) <= 1e-6
    # the CPU runs the twin: no launch is counted
    assert f.launches == 0 and jit.inject_kernel.launches == before


def test_inject_kernel_with_two_outputs_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    s = np.full((1, 1), -0.5, np.float32)

    def body(x_ref, s_ref, o_ref, p_ref):
        o_ref[...] = x_ref[...] * s_ref[0, 0] + 1.0
        p_ref[...] = x_ref[...] * s_ref[0, 0]
    spec = pl.BlockSpec((128, 128), lambda i: (i, 0))
    shape = jax.ShapeDtypeStruct((256, 128), jnp.float32)
    refs = jjit.inject_kernel(
        body, out_shape=[shape, shape], grid=(2,),
        in_specs=[spec, pl.BlockSpec((1, 1), lambda i: (0, 0))],
        out_specs=[spec, spec], interpret=True)(jnp.asarray(x),
                                                jnp.asarray(s))
    src = SCALE_SRC.replace("float* __restrict__ o)", "float* o, float* p)")
    f = jit.inject_kernel(
        src, out_shape=[((256, 128), torch.float32)] * 2,
        plain=lambda a, b: (a * b[0, 0] + 1, a * b[0, 0]))
    got = f(torch.from_numpy(x), torch.from_numpy(s))
    assert isinstance(got, tuple) and len(got) == 2
    for g, r in zip(got, refs):
        assert _rel(g, r) <= 1e-6


def test_inject_kernel_refusals():
    x, s = torch.zeros(256, 128), torch.ones(1, 1)
    f = jit.inject_kernel(SCALE_SRC, out_shape=((256, 128), torch.float32))
    with pytest.raises(RuntimeError, match="cannot run on the CPU"):
        f(x, s)                                   # no plain twin
    with pytest.raises(ValueError, match="no `// \\[thread_extent\\] thread"):
        jit.inject_kernel("// [thread_extent] blockIdx.x = 2\n"
                          "__global__ void k(float* o) {}",
                          out_shape=((2,), torch.float32))
    with pytest.raises(ValueError, match="no grid"):
        jit.inject_kernel("// [thread_extent] threadIdx.x = 2\n"
                          "__global__ void k(float* o) {}",
                          out_shape=((2,), torch.float32))
    g = jit.inject_kernel("// [thread_extent] threadIdx.x = 2\n"
                          "__global__ void k(float* o) {}", grid=(4, 2),
                          out_shape=((2,), torch.float32))
    assert g.launches == 0
    with pytest.raises(ValueError, match="grid must be"):
        jit.inject_kernel(SCALE_SRC, grid=(0,), out_shape=((2,), torch.float32))
    wrong = jit.inject_kernel(SCALE_SRC, out_shape=((256, 128), torch.float32),
                              plain=lambda a, b: a[:1])
    with pytest.raises(ValueError, match="plain returned"):
        wrong(x, s)
    with pytest.raises(TypeError, match="scalar"):
        wrong(x, 3.0)
    with pytest.raises(TypeError, match="out_shape"):
        jit.inject_kernel(SCALE_SRC, out_shape=(256, 128), plain=wrong)(x, s)
    with pytest.raises(ValueError, match="cpu or cuda"):
        f(x.to("meta"), s.to("meta"))


# one function per supported traced form; each lifted, then evaluated as
# the kernel would compute it (float32) and held against fn(x)
TRACED = {
    "add": lambda v: v + 1.5, "radd": lambda v: 2 + v,
    "sub": lambda v: v - 0.25, "rsub": lambda v: 1 - v,
    "mul": lambda v: v * v * 3, "div": lambda v: v / 7, "rdiv": lambda v: 1 / (v * v + 1),
    "pow2": lambda v: v ** 2, "pow3": lambda v: v ** 3, "pow_neg": lambda v: (v * v + 1) ** -2,
    "pow0": lambda v: v ** 0, "pow_float": lambda v: torch.abs(v) ** 1.5,
    "neg": lambda v: -v,
    "where_gt": lambda v: torch.where(v > 0, v, 0.1 * v),
    "where_ge": lambda v: torch.where(v >= 0.5, v, -v),
    "where_lt": lambda v: torch.where(v < -0.5, 1.0, v),
    "where_le": lambda v: torch.where(v <= 0, v * v, v),
    "where_eq_ne": lambda v: torch.where(v == v, v, 0.0) + torch.where(
        v != 0, 1.0, 0.0),
    "mask_mul": lambda v: v * (v > 0),
    "relu": lambda v: torch.relu(v), "sigmoid": lambda v: torch.sigmoid(v),
    "tanh": lambda v: torch.tanh(v), "exp": lambda v: torch.exp(v),
    "log": lambda v: torch.log(torch.abs(v) + 1),
    "sqrt": lambda v: torch.sqrt(torch.abs(v)),
    "rsqrt": lambda v: torch.rsqrt(torch.abs(v) + 0.5),
    "abs": lambda v: torch.abs(v), "erf": lambda v: torch.erf(v),
    "clamp": lambda v: torch.clamp(v, -1, 0.5),
    "clamp_min_kw": lambda v: torch.clamp(v, min=0.1),
    "clamp_max_kw": lambda v: torch.clamp(v, max=-0.1),
    "maximum": lambda v: torch.maximum(v, v * v - 1),
    "minimum": lambda v: torch.minimum(v, 0.5 - v),
    "torch_arith": lambda v: torch.div(torch.mul(torch.add(v, 1), 2),
                                       torch.sub(3, torch.neg(v))),
    "torch_pow": lambda v: torch.pow(v, 2) + torch.pow(2, v),
    "methods": lambda v: (v.relu() + v.sigmoid() * v.tanh() - v.exp() / 9
                          + v.abs().log().abs() + v.abs().sqrt()
                          + (v.abs() + 1).rsqrt() + v.erf()),
    "method_arith": lambda v: v.add(1).sub(0.5).mul(v).div(3).neg().pow(2),
    "method_clamp": lambda v: v.clamp(-0.5, 0.5) + v.clamp(min=0),
    "method_maxmin": lambda v: v.maximum(-v) + v.minimum(v * 2),
    "method_where": lambda v: v.where(v > 0, -v),
    "F_relu": lambda v: F.relu(v), "F_silu": lambda v: F.silu(v),
    "F_gelu": lambda v: F.gelu(v),
    "F_gelu_none": lambda v: F.gelu(v, approximate="none"),
    "F_gelu_tanh": lambda v: F.gelu(v, approximate="tanh"),
    "identity": lambda v: v,
}


@pytest.mark.parametrize("name", sorted(TRACED))
def test_tracer_op_matches_fn(name):
    fn = TRACED[name]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 48)).astype(np.float32))
    lifted = jit.lift(fn)
    assert lifted.steps or name == "identity"
    got, ref = lifted.evaluate(x), fn(x)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    k = jit.pallas_kernel(fn)
    assert torch.equal(k(x), ref) and k.launches == 0


def _cond(v):
    if (v > 0).any():
        return v
    return -v


@pytest.mark.parametrize("fn,what", [
    (lambda v: v.sum(), "Tensor.sum"),
    (lambda v: v[::2], "getitem"),
    (lambda v: torch.cumsum(v, 0), "cumsum"),
    (_cond, "control flow"),
    (lambda v: v * torch.tensor(2.0), "get_attr"),
    (lambda v, w: v + w, "more than one argument"),
    (lambda v: F.relu(v, inplace=True), "inplace=True"),
    (lambda v: F.gelu(v, approximate="bogus"), "approximate='bogus'"),
    (lambda v: torch.add(v, v, alpha=2), "keywords"),
    (lambda v: (v, v), "not one tensor"),
    (lambda v: v.float(), "Tensor.float"),
])
def test_unsupported_functions_raise_when_lifted(fn, what):
    with pytest.raises(ValueError, match="cannot lift") as info:
        jit.lift(fn)
    assert what in str(info.value)
    k = jit.pallas_kernel(fn)
    with pytest.raises(ValueError, match="cannot lift"):   # at the first call
        k(torch.ones(4))


def _gelu_tanh(lib):
    return lambda v: 0.5 * v * (1 + lib.tanh(0.7978845608 * (
        v + 0.044715 * v ** 3)))


# the same function written for each package: (torch, jax)
LIFTED = {
    "double": (lambda v: v * 2, lambda v: v * 2),
    "double_plus_one": (lambda v: v * 2 + 1, lambda v: v * 2 + 1),
    "squared_relu": (lambda v: torch.relu(v) ** 2,
                     lambda v: jax.nn.relu(v) ** 2),
    "gelu_tanh_formula": (_gelu_tanh(torch), _gelu_tanh(jnp)),
    "quick_gelu": (lambda v: v * torch.sigmoid(1.702 * v),
                   lambda v: v * jax.nn.sigmoid(1.702 * v)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LIFTED))
def test_pallas_kernel_matches_jax(name, dtype):
    tfn, jfn = LIFTED[name]
    x = np.random.default_rng(3).standard_normal((16, 40, 24)).astype(
        np.float32)
    ref = jjit.pallas_kernel(jfn, interpret=True)(
        jnp.asarray(x).astype(dtype))
    k = jit.pallas_kernel(tfn)
    got = k(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and k.launches == 0
    ref32 = np.asarray(ref.astype(jnp.float32))
    assert _rel(got.float(), ref32) <= (1e-6 if dtype == "float32" else 2e-2)
    # the kernel's float32 arithmetic against JAX in float32
    kernel32 = k.lifted.evaluate(torch.from_numpy(x))
    ref_f32 = np.asarray(jjit.pallas_kernel(jfn, interpret=True)(
        jnp.asarray(x)))
    assert _rel(kernel32, ref_f32) <= 1e-6


@pytest.mark.parametrize("quant", ["int4_two_call", "float"])
def test_moe_layer_with_lifted_activation_matches_jax(quant):
    """8 experts, 256 -> 512, top-2, dropless, squared ReLU lifted by each
    package's pallas_kernel; INT4 experts take the two-call path (no fused
    stream), float experts the bmm path."""
    gate = {"type": "top", "k": 2, "capacity_factor": 0.0}

    def experts(fn):
        return {"type": "ffn", "num_experts_per_device": 8,
                "hidden_size_per_expert": 512, "activation_fn": fn}
    jl = jmoe.moe_layer(gate_type=dict(gate), model_dim=256, seeds=(1, 1, 1),
                        group=jax.devices()[:1], experts=experts(
                            jjit.pallas_kernel(LIFTED["squared_relu"][1],
                                               interpret=True)))
    act = jit.pallas_kernel(LIFTED["squared_relu"][0])
    tl = tmoe.moe_layer(gate_type=dict(gate), model_dim=256, device="cpu",
                        experts=experts(act))
    jp = jl.init(jax.random.PRNGKey(0))
    if quant != "float":
        jp = dict(jp)
        jp["experts"] = jq.quantize_expert_params(jp["experts"], bits=4)
    tp = convert.from_jax_params(jp, "cpu")
    x = np.random.default_rng(4).standard_normal((24, 256)).astype(
        np.float32)
    ref, _ = jl(jp, jnp.asarray(x))
    got, _ = tl(tp, torch.from_numpy(x))
    assert _rel(got, ref) <= 1e-4
    assert act.launches == 0 and act.lifted.steps
