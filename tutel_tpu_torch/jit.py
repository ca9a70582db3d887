"""Runtime kernels (counterpart: tutel_tpu/jit.py).

The reference compiles CUDA source strings at run time (custom_kernel.cpp
`inject_source` + `invoke`), reads their launch geometry from
`// [thread_extent]` comments and caches the compiled function; the JAX
package maps that surface onto Pallas. The port maps it back onto CUDA:

  * `compile`       - returns the function unchanged (see its docstring).
  * `inject_kernel` - kernel K9: a CUDA C++ source with one `__global__`
    function, compiled by nvcc together with a generated launch trampoline
    (`csrc/build.py` `load_source`) and launched on PyTorch's current
    stream.
  * `pallas_kernel` - kernel K10: an elementwise function on tensors,
    traced with `torch.fx` into float32 statements that are written into
    the hand-written elementwise kernel `csrc/elementwise.cu`, which is
    built and launched through K9's machinery.

A source is compiled once (its library is kept in build/kernels/ under a
hash of the text) and loaded once per process: re-invoking never
recompiles. CPU tensors run each kernel's plain twin: `plain=` for
`inject_kernel`, `fn(x)` for `pallas_kernel`. CUDA tensors launch the
kernel or raise. Both count their launches (`.launches` on each returned
callable, and a total on `inject_kernel` and `pallas_kernel`).
"""

import ctypes
import dataclasses
import functools
import math
import operator
import re
import struct

import torch
import torch.fx

from .csrc import build

ELEMENTWISE = build.CSRC / "elementwise.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the trampoline: args, nargs, grid x/y/z, block x/y/z, dynamic shared
# bytes, device, stream
_ENTRY = "tt_jit_launch"
_ARGTYPES = [_P, _I] + [_I] * 6 + [_I, _I, _P]
_EXTENT = re.compile(r"//\s*\[thread_extent\]\s*(blockIdx|threadIdx)\."
                     r"([xyz])\s*=\s*(\d+)")
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_BOUNDS = r"(?:__launch_bounds__\s*\([^)]*\)\s*)?"
_KERNEL = re.compile(r"__global__\s+" + _BOUNDS + r"void\s+" + _BOUNDS +
                     r"(\w+)\s*\(")


def compile(fn):
    """`jax.jit`'s counterpart: `fn` unchanged. PyTorch runs eagerly, so
    the port needs no tracing compiler here (and this is not
    `torch.compile`)."""
    return fn


# -- K9: a CUDA source given at run time -------------------------------------

def thread_extents(source):
    """(grid, block) from the reference's `// [thread_extent] blockIdx.x =
    N` and `// [thread_extent] threadIdx.x = N` comments: each a 3-tuple
    (x, y, z) with 1 for an axis not named, or None where no axis is."""
    extents = {"blockIdx": {}, "threadIdx": {}}
    for var, axis, n in _EXTENT.findall(source):
        if axis in extents[var]:
            raise ValueError(f"two [thread_extent] comments for {var}.{axis}")
        extents[var][axis] = int(n)
    return tuple(tuple(e.get(a, 1) for a in "xyz") if e else None
                 for e in extents.values())


def kernel_signature(source):
    """(name, number of parameters) of the one `__global__ void` function of
    a CUDA source, read with its comments removed."""
    code = _COMMENT.sub(" ", source)
    found = list(_KERNEL.finditer(code))
    if len(found) != 1 or code.count("__global__") != 1 or \
            code[:found[0].start()].rstrip().endswith(">"):   # template <..>
        raise ValueError("the source must define exactly one __global__ void "
                         "function (not a template), at namespace scope")
    depth, params, cur = 1, [], []
    for ch in code[found[0].end():]:
        depth += ch in "(<["
        depth -= ch in ")>]"
        if depth == 0:
            break
        if ch == "," and depth == 1:
            params.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    params.append("".join(cur))
    params = [p for p in (p.strip() for p in params) if p and p != "void"]
    return found[0].group(1), len(params)


def trampoline(name, arity):
    """The extern "C" launcher compiled behind a kernel's source: it refuses
    another argument count than `arity`, raises the kernel's dynamic
    shared memory limit when a launch asks for more than 48 KB, launches
    `name` with cudaLaunchKernel on the given stream, and returns the
    launch's cudaError_t (which a launch refused for its geometry reports
    nowhere else)."""
    return f"""
extern "C" int {_ENTRY}(void** args, int nargs, int gx, int gy, int gz,
                             int bx, int by, int bz, int smem, int device,
                             void* stream) {{
  if (nargs != {arity}) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute((const void*){name},
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaLaunchKernel((const void*){name}, dim3(gx, gy, gz),
                           dim3(bx, by, bz), args, (size_t)smem,
                           static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();   // read and cleared
  return (int)(err != cudaSuccess ? err : last);
}}

extern "C" const char* tt_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}
"""


class _Launcher:
    """A CUDA source with one `__global__` function and its trampoline,
    built and loaded at the first launch."""

    def __init__(self, source):
        self.name, self.arity = kernel_signature(source)
        self.text = source + trampoline(self.name, self.arity)
        self._lib = None

    def __call__(self, args, grid, block, scratch_bytes, device):
        """Launch on the current stream of `device`; `args` holds one ctypes
        value per kernel parameter."""
        if self._lib is None:
            self._lib = build.load_source(self.text, _ENTRY, _ARGTYPES)
        ptrs = (ctypes.c_void_p * len(args))(
            *(ctypes.addressof(a) for a in args))
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = self._lib.tt_jit_launch(ptrs, len(args), *grid, *block,
                                     scratch_bytes, device.index or 0, stream)
        build.check(self._lib, rc, f"kernel {self.name}")


def _dims(grid):
    dims = (grid,) if isinstance(grid, int) else tuple(grid)
    if not 1 <= len(dims) <= 3 or any(
            not isinstance(d, int) or d < 1 for d in dims):
        raise ValueError(f"grid must be 1 to 3 positive ints, got {grid!r}")
    return dims + (1,) * (3 - len(dims))


def _is_pair(spec):
    return (isinstance(spec, (tuple, list)) and len(spec) == 2
            and isinstance(spec[1], torch.dtype))


def _out_specs(out_shape, args):
    """[(shape, dtype), ...] and whether the call returns one tensor."""
    spec = out_shape(*args) if callable(out_shape) else out_shape
    single = _is_pair(spec)
    specs = [spec] if single else list(spec)
    if not specs or not all(_is_pair(s) for s in specs):
        raise TypeError(f"out_shape must be a (shape, dtype) pair, a list of "
                        f"them, or a callable returning either; got {spec!r}")
    return [(tuple(int(d) for d in s), t) for s, t in specs], single


def inject_kernel(source, *, out_shape, grid=None, scratch_bytes=0,
                  plain=None):
    """Register a CUDA C++ kernel given as source text; returns a callable
    `f(*inputs)` that launches it (kernel K9).

    The counterpart of the reference's `inject_source(cuda_src)` +
    `invoke(inputs)` and of the JAX package's `inject_kernel(body, ...)`.
    `source` defines one `__global__ void` function, not a template, at
    namespace scope, whose parameters are the inputs' pointers and then
    the outputs', in the order of Pallas's refs; a scalar comes in as a
    small tensor. The block size comes from `// [thread_extent]
    threadIdx.x = N` comments (.y, .z likewise), the grid from `//
    [thread_extent] blockIdx.x = N` comments or from `grid=` (an int or up
    to three ints), which overrides them as JAX's `grid` does.

    out_shape: a (shape, dtype) pair, a list of pairs, or a callable of the
        inputs returning either; the outputs are allocated with torch.empty
        on the inputs' device, and a list returns a tuple.
    scratch_bytes: dynamic shared memory per block (JAX's scratch_shapes);
        above 48 KB the kernel's limit is raised for it.
    plain: the kernel's plain PyTorch twin, run for CPU tensors. Without
        it a CPU call raises: a CUDA source cannot run on the CPU.

    Inputs on a CUDA device must be contiguous and on one device; a launch
    error or an nvcc failure raises. JAX's `in_specs` and `out_specs` have
    no counterpart (a CUDA kernel computes its own offsets from blockIdx),
    nor has `dimension_semantics` (blocks always run in parallel) or
    `interpret` (the tensors' device picks the kernel or `plain`).

    Example, a tiled `x * s + 1` over [256, 128] float32:

        src = '''
        // [thread_extent] blockIdx.x = 2
        // [thread_extent] threadIdx.x = 256
        __global__ void scale(const float* x, const float* s, float* o) {
          const int base = blockIdx.x * 128 * 128;
          for (int i = threadIdx.x; i < 128 * 128; i += blockDim.x)
            o[base + i] = x[base + i] * s[0] + 1.f;
        }'''
        f = jit.inject_kernel(src, out_shape=((256, 128), torch.float32),
                              plain=lambda x, s: x * s[0, 0] + 1)
        y = f(x, s)
    """
    launcher = _Launcher(source)
    src_grid, block = thread_extents(source)
    grid = src_grid if grid is None else _dims(grid)
    if block is None:
        raise ValueError("no `// [thread_extent] threadIdx.x = N` comment: "
                         "the source gives no block size")
    if grid is None:
        raise ValueError("no grid: pass grid= or give a `// [thread_extent] "
                         "blockIdx.x = N` comment")

    def call(*args):
        if not args or not all(isinstance(a, torch.Tensor) for a in args):
            raise TypeError("an injected kernel takes one or more tensors "
                            "(pass a scalar as a small tensor)")
        devices = {a.device for a in args}
        if len(devices) != 1:
            raise ValueError(f"inputs on several devices: {devices}")
        device = args[0].device
        specs, single = _out_specs(out_shape, args)
        if device.type == "cpu":
            if plain is None:
                raise RuntimeError(
                    f"kernel {launcher.name} is CUDA source and cannot run "
                    "on the CPU; pass plain=, its PyTorch twin, to "
                    "inject_kernel for CPU tensors")
            out = plain(*args)
            got = [(tuple(t.shape), t.dtype)
                   for t in ([out] if single else out)]
            if got != specs:
                raise ValueError(f"plain returned {got}, out_shape says "
                                 f"{specs}")
            return out
        if device.type != "cuda":
            raise ValueError(f"injected kernels run on cpu or cuda, not "
                             f"{device}")
        if len(args) + len(specs) != launcher.arity:
            raise ValueError(f"kernel {launcher.name} takes {launcher.arity} "
                             f"pointers; got {len(args)} inputs and "
                             f"{len(specs)} outputs")
        if not all(a.is_contiguous() for a in args):
            raise ValueError("an injected kernel takes contiguous tensors")
        outs = [torch.empty(s, dtype=t, device=device) for s, t in specs]
        launcher([ctypes.c_void_p(t.data_ptr()) for t in (*args, *outs)],
                 grid, block, scratch_bytes, device)
        call.launches += 1
        inject_kernel.launches += 1
        return outs[0] if single else tuple(outs)

    call.launches = 0
    call.source = launcher.text      # what nvcc compiles
    return call


inject_kernel.launches = 0


# -- K10: an elementwise function lifted into csrc/elementwise.cu ------------

def _f32(c):
    """A Python number as the float32 value a float32 op would use."""
    return struct.unpack("f", struct.pack("f", float(c)))[0]


def _where(c, a, b):
    return torch.where(c != 0, a, b)


def _powi(a, n):
    r = torch.ones_like(a) if n == 0 else a
    for _ in range(abs(n) - 1):
        r = r * a
    return 1 / r if n < 0 else r


# op -> its PyTorch twin over float32 tensors: the arithmetic of the tt_<op>
# device function of csrc/elementwise.cu, in the same order
_OPS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": operator.truediv, "neg": operator.neg, "pow": torch.pow,
    "powi": _powi,
    "gt": lambda a, b: (a > b).float(), "ge": lambda a, b: (a >= b).float(),
    "lt": lambda a, b: (a < b).float(), "le": lambda a, b: (a <= b).float(),
    "eq": lambda a, b: (a == b).float(), "ne": lambda a, b: (a != b).float(),
    "where": _where, "maximum": torch.maximum, "minimum": torch.minimum,
    "relu": lambda a: torch.where(a < 0, 0.0, a), "abs": torch.abs,
    "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "tanh": torch.tanh, "erf": torch.erf,
    "sigmoid": lambda a: 1 / (1 + torch.exp(-a)),
    "silu": lambda a: a / (1 + torch.exp(-a)),
    "gelu": lambda a: a * 0.5 * (1 + torch.erf(a * 0.7071067811865476)),
    "gelu_tanh": lambda a: 0.5 * a * (1 + torch.tanh(
        0.7978845608028654 * (a + 0.044715 * (a * a * a)))),
}
_UNARY = ("neg", "relu", "abs", "exp", "log", "sqrt", "rsqrt", "tanh", "erf",
          "sigmoid", "silu", "gelu", "gelu_tanh")
_BINARY = ("add", "sub", "mul", "div", "pow", "gt", "ge", "lt", "le", "eq",
           "ne", "maximum", "minimum")
_F = torch.nn.functional
# traced call_function targets -> op; clamp, where, gelu and pow are
# rewritten below
_FUNCTIONS = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.truediv: "div", operator.neg: "neg", operator.pow: "pow",
    operator.gt: "gt", operator.ge: "ge", operator.lt: "lt",
    operator.le: "le", operator.eq: "eq", operator.ne: "ne",
    torch.add: "add", torch.sub: "sub", torch.mul: "mul", torch.div: "div",
    torch.neg: "neg", torch.pow: "pow", torch.relu: "relu",
    torch.sigmoid: "sigmoid", torch.tanh: "tanh", torch.exp: "exp",
    torch.log: "log", torch.sqrt: "sqrt", torch.rsqrt: "rsqrt",
    torch.abs: "abs", torch.erf: "erf", torch.clamp: "clamp",
    torch.maximum: "maximum", torch.minimum: "minimum", torch.where: "where",
    _F.relu: "relu", _F.silu: "silu", _F.gelu: "gelu",
}
# traced call_method names (Tensor methods) -> op
_METHODS = {name: name for name in (
    "add", "sub", "mul", "div", "neg", "pow", "relu", "sigmoid", "tanh",
    "exp", "log", "sqrt", "rsqrt", "abs", "erf", "clamp", "maximum",
    "minimum", "where")}


@dataclasses.dataclass(frozen=True)
class Lifted:
    """An elementwise function as straight-line float32 code. `steps` are
    (variable, op, operands); an operand is "v" (the input), an earlier
    variable, a float constant or, for powi, an int exponent."""
    steps: tuple
    result: str

    def cuda_body(self):
        """The statements of `tt_fn(float v)` in csrc/elementwise.cu."""
        def operand(a):
            if isinstance(a, str) or type(a) is int:
                return str(a)
            if not math.isfinite(a):
                bits = {math.inf: "0x7f800000", -math.inf: "0xff800000"}
                return f"__int_as_float({bits.get(a, '0x7fffffff')})"
            return f"({a!r}f)"
        lines = [f"const float {var} = tt_{op}("
                 f"{', '.join(map(operand, args))});"
                 for var, op, args in self.steps]
        return " ".join(lines + [f"return {self.result};"])

    def evaluate(self, x):
        """What the kernel computes, in PyTorch: each step's twin in
        float32, the result in float32 with x's shape."""
        env = {"v": x.float()}
        for var, op, args in self.steps:
            env[var] = _OPS[op](*(
                env[a] if isinstance(a, str) else
                a if type(a) is int else torch.tensor(a, dtype=torch.float32)
                for a in args))
        return torch.broadcast_to(env[self.result], x.shape)


def _refuse(fn, what):
    return ValueError(f"pallas_kernel cannot lift {fn!r}: {what}; it takes "
                      "one tensor through elementwise ops only")


def lift(fn):
    """Trace `fn` (one tensor in, one tensor out) with torch.fx and map
    each node to float32 steps of csrc/elementwise.cu. Raises ValueError
    naming the first op that is not elementwise or not covered (a
    reduction, a shape change, Python control flow on values, ...)."""
    try:
        graph = torch.fx.symbolic_trace(fn).graph
    except (TypeError, ValueError) as exc:     # fx's TraceError included
        raise _refuse(fn, f"tracing failed ({exc})") from exc
    names, steps, result = {}, [], None

    def operand(a):
        if isinstance(a, torch.fx.Node):
            return names[a]
        if isinstance(a, (bool, int, float)):
            return _f32(a)
        raise _refuse(fn, f"operand {a!r} is neither a traced value nor a "
                          "Python number")

    def emit(op, *args):
        var = f"t{len(steps)}"
        steps.append((var, op, tuple(args)))
        return var

    for node in graph.nodes:
        if node.op == "placeholder":
            if names:
                raise _refuse(fn, "it takes more than one argument")
            names[node] = "v"
            continue
        if node.op == "output":
            out = node.args[0]
            if not isinstance(out, torch.fx.Node):
                raise _refuse(fn, f"it returns {out!r}, not one tensor")
            result = names[out]
            continue
        if node.op == "call_function":
            op = _FUNCTIONS.get(node.target)
            label = getattr(node.target, "__name__", repr(node.target))
        elif node.op == "call_method":
            op = _METHODS.get(node.target)
            label = f"Tensor.{node.target}"
        else:                           # get_attr (a tensor constant), ...
            op, label = None, f"{node.op} {node.target}"
        if op is None:
            raise _refuse(fn, f"{label!r} is not supported")
        args, kw = list(node.args), dict(node.kwargs)

        def take(key, pos, default=None):
            if key in kw:
                return kw.pop(key)
            return args.pop(pos) if len(args) > pos else default

        if node.target in (_F.relu, _F.silu) and take("inplace", 1, False):
            raise _refuse(fn, f"{label}(inplace=True)")
        if op == "gelu":
            approximate = take("approximate", 1, "none")
            if approximate not in ("none", "tanh"):
                raise _refuse(fn, f"gelu(approximate={approximate!r})")
            op = "gelu" if approximate == "none" else "gelu_tanh"
        if op == "clamp":
            hi, lo = take("max", 2), take("min", 1)
        if op == "where" and node.op == "call_method" and len(args) == 3:
            args = [args[1], args[0], args[2]]      # self.where(cond, other)
        if kw:
            raise _refuse(fn, f"{label} with keywords {sorted(kw)}")
        if op == "clamp":
            if len(args) != 1 or (lo is None and hi is None):
                raise _refuse(fn, f"{label} with arguments {node.args}")
            var = operand(args[0])
            if lo is not None:
                var = emit("maximum", var, operand(lo))
            if hi is not None:
                var = emit("minimum", var, operand(hi))
            names[node] = var
            continue
        arity = 1 if op in _UNARY else 2 if op in _BINARY else 3   # where
        if len(args) != arity:
            raise _refuse(fn, f"{label} with {len(args)} arguments")
        exp = args[1] if op == "pow" else None
        if isinstance(exp, (int, float)) and float(exp).is_integer() and \
                abs(exp) <= 16:
            names[node] = emit("powi", operand(args[0]), int(exp))
        else:
            names[node] = emit(op, *map(operand, args))
    return Lifted(tuple(steps), result)


_ELEMENT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256       # kThreads of csrc/elementwise.cu
_BLOCKS_PER_SM = 8   # 2048 resident threads per SM on Hopper


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index):
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return _BLOCKS_PER_SM * sms


class LiftedKernel:
    """What `pallas_kernel(fn)` returns: call it on a tensor."""

    def __init__(self, fn):
        self.fn = fn
        self.launches = 0
        self._lifted = None
        self._launchers = {}          # dtype -> _Launcher

    @property
    def lifted(self):
        """fn lifted at the first use (raises for what it cannot lift)."""
        if self._lifted is None:
            self._lifted = lift(self.fn)
        return self._lifted

    def cuda_source(self, dtype):
        """The CUDA text K10 compiles for x of `dtype`, trampoline included."""
        return self._launcher(dtype).text

    def _launcher(self, dtype):
        launcher = self._launchers.get(dtype)
        if launcher is None:
            if dtype not in _ELEMENT_TYPES:
                raise ValueError(f"K10 takes float32, bfloat16 or float16, "
                                 f"not {dtype}")
            launcher = self._launchers[dtype] = _Launcher(
                f"#define TT_DTYPE {_ELEMENT_TYPES[dtype]}\n"
                f"#define TT_BODY {self.lifted.cuda_body()}\n"
                + ELEMENTWISE.read_text())
        return launcher

    def __call__(self, x):
        # lift at the first call on any device, so that the CPU refuses
        # what the card would
        self.lifted
        if x.device.type == "cpu":
            out = self.fn(x)
            if not isinstance(out, torch.Tensor) or out.shape != x.shape or \
                    out.dtype != x.dtype:
                raise ValueError(f"{self.fn!r} must keep its input's shape "
                                 f"and dtype ({tuple(x.shape)}, {x.dtype})")
            return out
        if x.device.type != "cuda":
            raise ValueError(f"pallas_kernel runs on cpu or cuda, not "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError("pallas_kernel takes a contiguous tensor")
        launcher = self._launcher(x.dtype)
        out = torch.empty_like(x)
        n = x.numel()
        if n == 0:
            return out
        per_block = _THREADS * 16 // x.element_size()
        grid = (min(-(-n // per_block), _max_blocks(x.device.index or 0)), 1,
                1)
        launcher([ctypes.c_void_p(x.data_ptr()),
                  ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(n)],
                 grid, (_THREADS, 1, 1), 0, x.device)
        self.launches += 1
        pallas_kernel.launches += 1
        return out


def pallas_kernel(fn):
    """Lift an elementwise function on tensors into kernel K10.

    Example: double = jit.pallas_kernel(lambda x: x * 2); double(t)

    `fn` takes one tensor and returns one of the same shape and dtype. At
    the first call it is traced (`torch.fx`) into float32 statements, which
    raises for an op that is not covered; see `lift`. A CUDA tensor of
    float32, bfloat16 or float16 then runs csrc/elementwise.cu with those
    statements, built once per dtype: one read and one write per element,
    float32 arithmetic, one rounding at the store (`fn(x)` in bfloat16
    rounds after every op). A CPU tensor runs `fn(x)`, the plain twin.
    JAX's `interpret` has no counterpart: the tensor's device decides.
    """
    return LiftedKernel(fn)


pallas_kernel.launches = 0
