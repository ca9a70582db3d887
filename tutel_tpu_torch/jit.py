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

A launch is one ctypes call with one argument: a launch record packed by
one `struct.pack` (`_Launcher.pack`) holding the kernel's arguments, the
grid and block, the dynamic shared memory, the device and PyTorch's
current stream. The trampoline compiled behind the source unpacks it
(see `trampoline`). What does not change between calls is done once:
`inject_kernel` parses the source and a fixed `out_shape`, a K10 callable
lifts `fn` at its first call, and the first launch builds the library
(and sizes K10's grid per dtype and device); later calls only check their
tensors, allocate the outputs and launch. A launch on the current stream
captures into a CUDA graph.
"""

import ctypes
import dataclasses
import math
import operator
import re
import struct

import torch
import torch.fx

from .csrc import build

ELEMENTWISE = build.CSRC / "elementwise.cu"
# the trampoline's entries (`trampoline`) and their ctypes argument types:
# a launch takes one launch record; the occupancy query (K10's text only)
# threads, dynamic shared bytes, device and a pointer to the int it writes
_ENTRY, _OCCUPANCY = "tt_jit_launch", "tt_jit_occupancy"
_SIGNATURES = {_ENTRY: [ctypes.c_char_p],
               _OCCUPANCY: [ctypes.c_int] * 3 + [ctypes.c_void_p]}
# the launch record's fixed part, little-endian as on the card's host: the
# argument count, the stream, grid x/y/z, block x/y/z, dynamic shared bytes,
# the device; then 8 bytes per argument (at least one slot)
_RECORD = "<qQ8i"
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


def trampoline(name, arity, occupancy=False):
    """The extern "C" entries compiled behind a kernel's source.

    `tt_jit_launch(record)` launches `name` from one launch record (see
    `_Launcher.pack`; the static_asserts give its layout, which
    tests/test_torch_jit.py holds against the packing). It refuses a
    record for another argument count than `arity`, points the kernel's
    parameters into the record, switches to the record's device only when
    the caller's differs and restores the caller's afterwards, raises the
    kernel's dynamic shared memory limit only when a launch asks for more
    than that device already allows (above the default 48 KB), launches
    with cudaLaunchKernel on the record's stream, and returns the launch's
    cudaError_t or, failing that, cudaGetLastError()'s (a launch refused
    for its geometry reports nowhere else).

    With `occupancy`, `tt_jit_occupancy` gives
    cudaOccupancyMaxActiveBlocksPerMultiprocessor of `name` for a block
    size and dynamic shared memory on a device (K10 sizes its grid by it)."""
    slots = max(arity, 1)
    return f"""
#include <atomic>
#include <cstddef>
#include <cstring>
#include <mutex>

namespace {{
struct tt_jit_record {{            // jit.py _RECORD
  long long nargs;
  unsigned long long stream;
  int grid[3];
  int block[3];
  int smem;
  int device;
  unsigned long long args[{slots}];  // pointers, 64-bit ints
}};
static_assert(offsetof(tt_jit_record, nargs) == 0, "record layout");
static_assert(offsetof(tt_jit_record, stream) == 8, "record layout");
static_assert(offsetof(tt_jit_record, grid) == 16, "record layout");
static_assert(offsetof(tt_jit_record, block) == 28, "record layout");
static_assert(offsetof(tt_jit_record, smem) == 40, "record layout");
static_assert(offsetof(tt_jit_record, device) == 44, "record layout");
static_assert(offsetof(tt_jit_record, args) == 48, "record layout");
static_assert(sizeof(tt_jit_record) == 48 + 8 * {slots}, "record layout");

constexpr int tt_jit_devices = 64;
// the dynamic shared memory each device already allows the kernel (0: the
// default 48 KB); raised under the lock, so the attribute only grows
std::atomic<int> tt_jit_smem[tt_jit_devices];
std::mutex tt_jit_smem_lock;

cudaError_t tt_jit_allow_smem(int smem, int device) {{
  if (device < 0 || device >= tt_jit_devices) return cudaErrorInvalidDevice;
  std::atomic<int>& allowed = tt_jit_smem[device];
  if (smem <= allowed.load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> hold(tt_jit_smem_lock);
  if (smem <= allowed.load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*){name}, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed.store(smem, std::memory_order_release);
  return err;
}}
}}  // namespace

extern "C" int {_ENTRY}(const void* data) {{
  tt_jit_record r;
  std::memcpy(&r, data, sizeof r);
  if (r.nargs != {arity}) return (int)cudaErrorInvalidValue;
  void* params[{slots}];
  for (int i = 0; i < {slots}; ++i) params[i] = &r.args[i];
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  const bool other = err == cudaSuccess && caller != r.device;
  if (other) err = cudaSetDevice(r.device);
  if (err == cudaSuccess && r.smem > 48 * 1024)
    err = tt_jit_allow_smem(r.smem, r.device);
  if (err == cudaSuccess)
    err = cudaLaunchKernel((const void*){name},
                           dim3(r.grid[0], r.grid[1], r.grid[2]),
                           dim3(r.block[0], r.block[1], r.block[2]), params,
                           (size_t)r.smem,
                           reinterpret_cast<cudaStream_t>(r.stream));
  if (other) cudaSetDevice(caller);               // the caller's device back
  const cudaError_t last = cudaGetLastError();   // read and cleared
  return (int)(err != cudaSuccess ? err : last);
}}
{_occupancy_entry(name) if occupancy else ""}
extern "C" const char* tt_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}
"""


def _occupancy_entry(name):
    return f"""
extern "C" int {_OCCUPANCY}(int threads, int smem, int device, int* blocks) {{
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  const bool other = err == cudaSuccess && caller != device;
  if (other) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, (const void*){name}, threads, (size_t)smem);
  if (other) cudaSetDevice(caller);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}}
"""


def _current_stream(index):
    """PyTorch's current CUDA stream on device `index`, as the int that
    `torch.cuda.current_stream(index).cuda_stream` gives, without building
    a torch.cuda.Stream object: the call PyTorch's Inductor-generated code
    makes before each launch."""
    return torch._C._cuda_getCurrentRawStream(index)


class _Launcher:
    """A CUDA source with one `__global__` function and its trampoline,
    built and loaded at the first launch; with `occupancy` the trampoline
    also answers `occupancy`."""

    def __init__(self, source, occupancy=False):
        self.name, self.arity = kernel_signature(source)
        self.text = source + trampoline(self.name, self.arity, occupancy)
        self._signatures = {e: _SIGNATURES[e] for e in
                            (_ENTRY, _OCCUPANCY)[:1 + occupancy]}
        self.record = struct.Struct(_RECORD + "Q" * max(self.arity, 1))
        self._pad = (0,) * (self.arity == 0)    # the unused slot of arity 0
        self._lib = self._launch = None

    def _load(self):
        self._lib = build.load_source(self.text, self._signatures)
        self._launch = getattr(self._lib, _ENTRY)

    def pack(self, args, grid, block, smem, device, stream):
        """The launch record of one call, as bytes: the argument count, the
        stream, the grid and block (3 ints each), the dynamic shared memory
        bytes, the device index, then each argument as 8 bytes (a pointer
        or a 64-bit int)."""
        return self.record.pack(len(args), stream, *grid, *block, smem,
                                device, *args, *self._pad)

    def __call__(self, args, grid, block, smem, device):
        """Launch on PyTorch's current stream of CUDA device `device` (an
        index); `args` holds one int per kernel parameter."""
        if self._launch is None:
            self._load()
        rc = self._launch(self.pack(args, grid, block, smem, device,
                                    _current_stream(device)))
        if rc:
            build.check(self._lib, rc, f"kernel {self.name}")

    def occupancy(self, threads, smem, device):
        """Resident blocks of `threads` threads per SM of device `device`."""
        if self._launch is None:
            self._load()
        blocks = ctypes.c_int(0)
        rc = getattr(self._lib, _OCCUPANCY)(threads, smem, device,
                                            ctypes.byref(blocks))
        build.check(self._lib, rc, f"occupancy of kernel {self.name}")
        return blocks.value


def _dims(grid):
    dims = (grid,) if isinstance(grid, int) else tuple(grid)
    if not 1 <= len(dims) <= 3 or any(
            not isinstance(d, int) or d < 1 for d in dims):
        raise ValueError(f"grid must be 1 to 3 positive ints, got {grid!r}")
    return dims + (1,) * (3 - len(dims))


def _cuda_index(args):
    """The device index of `args` when they are contiguous tensors on one
    CUDA device, else -1."""
    first = args[0] if args else None
    if not isinstance(first, torch.Tensor) or not first.is_cuda:
        return -1
    index = first.get_device()
    for a in args:
        if not (isinstance(a, torch.Tensor) and a.is_cuda and
                a.get_device() == index and a.is_contiguous()):
            return -1
    return index


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
        inputs returning either (a pair or list is checked here, a
        callable's result at each call); the outputs are allocated on the
        inputs' device, and a list returns a tuple.
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

    fixed = None if callable(out_shape) else _out_specs(out_shape, ())

    def check_arity(args, specs):
        if len(args) + len(specs) != launcher.arity:
            raise ValueError(f"kernel {launcher.name} takes {launcher.arity} "
                             f"pointers; got {len(args)} inputs and "
                             f"{len(specs)} outputs")

    def launch(args, device):
        specs, single = fixed or _out_specs(out_shape, args)
        check_arity(args, specs)
        # new_empty takes the first input's device without parsing one
        outs = [args[0].new_empty(s, dtype=t) for s, t in specs]
        launcher([t.data_ptr() for t in (*args, *outs)], grid, block,
                 scratch_bytes, device)
        call.launches += 1
        inject_kernel.launches += 1
        return outs[0] if single else tuple(outs)

    def call(*args):
        device = _cuda_index(args)
        if device >= 0:
            return launch(args, device)
        # not contiguous tensors on one CUDA device: the CPU's twin, or the
        # refusal the call earns
        if not args or not all(isinstance(a, torch.Tensor) for a in args):
            raise TypeError("an injected kernel takes one or more tensors "
                            "(pass a scalar as a small tensor)")
        devices = {a.device for a in args}
        if len(devices) != 1:
            raise ValueError(f"inputs on several devices: {devices}")
        device = args[0].device
        specs, single = fixed or _out_specs(out_shape, args)
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
        check_arity(args, specs)
        if not all(a.is_contiguous() for a in args):
            raise ValueError("an injected kernel takes contiguous tensors")
        return launch(args, device.index)

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
# K10's block: threads, and 16-byte vectors a thread loads a step; given
# to csrc/elementwise.cu as TT_THREADS and TT_UNROLL
_THREADS = 128
_BLOCK = (_THREADS, 1, 1)
_UNROLL = 2


class LiftedKernel:
    """What `pallas_kernel(fn)` returns: call it on a tensor."""

    def __init__(self, fn):
        self.fn = fn
        self.launches = 0
        self._lifted = None
        self._launchers = {}          # dtype -> _Launcher
        # (dtype, device index) -> (launcher, elements a block takes per
        # step, the blocks the body keeps resident on the card, the most
        # elements whose output fits in L2, the device index), filled at
        # the first launch
        self._geometry = {}

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
                f"#define TT_THREADS {_THREADS}\n"
                f"#define TT_UNROLL {_UNROLL}\n"
                f"#define TT_BODY {self.lifted.cuda_body()}\n"
                + ELEMENTWISE.read_text(), occupancy=True)
        return launcher

    def __call__(self, x):
        geometry = self._geometry.get((x.dtype, x.get_device())) \
            if x.is_cuda and x.is_contiguous() else None
        if geometry is None:
            return self._first_call(x)
        launcher, per_block, blocks, in_l2, device = geometry
        out = torch.empty_like(x)
        n = x.numel()
        if n:
            steps = -(-n // per_block)
            launcher((x.data_ptr(), out.data_ptr(), n),
                     (min(steps, blocks) if n <= in_l2 else steps, 1, 1),
                     _BLOCK, 0, device)
            self.launches += 1
            pallas_kernel.launches += 1
        return out

    def _first_call(self, x):
        """A call on the CPU, a refusal, or the first launch for x's dtype
        and device, which builds the kernel and sizes its grid: for an
        output that fits in L2, at most as many blocks as the lifted body's
        occupancy keeps resident on every SM; else one block per step (see
        csrc/elementwise.cu)."""
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
        if x.numel() == 0:
            return torch.empty_like(x)
        device = x.get_device()
        props = torch.cuda.get_device_properties(device)
        self._geometry[(x.dtype, device)] = (
            launcher, _THREADS * _UNROLL * 16 // x.element_size(),
            launcher.occupancy(_THREADS, 0, device) *
            props.multi_processor_count,
            props.L2_cache_size // x.element_size(), device)
        return self(x)


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
