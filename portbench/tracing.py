"""The traced run's instruments: profiler ranges around the port's
functions at each layer boundary, host spans and captured shapes of the
same calls, the port's launch counters, and the reduction of one
torch.profiler trace over a steady sub-window of the measured window.

The ranges come from the benchmark's metric files (each lists what it
wraps in `WRAPS`), are installed only in a traced run, and record only
while the sub-window is profiled. The profile is checked against CUDA
events over the same sub-window and against the port's launch counters;
a profile that disagrees (it lost device time) fails the run."""

import bisect
import importlib
import time

import torch

# the port's kernel wrappers that count their launches, and the CUDA
# symbol each launch runs once
LAUNCH_COUNTERS = (
    ("tutel_tpu_torch.ops.grouped_gemm_quant", "grouped_gemm_quant",
     "gmm_quant_kernel"),
    ("tutel_tpu_torch.ops.fused_ffn", "fused_ffn_quant", "fused_ffn_kernel"),
    ("tutel_tpu_torch.ops.fused_ffn", "fused_swiglu_quant",
     "fused_swiglu_kernel"),
    ("tutel_tpu_torch.ops.fused_ffn", "fused_ffn_w8a8", "fused_w8a8_kernel"),
    ("tutel_tpu_torch.ops.w8a8", "grouped_gemm_w8a8", "gmm_w8a8_kernel"),
    ("tutel_tpu_torch.ops.decode_attn", "decode_attn", "decode_attn_kernel"),
    ("tutel_tpu_torch.ops.decode_attn", "prefill_attn",
     "prefill_attn_kernel"),
    ("tutel_tpu_torch.ops.kv_write", "write_step", "kv_write_kernel"),
)
BACKWARD = "autograd::engine::evaluate_function: "
# a profile whose busy time exceeds the CUDA events' window by more than
# this share, or that holds fewer than LAUNCH_SHARE of a counted kernel's
# launches, lost or invented device time
SPAN_SLACK = 0.02
LAUNCH_SHARE = 0.98


def launches():
    """{kernel wrapper: launches so far}."""
    out = {}
    for mod, fn, _ in LAUNCH_COUNTERS:
        f = getattr(importlib.import_module(mod), fn)
        out[fn] = int(getattr(f, "launches", 0))
    return out


def _resolve(target):
    """'pkg.module:Owner.attr' -> (owner object, attribute name)."""
    mod, path = target.split(":")
    owner = importlib.import_module(mod)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Tracer:
    def __init__(self):
        self.recording = False
        self.calls = {}             # range name -> [(t0, t1, captured)]
        self._installed = {}        # target -> (owner, attr, original)
        self.prof = None

    def install(self, wraps):
        """Wrap each {"target", "range", "capture"?} once."""
        for w in wraps:
            if w["target"] in self._installed:
                continue
            owner, attr = _resolve(w["target"])
            original = getattr(owner, attr)
            self._installed[w["target"]] = (owner, attr, original)
            setattr(owner, attr, self._wrapper(original, w["range"],
                                               w.get("before"),
                                               w.get("capture")))

    def uninstall(self):
        for owner, attr, original in self._installed.values():
            setattr(owner, attr, original)
        self._installed = {}

    def _wrapper(self, fn, name, before, capture):
        """fn inside a profiler range while recording; the host span and
        capture(args, kwargs, out, before(args, kwargs)) are kept."""
        tracer = self

        def wrapped(*args, **kwargs):
            if not tracer.recording:
                return fn(*args, **kwargs)
            pre = before(args, kwargs) if before else None
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            t1 = time.perf_counter()
            info = capture(args, kwargs, out, pre) if capture else None
            tracer.calls.setdefault(name, []).append((t0, t1, info))
            return out
        wrapped.__wrapped__ = fn
        return wrapped

    def warm(self):
        """One short profile, so that the profiler's own start-up (seconds
        on a first start) falls outside the window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._launches0 = launches()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._ev0 = torch.cuda.Event(enable_timing=True)
        self._ev1 = torch.cuda.Event(enable_timing=True)
        self._ev0.record()
        self.t0 = time.perf_counter()
        self.recording = True

    def stop(self):
        self._ev1.record()
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.recording = False
        self.prof.__exit__(None, None, None)
        self.event_ms = self._ev0.elapsed_time(self._ev1)
        counted = launches()
        self.launched = {k: counted[k] - self._launches0[k] for k in counted}

    def reduce(self):
        """The profile as numbers: see `Trace`."""
        return Trace(self)


def _overlap(kernels, spans):
    """Microseconds of `kernels` ([(start, end, name)], sorted) inside
    `spans` ([(start, end)], sorted, disjoint)."""
    total, j = 0.0, 0
    for s, t in spans:
        while j < len(kernels) and kernels[j][1] <= s:
            j += 1
        k = j
        while k < len(kernels) and kernels[k][0] < t:
            total += max(0.0, min(t, kernels[k][1]) - max(s, kernels[k][0]))
            k += 1
    return total


def _device_total(e):
    """Device microseconds of the kernels launched inside a host event."""
    if hasattr(e, "device_time_total"):
        return float(e.device_time_total)
    return float(getattr(e, "cuda_time_total", 0.0))


class Trace:
    """One profiled sub-window.

    kernels: [(start us, end us, name)] of device work (kernels, copies,
    sets), sorted; busy_s: their union; window_s: the sub-window's length
    on the host clock; device_s_by_range: {range: device s of the kernels
    inside the range's extents on the device}; device_s_backward: {autograd node: device s of
    its backward}; calls: the tracer's host spans and captures; launched:
    the launch counters' advance."""

    def __init__(self, tracer):
        ranges = {n for n in tracer.calls}
        events = list(tracer.prof.events())
        kernels, cpu, spans = [], [], {}
        host_total, backward = {}, {}
        for e in events:
            dev = str(e.device_type).endswith("CUDA")
            if dev:
                if e.name in ranges or getattr(e, "is_user_annotation",
                                               False):
                    # a range's extent on the device timeline
                    spans.setdefault(e.name, []).append(
                        (e.time_range.start, e.time_range.end))
                    continue
                kernels.append((e.time_range.start, e.time_range.end,
                                e.name))
                continue
            cpu.append((e.time_range.start, e.time_range.end, e.name))
            if e.name in ranges:
                host_total[e.name] = host_total.get(e.name, 0.0) \
                    + _device_total(e) / 1e6
            elif e.name.startswith(BACKWARD):
                node = e.name[len(BACKWARD):]
                backward[node] = backward.get(node, 0.0) \
                    + _device_total(e) / 1e6
        if not kernels:
            kinds = {}
            for e in events:
                kinds[str(e.device_type)] = kinds.get(str(e.device_type),
                                                      0) + 1
            raise RuntimeError(f"the profiler recorded no device time "
                               f"(events by device type: {kinds})")
        kernels.sort()
        busy, cur = 0.0, None
        for s, t, _ in kernels:
            if cur is None or s > cur[1]:
                busy += 0.0 if cur is None else cur[1] - cur[0]
                cur = [s, t]
            else:
                cur[1] = max(cur[1], t)
        busy += cur[1] - cur[0]
        self.kernels = kernels
        self.cpu = sorted(cpu)
        self.busy_s = busy / 1e6
        self.span_s = (kernels[-1][1] - kernels[0][0]) / 1e6
        self.window_s = tracer.t1 - tracer.t0
        self.event_s = tracer.event_ms / 1e3
        # the kernels a range launched run inside its extent on the device
        # (one stream); kernels launched through ctypes hang off no host
        # op, so the host op's device total misses them
        self.device_s_by_range = {
            n: _overlap(kernels, sorted(v)) / 1e6 for n, v in spans.items()}
        for n, v in host_total.items():
            self.device_s_by_range.setdefault(n, v)
        self.device_s_backward = backward
        self.calls = tracer.calls
        self.launched = tracer.launched
        self.check()

    def kernel_s(self, marks=None):
        """Device seconds of the kernels whose name holds one of `marks`
        (all kernels for None)."""
        return sum(t - s for s, t, n in self.kernels
                   if marks is None or any(m in n for m in marks)) / 1e6

    def check(self):
        """Raise when the profile disagrees with CUDA events or with the
        launch counters."""
        if self.busy_s > self.event_s * (1 + SPAN_SLACK):
            raise RuntimeError(
                f"profile busy {self.busy_s:.6f} s over the CUDA events' "
                f"{self.event_s:.6f} s window")
        self.launch_check = {}
        for _, fn, symbol in LAUNCH_COUNTERS:
            n = self.launched.get(fn, 0)
            if n <= 0:
                continue
            seen = sum(1 for _, _, name in self.kernels if symbol in name)
            self.launch_check[fn] = [n, seen]
            if seen < LAUNCH_SHARE * n:
                raise RuntimeError(
                    f"the profile holds {seen} {symbol} kernels for {n} "
                    f"{fn} launches: it lost device time")

    def breakdown(self, top=10):
        """{"device_ops": the kernels with the most device seconds,
        "idle_gaps": idle device seconds by the host op running at each
        gap's midpoint}."""
        by_name = {}
        for s, t, n in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], None
        for s, t, _ in self.kernels:
            if end is not None and s > end:
                gaps.append(((end + s) / 2, (s - end) / 1e6))
            end = t if end is None else max(end, t)
        starts = [c[0] for c in self.cpu]
        by_host = {}
        for mid, dur in gaps:
            i = bisect.bisect_right(starts, mid)
            name = "(no host op)"
            # the deepest host op holding the midpoint: the latest start
            for j in range(i - 1, max(-1, i - 400), -1):
                s, t, n = self.cpu[j]
                if t >= mid:
                    name = n
                    break
            by_host[name] = by_host.get(name, 0.0) + dur
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[n[:120], v] for n, v in idle]}
