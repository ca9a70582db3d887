"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout of the repository. The cell's file names its
configuration and traffic generator (see `harness`). The run builds the
port's objects from the seed, warms up, measures for `--seconds`, checks
what the timed path produced against the plain reference, and prints one
JSON line last on stdout: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics of BENCHMARK.json, or with `--trace 1`
its per-layer metrics, read from a profiled sub-window), `device`,
`breakdown` (traced runs) and, last, `checks`: each compared number with
its limit, which also end stderr.

It exits non-zero and prints no result when no CUDA device is there,
when fewer devices are there than the cell asks for, when the port is
not the checkout's own, or when the process holds the JAX package, JAX
or the JAX package's benchmark once the window has closed. Build outputs
stay under build/ in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# every kernel cache of the program at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

from portbench import faults, harness, tracing  # noqa: E402

TRACE_AT = 0.4           # the traced sub-window opens at this share


class Context:
    """What a traffic generator gets, and what it hands back."""

    def __init__(self, cell, seed, seconds, device, tracer=None,
                 control=None, fault=None, t_start=T_START):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.config = cell["config_data"]
        self.params = cell["params"]
        self.device = device
        self.entry = harness.module("entries", self.config["entry"])
        self.reference = harness.module("reference", self.config["entry"])
        self.tracer, self.control, self.fault = tracer, control, fault
        self.notes, self.rec, self.checks = {}, None, None
        self.memory_peak = 0
        self.trace_steps = None
        self._trace_t0 = None
        self.clock = time.perf_counter
        self.t_start = t_start

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize()

    def apply_fault(self, obj):
        if self.fault:
            faults.apply(self.fault, obj)

    def window_start(self, t0):
        self.t0 = t0
        self.setup_s = t0 - self.t_start

    def running(self):
        """Whether the window goes on: until `seconds` have passed, and in
        a traced run also until its sub-window has closed."""
        if self.clock() - self.t0 < self.seconds:
            return True
        return self.tracer is not None and (
            self._trace_t0 is None or self.tracer.recording)

    def maybe_trace(self, steps):
        """Open the traced sub-window at TRACE_AT of the window; close it
        after the cell's `trace_seconds` (default 3)."""
        tr = self.tracer
        if tr is None:
            return
        now = self.clock()
        if self._trace_t0 is None and now - self.t0 >= TRACE_AT \
                * self.seconds:
            tr.start()
            self._trace_t0, self._steps0 = self.clock(), steps()
        elif tr.recording and now - self._trace_t0 >= self.params.get(
                "trace_seconds", 3.0):
            self._close_trace(steps)

    def _close_trace(self, steps):
        self.tracer.stop()
        self.trace_steps = steps() - self._steps0

    def window_end(self, t1, steps):
        self.window_s = t1 - self.t0
        if self.tracer is not None and self.tracer.recording:
            self._close_trace(steps)

    def read_memory(self):
        if self.device.type == "cuda":
            import torch
            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            import torch
            torch.cuda.empty_cache()

    def note(self, **kw):
        self.notes.update(kw)

    def outcome(self, rec, checks):
        self.rec, self.checks = rec, checks


def fail(msg, code):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def device_or_exit(chips):
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this benchmark measures "
             "the port on a CUDA device", 3)
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} devices, "
             f"{torch.cuda.device_count()} are there", 3)
    return torch.device("cuda", 0)


def own_port_or_exit():
    import tutel_tpu_torch
    path = pathlib.Path(tutel_tpu_torch.__file__).resolve()
    if ROOT not in path.parents:
        fail(f"tutel_tpu_torch comes from {path}, not from this checkout", 5)


def metric_values(run, metrics):
    out = {}
    for m in metrics:
        v = harness.module("metrics", m["name"]).read(run)
        if v is None:
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def power_limit_w():
    """The card's power limit in watts as nvidia-smi reads it, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def execute(cell, seed, seconds, trace, device=None, control=None,
            fault=None, bench=None, t_start=T_START):
    """One run of `cell` (a name, or a cell's dict as `harness.cell`
    gives it): (context, metrics, device, breakdown)."""
    bench = bench or harness.benchmark()
    if isinstance(cell, str):
        cell = harness.cell(cell)
    cell_name = cell["name"]
    if device is None:
        device = device_or_exit(cell["chips"])
    own_port_or_exit()
    kind = "per_layer" if trace else "end_to_end"
    metrics = harness.metrics_of(bench, cell_name, kind)
    tracer = None
    if trace:
        tracer = tracing.Tracer()
        for m in metrics:
            tracer.install(getattr(harness.module("metrics", m["name"]),
                                   "WRAPS", []))
        tracer.warm()          # the profiler's first start, in set-up
    ctx = Context(cell, seed, seconds, device, tracer, control, fault,
                  t_start)
    ctx.device_kind = (__import__("torch").cuda.get_device_name(0)
                       if device.type == "cuda" else "cpu")
    harness.module("traffic", cell["generator"]).run(ctx)
    ctx.trace = None
    if tracer is not None:
        tracer.uninstall()
        if tracer.prof is not None:
            ctx.trace = tr = tracer.reduce()
            ctx.note(trace_steps=ctx.trace_steps, event_s=tr.event_s,
                     launch_check=tr.launch_check,
                     device_s_by_range=tr.device_s_by_range,
                     device_s_backward=tr.device_s_backward,
                     kernel_s={fn: tr.kernel_s([sym]) for _, fn, sym
                               in tracing.LAUNCH_COUNTERS})
    ctx.note(launches=tracing.launches())
    values = metric_values(ctx, metrics)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": ctx.device_kind,
           "count": cell["chips"], "memory_peak_bytes": ctx.memory_peak}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    breakdown = None
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        breakdown = ctx.trace.breakdown()
    return ctx, values, dev, breakdown


def verdict(ctx):
    """`correct`: nothing failed, and every compared number is within its
    limit."""
    return ctx.rec["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in ctx.checks.values())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    ctx, values, dev, breakdown = execute(args.workload, args.seed,
                                          args.seconds, args.trace)
    found = harness.forbidden_modules()
    if found:
        fail(f"the run holds {found} once its window has closed", 4)
    checks = ctx.checks
    correct = verdict(ctx)
    print(json.dumps({"notes": ctx.notes, "setup_s": ctx.setup_s,
                      "window_s": ctx.window_s}, default=str),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, ctx.rec["attempted"],
                              ctx.rec["failed"], values, dev, checks,
                              breakdown), flush=True)


if __name__ == "__main__":
    main()
