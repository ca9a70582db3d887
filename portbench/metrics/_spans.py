"""What the program-span metrics share: the port's own spans
(`tutel_tpu_torch.trace.records()`) of the traced sub-window, their
ancestry, and the device time of the kernels each span launched.

A checkout whose port has no `trace` module gives no records, and every
metric that reads them then reads None."""

import bisect
import importlib


def records(run):
    """The port's records that opened inside the traced sub-window, or
    None where the port keeps none."""
    try:
        trace = importlib.import_module("tutel_tpu_torch.trace")
    except ModuleNotFoundError:
        return None
    tr = run.tracer
    if tr is None or getattr(tr, "t1", None) is None:
        return None
    t0, t1 = tr.t0 * 1e9, tr.t1 * 1e9
    recs = [r for r in trace.records() if t0 <= r.start_ns <= t1]
    return recs or None


def named(recs, name):
    return [r for r in recs if r.name == name]


def within(recs, name, outer):
    """The records named `name` with an ancestor named `outer`."""
    by_id = {r.id: r for r in recs}

    def inside(r):
        while r.parent is not None:
            r = by_id.get(r.parent)
            if r is None:
                return False
            if r.name == outer:
                return True
        return False
    return [r for r in named(recs, name) if inside(r)]


def seconds(recs):
    return sum(r.end_ns - r.start_ns for r in recs) / 1e9


def launched_device_s(run, name):
    """Device seconds of the kernels, copies and sets launched while a
    profiler range named `name` was open on the launching thread, summed
    over the range's instances.

    A launch (a CUDA runtime call on the host) and the device work it
    queued share a correlation id. The device timeline's user annotations
    would not do: the port's spans are function-scope ranges, and the
    profiler gives each kernel to the innermost user range only, so a
    range that holds another has no extent of its own over its
    kernels."""
    events = list(run.tracer.prof.events())
    device = {}
    for e in events:
        if str(e.device_type).endswith("CUDA") and not getattr(
                e, "is_user_annotation", False):
            device[e.id] = e.time_range.end - e.time_range.start
    outer = {}
    for e in events:
        if e.name == name and not str(e.device_type).endswith("CUDA"):
            outer.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end))
    if not outer:
        return None
    for spans in outer.values():
        spans.sort()
    total = 0.0
    for e in events:
        if e.id not in device or not e.name.startswith("cu") \
                or str(e.device_type).endswith("CUDA"):
            continue
        spans, t = outer.get(e.thread, ()), e.time_range.start
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            total += device[e.id]
    return total / 1e6
