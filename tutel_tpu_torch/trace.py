"""Spans and instant events inside the port, on the torch profiler's clock.

Tracing is on exactly while a torch profiler records (the benchmark's
traced sub-window, `system.profile_trace`, or an operator's own
`torch.profiler.profile`); there is no other switch. Off, `span()`
returns one shared no-op object after a single read of the profiler's
module flag: no `record_function`, no record, no device op.

On, a span opens a profiler range of its name on the host timeline and
keeps an in-memory `Record` (id, name, parent id, `perf_counter_ns` start
and end, attributes). Counts known only inside a span are added with
`set(**attrs)`; code that computes them tests the span first
(`if sp: sp.set(...)`), so the off path computes nothing.

The range is torch's function-scope range (`_RecordFunctionFast`, as
compiled code uses), not a `record_function` user annotation: it costs
a few microseconds a span where `record_function` costs ~17-19 on the
host, and it leaves the device timeline's user annotations to the
caller's own ranges. The profiler hands each kernel
to the innermost user range only, so a span there would take the
kernels of a user range it encloses. A span's kernels are the ones
launched inside it: a launch and its kernel share a correlation id.

The clock: the first span after `clear()` (or the first ever) records a
zero-length range `tutel.clock` and a record of the same name, whose
`start_ns` is read as the range closes. The range's end and that
`start_ns` map every record onto the profiler's timeline: profiler us =
clock range end + (record ns - clock ns) / 1e3.
A record and its profiler range join by name and order: the k-th record
named X is the k-th range named X. Call `clear()` before a profile to
start a fresh set (`system.profile_trace` does).

Spans nest in the order they open; open them from one thread.
"""

import itertools
import time

import torch
import torch.autograd.profiler as _profiler

_Range = torch._C._profiler._RecordFunctionFast
CLOCK = "tutel.clock"
SYNC = "tutel.sync"


class Record:
    """One span (or, with end_ns == start_ns, one event)."""

    __slots__ = ("id", "name", "parent", "start_ns", "end_ns", "attrs")

    def __init__(self, id, name, parent, start_ns, attrs):
        self.id, self.name, self.parent = id, name, parent
        self.start_ns = self.end_ns = start_ns
        self.attrs = attrs


class _Noop:
    """The span while no profiler records: does nothing, tests False."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


NOOP = _Noop()


class _State:
    def __init__(self):
        self.ids = itertools.count()
        self.records = []
        self.stack = []
        self.clock_ns = None


_STATE = _State()


class _Span:
    __slots__ = ("rec", "_range")

    def __init__(self, name, attrs):
        self.rec = Record(None, name, None, 0, attrs)

    def __bool__(self):
        return True

    def __enter__(self):
        st = _STATE
        if st.clock_ns is None:
            _mark_clock(st)
        rec = self.rec
        rec.id = next(st.ids)
        rec.parent = st.stack[-1].id if st.stack else None
        st.records.append(rec)
        st.stack.append(rec)
        self._range = _Range(rec.name)
        rec.start_ns = rec.end_ns = time.perf_counter_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.rec.end_ns = time.perf_counter_ns()
        _STATE.stack.pop()
        return False

    def set(self, **attrs):
        self.rec.attrs.update(attrs)


def _mark_clock(st):
    # read as the range closes: the first range a process opens is slow to
    # open (a millisecond after the profiler's start stamp), not to close
    with _Range(CLOCK):
        st.clock_ns = time.perf_counter_ns()
    st.records.append(Record(next(st.ids), CLOCK, None, st.clock_ns, {}))


def enabled():
    """Whether a torch profiler records (spans and events are kept)."""
    return _profiler._is_profiler_enabled


def span(name, **attrs):
    """A context manager: a profiler range and a record while a profiler
    records, else the shared no-op `NOOP`."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    return _Span(name, attrs)


def sync(what):
    """`span("tutel.sync", what=what)`: a host read that waits on the
    device."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    return _Span(SYNC, {"what": what})


def event(name, **attrs):
    """An instant record (a zero-length range) while a profiler records."""
    if _profiler._is_profiler_enabled:
        with _Span(name, attrs):
            pass


def records():
    """The records kept since the last `clear()`, in the order they
    opened."""
    return list(_STATE.records)


def clear():
    """Drop the records; the next span records the clock again."""
    _STATE.records = []
    _STATE.clock_ns = None
