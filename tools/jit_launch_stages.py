#!/usr/bin/env python3
"""Host time of one K9 (jit.inject_kernel) and one K10 (jit.pallas_kernel)
call, stage by stage, on one NVIDIA GPU.

Run from the root of a checkout; it imports that checkout's
tutel_tpu_torch and chip_smoke.py:

    python3 tools/jit_launch_stages.py

Cases: chip_smoke.py's `x * s + 1` source on float32 [256, 128] and
[16384, 2048] (K9); squared ReLU and tanh-GELU on bfloat16 [128, 32,
2048] (K10). For each it prints one JSON line with

  host_us, library_host_us: chip_smoke.host_us (1,000 calls without a
      synchronize) of the wrapper and of its library call
      (torch.addcmul, F.gelu), nothing instrumented;
  stages_us: a fresh wrapper for the same kernel called CALLS times
      after a warm-up, with time.perf_counter_ns around each function of
      STAGES that the call reaches (the library's own functions, wrapped
      for the run) and around the call itself, as mean µs per call;
      `timers` is what the wrapping costs a call (the wrapped calls
      times `timer_us`, a timed no-op less a plain one, measured just
      before), and `rest` the call less its stages and timers: the
      wrapper's own Python;
  reached: how many times one call reached each stage.

Because it wraps the functions the launch path calls instead of copying
that path, it follows whichever launch path the checkout has (a stage the
path does not call reads 0), and it fails unless every call reached the
kernel library's launch entry exactly once. It also prints what the stream lookups and output allocations a launch
path could use cost alone (`candidates`).
"""

import collections
import ctypes
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from tutel_tpu_torch import jit  # noqa: E402
from tutel_tpu_torch.csrc import build  # noqa: E402

ns = time.perf_counter_ns
CALLS = 1000
ENTRY = "tt_jit_launch"        # the launch entry of every jit library
LAUNCH = "launch entry (ctypes call and C side)"
# (stage, owner, attribute): the functions a K9/K10 launch path may call;
# an attribute the checkout lacks is skipped
STAGES = (
    ("device check", jit, "_cuda_index"),
    ("output specs", jit, "_out_specs"),
    ("output allocation", torch, "empty"),
    ("output allocation", torch, "empty_like"),
    ("output allocation", torch.Tensor, "new_empty"),
    ("grid", jit, "_max_blocks"),
    ("stream lookup", torch.cuda, "current_stream"),
    ("stream lookup", jit, "_current_stream"),
    ("record packing", jit._Launcher, "pack"),
    ("error check", build, "check"),
)


class Timers:
    """STAGES and the launch entry of each jit library loaded meanwhile,
    wrapped with timers while the context is open."""

    def __init__(self):
        self.spent = collections.Counter()
        self.reached = collections.Counter()
        self._undo = []

    def timed(self, stage, fn):
        def call(*args, **kwargs):
            t0 = ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spent[stage] += ns() - t0
                self.reached[stage] += 1
        return call

    def _patch(self, owner, attr, value):
        self._undo.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, value)

    def __enter__(self):
        for stage, owner, attr in STAGES:
            if hasattr(owner, attr):
                self._patch(owner, attr,
                            self.timed(stage, getattr(owner, attr)))
        load_source = build.load_source

        def load(*args, **kwargs):
            # the library is loaded once per process; a launcher made
            # meanwhile reads its entry after this returns
            lib = load_source(*args, **kwargs)
            if ENTRY not in lib.__dict__ or \
                    not getattr(lib.__dict__[ENTRY], "timed", False):
                entry = self.timed(LAUNCH, getattr(lib, ENTRY))
                entry.timed = True
                self._patch(lib, ENTRY, entry)
            return lib
        self._patch(build, "load_source", load)
        return self

    def __exit__(self, *exc):
        for owner, attr, old in reversed(self._undo):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._undo.clear()

    def reset(self):
        self.spent.clear()
        self.reached.clear()


def timer_us():
    """What a timed call costs more than a plain one, in µs."""
    noop = Timers().timed("noop", lambda: None)
    return per_call_us(noop) - per_call_us(lambda: None)


def stages(make, args, calls):
    """Mean µs per call of each stage of `make()(*args)`, and how many
    times a call reached each."""
    overhead = timer_us()
    with Timers() as timers:
        f = make()
        for _ in range(10):                      # builds, loads, lifts
            f(*args)
        torch.cuda.synchronize()
        timers.reset()
        total = 0
        for i in range(calls):
            t0 = ns()
            f(*args)
            total += ns() - t0
            if i % 100 == 99:                    # keep the queue short
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        if timers.reached[LAUNCH] != calls:
            raise RuntimeError(f"{calls} calls reached the launch entry "
                               f"{timers.reached[LAUNCH]} times")
        us = {k: v / calls / 1e3 for k, v in timers.spent.items()}
        us["timers"] = sum(timers.reached.values()) / calls * overhead
        us["rest"] = total / calls / 1e3 - sum(us.values())
        us["call"] = total / calls / 1e3
        return us, {k: v / calls for k, v in timers.reached.items()}


def per_call_us(fn, calls=10000):
    fn()
    t0 = ns()
    for _ in range(calls):
        fn()
    return (ns() - t0) / calls / 1e3


def candidates():
    """The stream lookups and output allocations alone, a ctypes call of
    libc's getpid, the cost of a timer around a call, and whether the raw
    stream is PyTorch's current one inside a stream context."""
    dev = torch.device("cuda", 0)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        same = (torch._C._cuda_getCurrentRawStream(0) ==
                torch.cuda.current_stream(0).cuda_stream == side.cuda_stream)
    x = torch.empty(128, 32, 2048, dtype=torch.bfloat16, device=dev)
    x32 = torch.empty(16384, 2048, dtype=torch.float32, device=dev)
    shape = (16384, 2048)
    return {
        "current_stream_cuda_stream_us": per_call_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream_us": per_call_us(
            lambda: torch._C._cuda_getCurrentRawStream(0)),
        "raw_stream_is_current_in_side_stream": same,
        "empty_device_object_us": per_call_us(
            lambda: torch.empty(shape, dtype=torch.float32, device=dev)),
        "new_empty_dtype_us": per_call_us(
            lambda: x32.new_empty(shape, dtype=torch.float32)),
        "empty_like_us": per_call_us(lambda: torch.empty_like(x)),
        "ctypes_getpid_us": per_call_us(ctypes.CDLL(None).getpid),
        "timer_us": timer_us(),
    }


def main():
    if not torch.cuda.is_available():
        print("jit_launch_stages.py: no CUDA device", file=sys.stderr)
        return 1
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip().splitlines()[0]
    print(json.dumps({"device": smi}), flush=True)
    print(json.dumps({"candidates": candidates()}), flush=True)
    s = torch.full((1, 1), 3.0, device="cuda")
    one = torch.ones((), device="cuda")
    for rows, cols, tile in ((256, 128, 128), (16384, 2048, 16)):
        f = chip_smoke.inject_scale(rows, cols, tile)
        x = torch.randn(rows, cols, device="cuda")
        host = chip_smoke.host_us(lambda: f(x, s))
        us, reached = stages(
            lambda: chip_smoke.inject_scale(rows, cols, tile), (x, s),
            CALLS)
        print(json.dumps({
            "kernel": "inject_kernel", "shape": f"float32_{rows}x{cols}",
            "host_us": host, "library_host_us": chip_smoke.host_us(
                lambda: torch.addcmul(one, x, s)),
            "stages_us": us, "reached": reached}), flush=True)
    x = torch.randn(128, 32, 2048, device="cuda").to(torch.bfloat16)
    for label, kernel, library in (
            ("squared_relu", chip_smoke.SQUARED_RELU, None),
            ("gelu_tanh", chip_smoke.GELU_TANH,
             chip_smoke.activations.gelu)):
        host = chip_smoke.host_us(lambda: kernel(x))
        us, reached = stages(lambda: jit.pallas_kernel(kernel.fn), (x,),
                             CALLS)
        print(json.dumps({
            "kernel": "pallas_kernel", "function": label,
            "shape": "bfloat16_128x32x2048", "host_us": host,
            "library_host_us": None if library is None else
            chip_smoke.host_us(lambda: library(x)),
            "stages_us": us, "reached": reached}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
