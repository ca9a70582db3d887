"""The metrics that read the program's own spans: each reads a made-up
traced run to the value worked out by hand, reads None where the port
keeps no spans, and reads a real CPU run of the engine."""

import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from tutel_tpu_torch import trace
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest

MS = 1_000_000          # ns
SERVE = ["chunk_steps.serve", "host_ms_per_step.serve",
         "first_token_p50_ms.serve", "expert_buffer_fill.serve"]


def _rec(id, name, parent, start_ms, end_ms, **attrs):
    r = trace.Record(id, name, parent, int(start_ms * MS), attrs)
    r.end_ns = int(end_ms * MS)
    return r


def _serve_records():
    """Chunk 1 (4 steps, 10 ms) holds an admission (with a 1-ms fetch of
    the first tokens and a prefill's experts call), a step with two
    experts calls of 1,024 rows in 8 x 512, and a 2-ms token fetch; chunk
    2 (2 steps, 6 ms) a 1-ms fetch; chunk 3 (1 ms) decodes nothing. One
    chunk opened before the window. Requests: 1 admitted at 0 and
    answered at 5 ms, 2 at 1 ms and 4 ms; 3 answered but admitted before
    the window, 4 admitted but not answered."""
    E = "tutel.moe.experts"
    return [
        _rec(0, "tutel.engine.chunk", None, -50, -40, steps=100),
        _rec(1, "tutel.request.admit", None, 0, 0, uid=1),
        _rec(2, "tutel.request.admit", None, 1, 1, uid=2),
        _rec(3, "tutel.engine.chunk", None, 2, 12, steps=4, active=3),
        _rec(4, "tutel.engine.admit", 3, 2, 5, requests=2),
        _rec(5, E, 4, 2.5, 3, experts=8, capacity=128, routed=100),
        _rec(6, "tutel.sync", 4, 3, 4, what="first_tokens"),
        _rec(7, "tutel.request.first_token", 4, 4, 4, uid=2),
        _rec(8, "tutel.request.first_token", 4, 5, 5, uid=1),
        _rec(9, "tutel.request.first_token", 4, 5, 5, uid=3),
        _rec(10, "tutel.engine.step", 3, 5, 9, attempt=0),
        _rec(11, E, 10, 6, 7, experts=8, capacity=512, routed=1024),
        _rec(12, E, 10, 7, 8, experts=8, capacity=512, routed=1024),
        _rec(13, "tutel.sync", 3, 9, 11, what="tokens"),
        _rec(14, "tutel.engine.chunk", None, 20, 26, steps=2),
        _rec(15, "tutel.sync", 14, 24, 25, what="tokens"),
        _rec(16, "tutel.engine.chunk", None, 30, 31),
        _rec(17, "tutel.request.admit", None, 32, 32, uid=4),
    ]


def _run(monkeypatch, recs, prof=None, trace_steps=None):
    monkeypatch.setattr(trace, "records", lambda: list(recs))
    tracer = SimpleNamespace(t0=0.0, t1=1.0, prof=prof)
    return SimpleNamespace(tracer=tracer, trace_steps=trace_steps)


def _read(name, run):
    return harness.module("metrics", name).read(run)


@pytest.mark.parametrize("name,want", [
    ("chunk_steps.serve", 3.0),
    # (10 + 6 + 1 ms of chunks - a 3-ms admission - 2 + 1 ms of token
    # fetches) over 6 steps
    ("host_ms_per_step.serve", 11.0 / 6),
    # the median of 5 and 3 ms
    ("first_token_p50_ms.serve", 4.0),
    # the decode step's 2,048 rows in 2 x 8 x 512, not the prefill's
    ("expert_buffer_fill.serve", 25.0),
])
def test_serve_metric_reads_a_made_up_run(monkeypatch, name, want):
    run = _run(monkeypatch, _serve_records())
    assert _read(name, run) == pytest.approx(want)


class _Event:
    def __init__(self, id, name, start, end, thread=1, cuda=False,
                 annotation=False):
        self.id, self.name, self.thread = id, name, thread
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = "DeviceType.CUDA" if cuda else "DeviceType.CPU"
        self.is_user_annotation = annotation


def test_probe_metric_counts_the_kernels_its_spans_launched(monkeypatch):
    """Two probes (us): kernels of 30, then 70 and a 20-us copy, launched
    inside them count; a launch on another thread, one outside, an op
    whose id collides with a kernel's and the device annotation do not."""
    ev = [
        _Event(50, "tutel.moe.probe", 100, 200, annotation=True),
        _Event(7, "cudaLaunchKernel", 120, 125),
        _Event(7, "gemm", 1000, 1030, cuda=True),
        _Event(7, "aten::mm", 118, 130),
        _Event(8, "cudaLaunchKernel", 150, 155, thread=2),
        _Event(8, "scan", 1100, 2100, cuda=True),
        _Event(51, "tutel.moe.probe", 1000, 2100, cuda=True,
               annotation=True),
        _Event(9, "cudaLaunchKernel", 250, 255),
        _Event(9, "scan", 2200, 2700, cuda=True),
        _Event(52, "tutel.moe.probe", 300, 400, annotation=True),
        _Event(10, "cudaLaunchKernelExC", 310, 315),
        _Event(10, "max", 2800, 2870, cuda=True),
        _Event(11, "cudaMemcpyAsync", 320, 330),
        _Event(11, "Memcpy DtoH", 2900, 2920, cuda=True),
    ]
    prof = SimpleNamespace(events=lambda: ev)
    recs = [_rec(0, "tutel.moe.probe", None, 1, 2)]
    run = _run(monkeypatch, recs, prof, trace_steps=2)
    assert _read("probe_ms_per_step.train", run) == pytest.approx(0.06)
    assert _read("probe_ms_per_step.train",
                 _run(monkeypatch, recs, prof, trace_steps=0)) is None


@pytest.mark.parametrize("name", SERVE + ["probe_ms_per_step.train"])
def test_a_port_without_spans_reads_none(monkeypatch, name):
    run = _run(monkeypatch, [], SimpleNamespace(events=lambda: []), 3)
    assert _read(name, run) is None
    monkeypatch.setitem(sys.modules, "tutel_tpu_torch.trace", None)
    assert _read(name, run) is None


def test_serve_metrics_read_a_real_cpu_run(monkeypatch):
    """A small engine (speculative capacity, 7 requests through 3 slots)
    under a CPU profile: the spans the port records are the ones the
    metrics read."""
    torch.set_num_threads(1)
    cfg = TransformerMoEConfig(
        vocab_size=61, max_len=48, model_dim=32, num_heads=2, num_layers=2,
        ffn_hidden=64, moe_every=2, num_local_experts=4, top_k=2,
        expert_hidden=64, capacity_factor=8.0)
    model = TransformerMoE(cfg, device="cpu")
    eng = LmDecodeEngine(model, model.init(torch.Generator().manual_seed(0)),
                         max_batch=3, speculative_capacity=4.0,
                         capacity_bucket=1)
    rng = np.random.default_rng(0)
    reqs = [LmRequest(uid=i, prompt=rng.integers(0, 61, 3 + i % 3),
                      max_new_tokens=2 + i % 4) for i in range(7)]
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        eng.run(reqs, chunk=3)
        t1 = time.perf_counter()
    run = SimpleNamespace(tracer=SimpleNamespace(t0=t0, t1=t1, prof=None),
                          trace_steps=eng.stats["steps"])
    got = {n: _read(n, run) for n in SERVE}
    trace.clear()
    assert 1 <= got["chunk_steps.serve"] <= 3
    assert got["host_ms_per_step.serve"] > 0
    assert 0 < got["first_token_p50_ms.serve"] < 1e3 * (t1 - t0)
    # every slot routes top-2 of 4 experts into a 4 x 3 buffer at most
    assert 50.0 <= got["expert_buffer_fill.serve"] <= 100.0
