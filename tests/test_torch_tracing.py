"""The port's spans and events (`tutel_tpu_torch.trace`).

Off unless a torch profiler records: every site gets the one shared no-op
object and nothing is kept. Under `torch.profiler.profile` a small
`LmDecodeEngine` run (the SMALL model of tests/test_torch_lm_serving.py,
greedy, with and without speculative capacity and its replays) records
the documented tree, its counts agree with the engine's `stats`, each
request's events come in order, each record joins its profiler range by
name and order, the `tutel.clock` pair maps the records onto the
profiler's clock, and the tokens equal those of an untraced run. A
dropless training forward of `MOELayer` records its capacity probe, and
a W = 2 gloo forward its all-to-all.

The ranks import this module to find their functions: it imports no jax.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch import system, trace
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.ops import routing as routing_ops
from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)
# the SMALL model of tests/test_torch_lm_serving.py
SMALL = dict(vocab_size=61, max_len=48, model_dim=32, num_heads=2,
             num_layers=2, ffn_hidden=64, moe_every=2, num_local_experts=4,
             top_k=2, expert_hidden=64, capacity_factor=8.0)
# speculative capacity margins: off, and one that overflows and replays
MARGINS = [0.0, 0.5]
STEP_CHILDREN = {"tutel.attn.decode", "tutel.moe.route", "tutel.moe.encode",
                 "tutel.moe.experts", "tutel.moe.decode",
                 "tutel.attn.kv_write"}


def _model():
    model = TransformerMoE(TransformerMoEConfig(**SMALL), device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _serve(margin):
    """7 requests through 3 slots: (engine, {uid: tokens}). A fresh model
    each time: a model keeps its engines' observed capacities."""
    model, params = _model()
    eng = LmDecodeEngine(model, params, max_batch=3,
                         speculative_capacity=margin, capacity_bucket=1)
    rng = np.random.default_rng(0)
    reqs = [LmRequest(uid=i, prompt=rng.integers(0, 61, 3 + i % 3),
                      max_new_tokens=2 + i % 4) for i in range(7)]
    out = eng.run(reqs, chunk=3)
    return eng, {u: t.tolist() for u, t in out.items()}


@pytest.fixture(scope="module")
def runs():
    """Per margin: the untraced run, the traced run, its records and the
    profiler's CPU events."""
    got = {}
    for margin in MARGINS:
        trace.clear()
        off = _serve(margin)
        kept_off = trace.records()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = _serve(margin)
        recs = trace.records()
        events = [e for e in prof.events()
                  if e.name.startswith("tutel.")]
        got[margin] = dict(off=off, on=on, kept_off=kept_off, recs=recs,
                           events=events)
    trace.clear()
    return got


def _children(recs):
    kids = collections.defaultdict(list)
    for r in recs:
        kids[r.parent].append(r)
    return kids


@pytest.mark.parametrize("site", ["span", "sync", "event"])
def test_off_returns_the_shared_noop_and_keeps_nothing(runs, site):
    assert not trace.enabled()
    if site == "span":
        sp = trace.span("tutel.engine.chunk", steps=1)
    elif site == "sync":
        sp = trace.sync("tokens")
    else:
        sp = trace.event("tutel.request.admit", uid=0)
        assert sp is None
        sp = trace.NOOP
    assert sp is trace.NOOP and not sp
    with sp as inner:
        inner.set(steps=2)
    assert trace.records() == []
    for margin in MARGINS:
        assert runs[margin]["kept_off"] == []


@pytest.mark.parametrize("margin", MARGINS)
def test_engine_records_the_documented_tree(runs, margin):
    eng, _ = runs[margin]["on"]
    recs = runs[margin]["recs"]
    by_id = {r.id: r for r in recs}
    kids = _children(recs)
    assert recs[0].name == trace.CLOCK
    chunks = [r for r in recs if r.name == "tutel.engine.chunk"]
    assert chunks and all(r.parent is None for r in chunks)
    assert sum(r.attrs.get("steps", 0) for r in chunks) == eng.stats["steps"]
    assert sum(r.attrs.get("replays", 0) for r in chunks) \
        == eng.stats["spec_retries"]
    if margin:
        assert eng.stats["spec_retries"] > 0
    steps = [r for r in recs if r.name == "tutel.engine.step"]
    assert len(steps) == eng.stats["steps"] + sum(
        r.attrs.get("replays", 0) * r.attrs.get("steps", 0) for r in chunks)
    for st in steps:
        assert by_id[st.parent].name == "tutel.engine.chunk"
        names = {k.name for k in kids[st.id]}
        assert STEP_CHILDREN <= names
        assert ("tutel.moe.probe" in names) == (margin > 0)
        assert st.attrs["attempt"] <= by_id[st.parent].attrs["replays"]
    for probe in (r for r in recs if r.name == "tutel.moe.probe"):
        assert [k.name for k in kids[probe.id]] == ["tutel.moe.route"]
    admits = [r for r in recs if r.name == "tutel.engine.admit"]
    assert sum(r.attrs["requests"] for r in admits) == eng.stats["joined"]
    for ad in admits:
        assert by_id[ad.parent].name == "tutel.engine.chunk"
        names = [k.name for k in kids[ad.id]]
        assert "tutel.attn.prefill" in names and "tutel.sync" in names
        assert ad.attrs["padded_tokens"] >= ad.attrs["prompt_tokens"]
    sweeps = [r for r in recs if r.name == "tutel.engine.sweep"]
    assert sum(r.attrs["finished"] for r in sweeps) <= eng.stats["finished"]
    for sp in recs:
        assert sp.start_ns <= sp.end_ns
        if sp.parent is not None:
            p = by_id[sp.parent]
            assert p.start_ns <= sp.start_ns and sp.end_ns <= p.end_ns


@pytest.mark.parametrize("margin", MARGINS)
def test_each_request_is_admitted_answered_and_finished_in_order(runs,
                                                                 margin):
    eng, tokens = runs[margin]["on"]
    order = collections.defaultdict(list)
    for r in runs[margin]["recs"]:
        if r.name.startswith("tutel.request."):
            order[r.attrs["uid"]].append(r.name.split(".")[-1])
    assert sorted(order) == sorted(tokens)
    for uid, seen in order.items():
        assert seen == ["admit", "first_token", "finish"], uid


@pytest.mark.parametrize("margin", MARGINS)
def test_records_join_their_profiler_ranges_on_one_clock(runs, margin):
    recs, events = runs[margin]["recs"], runs[margin]["events"]
    ranges = collections.defaultdict(list)
    for e in sorted(events, key=lambda e: e.time_range.start):
        ranges[e.name].append(e.time_range.start)
    clock_us = [e.time_range.end for e in events if e.name == trace.CLOCK]
    named = collections.defaultdict(list)
    for r in recs:
        named[r.name].append(r.start_ns)
    assert {k: len(v) for k, v in named.items()} \
        == {k: len(v) for k, v in ranges.items()}
    clock_us, clock_ns = clock_us[0], named[trace.CLOCK][0]
    for name, starts in named.items():
        if name == trace.CLOCK:
            continue
        for ns, us in zip(starts, ranges[name]):
            assert abs(clock_us + (ns - clock_ns) / 1e3 - us) < 1e3, name


@pytest.mark.parametrize("margin", MARGINS)
def test_greedy_tokens_are_the_same_traced_and_not(runs, margin):
    assert runs[margin]["on"][1] == runs[margin]["off"][1]
    assert runs[margin]["on"][0].stats == runs[margin]["off"][0].stats


def test_dropless_training_forward_records_its_probe():
    layer = tmoe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        experts={"type": "ffn", "num_experts_per_device": 4,
                 "hidden_size_per_expert": 32},
        model_dim=16, device="cpu")
    params = layer.init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 24, 16, generator=torch.Generator().manual_seed(1))
    want = layer.resolve_capacity(params, x, training=True)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        layer(params, x, training=True)
    recs = trace.records()
    trace.clear()
    by_id = {r.id: r for r in recs}
    kids = _children(recs)
    probes = [r for r in recs if r.name == "tutel.moe.probe"]
    assert len(probes) == 1
    assert [k.name for k in kids[probes[0].id]] == ["tutel.moe.route"]
    assert kids[probes[0].id][0].attrs["capacity"] == 1
    syncs = [r for r in recs if r.name == "tutel.sync"]
    assert [s.attrs["what"] for s in syncs] == ["capacity"]
    experts = [r for r in recs if r.name == "tutel.moe.experts"]
    assert len(experts) == 1
    assert experts[0].attrs["capacity"] == want
    assert experts[0].attrs["experts"] == 4
    assert experts[0].attrs["routed"] == 2 * 48
    assert experts[0].attrs["bits"] == 32
    routes = [r for r in recs if r.name == "tutel.moe.route"
              and by_id.get(r.parent) is None]
    assert [r.attrs["capacity"] for r in routes] == [want]


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_route_records_its_scan_tiles(device):
    """`tutel.moe.route` carries the location scan's tiles: 0 where the
    plain twin runs (CPU), ceil(K*S / TILE) on CUDA."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the location scan has no CPU mode")
    layer = tmoe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        experts={"type": "ffn", "num_experts_per_device": 4,
                 "hidden_size_per_expert": 32},
        model_dim=16, device=device)
    params = layer.init(torch.Generator(device=device).manual_seed(0))
    tokens = 3000                      # 6,000 routings: two tiles on CUDA
    x = torch.randn(2, tokens // 2, 16, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        layer(params, x, training=True)
    routes = [r for r in trace.records() if r.name == "tutel.moe.route"]
    trace.clear()
    assert len(routes) == 2                 # the probe's and the forward's
    want = 0 if device == "cpu" else -(-2 * tokens // routing_ops.TILE)
    assert [r.attrs["scan_tiles"] for r in routes] == [want, want]


def test_profile_trace_starts_a_fresh_record_set(tmp_path):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("tutel.engine.chunk"):
            pass
    assert [r.name for r in trace.records()] == [trace.CLOCK,
                                                 "tutel.engine.chunk"]
    with system.profile_trace(str(tmp_path)):
        with trace.span("tutel.engine.step") as sp:
            sp.set(attempt=0)
    recs = trace.records()
    trace.clear()
    assert [r.name for r in recs] == [trace.CLOCK, "tutel.engine.step"]
    assert recs[1].attrs == {"attempt": 0}
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {trace.CLOCK, "tutel.engine.step"} <= names


# -- W = 2 ------------------------------------------------------------------

def _rank_a2a(x):
    layer = tmoe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": 1,
                 "hidden_size_per_expert": 32},
        model_dim=16, device="cpu")
    params = layer.shard_params(layer.init(torch.Generator().manual_seed(0)))
    n = x.shape[0] // dist.get_world_size()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        layer(params, x[dist.get_rank() * n:(dist.get_rank() + 1) * n])
    recs = trace.records()
    trace.clear()
    return [(r.name, r.attrs) for r in recs]


def test_the_all_to_all_records_its_bytes_at_world_2(tmp_path):
    pool = RankPool(2, str(tmp_path))
    try:
        got = pool.run(_rank_a2a, torch.randn(
            16, 16, generator=torch.Generator().manual_seed(2)))
    finally:
        pool.close()
    for recs in got:
        a2a = [attrs for name, attrs in recs if name == "tutel.moe.a2a"]
        # there and back, each the [E=2, C, 16] float32 buffer
        assert len(a2a) == 2
        cap = [attrs for name, attrs in recs
               if name == "tutel.moe.experts"][0]["capacity"]
        assert a2a[0]["bytes"] == a2a[1]["bytes"] > 0
        assert a2a[0]["bytes"] == 2 * (cap // 2) * 16 * 4
