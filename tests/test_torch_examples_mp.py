"""Port parity over a process group: the multi-rank examples of slice 6c
(helloworld_ddp, helloworld_ddp_tutel, helloworld_custom_expert_sharded,
all_to_all_v, bandwidth_test) at W = 2 and 4 gloo ranks
(`testing.RankPool`) against the JAX examples on the first W of the
virtual CPU devices (`jax.devices` narrowed in the pytest process), from
the JAX examples' parameters and inputs through `convert`.

Tolerances: the losses within 1e-5 relative; the all-to-all-v rows and
counts exactly; bandwidth_test's chained outputs exactly for the
exchanges that only move data and within 1e-6 relative for the sums
(summation order), against a numpy emulation of the JAX example's ops.
helloworld_ddp raises unless the gate gradient is bitwise equal on every
rank.

The ranks import this module, so jax is imported only inside the
functions the pytest process calls.
"""

import argparse
import importlib

import numpy as np
import pytest
import torch

from tutel_tpu_torch import convert
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(w):
        if w not in made:
            made[w] = RankPool(w, str(tmp_path_factory.mktemp(f"ranks{w}")))
        return made[w]
    yield get
    for p in made.values():
        p.close()


def _world(monkeypatch, w):
    """jax.devices() narrowed to the first w devices; returns jax."""
    import jax
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:w])
    return jax


def _jit_losses(monkeypatch, name):
    """The loss (output 1) of every call of the jitted function `name`
    made outside a trace, recorded by wrapping jax.jit."""
    import jax
    real, losses = jax.jit, []

    def jit(fun=None, **kw):
        if fun is None:
            return lambda f: jit(f, **kw)
        jf = real(fun, **kw)
        if getattr(fun, "__name__", "") != name:
            return jf

        def wrapped(*a, **k):
            out = jf(*a, **k)
            if not isinstance(out[1], jax.core.Tracer):
                losses.append(float(out[1]))
            return out
        return wrapped
    monkeypatch.setattr(jax, "jit", jit)
    return losses


def _rank_example(name, argv, params=None, x=None):
    mod = importlib.import_module(f"tutel_tpu_torch.examples.{name}")
    kw = {} if params is None and x is None else {"params": params, "x": x}
    return mod.run(mod.build_args(argv), log=lambda *_: None, **kw)


def _params(tree):
    return convert.from_jax_params(tree, "cpu")


def _t(x):
    return convert.to_tensor(np.asarray(x), "cpu")


def _jax_layer(jax, group, **kw):
    from tutel_tpu import moe as jmoe
    return jmoe.moe_layer(seeds=(1, 1, 1), group=group, **kw)


@pytest.mark.parametrize("w", [2, 4])
def test_ddp_matches_jax(pools, monkeypatch, w):
    jax = _world(monkeypatch, w)
    from tutel_tpu.examples import helloworld_ddp as jex
    args = dict(batch_size=16, num_tokens=32, model_dim=64, hidden_size=64,
                num_local_experts=1, top=2, num_steps=3, lr=1e-2,
                dtype="float32")
    ref = _jit_losses(monkeypatch, "train_step")
    jex.run(argparse.Namespace(**args, device="cpu"), log=lambda *_: None)
    layer = _jax_layer(
        jax, jax.devices(),
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": 1,
                 "hidden_size_per_expert": 64}, model_dim=64)
    params = layer.init(jax.random.PRNGKey(1))
    x = jax.random.normal(jax.random.PRNGKey(0), (16, 32, 64))
    argv = [f"--{k}={v}" for k, v in args.items()] + ["--device", "cpu"]
    got = pools(w).run(_rank_example, "helloworld_ddp", argv,
                       _params(params), _t(x))
    assert len(ref) == 3
    for losses in got:
        np.testing.assert_allclose(losses, ref, rtol=1e-5)


@pytest.mark.parametrize("w", [2, 4])
def test_ddp_tutel_matches_jax(pools, monkeypatch, w):
    jax = _world(monkeypatch, w)
    from tutel_tpu.examples import helloworld_ddp_tutel as jex
    argv = ["--device", "cpu", "--num_steps", "3"]
    jargs = jex.build_args(argv)
    ref = jex.run(jargs, log=lambda *_: None)
    layer = _jax_layer(
        jax, jax.devices(),
        gate_type={"type": "top", "k": jargs.top, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": 1,
                 "hidden_size_per_expert": jargs.hidden_size},
        model_dim=jargs.model_dim)
    params = layer.init(jax.random.PRNGKey(1))
    x = jax.random.normal(jax.random.PRNGKey(0),
                          (w * jargs.batch_size * jargs.num_tokens,
                           jargs.model_dim))
    got = pools(w).run(_rank_example, "helloworld_ddp_tutel", argv,
                       _params(params), _t(x))
    for losses in got:
        np.testing.assert_allclose(losses, ref, rtol=1e-5)


@pytest.mark.parametrize("w", [2, 4])
def test_custom_expert_sharded_matches_jax(pools, monkeypatch, w):
    jax = _world(monkeypatch, w)
    from tutel_tpu.examples import helloworld_custom_expert_sharded as jex
    argv = ["--device", "cpu", "--num_steps", "3"]
    jargs = jex.build_args(argv)
    ref = jex.run(jargs, log=lambda *_: None)
    layer = _jax_layer(
        jax, jax.devices(),
        gate_type={"type": "top", "k": jargs.top, "capacity_factor": 1.0},
        experts={"type": "custom", "module": jex.CustomShardedExpert,
                 "num_experts_per_device": jargs.num_local_experts,
                 "my_config": "relu"},
        model_dim=jargs.model_dim, parallel_type="data")
    assert layer.sharded_count == 2
    params = layer.init(jax.random.PRNGKey(1))
    x = jax.random.normal(jax.random.PRNGKey(0),
                          (jargs.batch_size * jargs.num_tokens,
                           jargs.model_dim))
    got = pools(w).run(_rank_example, "helloworld_custom_expert_sharded",
                       argv, _params(params), _t(x))
    for losses in got:
        np.testing.assert_allclose(losses, ref, rtol=1e-5)


@pytest.mark.parametrize("w", [2, 4])
def test_all_to_all_v_matches_jax(pools, monkeypatch, w):
    _world(monkeypatch, w)
    from tutel_tpu.examples import all_to_all_v as jex
    ref_out, ref_recv = jex.run(argparse.Namespace(capacity=16, cols=2,
                                                   device="cpu"),
                                log=lambda *_: None)
    got = pools(w).run(_rank_example, "all_to_all_v",
                       ["--capacity", "16", "--cols", "2", "--device",
                        "cpu"])
    want_gathered = np.concatenate(
        [ref_out[d, :ref_recv[d].sum()] for d in range(w)])
    for d, (out, recv, gathered, gcounts) in enumerate(got):
        np.testing.assert_array_equal(out.numpy(), ref_out[d])
        np.testing.assert_array_equal(recv.numpy(), ref_recv[d])
        np.testing.assert_array_equal(gcounts.numpy(), ref_recv.sum(1))
        n = len(want_gathered)
        np.testing.assert_array_equal(gathered[:n].numpy(), want_gathered)
        assert not gathered[n:].any() and gathered.shape[0] == 16 * w


def _emulate_bandwidth(w, n, iters):
    """The JAX example's chained ops on the W blocks of arange(n), in
    numpy float32."""
    blocks = np.arange(n, dtype=np.float32).reshape(w * w, -1)
    blocks = [blocks[d * w:(d + 1) * w] for d in range(w)]
    c = np.float32(1.0000001)

    def a2a(bs):
        return [np.concatenate([b[d:d + 1] for b in bs]) for d in range(w)]

    def reduce(bs):
        return [np.sum(bs, axis=0, dtype=np.float32)] * w

    def gather(bs):
        return [np.concatenate(bs)[:w]] * w

    def scatter(bs):
        total = np.sum(bs, axis=0, dtype=np.float32)
        return [np.tile(total[d:d + 1], (w, 1)) for d in range(w)]

    out = {}
    for name, op in (("AllToAll", a2a), ("AllReduce", reduce),
                     ("AllGather", gather), ("ReduceScatter", scatter)):
        acc = blocks
        for _ in range(iters):
            acc = op([a * c for a in acc])
        out[name] = acc
    return out


@pytest.mark.parametrize("w", [2, 4])
def test_bandwidth_test_matches_jax(pools, monkeypatch, w):
    _world(monkeypatch, w)
    from tutel_tpu.examples import bandwidth_test as jex
    ref = jex.run(argparse.Namespace(size_mb=1, iters=2, device="cpu",
                                     num_devices=0), log=lambda *_: None)
    got = pools(w).run(_rank_example, "bandwidth_test",
                       ["--size_mb", "1", "--iters", "2", "--device", "cpu"])
    n = 1024 * 1024 // 4 // (w * w) * (w * w)
    want = _emulate_bandwidth(w, n, 2)
    for d, (rates, outputs) in enumerate(got):
        assert sorted(rates) == sorted(ref)
        assert all(r > 0 for r in rates.values())
        for name in ("AllToAll", "AllGather"):
            np.testing.assert_array_equal(outputs[name].numpy(),
                                          want[name][d])
        for name in ("AllReduce", "ReduceScatter"):
            np.testing.assert_allclose(outputs[name].numpy(), want[name][d],
                                       rtol=1e-6)
