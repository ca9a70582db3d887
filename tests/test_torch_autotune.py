"""Port parity: `tutel_tpu_torch.autotune` against `tutel_tpu.autotune`.

The candidate lists of both tuners for the same layers (one rank, dropless,
several local experts, a W = 2 layer over 2 gloo ranks for ragged expert
parallelism), pruning of candidates that raise and the RuntimeError when
none is left, the ConfigStore's JSON (round trips, a store the JAX tuner
wrote loads), and, with `_time_chained` replaced in both packages by the
same fake clock (which runs each step once, so an invalid candidate still
raises), the same `best` and timing keys from `tune_moe` and
`tune_layer_variants`. The real clock is checked for what it returns: a
positive slope that grows with the work of a step.

The ranks import this module, so jax is imported only inside the
functions the pytest process calls.
"""

import json

import numpy as np
import pytest
import torch

from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.autotune import ConfigStore, moe_candidates, tune, \
    tune_moe
from tutel_tpu_torch.autotune import tuner as ttuner
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

LAYERS = {
    "top2_e4": ({"type": "top", "k": 2, "capacity_factor": 1.0}, 4),
    "dropless_e4": ({"type": "top", "k": 2, "capacity_factor": 0.0}, 4),
    "top1_e1": ({"type": "top", "k": 1, "capacity_factor": 1.0}, 1),
}


def _kw(name, hidden=32, dim=32):
    gate, e = LAYERS[name]
    return dict(gate_type=gate,
                experts={"type": "ffn", "num_experts_per_device": e,
                         "hidden_size_per_expert": hidden},
                model_dim=dim, seeds=(1, 1, 1))


def _jax_layer(name, w=1, **over):
    import jax
    from tutel_tpu import moe as jmoe
    return jmoe.moe_layer(group=jax.devices()[:w], **{**_kw(name), **over})


def _torch_layer(name, **over):
    return tmoe.moe_layer(group=[0], device="cpu", **{**_kw(name), **over})


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_moe_candidates_match_jax(name, training):
    from tutel_tpu.autotune import moe_candidates as jcands
    assert moe_candidates(_torch_layer(name), training=training) == \
        jcands(_jax_layer(name), training=training)


def _rank_candidates(name):
    from tutel_tpu_torch import system
    env = system.init_data_model_parallel(device="cpu")
    layer = tmoe.moe_layer(group=env, device="cpu", **_kw(name))
    return moe_candidates(layer)


def test_moe_candidates_at_two_ranks_match_jax(tmp_path):
    from tutel_tpu.autotune import moe_candidates as jcands
    pool = RankPool(2, str(tmp_path))
    try:
        got = pool.run(_rank_candidates, "dropless_e4")
    finally:
        pool.close()
    want = jcands(_jax_layer("dropless_e4", w=2))
    assert {"use_ragged_ep": True} in want
    assert got == [want, want]


def test_layer_variant_candidates_match_jax():
    import jax.numpy as jnp
    from tutel_tpu.autotune.tuner import layer_variant_candidates as jl
    got = ttuner.layer_variant_candidates(use_2dh_hosts=(2, 4),
                                          a2a_dtypes=(torch.bfloat16,))
    want = jl(use_2dh_hosts=(2, 4), a2a_dtypes=(jnp.bfloat16,))
    assert len(got) == len(want) == 4
    assert got[:3] == want[:3]
    assert got[3] == {"a2a_dtype": torch.bfloat16}


def _inputs(name):
    import jax
    jl = _jax_layer(name)
    params = jl.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 32))
    return jl, params, x, convert.from_jax_params(params, "cpu"), \
        convert.to_tensor(np.asarray(x), "cpu")


class _FakeClock:
    """A stand-in for `_time_chained`: runs the step once (so a candidate
    the layer refuses raises as it would under the real clock) and
    returns the next time of a fixed sequence."""

    def __init__(self, times):
        self.times, self.n = times, 0

    def __call__(self, step, init, iters):
        step(0, init)
        t = self.times[self.n % len(self.times)]
        self.n += 1
        return t


def test_tune_moe_with_the_same_clock_matches_jax(monkeypatch, tmp_path):
    from tutel_tpu.autotune import tuner as jtuner
    times = [3e-3, 1e-3, 2e-3, 5e-3, 4e-3, 6e-3]
    monkeypatch.setattr(jtuner, "_time_chained", _FakeClock(times))
    monkeypatch.setattr(ttuner, "_time_chained", _FakeClock(times))
    jl, jp, jx, tp, tx = _inputs("top2_e4")
    tl = _torch_layer("top2_e4")
    cands = [{"adaptive_r": 7, "a2a_ffn_overlap_degree": 1}] + \
        moe_candidates(tl)
    want = jtuner.tune_moe(jl, jp, jx, candidates=cands, iters=1)
    store = ConfigStore(str(tmp_path / "cfg.json"))
    got = tune_moe(tl, tp, tx, candidates=cands, iters=1, store=store,
                   store_key="layer0")
    assert got["best"] == want["best"]
    assert got["timings"] == want["timings"]
    assert '"adaptive_r": 7' not in "".join(got["timings"])
    assert store.load()["layer0"] == got
    out, _ = tl(tp, tx, **json.loads(got["best"]))
    assert out.shape == tx.shape


def test_tune_layer_variants_with_the_same_clock_matches_jax(monkeypatch):
    import jax.numpy as jnp
    from tutel_tpu.autotune import tuner as jtuner
    times = [2e-3, 1e-3, 3e-3]
    monkeypatch.setattr(jtuner, "_time_chained", _FakeClock(times))
    monkeypatch.setattr(ttuner, "_time_chained", _FakeClock(times))
    _, jp, jx, tp, tx = _inputs("top2_e4")
    want = jtuner.tune_layer_variants(
        lambda **o: _jax_layer("top2_e4", **o), jp, jx,
        variants=jtuner.layer_variant_candidates(
            use_2dh_hosts=(1,), a2a_dtypes=(jnp.bfloat16,)), iters=1)
    got = ttuner.tune_layer_variants(
        lambda **o: _torch_layer("top2_e4", **o), tp, tx,
        variants=ttuner.layer_variant_candidates(
            use_2dh_hosts=(1,), a2a_dtypes=(torch.bfloat16,)), iters=1)
    assert got["best"] == want["best"] == \
        '{"num_hosts": "1", "use_2dh": "True"}'
    assert sorted(got["timings"]) == sorted(
        k.replace(str(jnp.bfloat16), str(torch.bfloat16))
        for k in want["timings"])
    assert len(got["timings"]) == 3


def test_invalid_candidates_pruned_and_none_left_raises():
    tl = _torch_layer("top1_e1")
    _, _, _, tp, tx = _inputs("top1_e1")
    bad = [{"adaptive_r": 7, "a2a_ffn_overlap_degree": 1},
           {"top_k": "two"}]
    result = tune_moe(tl, tp, tx, candidates=bad[:1] + moe_candidates(
        tl, overlap_degrees=(1,)), iters=1)
    assert list(result["timings"]) == [
        '{"a2a_ffn_overlap_degree": 1, "adaptive_r": 1}']
    with pytest.raises(RuntimeError, match="no valid tuning candidate"):
        tune_moe(tl, tp, tx, candidates=bad, iters=1)
    with pytest.raises(RuntimeError, match="no valid tuning candidate"):
        tune(lambda cfg: (_ for _ in ()).throw(ValueError(cfg)), [1, 2],
             None)


def test_config_store_round_trips_and_reads_jax_stores(tmp_path,
                                                      monkeypatch):
    from tutel_tpu.autotune import ConfigStore as JStore
    path = str(tmp_path / "sub" / "store.json")
    data = {"moe": {"best": '{"adaptive_r": 1}',
                    "timings": {'{"adaptive_r": 1}': 0.5}}}
    JStore(path).save(data)
    assert ConfigStore(path).load() == data
    ConfigStore(path).save({**data, "more": {"best": "x", "timings": {}}})
    assert JStore(path).load()["more"]["best"] == "x"
    assert open(path).read() == json.dumps(ConfigStore(path).load(),
                                           indent=2, sort_keys=True)
    monkeypatch.setenv("CONFIG_STORE_PATH", path)
    assert ConfigStore().load() == JStore().load()
    monkeypatch.delenv("CONFIG_STORE_PATH")
    empty = ConfigStore()
    empty.save(data)                       # no path: stores nothing
    assert empty.load() == {}


def test_time_chained_is_a_positive_slope():
    def make(work):
        def step(i, carry):
            a = carry
            for _ in range(work):
                a = torch.tanh(a @ a)
            return a
        return step
    x = torch.randn(64, 64) * 0.1
    small = ttuner._time_chained(make(1), x, 3)
    large = ttuner._time_chained(make(40), x, 3)
    assert 0 < small < large
