"""Port parity: the MoE layer (tutel_tpu_torch.moe.MOELayer) against the
JAX MOELayer on one device, with the same parameters (converted through
numpy) and the same inputs: float, INT4 fused-stream and INT4 two-call
experts under padded (dropping) and dropless capacity, with valid_tokens
masking, megablocks rounding and the load-importance loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu import moe as jmoe
from tutel_tpu.ops import fused_ffn_pallas as jfp
from tutel_tpu.ops import quant as jq
from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe

torch.set_num_threads(1)

S, E = 24, 4


def _layers(model_dim, hidden, gate=None, **kw):
    gate = {"type": "top", "k": 2, **(gate or {})}
    experts = {"type": "ffn", "num_experts_per_device": E,
               "hidden_size_per_expert": hidden}
    j = jmoe.moe_layer(gate_type=gate, experts=dict(experts),
                       model_dim=model_dim, seeds=(1, 1, 1),
                       group=jax.devices()[:1], **kw)
    t = tmoe.moe_layer(gate_type=gate, experts=dict(experts),
                       model_dim=model_dim, device="cpu", **kw)
    return j, t


def _params(jlayer, quant):
    jp = jlayer.init(jax.random.PRNGKey(0))
    if quant:
        jp = dict(jp)
        jp["experts"] = jq.quantize_expert_params(jp["experts"], bits=4)
        if quant == "fused":
            jp["experts"] = jfp.prepare_fused_ffn_params(jp["experts"])
            assert "fused_stream" in jp["experts"]
    return jp, convert.from_jax_params(jp, "cpu")


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-12)


@pytest.mark.parametrize("quant,cf,valid,mega,layer_kw", [
    (None, 0.5, None, 0, {}),                       # padded, drops tokens
    (None, 0.0, 17, 0, {"batch_prioritized_routing": True,
                        "is_postscore": False}),
    (None, 0.0, None, 0, {"is_gshard_loss": False}),
    ("fused", 0.0, None, 0, {}),
    ("fused", 1.0, 19, 0, {}),
    ("two_call", 0.0, 13, 4, {}),
    ("two_call", -1.0, None, 0, {}),                # capped dropless
])
def test_layer_forward_matches_jax(quant, cf, valid, mega, layer_kw):
    m = 128 if quant else 32
    gate = {"capacity_factor": cf, "gate_noise": 1.0}
    jl, tl = _layers(m, 256 if quant else 64, gate, **layer_kw)
    jp, tp = _params(jl, quant)
    x = np.random.default_rng(3).standard_normal((2, S // 2, m)).astype(
        np.float32)
    ref, rl = jl(jp, jnp.asarray(x), valid_tokens=valid,
                 megablocks_size=mega)
    got, gl = tl(tp, torch.from_numpy(x), valid_tokens=valid,
                 megablocks_size=mega)
    _close(got.numpy(), ref)
    _close(gl, rl)
    if valid is not None:
        assert not np.any(got.reshape(S, m).numpy()[valid:])


def test_capacity_probes_match_jax():
    jl, tl = _layers(32, 64)
    jp, tp = _params(jl, None)
    x = np.random.default_rng(8).standard_normal((S, 32)).astype(np.float32)
    assert tl.resolve_capacity(tp, torch.from_numpy(x)) == \
        jl.resolve_capacity(jp, jnp.asarray(x))
    mask = np.arange(S) < 10
    ref = jl.count_needed_traceable()(jp, jnp.asarray(x), jax.random.PRNGKey(0),
                                      jnp.asarray(mask))
    got = tl.count_needed_traceable()(tp, torch.from_numpy(x),
                                      token_mask=torch.from_numpy(mask))
    assert int(got) == int(ref)
    assert tl._static_capacity(S, 2, 1.5, 0) == jl._static_capacity(
        S, 2, 1.5, 1, 0)


def test_state_dict_round_trips_between_packages():
    jl, tl = _layers(32, 64)
    jp, _ = _params(jl, None)
    jsd = jl.state_dict(jp)
    tp = tl.load_state_dict(tl.init(torch.Generator().manual_seed(5)), jsd,
                            strict=True)
    tsd = tl.state_dict(tp)
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        np.testing.assert_array_equal(tsd[k], np.asarray(jsd[k]))
    with pytest.raises(ValueError, match="global experts"):
        tl.load_state_dict(tp, {**jsd, "_num_global_experts": np.asarray(8)})


def test_layer_construction_matches_jax():
    for n in (4, 1, -1):
        assert tmoe.MOELayer.global_expert_count(n, 1) == \
            jmoe.MOELayer.global_expert_count(n, 1)
    with pytest.raises(ValueError):
        tmoe.MOELayer.global_expert_count(0)
    _, tl = _layers(32, 64)
    assert tl.num_global_experts == E and tl.gates[0].top_k == 2
    params = tl.init()
    assert params["gates"][0]["wg"].shape == (32, E)
    # use_2dh is a constructor argument since the sharded layer; an
    # unknown one still raises
    tmoe.moe_layer(gate_type="Top2Gate", model_dim=32, device="cpu",
                   experts={"type": "ffn", "hidden_size_per_expert": 8},
                   use_2dh=True)
    with pytest.raises(TypeError):
        tmoe.moe_layer(gate_type="Top2Gate", model_dim=32, device="cpu",
                       experts={"type": "ffn", "hidden_size_per_expert": 8},
                       use_ragged_ep=True)
