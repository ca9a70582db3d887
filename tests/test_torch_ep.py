"""Port parity: the sharded MoE layer (tutel_tpu_torch.moe.MOELayer over a
process group) at W = 2 and 4 gloo ranks (one spawned process a rank,
`testing.RankPool`) against the JAX MOELayer under shard_map on W of the 8
virtual CPU devices, from the same global parameters and input: each rank
takes its shard of the parameters (`shard_params`) and its rows of the
batch, and the ranks' outputs together are JAX's output.

Cases: expert parallelism with 1 and 2 local experts; expert slicing
(num_local_experts -2 / -4) under data, model, every adaptive r in
valid_rs and auto; a2a/FFN overlap 2; the two-level exchange with 2
hosts; a bfloat16 a2a payload; dropless and capped capacity; valid_tokens
as a global scalar and as a per-rank vector with inequivalent_tokens; the
gradients of the gate and the experts against jax.grad of the global loss;
an INT8 pure-EP layer (JAX's Pallas kernels in interpret mode, the port's
K1 twin); and the helloworld trainer, 3 steps at W = 2 under data, model
and overlap 2, against tutel_tpu.examples.helloworld with --num_devices 2.

Tolerances: max |port - jax| <= 1e-5 * max |jax| for outputs, l_aux and
gradients (float32 sums in other orders), 1e-2 with the bfloat16 payload,
losses within 1e-4 (tests/test_helloworld.py's). Gate noise is 0: JAX
folds the device index into its key, the port draws from a Generator.

The ranks import this module to find their functions, so jax is imported
only inside the functions the pytest process calls (`_jax`).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

M, H, ROWS = 16, 32, 8            # model dim, hidden, rows a rank

# name -> (W, layer kwargs, call kwargs); layer kwargs hold
# num_local_experts ("nle"), capacity_factor ("cf") and the rest as is
CASES = {
    "ep1": (2, {"nle": 1}, {}),
    "ep2": (2, {"nle": 2}, {}),
    "ep2_dropless": (2, {"nle": 2, "cf": 0.0}, {}),
    "ep2_capped": (2, {"nle": 2, "cf": -1.0}, {}),
    "tp_data": (2, {"nle": -2, "parallel_type": "data"}, {}),
    "tp_model": (2, {"nle": -2, "parallel_type": "model"}, {}),
    "tp_r0": (2, {"nle": -2}, {"adaptive_r": 0}),
    "tp_auto": (2, {"nle": -2, "parallel_type": "auto"}, {}),
    "overlap2": (2, {"nle": 2, "a2a_ffn_overlap_degree": 2}, {}),
    "overlap2_tp": (2, {"nle": -2, "parallel_type": "model",
                        "a2a_ffn_overlap_degree": 2}, {}),
    "2dh": (2, {"nle": 1, "use_2dh": True, "num_hosts": 2}, {}),
    "a2a_bf16": (2, {"nle": 1, "a2a_dtype": "bfloat16"}, {}),
    "valid_scalar": (2, {"nle": 2, "cf": 4.0}, {"valid_tokens": 11}),
    "valid_vector": (2, {"nle": 1, "cf": 4.0},
                     {"valid_tokens": [8, 3], "inequivalent_tokens": True}),
    "w4_ep1": (4, {"nle": 1}, {}),
    "w4_ep2_dropless": (4, {"nle": 2, "cf": 0.0}, {}),
    "w4_tp2_data": (4, {"nle": -2, "parallel_type": "data"}, {}),
    "w4_tp2_model": (4, {"nle": -2, "parallel_type": "model"}, {}),
    "w4_tp4_r0": (4, {"nle": -4}, {"adaptive_r": 0}),
    "w4_tp4_r1": (4, {"nle": -4}, {"adaptive_r": 1}),
    "w4_tp4_r2": (4, {"nle": -4}, {"adaptive_r": 2}),
    "w4_tp4_r4": (4, {"nle": -4}, {"adaptive_r": 4}),
    "w4_tp4_auto": (4, {"nle": -4, "parallel_type": "auto"}, {}),
    "w4_overlap2": (4, {"nle": -2, "a2a_ffn_overlap_degree": 2,
                        "parallel_type": "model"}, {}),
    "w4_2dh": (4, {"nle": 1, "use_2dh": True, "num_hosts": 2}, {}),
    "w4_a2a_bf16": (4, {"nle": 2, "a2a_dtype": "bfloat16"}, {}),
    "w4_valid_vector": (4, {"nle": 1, "cf": 4.0},
                        {"valid_tokens": [8, 5, 0, 2],
                         "inequivalent_tokens": True}),
    "w4_valid_scalar": (4, {"nle": -2, "cf": 4.0, "parallel_type": "model"},
                        {"valid_tokens": 19}),
}

# name -> (W, layer kwargs, call kwargs, l_aux weight): gradient cases
GRAD_CASES = {
    "ep2": (2, {"nle": 2}, {}, 0.01),
    "tp_data": (2, {"nle": -2, "parallel_type": "data"}, {}, 0.0),
    "tp_model": (2, {"nle": -2, "parallel_type": "model"}, {}, 0.01),
    "tp_r0": (2, {"nle": -2}, {"adaptive_r": 0}, 0.0),
    "w4_tp4_r2": (4, {"nle": -4}, {"adaptive_r": 2}, 0.01),
    "w4_ep1_overlap2": (4, {"nle": 1, "a2a_ffn_overlap_degree": 2}, {},
                        0.0),
}


def _jax():
    import jax
    import jax.numpy as jnp
    from tutel_tpu import moe as jmoe
    return jax, jnp, jmoe


def _kwargs(spec, dtypes):
    spec = dict(spec)
    nle, cf = spec.pop("nle"), spec.pop("cf", 1.0)
    if "a2a_dtype" in spec:
        spec["a2a_dtype"] = dtypes[spec["a2a_dtype"]]
    gate = {"type": "top", "k": 2, "capacity_factor": cf}
    experts = {"type": "ffn", "num_experts_per_device": nle,
               "hidden_size_per_expert": spec.pop("hidden", H)}
    return dict(gate_type=gate, experts=experts,
                model_dim=spec.pop("model_dim", M), **spec)


def _jax_layer(w, spec):
    jax, jnp, jmoe = _jax()
    return jmoe.moe_layer(seeds=(1, 1, 1), group=jax.devices()[:w],
                          **_kwargs(spec, {"bfloat16": jnp.bfloat16}))


def _port_layer(spec):
    return tmoe.moe_layer(device="cpu",
                          **_kwargs(spec, {"bfloat16": torch.bfloat16}))


def _close(got, ref, tol=1e-5, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.max(np.abs(got - ref)) if got.size else 0.0
    assert err <= tol * max(np.max(np.abs(ref)), 1e-12), (what, err)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


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


def _rows(x):
    n = x.shape[0] // dist.get_world_size()
    return x[dist.get_rank() * n:(dist.get_rank() + 1) * n]


# -- forward ----------------------------------------------------------------

def _rank_forward(spec, call, params, x):
    layer = _port_layer(spec)
    local = layer.shard_params(params)
    with torch.no_grad():
        out, l_aux = layer(local, _rows(x), **call)
    return out.float().numpy(), float(l_aux), layer.adaptive_degree


def _jax_forward(w, spec, call, x, key=0, quant_bits=0):
    jax, jnp, _ = _jax()
    jl = _jax_layer(w, spec)
    jp = jl.init(jax.random.PRNGKey(key))
    if quant_bits:
        from tutel_tpu.ops import quant as jq
        jp = {**jp, "experts": jq.quantize_expert_params(jp["experts"],
                                                         bits=quant_bits)}
    call = dict(call)
    if "valid_tokens" in call:
        call["valid_tokens"] = jnp.asarray(call["valid_tokens"], jnp.int32)
    out, l_aux = jl(jl.shard_params(jp), jnp.asarray(x), **call)
    return jp, np.asarray(out, np.float32), float(l_aux), jl.adaptive_degree


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_layer_matches_jax(pools, case):
    w, spec, call = CASES[case]
    x = np.random.default_rng(len(case)).standard_normal(
        (w * ROWS, M)).astype(np.float32)
    jp, ref, ref_aux, ref_r = _jax_forward(w, spec, call, x)
    params = convert.from_jax_params(jp, "cpu")
    got = pools(w).run(_rank_forward, spec, call, params,
                       torch.from_numpy(x))
    tol = 1e-2 if "a2a_dtype" in spec else 1e-5
    _close(np.concatenate([g[0] for g in got]), ref, tol, case)
    for g in got:
        _close(g[1], ref_aux, tol, case + " l_aux")
        assert g[2] == ref_r                # auto picks JAX's r
    if "valid_tokens" in call:              # padding rows are zeros
        assert np.count_nonzero(np.abs(ref).sum(1) == 0) > 0


def test_int8_pure_ep_layer_matches_jax(pools):
    """INT8 expert weights under pure expert parallelism: each rank holds
    its experts' values and scales and runs K1's twin on them with no row
    counts, JAX its Pallas kernels in interpret mode."""
    w, spec = 2, {"nle": 2, "model_dim": 128, "hidden": 256, "cf": 0.0}
    x = np.random.default_rng(7).standard_normal((w * ROWS, 128)).astype(
        np.float32)
    jp, ref, ref_aux, _ = _jax_forward(w, spec, {}, x, quant_bits=8)
    params = convert.from_jax_params(jp, "cpu")
    got = pools(w).run(_rank_forward, spec, {}, params, torch.from_numpy(x))
    _close(np.concatenate([g[0] for g in got]), ref, 1e-5, "int8")
    _close(got[0][1], ref_aux, 1e-5, "int8 l_aux")


def _rank_quant_tp_raises(spec, params):
    layer = _port_layer(spec)
    try:
        layer.shard_params(params)
    except ValueError as e:
        return str(e)
    return None


def test_quantized_weights_under_slicing_raise(pools):
    """Quantized weights slice (tests/test_torch_quant_tp.py), but not an
    INT4 matrix packed in one block along a sliced K, nor a fused
    stream."""
    from tutel_tpu_torch.ops import fused_ffn, quant
    spec = {"nle": -2}
    params = _port_layer({"nle": 1}).init(torch.Generator().manual_seed(0))
    experts = params["experts"]
    for qe, what in (
            (quant.quantize_expert_params(experts, 4), "shard_blocks=1"),
            (fused_ffn.prepare_fused_ffn_params(
                quant.quantize_expert_params(experts, 8), bw=H),
             "fused weight streams")):
        msgs = pools(2).run(_rank_quant_tp_raises, spec,
                            {**params, "experts": qe})
        assert all(m and what in m for m in msgs), msgs
    msgs = pools(2).run(_rank_quant_tp_raises, spec, {
        **params, "experts": quant.quantize_expert_params(
            experts, 4, sharded_count=2)})
    assert msgs == [None, None]


# -- gradients ----------------------------------------------------------------

def _rank_grads(spec, call, params, x, cot, wt, jgrads):
    layer = _port_layer(spec)
    local = layer.shard_params(params)
    named = _flat(local)
    for t in named.values():
        t.requires_grad_(True)
    out, l_aux = layer(local, _rows(x), training=True, **call)
    loss = (out * _rows(cot)).sum() + wt * l_aux / dist.get_world_size()
    loss.backward()
    ref = _flat(layer.shard_params(jgrads))
    return {n: (t.grad.numpy(), ref[n].numpy()) for n, t in named.items()}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_sharded_gradients_match_jax_grad(pools, case):
    jax, jnp, _ = _jax()
    w, spec, call, wt = GRAD_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    x = rng.standard_normal((w * ROWS, M)).astype(np.float32)
    cot = rng.standard_normal((w * ROWS, M)).astype(np.float32)
    jl = _jax_layer(w, spec)
    jp = jl.shard_params(jl.init(jax.random.PRNGKey(0)))

    def loss(p):
        out, l_aux = jl(p, jnp.asarray(x), training=True, **call)
        return jnp.sum(out * jnp.asarray(cot)) + wt * l_aux
    grads = jax.grad(loss)(jp)
    params = convert.from_jax_params(jax.device_get(jp), "cpu")
    jgrads = convert.from_jax_params(jax.device_get(grads), "cpu")
    got = pools(w).run(_rank_grads, spec, call, params,
                       torch.from_numpy(x), torch.from_numpy(cot), wt,
                       jgrads)
    for rank in got:
        for name, (g, ref) in rank.items():
            _close(g, ref, 1e-5, f"{case} {name}")


# -- the helloworld trainer ------------------------------------------------------

def _rank_helloworld(argv, params, x):
    from tutel_tpu_torch.examples import helloworld
    losses, _ = helloworld.run(helloworld.build_args(argv),
                               log=lambda *_: None, params=params, x=x)
    return losses


HELLO = ["--batch_size", "8", "--num_tokens", "32", "--model_dim", "32",
         "--hidden_size", "32", "--num_steps", "3", "--device", "cpu",
         "--num_devices", "2", "--top", "2"]


@pytest.mark.parametrize("extra", [
    ["--num_local_experts", "-2", "--parallel_type", "data"],
    ["--num_local_experts", "-2", "--parallel_type", "model"],
    ["--num_local_experts", "2", "--a2a_ffn_overlap_degree", "2"]],
    ids=["data", "model", "overlap2"])
def test_helloworld_trains_like_jax_at_two_ranks(pools, extra):
    jax, jnp, jmoe = _jax()
    from tutel_tpu.examples import helloworld as jhello
    argv = HELLO + extra
    ref, _ = jhello.run(jhello.build_args(argv), log=lambda *_: None)
    args = jhello.build_args(argv)
    jl = jmoe.moe_layer(
        gate_type={"type": "top", "k": args.top,
                   "capacity_factor": args.capacity_factor},
        experts={"type": "ffn", "num_experts_per_device":
                 args.num_local_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=jax.devices()[:2])
    params = convert.from_jax_params(jl.init(jax.random.PRNGKey(1)), "cpu")
    x = jax.random.normal(jax.random.PRNGKey(0), (args.batch_size,
                                                  args.num_tokens,
                                                  args.model_dim))
    got = pools(2).run(_rank_helloworld, argv, params,
                       convert.to_tensor(np.asarray(x), "cpu"))
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], ref, rtol=1e-4, atol=1e-4)


def _rank_helloworld_refuses(argv):
    from tutel_tpu_torch.examples import helloworld
    try:
        helloworld.run(helloworld.build_args(argv), log=lambda *_: None)
    except ValueError as e:
        return str(e)
    return None


def test_helloworld_num_devices_must_be_the_world(pools):
    argv = HELLO[:-4] + ["--num_devices", "4", "--num_steps", "1"]
    assert all("--num_devices" in m for m in pools(2).run(
        _rank_helloworld_refuses, argv))
