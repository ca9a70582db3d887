"""Port parity: quantized expert weights under expert slicing
(`sharded_count` 2) at W = 2 (one global expert) and W = 4 (two), gloo
ranks of `testing.RankPool`, against the JAX MOELayer under shard_map on
W of the 8 virtual CPU devices, from the same global parameters (INT8 and
INT4 packed with `quantize_expert_params(..., sharded_count=2)`) and
input: two-layer `ffn` experts and SwiGLU `llama_ffn` experts (also in
float32), at adaptive r = 0 (the weights regathered whole: INT4 K-slices
joined into a two-block packing), 1 and 2; and the error for an INT4
weight packed in one block, with JAX's message, and for a fused stream.

Tolerance: max |port - jax| <= 1e-5 * max |jax| (K1's twin against the
Pallas kernels in interpret mode, float32 sums in other orders).

The ranks import this module, so jax is imported only inside the
functions the pytest process calls (`_jax`).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

M, H, ROWS = 32, 64, 8            # model dim, hidden, rows a rank


def _jax():
    import jax
    import jax.numpy as jnp
    from tutel_tpu import moe as jmoe
    from tutel_tpu.ops import quant as jq
    return jax, jnp, jmoe, jq


def _kwargs(expert_type, nle):
    return dict(gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
                experts={"type": expert_type, "num_experts_per_device": nle,
                         "hidden_size_per_expert": H},
                model_dim=M)


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


def _rank_forward(expert_type, nle, params, x, rs):
    layer = tmoe.moe_layer(device="cpu", **_kwargs(expert_type, nle))
    local = layer.shard_params(params)
    outs = []
    with torch.no_grad():
        for r in rs:
            outs.append(layer(local, _rows(x), adaptive_r=r)[0].numpy())
    return outs, layer.sharded_count


RS = (0, 1, 2)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("expert_type,bits", [
    ("ffn", 8), ("ffn", 4), ("llama_ffn", 0), ("llama_ffn", 8),
    ("llama_ffn", 4)])
def test_sliced_quantized_experts_match_jax(pools, w, expert_type, bits):
    jax, jnp, jmoe, jq = _jax()
    nle = -2                                  # each expert over 2 ranks
    jl = jmoe.moe_layer(seeds=(1, 1, 1), group=jax.devices()[:w],
                        **_kwargs(expert_type, nle))
    assert jl.sharded_count == 2
    jp = jl.init(jax.random.PRNGKey(w + bits))
    if bits:
        jp = {**jp, "experts": jq.quantize_expert_params(
            jp["experts"], bits=bits, sharded_count=2)}
    x = np.random.default_rng(bits + w).standard_normal(
        (w * ROWS, M)).astype(np.float32)
    refs = []
    for r in RS:
        out, _ = jl(jl.shard_params(jp, adaptive_r=r), jnp.asarray(x),
                    adaptive_r=r)
        refs.append(np.asarray(out))
    got = pools(w).run(_rank_forward, expert_type, nle,
                       convert.from_jax_params(jp, "cpu"),
                       torch.from_numpy(x), RS)
    for i, r in enumerate(RS):
        out = np.concatenate([g[0][i] for g in got])
        err = np.max(np.abs(out - refs[i]))
        assert err <= 1e-5 * np.max(np.abs(refs[i])), (r, err)
    assert all(g[1] == 2 for g in got)


def _rank_refuses(params):
    layer = tmoe.moe_layer(device="cpu", **_kwargs("ffn", -2))
    try:
        layer.shard_params(params)
    except ValueError as e:
        return str(e)
    return None


def test_int4_packed_in_one_block_raises_like_jax(pools):
    """A K-sliced INT4 weight must be packed per shard block: the port
    raises JAX's message; a fused stream does not slice and raises."""
    jax, _, jmoe, jq = _jax()
    jl = jmoe.moe_layer(seeds=(1, 1, 1), group=jax.devices()[:2],
                        **_kwargs("ffn", -2))
    jp = jl.init(jax.random.PRNGKey(0))
    jp = {**jp, "experts": jq.quantize_expert_params(jp["experts"], bits=4)}
    with pytest.raises(ValueError) as ref:
        jl.shard_params(jp)
    got = pools(2).run(_rank_refuses, convert.from_jax_params(jp, "cpu"))
    assert got == [str(ref.value)] * 2
    assert "shard_blocks=1" in got[0]

    from tutel_tpu_torch.ops import fused_ffn, quant
    params = tmoe.moe_layer(device="cpu", **_kwargs("ffn", 1)).init(
        torch.Generator().manual_seed(0))
    params["experts"] = fused_ffn.prepare_fused_ffn_params(
        quant.quantize_expert_params(params["experts"], 8), bw=H)
    assert "fused_stream" in params["experts"]
    got = pools(2).run(_rank_refuses, params)
    assert all(m and "fused weight streams" in m for m in got), got
