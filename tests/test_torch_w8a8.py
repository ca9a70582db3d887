"""Port parity for the W8A8 / W4A8 path (int8 activations, integer-domain
products): the activation quantizer, the plain twins of the CUDA kernels
K5 (`grouped_gemm_w8a8`) and K3 (`fused_ffn_w8a8`) against the JAX
package's Pallas kernels in interpret mode, `w8a8_ffn`, an
`activation_bits=8` MoE layer and a W4A8 decode engine, each against the
JAX function on the same numpy inputs. Only rows below counts[e] are
compared: the port writes zeros past them, the JAX kernels leave values
there that no caller reads.

Tolerances, relative to max |reference| over live rows:
  * the quantizer is exact (both compute round(x / (absmax / 127)));
  * K5's twin 1e-6: its integer sums are exact and the two rescales run in
    the Pallas order, so only float32 rounding of equal operations is left;
  * K3's twin 1e-5, on inputs where no re-quantized hidden value differs
    from the JAX kernel's (counted and asserted): torch's and jax's gelu
    differ by an ulp in some elements, which can move a hidden int8 value
    by one step;
  * layer and engine 1e-4, as for the weight-only experts.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu import moe as jmoe
from tutel_tpu.ops import fused_ffn_pallas as jfp
from tutel_tpu.ops import quant as jq
from tutel_tpu.ops import w8a8_pallas as jw8
from tutel_tpu.serving import MoeDecodeEngine as JEngine
from tutel_tpu.serving import Request as JRequest
from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.ops import activations, fused_ffn, quant, w8a8
from tutel_tpu_torch.serving import MoeDecodeEngine, Request

torch.set_num_threads(1)

E, C, K, H, N = 4, 8, 128, 256, 128
COUNTS = np.array([5, 0, 8, 3], np.int32)        # expert 1 is empty
ACTS = {"relu": (jax.nn.relu, activations.relu),
        "gelu": (jax.nn.gelu, activations.gelu)}


def _live_err(got, ref, counts):
    """max |got - ref| / max |ref| over rows < counts[e]."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    live = np.arange(ref.shape[1])[None, :, None] < counts[:, None, None]
    scale = np.max(np.abs(np.where(live, ref, 0)))
    assert scale > 0
    return np.max(np.where(live, np.abs(got - ref), 0)) / scale


def _dead_rows_zero(got, counts):
    dead = np.arange(got.shape[1])[None, :, None] >= counts[:, None, None]
    return not np.any(np.where(dead, np.asarray(got), 0))


def _ffn_params(seed, bits, k=K, h=H, n=N, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, k)).astype(np.float32)
    jp = {"fc1_w": jq.quantize(jnp.asarray(
              rng.standard_normal((E, k, h)).astype(np.float32) * 0.05), bits),
          "fc2_w": jq.quantize(jnp.asarray(
              rng.standard_normal((E, h, n)).astype(np.float32) * 0.05), bits)}
    if bias:
        jp["fc1_b"] = jnp.asarray(rng.standard_normal((E, h)), jnp.float32) * .1
        jp["fc2_b"] = jnp.asarray(rng.standard_normal((E, n)), jnp.float32) * .1
    return x, jp


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_activations_is_bitwise_jax(dtype):
    x = np.random.default_rng(0).standard_normal((3, 7, 96)) * 3.0
    x[1, 2] = 0.0                                   # an all-zero row: scale 1
    jx = jnp.asarray(x, dtype)
    tx = convert.to_tensor(jx, "cpu")
    jqv, js = jw8.quantize_activations(jx)
    tqv, ts = quant.quantize_activations(tx)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1, 2, 0]) == 1.0


@pytest.mark.parametrize("bits,blocks,kn", [(8, 1, (K, H)), (4, 1, (H, N)),
                                            (4, 2, (H, N))])
def test_grouped_gemm_w8a8_twin_matches_pallas(bits, blocks, kn):
    k, n = kn
    rng = np.random.default_rng(bits + blocks)
    x = rng.standard_normal((E, C, k)).astype(np.float32)
    w = rng.standard_normal((E, k, n)).astype(np.float32) * 0.05
    jw = jq.quantize(jnp.asarray(w), bits, shard_blocks=blocks)
    ref = jw8.grouped_gemm_w8a8(jnp.asarray(x), jw, jnp.asarray(COUNTS),
                                interpret=True)
    got = w8a8.grouped_gemm_w8a8(torch.from_numpy(x),
                                 convert.from_jax_params(jw, "cpu"),
                                 torch.from_numpy(COUNTS))
    assert _live_err(got.numpy(), ref, COUNTS) <= 1e-6
    assert _dead_rows_zero(got.numpy(), COUNTS)


def _jax_hidden(x, jst, act):
    """The Pallas K3's re-quantized hidden (hq, sxh), computed with the
    kernel's own operations outside the kernel."""
    xq, sx = jw8.quantize_activations(jnp.asarray(x))
    xp = jfp._relayout_x(xq, jst.bits, jst.kr, x.shape[1])
    q = jst.wstream if jst.bits == 8 else jq.unpack_int4(jst.wstream)
    e, _, w, bw = q.shape
    w1 = q[:, :jst.t1].transpose(0, 2, 1, 3).reshape(e, w, jst.t1 * bw)
    sb = jst.sb[:, :jst.t1].transpose(0, 2, 1, 3).reshape(e, 2, jst.t1 * bw)
    acc = jnp.einsum("eck,ekh->ech", xp, w1, preferred_element_type=jnp.int32)
    h = act(acc.astype(jnp.float32) * sx * sb[:, 0:1] + sb[:, 1:2])
    return jw8.quantize_activations(h)


@pytest.mark.parametrize("bits,act,kh,bias", [
    (8, "relu", (K, H), True),             # K < H: x re-laid and padded
    (4, "gelu", (K, H), True),
    (4, "relu", (H, H), False),
    (8, "gelu", (H, H), True),
])
def test_fused_ffn_w8a8_twin_matches_pallas(bits, act, kh, bias):
    k, h = kh
    x, jp = _ffn_params(bits * 5 + k, bits, k=k, h=h, bias=bias)
    jst = jfp.prepare_fused_ffn(jp["fc1_w"], jp["fc2_w"], jp.get("fc1_b"),
                                jp.get("fc2_b"), bw=128)
    jact, tact = ACTS[act]
    ref = jfp.fused_ffn_w8a8(jnp.asarray(x), jst, jnp.asarray(COUNTS),
                             activation_fn=jact, interpret=True)
    st = convert.from_jax_params(jst, "cpu")
    got = fused_ffn.fused_ffn_w8a8(torch.from_numpy(x), st,
                                   torch.from_numpy(COUNTS),
                                   activation_fn=tact)
    # the re-quantized hidden, live rows: no int8 value differs
    jhq, jsxh = _jax_hidden(x, jst, jact)
    thq, tsxh = fused_ffn.fused_ffn_w8a8_hidden(torch.from_numpy(x), st, tact)
    live = np.arange(C)[None, :, None] < COUNTS[:, None, None]
    flips = int(np.sum(live & (thq.numpy() != np.asarray(jhq))))
    assert flips == 0
    np.testing.assert_allclose(np.where(live, tsxh.numpy(), 0),
                               np.where(live, np.asarray(jsxh), 0),
                               rtol=1e-6)
    assert _live_err(got.numpy(), ref, COUNTS) <= 1e-5
    assert _dead_rows_zero(got.numpy(), COUNTS)


@pytest.mark.parametrize("fused", [True, False])
def test_w8a8_ffn_matches_jax_with_unrounded_counts(fused):
    """The expert-level W8A8 FFN, fused (K3) or two K5 calls with bias and
    gelu between them. The counts are NOT rounded up to megablocks_size
    (unlike the weight-only quantized_ffn): rows from counts[e] on are
    zeros even with megablocks_size=4."""
    x, jp = _ffn_params(31, 4)
    if fused:
        jp = jfp.prepare_fused_ffn_params(jp)
        assert "fused_stream" in jp
    tp = convert.from_jax_params(jp, "cpu")
    ref = jw8.w8a8_ffn(jnp.asarray(x), jp, SimpleNamespace(
        megablocks_size=4, dispatch_count=jnp.asarray(COUNTS)),
        activation_fn=jax.nn.gelu, output_dim=N, interpret=True)
    got = w8a8.w8a8_ffn(torch.from_numpy(x), tp, SimpleNamespace(
        megablocks_size=4, dispatch_count=torch.from_numpy(COUNTS)),
        activation_fn=activations.gelu, output_dim=N)
    assert _live_err(got.numpy(), ref, COUNTS) <= 1e-5
    if fused:            # the two-call path adds fc2_b to every row
        assert _dead_rows_zero(got.numpy(), COUNTS)


@pytest.mark.parametrize("bits,cf", [(8, 1.0), (4, 0.0)])
def test_moe_layer_activation_bits_8_matches_jax(bits, cf):
    """An `activation_bits=8` layer (the analog of the JAX package's
    test_moe_layer_w8a8), padded and dropless, INT8 and INT4 experts."""
    gate = {"type": "top", "k": 2, "capacity_factor": cf}
    experts = {"type": "ffn", "num_experts_per_device": E,
               "hidden_size_per_expert": 256, "activation_bits": 8}
    jl = jmoe.moe_layer(gate_type=gate, experts=dict(experts), model_dim=128,
                        seeds=(1, 1, 1), group=jax.devices()[:1])
    tl = tmoe.moe_layer(gate_type=gate, experts=dict(experts), model_dim=128,
                        device="cpu")
    jp = dict(jl.init(jax.random.PRNGKey(0)))
    jp["experts"] = jq.quantize_expert_params(jp["experts"], bits=bits)
    tp = convert.from_jax_params(jp, "cpu")
    x = np.random.default_rng(5).standard_normal((2, 12, 128)).astype(
        np.float32)
    ref, rl = jl(jp, jnp.asarray(x))
    got, gl = tl(tp, torch.from_numpy(x))
    assert _live_err(got.numpy(), ref, np.array([12, 12])) <= 1e-4
    assert abs(float(gl) - float(rl)) <= 1e-5 * abs(float(rl))


@pytest.mark.parametrize("auto_fuse", [True, False])
def test_w4a8_decode_engine_matches_jax(auto_fuse):
    """A W4A8 MoeDecodeEngine (INT4 weights, activation_bits=8), fused
    (K3's twin) or two-call (K5's twin), against the JAX engine."""
    gate = {"type": "top", "k": 2, "capacity_factor": 0.0}
    experts = {"type": "ffn", "num_experts_per_device": E,
               "hidden_size_per_expert": 256, "activation_bits": 8}
    jl = jmoe.moe_layer(gate_type=gate, experts=dict(experts), model_dim=128,
                        seeds=(1, 1, 1), group=jax.devices()[:1])
    tl = tmoe.moe_layer(gate_type=gate, experts=dict(experts), model_dim=128,
                        device="cpu")
    jp = dict(jl.init(jax.random.PRNGKey(0)))
    jp["experts"] = jq.quantize_expert_params(jp["experts"], bits=4)
    tp = convert.from_jax_params(jp, "cpu")
    states = np.random.default_rng(7).standard_normal((10, 128)).astype(
        np.float32)
    kw = dict(max_batch=4, auto_fuse=auto_fuse, state_update="residual_norm")
    jeng, teng = JEngine(jl, jp, **kw), MoeDecodeEngine(tl, tp, **kw)
    assert ("fused_stream" in teng.params["experts"]) == auto_fuse
    before = (fused_ffn.fused_ffn_w8a8.launches,
              w8a8.grouped_gemm_w8a8.launches)
    ref = jeng.run([JRequest(uid=i, state=states[i], remaining=1 + i % 4)
                    for i in range(10)], chunk=2)
    got = teng.run([Request(uid=i, state=states[i], remaining=1 + i % 4)
                    for i in range(10)], chunk=2)
    assert set(got) == set(ref) == set(range(10))
    for uid in ref:
        err = np.max(np.abs(got[uid].numpy() - np.asarray(ref[uid])))
        assert err <= 1e-4 * np.max(np.abs(np.asarray(ref[uid]))), uid
    # CPU tensors run the plain twins: no kernel launch is counted
    assert (fused_ffn.fused_ffn_w8a8.launches,
            w8a8.grouped_gemm_w8a8.launches) == before


def test_w8a8_wrappers_refuse_what_the_kernels_do_not_take():
    x, jp = _ffn_params(2, 4, bias=False)
    tp = convert.from_jax_params(jfp.prepare_fused_ffn_params(jp), "cpu")
    meta = torch.empty((E, C, K), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        w8a8.grouped_gemm_w8a8(meta, tp["fc1_w"])
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_ffn.fused_ffn_w8a8(meta, tp["fused_stream"])
    with pytest.raises(ValueError, match="does not match"):
        w8a8.grouped_gemm_w8a8(torch.zeros(E, C, K + 2), tp["fc1_w"])
    assert activations.kernel_code(activations.silu) == 2
