"""Port parity: INT8/INT4 quantization, the fused weight stream and weight
conversion (tutel_tpu_torch.ops.quant, .ops.fused_ffn, .convert) against
the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.ops import fused_ffn_pallas as jfp
from tutel_tpu.ops import quant as jq
from tutel_tpu_torch import convert
from tutel_tpu_torch.ops import fused_ffn as tfp
from tutel_tpu_torch.experts.ffn import FusedExpertsNetwork
from tutel_tpu_torch.experts.llama_ffn import LlamaFFNNetwork
from tutel_tpu_torch.gates.top import LinearTopKGate
from tutel_tpu_torch.ops import quant as tq
from tutel_tpu_torch.utils import resolve_device

torch.set_num_threads(1)


def _weights(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.05


@pytest.mark.parametrize("bits,blocks", [(8, 1), (4, 1), (4, 2)])
def test_quantize_is_byte_identical(bits, blocks):
    w = _weights(bits + blocks, (3, 16, 12))
    w[1, :, 2] = 0.0                      # an all-zero column: scale 1
    ref = jq.quantize(jnp.asarray(w), bits=bits, shard_blocks=blocks)
    got = tq.quantize(torch.from_numpy(w), bits=bits, shard_blocks=blocks)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    assert (got.bits, got.orig_k, got.blocks, got.shape) == \
        (ref.bits, ref.orig_k, ref.blocks, ref.shape)
    np.testing.assert_array_equal(
        tq.dequantize(got).numpy(), np.asarray(jq.dequantize(ref)))
    if bits == 4:
        np.testing.assert_array_equal(
            tq.unpack_int4(got.values, blocks).numpy(),
            np.asarray(jq.unpack_int4(ref.values, blocks)))


def test_quantize_expert_params_passes_biases_through():
    params = {"fc1_w": torch.from_numpy(_weights(0, (2, 8, 4))),
              "fc2_w": torch.from_numpy(_weights(1, (2, 4, 8))),
              "fc1_b": torch.zeros(2, 4)}
    out = tq.quantize_expert_params(params, bits=4, sharded_count=2)
    assert out["fc1_b"] is params["fc1_b"]
    assert out["fc1_w"].blocks == 1 and out["fc2_w"].blocks == 2


@pytest.mark.parametrize("bits,use_bias,shape,bw", [
    (4, True, (3, 128, 256, 128), 128),       # K < H, bias, N padded
    (8, False, (2, 128, 256, 192), 128),      # INT8, fc2 tail padded
    (4, False, (2, 256, 256, 256), None),     # default tile width
])
def test_prepare_fused_ffn_stream_is_byte_identical(bits, use_bias, shape,
                                                    bw):
    e, k, h, n = shape
    rng = np.random.default_rng(bits * 10 + e)
    w1 = rng.standard_normal((e, k, h)).astype(np.float32) * 0.05
    w2 = rng.standard_normal((e, h, n)).astype(np.float32) * 0.05
    b1 = rng.standard_normal((e, h)).astype(np.float32) if use_bias else None
    b2 = rng.standard_normal((e, n)).astype(np.float32) if use_bias else None
    j1, j2 = jq.quantize(jnp.asarray(w1), bits), jq.quantize(jnp.asarray(w2),
                                                            bits)
    ref = jfp.prepare_fused_ffn(
        j1, j2, None if b1 is None else jnp.asarray(b1),
        None if b2 is None else jnp.asarray(b2), bw=bw)
    got = tfp.prepare_fused_ffn(
        convert.from_jax_params(j1, "cpu"), convert.from_jax_params(j2, "cpu"),
        None if b1 is None else torch.from_numpy(b1),
        None if b2 is None else torch.from_numpy(b2), bw=bw)
    assert ref is not None and got is not None
    for f in ("bits", "k", "h", "n", "t1", "t2", "bw", "kr"):
        assert getattr(got, f) == getattr(ref, f), f
    np.testing.assert_array_equal(got.wstream.numpy(), np.asarray(ref.wstream))
    np.testing.assert_array_equal(got.sb.numpy(), np.asarray(ref.sb))


def test_prepare_fused_ffn_refuses_what_jax_refuses():
    w = jq.quantize(jnp.asarray(_weights(3, (2, 256, 128))), 4)     # H < K
    wt = convert.from_jax_params(w, "cpu")
    assert jfp.prepare_fused_ffn(w, w) is None
    assert tfp.prepare_fused_ffn(wt, wt) is None
    params = {"fc1_w": wt, "fc2_w": wt}
    assert tfp.prepare_fused_ffn_params(params) is params


def test_from_jax_params_converts_arrays_weights_and_streams():
    rng = np.random.default_rng(5)
    w1 = jq.quantize(jnp.asarray(_weights(6, (2, 128, 128))), 4)
    w2 = jq.quantize(jnp.asarray(_weights(7, (2, 128, 128))), 4)
    bf = jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16)
    tree = {"gates": [{"wg": bf}],
            "experts": {"fc1_w": w1, "fc2_w": w2,
                        "fused_stream": jfp.prepare_fused_ffn(w1, w2)}}
    got = convert.from_jax_params(tree, "cpu")
    wg = got["gates"][0]["wg"]
    assert wg.dtype == torch.bfloat16
    np.testing.assert_array_equal(wg.float().numpy(),
                                  np.asarray(bf, np.float32))
    assert isinstance(got["experts"]["fc1_w"], tq.QuantizedWeight)
    np.testing.assert_array_equal(got["experts"]["fc1_w"].values.numpy(),
                                  np.asarray(w1.values))
    st = got["experts"]["fused_stream"]
    assert isinstance(st, tfp.FusedFFNStream) and st.kr == 64
    np.testing.assert_array_equal(
        st.wstream.numpy(),
        np.asarray(tree["experts"]["fused_stream"].wstream))


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot occur")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        convert.from_jax_params({"w": np.zeros(2, np.float32)})


@pytest.mark.parametrize("module", [
    FusedExpertsNetwork(model_dim=8, hidden_size_per_expert=16,
                        num_experts_per_device=2),
    LlamaFFNNetwork(model_dim=8, hidden_size_per_expert=16,
                    num_experts_per_device=2),
    LinearTopKGate(model_dim=8, num_global_experts=4, k=2)],
    ids=["ffn", "llama_ffn", "top_gate"])
def test_init_defaults_to_cuda(module):
    """The parts' init methods default to the GPU like every entry point:
    without one they raise; with device="cpu" they build on the CPU."""
    params = module.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(v.device.type == "cpu" for v in params.values())
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU error cannot occur")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.init(torch.Generator().manual_seed(0))
