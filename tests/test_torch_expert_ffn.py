"""Port parity: the plain PyTorch twins of the CUDA kernels K1
(`grouped_gemm_quant`) and K2 (`fused_ffn_quant`), `quantized_ffn` and the
expert FFN, against the JAX package's Pallas kernels in interpret mode on
the same numpy inputs. Only rows below counts[e] are compared: rows past
them are undefined in the JAX kernels and unread by every caller."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.experts import ffn as jffn
from tutel_tpu.ops import fused_ffn_pallas as jfp
from tutel_tpu.ops import grouped_gemm_pallas as jgp
from tutel_tpu.ops import quant as jq
from tutel_tpu_torch import convert
from tutel_tpu_torch.experts import ffn as tffn
from tutel_tpu_torch.ops import activations
from tutel_tpu_torch.ops import fused_ffn as tfp
from tutel_tpu_torch.ops import grouped_gemm_quant as tgp

torch.set_num_threads(1)

E, C, K, H, N = 4, 8, 128, 256, 128
COUNTS = np.array([5, 0, 8, 3], np.int32)        # expert 1 is empty
ACTS = {"relu": (jax.nn.relu, activations.relu),
        "gelu": (jax.nn.gelu, activations.gelu)}


def _live_close(got, ref, counts, tol=1e-5):
    """max |got - ref| / max |ref| over rows < counts[e]."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    live = np.arange(ref.shape[1])[None, :, None] < counts[:, None, None]
    scale = np.max(np.abs(np.where(live, ref, 0)))
    err = np.max(np.where(live, np.abs(got - ref), 0))
    assert scale > 0 and err / scale <= tol, (err, scale)


def _ffn_inputs(seed, bits, use_bias, k=K, h=H, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, k)).astype(np.float32)
    w1 = rng.standard_normal((E, k, h)).astype(np.float32) * 0.05
    w2 = rng.standard_normal((E, h, n)).astype(np.float32) * 0.05
    b1 = rng.standard_normal((E, h)).astype(np.float32) * 0.1
    b2 = rng.standard_normal((E, n)).astype(np.float32) * 0.1
    jp = {"fc1_w": jq.quantize(jnp.asarray(w1), bits),
          "fc2_w": jq.quantize(jnp.asarray(w2), bits)}
    if use_bias:
        jp["fc1_b"], jp["fc2_b"] = jnp.asarray(b1), jnp.asarray(b2)
    return x, jp


@pytest.mark.parametrize("bits,blocks,kn", [(4, 1, (K, H)), (8, 1, (H, N)),
                                            (4, 2, (H, N))])
def test_grouped_gemm_quant_twin_matches_pallas(bits, blocks, kn):
    k, n = kn
    rng = np.random.default_rng(bits + blocks)
    x = rng.standard_normal((E, C, k)).astype(np.float32)
    w = rng.standard_normal((E, k, n)).astype(np.float32) * 0.05
    jw = jq.quantize(jnp.asarray(w), bits, shard_blocks=blocks)
    ref = jgp.grouped_gemm_quant(jnp.asarray(x), jw, jnp.asarray(COUNTS),
                                 interpret=True)
    got = tgp.grouped_gemm_quant(torch.from_numpy(x),
                                 convert.from_jax_params(jw, "cpu"),
                                 torch.from_numpy(COUNTS))
    _live_close(got.numpy(), ref, COUNTS)
    # the port defines the rows past counts[e] as zeros
    dead = np.arange(C)[None, :, None] >= COUNTS[:, None, None]
    assert not np.any(np.where(dead, got.numpy(), 0))


@pytest.mark.parametrize("bits,use_bias,act,kh", [
    (4, True, "gelu", (K, H)),        # K < H: x halves re-laid and padded
    (4, False, "relu", (K, H)),
    (8, True, "relu", (K, H)),
    (8, False, "gelu", (H, H)),
    (4, True, "relu", (H, H)),
])
def test_fused_ffn_quant_twin_matches_pallas(bits, use_bias, act, kh):
    k, h = kh
    x, jp = _ffn_inputs(bits * 3 + use_bias, bits, use_bias, k=k, h=h)
    jst = jfp.prepare_fused_ffn(jp["fc1_w"], jp["fc2_w"], jp.get("fc1_b"),
                                jp.get("fc2_b"), bw=128)
    jact, tact = ACTS[act]
    ref = jfp.fused_ffn_quant(jnp.asarray(x), jst, jnp.asarray(COUNTS),
                              activation_fn=jact, interpret=True)
    st = convert.from_jax_params(jst, "cpu")
    got = tfp.fused_ffn_quant(torch.from_numpy(x), st,
                              torch.from_numpy(COUNTS), activation_fn=tact)
    _live_close(got.numpy(), ref, COUNTS)


@pytest.mark.parametrize("fused", [False, True])
def test_quantized_ffn_matches_jax_with_megablocks_counts(fused):
    """The layer-level FFN: megablocks rounds counts up (here to 4) and
    clips them to C, then K2 or two K1 calls with bias and gelu between."""
    x, jp = _ffn_inputs(21, 4, True)
    if fused:
        jp = jfp.prepare_fused_ffn_params(jp)
        assert "fused_stream" in jp
    tp = convert.from_jax_params(jp, "cpu")
    ctx = dict(megablocks_size=4, dispatch_count=COUNTS)
    ref = jgp.quantized_ffn(
        jnp.asarray(x), jp, SimpleNamespace(**{**ctx, "dispatch_count":
                                               jnp.asarray(COUNTS)}),
        activation_fn=jax.nn.gelu, output_dim=N, interpret=True)
    got = tgp.quantized_ffn(
        torch.from_numpy(x), tp, SimpleNamespace(**{**ctx, "dispatch_count":
                                                   torch.from_numpy(COUNTS)}),
        activation_fn=activations.gelu, output_dim=N)
    rounded = np.minimum((COUNTS + 3) // 4 * 4, C)
    _live_close(got.numpy(), ref, rounded)


def test_expert_ffn_float_path_matches_jax():
    rng = np.random.default_rng(4)
    jnet = jffn.FusedExpertsNetwork(model_dim=16, hidden_size_per_expert=32,
                                    num_experts_per_device=3, output_dim=24)
    tnet = tffn.FusedExpertsNetwork(model_dim=16, hidden_size_per_expert=32,
                                    num_experts_per_device=3, output_dim=24)
    jp = jnet.init(jax.random.PRNGKey(0))
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    ref = jnet.apply(jp, jnp.asarray(x))
    got = tnet.apply(convert.from_jax_params(jp, "cpu"), torch.from_numpy(x))
    _live_close(got.numpy(), ref, np.full(3, 5))
    shapes = {k: tuple(v.shape)
              for k, v in tnet.init(torch.Generator().manual_seed(0),
                                  device="cpu").items()}
    assert shapes == {k: tuple(v.shape) for k, v in jp.items()}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    before = (tgp.grouped_gemm_quant.launches, tfp.fused_ffn_quant.launches)
    x, jp = _ffn_inputs(2, 4, False)
    tp = convert.from_jax_params(jfp.prepare_fused_ffn_params(jp), "cpu")
    meta = torch.empty((E, C, K), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgp.grouped_gemm_quant(meta, tp["fc1_w"])
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfp.fused_ffn_quant(meta, tp["fused_stream"])
    with pytest.raises(ValueError, match="does not match"):
        tgp.grouped_gemm_quant(torch.zeros(E, C, K + 2), tp["fc1_w"])
    assert activations.kernel_code(torch.relu) == 0
    assert activations.kernel_code(activations.gelu) == 1
    with pytest.raises(ValueError, match="no CUDA kernel"):
        activations.kernel_code(torch.tanh)
    tgp.grouped_gemm_quant(torch.from_numpy(x), tp["fc1_w"])
    tfp.fused_ffn_quant(torch.from_numpy(x), tp["fused_stream"])
    # CPU tensors run the plain twins: no kernel launch is counted
    assert (tgp.grouped_gemm_quant.launches,
            tfp.fused_ffn_quant.launches) == before
