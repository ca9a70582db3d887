"""Port parity, bitwise: the port's bfloat16 decode chain against the JAX
model's on its Pallas decode kernel (interpret mode on the CPU, forced
with TUTEL_TPU_DECODE_ATTN=1, tutel_tpu/models/transformer.py:829-859).

A small dense LM (2 layers, model_dim 128, 4 query heads over 2 KV heads
of 32, bfloat16; the kernel's tiling needs model_dim % 128 == 0 and
max_len % 16, % 128 with INT8) decodes 8 steps for 3 rows, one of them 3
positions ahead, with a bfloat16 and an INT8 KV cache. Both sides take
every product in float32 and round to bfloat16 at the same points, so:

  * the logits are equal bit for bit at every step, in both caches;
  * the INT8 cache (its int8 values and their float32 scales, compared as
    bits) is equal bit for bit at every step;
  * the bfloat16 cache is held to one bfloat16 step (1 in the bits of
    values of one sign), since one of its values flips by step 7.

That flip, and the reason the test does not run the serving head_dim of
128: bitwise equality also needs each float32 sum to land on the same
side of a bfloat16 rounding boundary, and PyTorch's and XLA's CPU matrix
products sum in different orders (their float32 products of the same
bfloat16 operands differ in the last bits in 10-73% of the elements at
depths 128-512). Now and then that flips one bfloat16 step of a
projection, which neither side is at fault for. At this width the one
flip lands in the last layer's V cache and no logit moves. At head_dim
128 (model_dim 256 over 2 heads, or 512 over 4 heads and 2 KV heads) a
flip comes within the first few steps and spreads through the later
projections into the logits (by many bfloat16 steps for a logit near 0)
and, at model_dim 256, into the next layer's cache, so no bound of a
step or two holds there;
tests/test_torch_transformer.py holds those widths in float32. JAX's
default CPU path rounds the normalized probabilities to bfloat16 instead
and misses both this chain and its own kernel path by 0.6-1.2% of
max |logit|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.models import TransformerMoE as JModel
from tutel_tpu.models import TransformerMoEConfig as JConfig
from tutel_tpu_torch import convert
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig

torch.set_num_threads(1)
DENSE = dict(vocab_size=61, model_dim=128, num_heads=4, num_kv_heads=2,
             num_layers=2, ffn_hidden=256, moe_every=0)
_AS_BITS = {torch.bfloat16: (torch.int16, np.int16),
            torch.float32: (torch.int32, np.int32)}


def _bits(got, ref):
    """A port tensor and a JAX array of the same dtype, as integers: the
    bits of a bfloat16 (one step apart = 1 for values of one sign) or a
    float32, or the int8 values."""
    ref = np.asarray(ref)
    assert got.dtype == convert.to_tensor(ref.reshape(-1)[:1], "cpu").dtype
    if got.dtype in _AS_BITS:
        view, np_view = _AS_BITS[got.dtype]
        return (got.view(view).numpy().astype(np.int64),
                ref.view(np_view).astype(np.int64))
    return got.numpy().astype(np.int64), ref.astype(np.int64)


@pytest.mark.parametrize("kv_bits,max_len", [(0, 48), (8, 128)])
def test_bfloat16_decode_chain_is_bitwise_jax(monkeypatch, kv_bits, max_len):
    monkeypatch.setenv("TUTEL_TPU_DECODE_ATTN", "1")
    cfg = dict(DENSE, max_len=max_len, kv_bits=kv_bits)
    jm = JModel(JConfig(**cfg, dtype=jnp.bfloat16), group=jax.devices()[:1])
    assert jm._attn_kernel_mode(cfg["model_dim"]) == "interpret"
    tm = TransformerMoE(TransformerMoEConfig(**cfg, dtype=torch.bfloat16),
                        device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jp, "cpu")
    b, steps = 3, 8
    toks = np.random.default_rng(2).integers(0, 61, (b, steps)).astype(
        np.int32)
    jc, tc = jm.init_cache(b), tm.init_cache(b)
    limit = 0 if kv_bits else 1     # INT8 bytes and scales exact; bf16: a step
    for i in range(steps):
        pos = np.full((b,), i, np.int32)
        pos[0] = i + 3                          # rows at different positions
        lj, jc, _ = jm.apply_decode(jp, jnp.asarray(toks[:, i]), jc,
                                    jnp.asarray(pos))
        lt, tc, _ = tm.apply_decode(tp, torch.from_numpy(toks[:, i]), tc,
                                    torch.from_numpy(pos))
        got, ref = _bits(lt, lj)
        assert lt.dtype == torch.bfloat16 and np.array_equal(got, ref), i
        for jl, tl in zip(jc, tc):
            assert sorted(jl) == sorted(tl)
            for key in jl:
                got, ref = _bits(tl[key], jl[key])
                assert np.abs(got - ref).max() <= limit, (i, key)
