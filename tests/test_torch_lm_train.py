"""Port parity: TransformerMoE.loss of the port against the JAX model's
under `jax.value_and_grad`, on a small float32 LM (2 layers, model_dim 64,
4 heads over 2 KV heads, an MoE block of 4 top-2 experts), with the same
parameters (converted through numpy) and tokens: both branches of the
loss (a sequence up to max_len runs whole and shifts the per-position
losses; a longer one runs tokens[:, :-1]), the nll and l_aux parts, and
every parameter gradient.

Tolerance: the loss parts within 1e-6 relative, each gradient within
1e-5 * max |jax gradient| (float32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.models import transformer as jtr
from tutel_tpu_torch import convert
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig

torch.set_num_threads(1)

CFG = dict(vocab_size=97, max_len=16, model_dim=64, num_heads=4,
           num_kv_heads=2, num_layers=2, ffn_hidden=128, moe_every=2,
           num_local_experts=4, expert_hidden=64, top_k=2,
           capacity_factor=1.25)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _flat(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _flat(t, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def models():
    jm = jtr.TransformerMoE(jtr.TransformerMoEConfig(**CFG),
                            group=jax.devices()[:1])
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerMoE(TransformerMoEConfig(**CFG), device="cpu")
    return jm, jp, tm


@pytest.mark.parametrize("l_aux_wt", [0.0, 0.01])
@pytest.mark.parametrize("t", [16, 12, 17])       # 17 > max_len: sliced
def test_loss_and_grads_match_jax(models, t, l_aux_wt):
    jm, jp, tm = models
    tokens = np.random.default_rng(t).integers(0, CFG["vocab_size"], (2, t))

    def jloss(p):
        loss, parts = jm.loss(p, jnp.asarray(tokens, jnp.int32),
                              key=jax.random.PRNGKey(1), l_aux_wt=l_aux_wt)
        return loss, parts
    (jl, (jnll, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)

    tp = convert.from_jax_params(jp, "cpu")
    leaves = _flat(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    tl, (tnll, taux) = tm.loss(tp, torch.from_numpy(tokens),
                               key=torch.Generator().manual_seed(1),
                               l_aux_wt=l_aux_wt)
    grads = torch.autograd.grad(tl, list(leaves.values()))

    for got, ref in ((tl, jl), (tnll, jnll), (taux, jaux)):
        assert abs(float(got.detach()) - float(ref)) <= \
            1e-6 * abs(float(ref))
    jflat = _flat(jg)
    assert sorted(jflat) == sorted(leaves)
    for name, g in zip(leaves, grads):
        ref = np.asarray(jflat[name], np.float64)
        scale = max(np.max(np.abs(ref)), 1e-30)
        assert np.max(np.abs(g.numpy() - ref)) <= 1e-5 * scale, name


def test_nll_forms_match_jax():
    """_nll and _nll_shifted on the same logits as JAX's, bfloat16 logits
    reduced in float32 included."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    tokens = rng.integers(0, 50, (3, 7))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jlog = jnp.asarray(logits).astype(jdt)
        tlog = convert.to_tensor(np.asarray(jlog), "cpu")
        assert tlog.dtype == dt
        for got, ref in (
                (TransformerMoE._nll_shifted(tlog, torch.from_numpy(tokens)),
                 jtr.TransformerMoE._nll_shifted(jlog, jnp.asarray(tokens))),
                (TransformerMoE._nll(tlog[:, :-1],
                                     torch.from_numpy(tokens[:, 1:])),
                 jtr.TransformerMoE._nll(jlog[:, :-1],
                                         jnp.asarray(tokens[:, 1:])))):
            assert got.dtype == torch.float32
            assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


def test_training_forward_is_the_inference_forward(models):
    """With no gate noise, apply(training=True) gives apply's logits."""
    jm, jp, tm = models
    tp = convert.from_jax_params(jp, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 97,
                                                                (2, 16)))
    a, la = tm.apply(tp, tokens)
    b, lb = tm.apply(tp, tokens, key=torch.Generator().manual_seed(0),
                     training=True)
    assert torch.equal(a, b) and torch.equal(la, lb)
