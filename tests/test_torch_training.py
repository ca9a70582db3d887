"""Port parity: MOELayer(training=True) of the port against the JAX layer
under `jax.value_and_grad`, with the same parameters (converted through
numpy), inputs and loss: the loss value and every parameter gradient,
with l_aux_wt 0 and 0.01, top-1 and top-2 with dropped tokens, dropless,
the top_k == E dense shortcut, the cosine gate, is_postscore=False,
batch-prioritized routing, the load-importance loss with the gate noise
JAX drew, and remat_experts.

Tolerance: max |port - jax| <= 1e-5 * max |jax| for each gradient (float32
sums in other orders; the loss within 1e-6 relative). JAX runs under
jax.jit, where its dropless capacity is the lossless worst case; the
port reads the exact one. Neither drops a token, so the values agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu import moe as jmoe
from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.ops import dispatch as td
from tutel_tpu_torch.ops import quant
from tutel_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)

S, E, M, H = 24, 4, 32, 48


def _layers(gate, layer_kw):
    experts = {"type": "ffn", "num_experts_per_device": E,
               "hidden_size_per_expert": H}
    j = jmoe.moe_layer(gate_type=dict(gate), experts=dict(experts),
                       model_dim=M, seeds=(1, 1, 1), group=jax.devices()[:1],
                       **layer_kw)
    t = tmoe.moe_layer(gate_type=dict(gate), experts=dict(experts),
                       model_dim=M, device="cpu", **layer_kw)
    return j, t


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(
        tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree,
        np.float64)}


def _jax_loss_and_grads(jl, jp, x, r, l_aux_wt, key):
    def loss(p, xx):
        out, l_aux = jl(p, xx, key=key, training=True)
        return jnp.sum(out * r) + l_aux_wt * l_aux
    return jax.jit(jax.value_and_grad(loss))(jp, jnp.asarray(x))


def _port_loss_and_grads(tl, tp, x, r, l_aux_wt):
    names, leaves = list(_flat(tp)), tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    out, l_aux = tl(tp, torch.from_numpy(x), training=True)
    loss = torch.sum(out * torch.from_numpy(r)) + l_aux_wt * l_aux
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {n: g.numpy() for n, g in zip(names, grads)}


CASES = {
    "top1_drop": ({"k": 1, "capacity_factor": 0.5}, {}),
    "top2_drop": ({"k": 2, "capacity_factor": 0.5}, {}),
    "top2_dropless": ({"k": 2, "capacity_factor": 0.0}, {}),
    "top2_prescore_bpr": ({"k": 2, "capacity_factor": 1.0},
                          {"is_postscore": False,
                           "batch_prioritized_routing": True}),
    "dense_topk_eq_e": ({"k": E, "capacity_factor": 0.0}, {}),
    "dense_topk_eq_e_prescore": ({"k": E, "capacity_factor": 1.0},
                                 {"is_postscore": False}),
    "cosine": ({"type": "cosine_top", "k": 2, "capacity_factor": 1.0,
                "proj_dim": 16}, {}),
    "remat": ({"k": 2, "capacity_factor": 0.0}, {"remat_experts": True}),
    "load_importance_noise": ({"k": 2, "capacity_factor": 1.0,
                               "gate_noise": 1.0},
                              {"is_gshard_loss": False}),
}


@pytest.mark.parametrize("l_aux_wt", [0.0, 0.01])
@pytest.mark.parametrize("case", list(CASES))
def test_training_grads_match_jax(case, l_aux_wt, monkeypatch):
    gate, layer_kw = CASES[case]
    gate = {"type": "top", **gate}
    jl, tl = _layers(gate, layer_kw)
    jp = jl.init(jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jp, "cpu")
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((S, M)).astype(np.float32)
    r = rng.standard_normal((S, M)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    if gate.get("gate_noise"):
        # the noise the JAX layer draws on one device (fold_in(key, 0))
        noise = np.array(jax.random.normal(jax.random.fold_in(key, 0),
                                           (S, E), jnp.float32))
        monkeypatch.setattr(tl, "_draw_noise",
                            lambda shape, k, dev: torch.from_numpy(noise))
    dense = []
    real_dense = td.dense_encode
    monkeypatch.setattr(td, "dense_encode",
                        lambda *a: dense.append(1) or real_dense(*a))

    jloss, jgrads = _jax_loss_and_grads(jl, jp, x, r, l_aux_wt, key)
    tloss, tgrads = _port_loss_and_grads(tl, tp, x, r, l_aux_wt)
    assert bool(dense) == case.startswith("dense")
    assert abs(tloss - float(jloss)) <= 1e-6 * abs(float(jloss))
    jflat = _flat(jgrads)
    assert sorted(jflat) == sorted(tgrads)
    for name, ref in jflat.items():
        got = tgrads[name]
        scale = max(np.max(np.abs(ref)), 1e-30)
        assert np.max(np.abs(got - ref)) <= 1e-5 * scale, name
        if l_aux_wt and name.startswith("gates"):
            assert np.any(ref)


def test_remat_gives_the_same_gradients():
    """remat_experts recomputes the experts in the backward: the same
    gradients bit for bit."""
    grads = []
    for remat in (False, True):
        _, tl = _layers({"type": "top", "k": 2, "capacity_factor": 0.0},
                        {"remat_experts": remat})
        tp = tl.init(torch.Generator().manual_seed(3))
        x = np.random.default_rng(1).standard_normal((S, M)).astype(
            np.float32)
        r = np.ones((S, M), np.float32)
        grads.append(_port_loss_and_grads(tl, tp, x, r, 0.01)[1])
    for name in grads[0]:
        assert np.array_equal(grads[0][name], grads[1][name]), name


def test_gate_noise_follows_the_generator():
    """Training noise comes from the key Generator: the same seed gives the
    same output, another seed another routing; the dropless probe and the
    routing see the same noise, so no token is dropped."""
    _, tl = _layers({"type": "top", "k": 1, "capacity_factor": 0.0,
                     "gate_noise": 4.0}, {})
    tp = tl.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (S, M)).astype(np.float32))

    def run(seed):
        return tl(tp, x, key=torch.Generator().manual_seed(seed),
                  training=True)[0]
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.all(a.abs().sum(dim=1) > 0)          # every token served
    assert torch.equal(tl(tp, x)[0], tl(tp, x, key=torch.Generator()
                                        .manual_seed(9))[0])


def test_quantized_experts_refuse_training():
    _, tl = _layers({"type": "top", "k": 2, "capacity_factor": 1.0}, {})
    tp = tl.init(torch.Generator().manual_seed(0))
    tp["experts"] = quant.quantize_expert_params(tp["experts"], 8)
    x = torch.randn(S, M)
    tl(tp, x)                                         # inference runs
    with pytest.raises(ValueError, match="inference-only"):
        tl(tp, x, training=True)
