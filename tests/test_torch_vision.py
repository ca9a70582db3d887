"""Port parity: the ViT-MoE model family (`models.vision.VisionMoE`)
against the JAX model at tests/test_vision.py's configuration, from the
JAX model's parameters (`convert.from_jax_params`) and the same images:
logits, l_aux, the loss and every gradient leaf (1e-5), 8 Adam steps
against optax.adam's (1e-4), and the SwinV2-style reshard of its
namespaced MoE state through the port's `checkpoint.reshard`
(scatter to N files, gather back, load: bit for bit), also on JAX's state.
"""

import numpy as np
import pytest
import torch

from tutel_tpu_torch import convert
from tutel_tpu_torch.checkpoint import reshard
from tutel_tpu_torch.models import VisionMoE, VisionMoEConfig
from tutel_tpu_torch.utils import tree_leaves, tree_replace

torch.set_num_threads(1)

CFG = dict(image_size=16, patch_size=4, model_dim=32, num_heads=2,
           num_layers=2, ffn_hidden=64, moe_every=2, num_local_experts=4,
           expert_hidden=64)
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_model():
    import jax
    from tutel_tpu.models import VisionMoE as JVision
    from tutel_tpu.models import VisionMoEConfig as JConfig
    return jax, JVision(JConfig(**CFG), group=jax.devices()[:1])


def _inputs(b, seed=1):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
    labels = np.asarray([i % 10 for i in range(b)], np.int32)
    return imgs, labels


@pytest.mark.parametrize("b", [8, 3])
def test_forward_loss_and_grads_match_jax(b):
    jax, jm = _jax_model()
    jp = jm.init(jax.random.PRNGKey(0))
    imgs, labels = _inputs(b)
    (jloss, (jnll, jlogits)), jg = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, imgs, labels)
    _, jaux = jax.jit(jm.apply)(jp, imgs)
    model = VisionMoE(VisionMoEConfig(**CFG), device="cpu")
    params = convert.from_jax_params(jp, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, (nll, logits) = model.loss(tree_replace(params, leaves),
                                     torch.from_numpy(imgs),
                                     torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        _, aux = model.apply(params, torch.from_numpy(imgs))
    assert logits.shape == (b, 10) and float(aux) > 0
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    np.testing.assert_allclose(float(nll), float(jnll), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    ref = tree_leaves(convert.from_jax_params(jg, "cpu"))
    assert len(ref) == len(grads)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)


def test_adam_steps_match_optax():
    """8 Adam(1e-2) steps, as tests/test_vision.py trains: the losses
    within 1e-4 of optax.adam's, and falling."""
    import optax
    jax, jm = _jax_model()
    jp = jm.init(jax.random.PRNGKey(0))
    imgs, labels = _inputs(8)
    opt = optax.adam(1e-2)

    @jax.jit
    def step(p, state):
        (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
            p, imgs, labels)
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    ref, state, p = [], opt.init(jp), jp
    for _ in range(8):
        p, state, loss = step(p, state)
        ref.append(float(loss))
    model = VisionMoE(VisionMoEConfig(**CFG), device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(
        convert.from_jax_params(jp, "cpu"))]
    params = tree_replace(convert.from_jax_params(jp, "cpu"), leaves)
    topt = torch.optim.Adam(leaves, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    got = []
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    for _ in range(8):
        topt.zero_grad()
        loss, _ = model.loss(params, x, y)
        loss.backward()
        topt.step()
        got.append(float(loss))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("size", [2, 4])
def test_swin_style_checkpoint_reshard(size):
    """The MoE state reshards 1 -> size -> 1 bit for bit and loads back;
    the port's state equals JAX's moe_state_dict of the same parameters,
    and JAX's scattered files equal the port's."""
    from tutel_tpu.checkpoint import reshard as jreshard
    jax, jm = _jax_model()
    jp = jm.init(jax.random.PRNGKey(0))
    model = VisionMoE(VisionMoEConfig(**CFG), device="cpu")
    params = convert.from_jax_params(jp, "cpu")
    sd = model.moe_state_dict(params)
    jsd = jm.moe_state_dict(jp)
    assert sorted(sd) == sorted(jsd)
    assert "blocks.1.moe._num_global_experts" in sd
    for k in sd:
        np.testing.assert_array_equal(sd[k], np.asarray(jsd[k]))
    ranks = reshard.scatter_state(sd, size)
    assert ranks[0]["blocks.1.moe.experts.fc1_w"].shape[0] == 4 // size
    for mine, theirs in zip(ranks, jreshard.scatter_state(jsd, size)):
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]))
    merged = reshard.gather_states(ranks)
    for k in sd:
        np.testing.assert_array_equal(merged[k], sd[k])
    other = model.init(torch.Generator().manual_seed(7))
    loaded = model.load_moe_state_dict(other, merged)
    for i in model.moe_layers:
        for a, b in zip(tree_leaves(loaded["blocks"][i]["moe"]),
                        tree_leaves(params["blocks"][i]["moe"])):
            assert torch.equal(a, b)
    # only the MoE state moved
    assert torch.equal(loaded["patch_w"], other["patch_w"])
