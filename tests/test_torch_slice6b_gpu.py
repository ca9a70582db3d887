"""Slices 6b and 6c on the GPU: the sequence-parallel per-rank body at one
rank (`_seqpar_local`, `_loss_seqpar_local`, both attention modes) against
`apply` / `loss` on the card; the ring's per-step function
(`ring_attention_step`) over 4 blocks of one sequence, in each rank's
ring order, against full causal attention, forward and gradients, MHA and
GQA, float32 and bfloat16; `VisionMoE` and the moe_transformer_lm and
seqpar_lm examples on the card against the CPU; the host library against
the port's dispatch run on the card.

No hand-written kernel lies on these paths. These tests need an NVIDIA GPU
and skip without one. This file imports no JAX; on a machine without JAX
run it as `python -m pytest --noconftest tests/test_torch_slice6b_gpu.py`.

Tolerances: float32 within 1e-5 of max |ref| (1e-4 for losses after
training steps), bfloat16 within 2e-2 of max |ref|.
"""

import argparse

import numpy as np
import pytest
import torch

from tutel_tpu_torch import csrc
from tutel_tpu_torch.models import (TransformerMoE, TransformerMoEConfig,
                                    VisionMoE, VisionMoEConfig)
from tutel_tpu_torch.models.transformer import ring_attention_step
from tutel_tpu_torch.ops import dispatch, routing
from tutel_tpu_torch.utils import tree_leaves, tree_replace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's entry points run on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _on(tree, device):
    return tree_replace(tree, [t.to(device) for t in tree_leaves(tree)])


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_seqpar_body_at_one_rank_matches_apply(cuda, mode):
    cfg = TransformerMoEConfig(
        vocab_size=97, max_len=64, model_dim=64, num_heads=4, num_kv_heads=2,
        num_layers=2, ffn_hidden=128, num_local_experts=4,
        expert_hidden=128, capacity_factor=1.25)
    model = TransformerMoE(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, 97, (2, 32), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    with torch.no_grad():
        ref, _ = model.apply(params, toks)
        got, _ = model._seqpar_local(params, toks, attn_mode=mode)
    assert _rel(got, ref) <= 1e-5
    results = []
    for fn in (model.loss, lambda p, t: model._loss_seqpar_local(
            p, t, attn_mode=mode)):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, (nll, _) = fn(tree_replace(params, leaves), toks)
        results.append((float(nll), torch.autograd.grad(loss, leaves)))
    (nll, grads), (snll, sgrads) = results
    assert abs(snll - nll) <= 1e-5 * abs(nll)
    for g, r in zip(sgrads, grads):
        assert _rel(g, r) <= 1e-4


def ring_blocks(q, k, v, p):
    """`ring_attention_step` over p blocks of one sequence: block i's
    queries take the K/V blocks in rank i's ring order (i, i - 1, ...),
    with no collective. q [B, T, NH, HD], k, v [B, T, KVH, HD]."""
    b, t, nh, hd = q.shape
    kvh = k.shape[2]
    mq, tl = nh // kvh, t // p
    pos = torch.arange(tl, device=q.device)
    qg = q.reshape(b, t, mq, kvh, hd)
    outs = []
    for i in range(p):
        m = torch.full((b, mq, kvh, tl), float("-inf"), device=q.device)
        den = torch.zeros((b, mq, kvh, tl), device=q.device)
        acc = torch.zeros((b, tl, mq, kvh, hd), device=q.device)
        for j in range(p):
            src = (i - j) % p
            m, den, acc = ring_attention_step(
                qg[:, i * tl:(i + 1) * tl], k[:, src * tl:(src + 1) * tl],
                v[:, src * tl:(src + 1) * tl], i * tl + pos, src * tl + pos,
                m, den, acc)
        outs.append(acc / den.permute(0, 3, 1, 2)[..., None])
    return torch.cat(outs, dim=1).reshape(b, t, nh, hd).to(q.dtype)


def full_attention(q, k, v):
    """Causal attention over the whole sequence as the model's `_attn`
    computes it (float32 scores, probabilities in q's dtype)."""
    b, t, nh, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, t, nh // kvh, kvh, hd)
    scores = torch.einsum("bqmgd,bkgd->bmgqk", qg.float(),
                          k.float()) * hd ** -0.5
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, torch.full_like(scores,
                                                       float("-inf")))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bmgqk,bkgd->bqmgd", probs, v)
    return out.reshape(b, t, nh, hd)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kvh", [8, 2])
def test_ring_blocks_match_full_attention(cuda, dtype, tol, kvh):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, cot = (torch.randn(2, 256, n, 64, generator=g, device=cuda)
                    for n in (8, kvh, kvh, 8))
    q, k, v = (a.to(dtype).requires_grad_(True) for a in (q, k, v))
    outs, grads = [], []
    for fn in (ring_blocks, full_attention):
        out = fn(q, k, v, 4) if fn is ring_blocks else fn(q, k, v)
        outs.append(out)
        grads.append(torch.autograd.grad(out.float(), (q, k, v),
                                         cot.to(out.dtype).float()))
    assert _rel(outs[0], outs[1]) <= tol
    for a, b in zip(*grads):
        assert torch.isfinite(a).all() and _rel(a, b) <= tol


def test_vision_on_card_matches_cpu(cuda):
    cfg = VisionMoEConfig(image_size=16, model_dim=32, num_heads=2,
                          num_layers=2, ffn_hidden=64, expert_hidden=64)
    start = VisionMoE(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    imgs = torch.randn(16, 16, 16, 3, generator=g)
    labels = torch.arange(16) % 10
    losses = {}
    for dev in ("cpu", cuda):
        model = VisionMoE(cfg, device=dev)
        leaves = [p.clone().requires_grad_(True)
                  for p in tree_leaves(_on(start, dev))]
        params = tree_replace(start, leaves)
        opt = torch.optim.Adam(leaves, lr=1e-2)
        ls = []
        for _ in range(3):
            opt.zero_grad()
            loss, _ = model.loss(params, imgs.to(dev), labels.to(dev))
            loss.backward()
            opt.step()
            ls.append(float(loss))
        losses[str(dev)] = np.array(ls)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4,
                               atol=1e-4)


def test_host_library_matches_dispatch_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    scores = torch.softmax(torch.randn(64, 8, generator=g, device=cuda), 1)
    crit, _ = routing.extract_critical(scores, 2, 12, loss_fn=None)
    x = torch.randn(64, 32, generator=g, device=cuda)
    disp = torch.randn(8, 12, 32, generator=g, device=cuda)
    host = {k: getattr(crit, k).cpu() for k in ("gates", "indices",
                                                "locations")}
    enc = csrc.dispatch_forward(host["gates"], host["indices"],
                                host["locations"], x.cpu(), 12, 8)
    assert _rel(enc, dispatch.fast_encode(x, crit, False).cpu()) <= 1e-5
    dec = csrc.dispatch_backward_data(host["gates"], host["indices"],
                                      host["locations"], disp.cpu(), 64)
    assert _rel(dec, dispatch.fast_decode(disp, crit, True).cpu()) <= 1e-5
    locs, counts = csrc.cumsum_locations(host["indices"], 8)
    assert torch.equal(locs.long(), crit.locations.cpu().long())
    assert torch.equal(counts.long(), crit.dispatch_count.cpu().long())


def test_examples_on_card_match_cpu(cuda):
    from tutel_tpu_torch.examples import moe_transformer_lm, seqpar_lm
    lm = dict(batch_size=4, seq_len=32, model_dim=32, num_heads=2,
              num_layers=2, hidden=64, moe_every=2, num_experts=4, top=2,
              steps=4, lr=3e-3, l_aux_wt=0.01, dtype="float32",
              data_file="", checkpoint_path="")
    sp = dict(batch=2, seq_len=32, model_dim=32, num_heads=8, num_layers=2,
              experts_per_device=2, steps=3, lr=1e-3, attn="ring",
              num_kv_heads=4)
    for module, kw in ((moe_transformer_lm, lm), (seqpar_lm, sp)):
        got = {dev: np.array(module.run(argparse.Namespace(**kw, device=dev),
                                        log=lambda *_: None))
               for dev in ("cpu", "cuda")}
        np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4,
                                   atol=1e-4)
