"""Port parity: the host native library (`tutel_tpu_torch.csrc`, the
port's copy of dispatch_cpu.cpp built with g++), the moe_transformer_lm
example, and the small names of the JAX package the port adds with them
(`utils.initializers.normal`, `MOELayer.extra_repr`,
`parallel.default_devices`, `MoeMesh.world_size` / `with_adaptive_r`).

The library is held against the JAX package's own (`tutel_tpu.csrc`,
built from its copy of the source) and against the port's dispatch and
routing (`ops.dispatch`, `ops.routing`) on the same numpy inputs, as
tests/test_native.py holds the JAX one against XLA; the example's losses
against the JAX example's from the same parameters and batches (1e-4).
"""

import argparse

import numpy as np
import pytest
import torch

from tutel_tpu import csrc as jcsrc
from tutel_tpu_torch import convert, csrc
from tutel_tpu_torch.ops import dispatch, routing

torch.set_num_threads(1)


def _crit(s=33, e=8, k=2, cap=3, seed=0):
    """The port's routing of tie-free softmax scores."""
    logits = np.random.RandomState(seed).randn(s, e).astype(np.float32)
    scores = torch.softmax(torch.from_numpy(logits), dim=1)
    crit, _ = routing.extract_critical(scores, k, cap, loss_fn=None)
    return crit


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("use_gates", [True, False])
def test_dispatch_forward_matches(use_gates):
    crit = _crit()
    x = np.random.RandomState(1).randn(33, 16).astype(np.float32)
    got = csrc.dispatch_forward(crit.gates, crit.indices, crit.locations, x,
                                crit.capacity, crit.num_global_experts,
                                use_gates=use_gates)
    ref = jcsrc.dispatch_forward(_np(crit.gates), _np(crit.indices),
                                 _np(crit.locations), x, crit.capacity,
                                 crit.num_global_experts, use_gates=use_gates)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    port = dispatch.fast_encode(torch.from_numpy(x), crit,
                                is_postscore=not use_gates)
    np.testing.assert_allclose(got.numpy(), _np(port), rtol=1e-6, atol=1e-6)


def test_dispatch_backward_data_matches():
    crit = _crit(seed=2)
    e, c = crit.num_global_experts, crit.capacity
    disp = np.random.RandomState(3).randn(e, c, 16).astype(np.float32)
    got = csrc.dispatch_backward_data(crit.gates, crit.indices,
                                      crit.locations, torch.from_numpy(disp),
                                      33)
    ref = jcsrc.dispatch_backward_data(_np(crit.gates), _np(crit.indices),
                                       _np(crit.locations), disp, 33)
    np.testing.assert_array_equal(got.numpy(), ref)
    port = dispatch.fast_decode(torch.from_numpy(disp), crit,
                                is_postscore=True)
    np.testing.assert_allclose(got.numpy(), _np(port), rtol=1e-5, atol=1e-5)


def test_dispatch_backward_gate_matches():
    crit = _crit(seed=4)
    e, c = crit.num_global_experts, crit.capacity
    x = np.random.RandomState(5).randn(33, 16).astype(np.float32)
    disp = np.random.RandomState(6).randn(e, c, 16).astype(np.float32)
    gates = crit.gates.clone().requires_grad_(True)
    out = dispatch.fast_decode(torch.from_numpy(disp),
                               crit._replace(gates=gates), is_postscore=True)
    port, = torch.autograd.grad((out * torch.from_numpy(x)).sum(), gates)
    got = csrc.dispatch_backward_gate(crit.indices, crit.locations, disp, x)
    ref = jcsrc.dispatch_backward_gate(_np(crit.indices), _np(crit.locations),
                                       disp, x)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(got.numpy(), _np(port), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,e,k", [(50, 4, 2), (33, 8, 1)])
def test_cumsum_locations_matches_routing(s, e, k):
    crit = _crit(s=s, e=e, k=k, cap=1000, seed=7)
    locs, counts = csrc.cumsum_locations(crit.indices, e)
    ref_locs, ref_counts = jcsrc.cumsum_locations(_np(crit.indices), e)
    np.testing.assert_array_equal(locs.numpy(), ref_locs)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    np.testing.assert_array_equal(locs.numpy(), _np(crit.locations))
    np.testing.assert_array_equal(counts.numpy(), _np(crit.dispatch_count))


def test_sample_windows():
    corpus = np.arange(100, dtype=np.int32)
    offsets = np.asarray([0, 10, 90])
    got = csrc.sample_windows(torch.from_numpy(corpus), offsets, 10)
    np.testing.assert_array_equal(got.numpy(),
                                  jcsrc.sample_windows(corpus, offsets, 10))
    np.testing.assert_array_equal(got[1].numpy(), np.arange(10, 20))
    with pytest.raises(ValueError, match="leaves the corpus"):
        csrc.sample_windows(corpus, np.asarray([91]), 10)
    assert csrc.available()
    assert csrc.native.library_path().parent.name == "kernels"


def test_host_library_refuses_a_device_tensor():
    """The library is host code: a tensor on another device raises."""
    meta = torch.empty(3, 4, device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        csrc.sample_windows(meta, np.asarray([0]), 2)


def _lm_args(**kw):
    base = dict(batch_size=4, seq_len=32, model_dim=32, num_heads=2,
                num_layers=2, hidden=64, moe_every=1, num_experts=4, top=2,
                steps=8, lr=3e-3, l_aux_wt=0.01, dtype="float32",
                data_file="", checkpoint_path="", device="cpu")
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("moe_every", [1, 2])
def test_moe_transformer_lm_matches_jax(tmp_path, moe_every):
    """The example's AdamW losses against the JAX example's optax.adamw
    losses, step by step, from the JAX example's parameters and the same
    corpus windows; the MoE checkpoint it writes holds each block."""
    import jax
    from tutel_tpu.examples import moe_transformer_lm as jex
    from tutel_tpu.models import TransformerMoE as JModel
    from tutel_tpu.models import TransformerMoEConfig as JConfig
    from tutel_tpu_torch.checkpoint import load_state
    from tutel_tpu_torch.examples import moe_transformer_lm as tex
    args = _lm_args(moe_every=moe_every)
    ref = jex.run(args, log=lambda *_: None)
    jm = JModel(JConfig(
        vocab_size=256, max_len=args.seq_len, model_dim=args.model_dim,
        num_heads=args.num_heads, num_layers=args.num_layers,
        ffn_hidden=args.hidden, moe_every=args.moe_every,
        num_local_experts=args.num_experts, top_k=args.top,
        expert_hidden=args.hidden), group=jax.devices()[:1])
    params = convert.from_jax_params(jm.init(jax.random.PRNGKey(0)), "cpu")
    path = str(tmp_path / "moe.npz")
    got = tex.run(_lm_args(moe_every=moe_every, checkpoint_path=path),
                  log=lambda *_: None, params=params)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    state = load_state(path)
    assert sorted(state) == [f"block{i}" for i in range(args.num_layers)
                             if (i + 1) % moe_every == 0]


def test_moe_transformer_lm_batches_match_jax():
    """The corpus and its windows, taken by the host library, equal the
    JAX example's."""
    from tutel_tpu.examples import moe_transformer_lm as jex
    from tutel_tpu_torch.examples import moe_transformer_lm as tex
    args = _lm_args(steps=5)
    corpus = jex.make_corpus(args)
    np.testing.assert_array_equal(tex.make_corpus(args), corpus)
    starts = np.random.RandomState(1).randint(
        0, len(corpus) - args.seq_len - 1, size=(5, args.batch_size))
    want = np.stack([np.stack([corpus[s:s + args.seq_len + 1] for s in row])
                     for row in starts])
    np.testing.assert_array_equal(tex.make_batches(args).numpy(), want)


def test_small_names_match_jax():
    import jax
    from tutel_tpu import moe as jmoe
    from tutel_tpu.parallel import mesh as jmesh
    from tutel_tpu_torch import moe as tmoe
    from tutel_tpu_torch import parallel
    from tutel_tpu_torch.utils import initializers
    w = initializers.normal((4000,), std=0.5, dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(0))
    assert w.dtype == torch.bfloat16 and w.shape == (4000,)
    assert abs(float(w.float().std()) - 0.5) < 0.03
    assert abs(float(initializers.normal((4000,)).std()) - 0.01) < 1e-3
    kw = dict(gate_type=[{"type": "top", "k": 2, "gate_noise": 0.5},
                         {"type": "top", "k": 1}],
              experts={"type": "ffn", "num_experts_per_device": 4,
                       "hidden_size_per_expert": 8}, model_dim=8)
    assert tmoe.moe_layer(**kw, device="cpu").extra_repr() == \
        jmoe.moe_layer(**kw, group=jax.devices()[:1]).extra_repr()
    assert parallel.default_devices() == (0,)
    mesh = parallel.MoeMesh((0, 1, 2, 3), 1, 4, 1)
    jm = jmesh.MoeMesh(tuple(jax.devices()[:4]), 1, 4, 1)
    assert mesh.world_size == jm.world_size == 4
    r2 = mesh.with_adaptive_r(2)
    assert (r2.adaptive_r, r2.gather_group_size, r2.ranks) == \
        (jm.with_adaptive_r(2).adaptive_r,
         jm.with_adaptive_r(2).gather_group_size, mesh.ranks)
