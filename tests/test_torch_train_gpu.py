"""The training slice on the GPU: the dispatch backward repeats bit for
bit, the MoE layer's gradients on the card agree with the CPU's, the
helloworld trainer's losses agree with the CPU's, the bfloat16
`matmul_f32` has a backward on the card (the `out_dtype` overloads of
torch.mm / torch.bmm have none), and a quantized layer whose top_k equals
its expert count (the dense dispatch shortcut) runs its kernels on the
card as the CPU runs their twins.

These tests need an NVIDIA GPU and skip without one. This file imports no
JAX; on a machine without JAX run it as
`python -m pytest --noconftest tests/test_torch_train_gpu.py`.

Tolerances: float32 with TF32 off, gradients within 1e-5 of max |CPU
gradient| and losses within 1e-4 (sums in other orders); bfloat16
`matmul_f32` gradients within 1e-2 of max |float32 gradient| (the
cotangent is rounded to bfloat16 once, and so is the gradient); the
quantized layer's output within 1e-4 of max |CPU output| for
weight-only experts and 2e-3 for W4A8 / W8A8 (an activation rounded to
the other int8 step at a tie), as `chip_smoke.py`'s engine checks.
"""

import numpy as np
import pytest
import torch

from tutel_tpu_torch import moe
from tutel_tpu_torch.examples import helloworld
from tutel_tpu_torch.ops import (dispatch, fused_ffn, grouped_gemm_quant,
                                 quant, routing, w8a8)
from tutel_tpu_torch.utils import matmul_f32, tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("k,cf,dtype", [(1, 1.0, torch.float32),
                                        (2, 0.5, torch.float32),
                                        (2, 1.0, torch.bfloat16)])
def test_dispatch_backward_repeats_bitwise(cuda, k, cf, dtype):
    s, e, m = 8192, 4, 1024
    g = torch.Generator(device=cuda).manual_seed(0)
    scores = torch.softmax(torch.randn(s, e, generator=g, device=cuda), 1)
    cap = routing.compute_static_capacity(s, e, k, cf)
    crit, _ = routing.extract_critical(scores, k, cap)
    x = torch.randn(s, m, generator=g, device=cuda).to(dtype)
    cot = torch.randn(s, m, generator=g, device=cuda).to(dtype)
    w = torch.randn(e, 1, m, generator=g, device=cuda).to(dtype)
    grads = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        gates = crit.gates.clone().requires_grad_(True)
        c = crit._replace(gates=gates)
        y = dispatch.fast_encode(xx, c, False) * w
        out = dispatch.fast_decode(y, c, True)
        grads.append(torch.autograd.grad(out, (xx, gates), cot))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("gate,cf", [({"type": "top", "k": 1}, 1.0),
                                     ({"type": "top", "k": 2}, 0.0),
                                     ({"type": "top", "k": 4}, 1.0),
                                     ({"type": "cosine_top", "k": 2}, 1.0)])
def test_layer_grads_match_cpu(cuda, gate, cf):
    layers = {d: moe.moe_layer(
        gate_type={**gate, "capacity_factor": cf},
        experts={"type": "ffn", "num_experts_per_device": 4,
                 "hidden_size_per_expert": 512},
        model_dim=256, device=d) for d in ("cpu", "cuda")}
    params = layers["cpu"].init(torch.Generator().manual_seed(0))
    x = torch.randn(1024, 256, generator=torch.Generator().manual_seed(1))
    r = torch.randn(1024, 256, generator=torch.Generator().manual_seed(2))
    grads = {}
    for d, layer in layers.items():
        p = _to(params, d)
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        out, l_aux = layer(p, x.to(d), training=True)
        loss = torch.sum(out * r.to(d)) + 0.01 * l_aux
        grads[d] = [t.cpu() for t in torch.autograd.grad(loss, leaves)]
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())


def test_helloworld_matches_cpu(cuda):
    base = ["--batch_size", "4", "--num_tokens", "128", "--model_dim", "256",
            "--hidden_size", "256", "--num_steps", "10", "--top", "1"]
    args = {d: helloworld.build_args(base + ["--device", d])
            for d in ("cpu", "cuda")}
    params, x = helloworld.start(args["cpu"], "cpu")
    losses = {d: helloworld.run(a, log=lambda *_: None,
                                params=_to(params, d), x=x.to(d))[0]
              for d, a in args.items()}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("batched", [False, True])
def test_matmul_f32_bfloat16_backward(cuda, batched):
    g = torch.Generator().manual_seed(0)
    shape_a, shape_b = ((4, 64, 256), (4, 256, 128)) if batched else \
        ((2, 64, 256), (256, 128))
    a = torch.randn(shape_a, generator=g).to(torch.bfloat16)
    b = torch.randn(shape_b, generator=g).to(torch.bfloat16)
    cot = torch.randn(shape_a[:-1] + (128,), generator=g)
    ref = []
    for t in (a.float(), b.float()):
        t.requires_grad_(True)
        ref.append(t)
    torch.autograd.backward(ref[0] @ ref[1], cot)
    ga, gb = a.to(cuda).requires_grad_(True), b.to(cuda).requires_grad_(True)
    out = matmul_f32(ga, gb)
    assert out.dtype == torch.float32
    out.backward(cot.to(cuda))
    for got, want in ((ga.grad, ref[0].grad), (gb.grad, ref[1].grad)):
        assert got.dtype == torch.bfloat16
        assert float((got.float().cpu() - want).abs().max()) <= 1e-2 * float(
            want.abs().max())


# expert type, weight bits, activation bits, fused stream, gates applied
# after the experts, the kernel
QUANT_DENSE = [
    ("ffn", 4, 0, False, True, grouped_gemm_quant.grouped_gemm_quant),
    ("ffn", 4, 0, True, True, fused_ffn.fused_ffn_quant),
    ("ffn", 4, 0, True, False, fused_ffn.fused_ffn_quant),
    ("ffn", 4, 8, False, True, w8a8.grouped_gemm_w8a8),
    ("ffn", 8, 8, True, True, fused_ffn.fused_ffn_w8a8),
    ("llama_ffn", 8, 0, True, True, fused_ffn.fused_swiglu_quant)]


@pytest.mark.parametrize("expert_type,bits,act_bits,fused,postscore,kernel",
                         QUANT_DENSE)
def test_quantized_dense_shortcut_matches_cpu(cuda, expert_type, bits,
                                              act_bits, fused, postscore,
                                              kernel):
    """top-2 of 2 experts at capacity factor 1.0 takes the dense dispatch
    (every token at every expert, [E, S, M] in token order); the expert
    kernels get that buffer on the card and agree with their twins."""
    experts = {"type": expert_type, "num_experts_per_device": 2,
               "hidden_size_per_expert": 512}
    if act_bits:
        experts["activation_bits"] = act_bits
    layers = {d: moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
        experts=experts, model_dim=256, is_postscore=postscore, device=d)
        for d in ("cpu", "cuda")}
    params = layers["cpu"].init(torch.Generator().manual_seed(0))
    qexp = quant.quantize_expert_params(params["experts"], bits)
    x = torch.randn(96, 256, generator=torch.Generator().manual_seed(1))
    outs = {}
    for d, layer in layers.items():
        ex = {k: v.to(d) for k, v in qexp.items()}
        if fused:
            ex = fused_ffn.prepare_fused_ffn_params(ex)
            assert "fused_stream" in ex
        p = {"gates": [{k: v.to(d) for k, v in g.items()}
                       for g in params["gates"]], "experts": ex}
        before = kernel.launches
        outs[d], _ = layer(p, x.to(d))
        if d == "cuda":
            torch.cuda.synchronize()
            assert kernel.launches > before
    ref = outs["cpu"]
    err = (outs["cuda"].cpu() - ref).abs().max() / ref.abs().max()
    assert float(err) <= (2e-3 if act_bits else 1e-4)
