"""Slice 6a on the GPU: the expert-choice layer with INT4 experts on the
two-call path (K1 twice) and on a fused stream (K2 once) against the same
forward through the kernels' plain twins, two calls bitwise equal (the
card's combine sums each token's rows in a fixed order); the layer in
float32 against the CPU; and the pipelines at one stage (no process
group: the hops are the identity) against the microbatches run in
sequence, GPipe's and 1F1B's gradients equal.

These tests need an NVIDIA GPU and nvcc and skip without them (a CUDA
kernel has no CPU mode). This file imports no JAX; on a machine without
JAX run it as `python -m pytest --noconftest tests/test_torch_slice6a_gpu.py`.

Tolerances: bfloat16 within 2e-2 of max |twin| per token, float32 within
1e-5 of max |ref| (tests/test_torch_kernels_gpu.py's).
"""

import dataclasses

import pytest
import torch

from tutel_tpu_torch import moe
from tutel_tpu_torch.ops import activations, fused_ffn, grouped_gemm_quant
from tutel_tpu_torch.ops import expert_choice as ec_ops
from tutel_tpu_torch.ops import quant
from tutel_tpu_torch.parallel import (ProcessMesh, local_stage_params,
                                      pipeline, pipeline_1f1b,
                                      stack_stage_params)
from tutel_tpu_torch.utils import tree_leaves, tree_replace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ec_layer(device, dtype, e=16, m=256, h=512):
    return moe.moe_layer(
        gate_type={"type": "expert_choice", "capacity_factor": 2.0},
        experts={"type": "ffn", "num_experts_per_device": e,
                 "hidden_size_per_expert": h, "has_fc1_bias": False,
                 "has_fc2_bias": False},
        model_dim=m, dtype=dtype, device=device)


def _params(layer, device, fused):
    p = layer.init(torch.Generator(device=device).manual_seed(0))
    p["experts"] = quant.quantize_expert_params(p["experts"], 4)
    if fused:
        p["experts"] = fused_ffn.prepare_fused_ffn_params(p["experts"])
    return p


def _to(tree, device):
    """A parameter tree on `device`, quantized weights and streams
    included."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name).to(device)
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree.to(device)


def twin_forward(layer, params, x):
    """The EC forward of `layer` with the experts through the kernels'
    plain twins."""
    scores = torch.softmax(layer.gates[0].apply(params["gates"][0], x), 1)
    ec = ec_ops.expert_choice_routing(
        scores, layer._ec_capacity(x.shape[0], 2.0, None, 1))
    y = ec_ops.ec_encode(x, ec)
    ex = params["experts"]
    if "fused_stream" in ex:
        y = fused_ffn.fused_ffn_quant_reference(y, ex["fused_stream"], None,
                                                activations.relu)
    else:
        y = grouped_gemm_quant.two_call_ffn(
            lambda a, w, c: grouped_gemm_quant.grouped_gemm_quant_reference(
                a, w, c), y, ex, None, activations.relu, layer.model_dim)
    return ec_ops.ec_decode(y, ec, x.shape[0])


@pytest.mark.parametrize("fused", [False, True], ids=["two_call", "fused"])
def test_ec_layer_kernels_match_twins_bitwise_repeatable(cuda, fused):
    layer = _ec_layer(cuda, torch.bfloat16)
    params = _params(layer, cuda, fused)
    x = torch.randn(64, 256, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda).to(torch.bfloat16)
    kernel = (fused_ffn.fused_ffn_quant if fused
              else grouped_gemm_quant.grouped_gemm_quant)
    before = kernel.launches
    with torch.no_grad():
        got, _ = layer(params, x)
        again, _ = layer(params, x)
        ref = twin_forward(layer, params, x)
    assert kernel.launches - before == (2 if fused else 4)
    assert torch.equal(got, again)
    err = ((got.float() - ref.float()).abs().amax(1)
           / ref.float().abs().amax(1).clamp_min(1e-30)).max()
    assert float(err) <= 2e-2


@pytest.mark.parametrize("fused", [False, True], ids=["two_call", "fused"])
def test_ec_layer_float32_matches_cpu(cuda, fused):
    layers = [_ec_layer(d, torch.float32) for d in ("cpu", cuda)]
    params = _params(layers[0], "cpu", fused)
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref, zr = layers[0](params, x)
        got, z = layers[1](_to(params, cuda), x.to(cuda))
    assert float((got.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert abs(float(z) - float(zr)) <= 1e-5 * abs(float(zr))


def _stage_fn(gate):
    layer = moe.moe_layer(
        gate_type=({"type": "top", "k": 2, "capacity_factor": 1.0}
                   if gate == "top" else
                   {"type": "expert_choice", "capacity_factor": 2.0}),
        experts={"type": "ffn", "num_experts_per_device": 4,
                 "hidden_size_per_expert": 128},
        model_dim=64, device="cuda")
    local = layer.local_forward()

    def stage(p, h):
        out, l_aux = local(p, h)
        return h + out, l_aux
    return layer, stage


@pytest.mark.parametrize("gate", ["top", "expert_choice"])
def test_world1_pipelines_match_sequential(cuda, gate):
    layer, stage = _stage_fn(gate)
    mesh = ProcessMesh([0], (1,), ("pp",))
    stacked = stack_stage_params([layer.init(torch.Generator(
        device=cuda).manual_seed(3))])
    local = local_stage_params(stacked, mesh)
    x = torch.randn(256, 64, generator=torch.Generator(
        device=cuda).manual_seed(4), device=cuda)
    nm = 8

    def loss_fn(y):
        return (y ** 2).sum() / x.shape[0]

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
    y, aux = pipeline(stage, 1, mesh, n_micro=nm, has_aux=True)(
        tree_replace(local, leaves), x)
    gp_loss = sum(loss_fn(ym) for ym in y.reshape(nm, -1, 64)) / nm + aux
    gp_grads = torch.autograd.grad(gp_loss, leaves)
    gp_loss = gp_loss.detach()
    loss, grads = pipeline_1f1b(stage, loss_fn, 1, mesh, n_micro=nm,
                                has_aux=True)(local, x)
    p0 = tree_replace(local, [t[0] for t in tree_leaves(local)])
    outs, total = [], 0.0
    with torch.no_grad():
        for xm in x.reshape(nm, -1, 64):
            ym, a = stage(p0, xm)
            outs.append(ym)
            total = total + loss_fn(ym) + a
    seq = torch.cat(outs)
    assert float((y.detach() - seq).abs().max() / seq.abs().max()) <= 1e-5
    assert abs(float(loss) - float(total / nm)) <= 1e-5 * abs(float(loss))
    assert abs(float(gp_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    for a, b in zip(gp_grads, tree_leaves(grads)):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
