"""Parted on the GPU: a small version of `chip_smoke.py`'s step 17. Its
MLP graph, with K10 (`jit.pallas_kernel`, squared ReLU) as the activation
node, compiled under the default plan and step 17's forced plans
(`chip_smoke.PARTED_PLANS`: data-parallel, the K-split FAR, ZERO, A2A +
FAR, RS + AG) at one rank on the card, against the same plans on the CPU,
where K10 runs its plain twin.

These tests need an NVIDIA GPU and nvcc and skip without them (a CUDA
kernel has no CPU mode). This file imports no JAX; on a machine without
JAX run it as `python -m pytest --noconftest tests/test_torch_parted_gpu.py`.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from tutel_tpu_torch import parted  # noqa: E402
from tutel_tpu_torch.parted import spmdx  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-5                   # max |card - CPU| / max |CPU|, float32
SHAPE = {"n": 256, "k": 64, "h": 128, "m": 64}
PLANS = {"default": ({}, []), **cs.PARTED_PLANS}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(device, cfg, args):
    parted.init(device=device)
    prog = parted.compile_graph(cs.parted_graph(spmdx, SHAPE),
                                spmdx.Config(cfg))
    with torch.no_grad():
        return prog, prog(*[a.to(device) for a in args])


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_parted_plan_on_gpu_matches_cpu(cuda, plan):
    cfg, kinds = PLANS[plan]
    g = torch.Generator().manual_seed(len(plan))
    args = [torch.randn(SHAPE["n"], SHAPE["k"], generator=g),
            torch.randn(SHAPE["k"], SHAPE["h"], generator=g) * 0.1,
            torch.randn(SHAPE["h"], SHAPE["m"], generator=g) * 0.1]
    _, ref = _run("cpu", cfg, args)
    before = cs.SQUARED_RELU.launches
    prog, got = _run("cuda", cfg, args)
    torch.cuda.synchronize()
    assert cs.SQUARED_RELU.launches == before + 1
    assert [c.kind for c in prog.collectives] == kinds
    err = float((got.cpu() - ref).abs().max() / ref.abs().max())
    assert err <= TOL, err
    assert prog.execute(steps=2, warmup=1) > 0
    assert cs.SQUARED_RELU.launches == before + 4


def test_optimize_on_gpu_returns_the_default_plan(cuda):
    parted.init(device="cuda")
    y2 = cs.parted_graph(spmdx, SHAPE)
    (cost, cfg), = parted.optimize(y2)
    assert cost == 0.0 and cfg == spmdx.Config.default(spmdx.Graph([y2]))
    (t, cfg2), = parted.optimize(y2, top_k=3, measure=True)
    assert t > 0 and cfg2 == cfg
