"""Slice 5a on the GPU: the float megablocks branch on the card against
its padded path and against the CPU, the grouped GEMM's bfloat16 path
(`torch._grouped_mm`) against the CPU's, and a world-1 NCCL process group:
every collective of `net` on the card equal to the same call on the CPU,
and a layer forward and backward under the group equal to the CPU's.

These tests need an NVIDIA GPU and skip without one. This file imports no
JAX; on a machine without JAX run it as
`python -m pytest --noconftest tests/test_torch_ep_gpu.py`.

Tolerances: float32 with TF32 off within 1e-5 of max |CPU| (sums in other
orders); bfloat16 megablocks against the padded bmm within 2e-2 of each
token's max (two bf16 GEMMs by other kernels); collectives exact.
"""

import os
import socket

import pytest
import torch

from tutel_tpu_torch import moe, net, system
from tutel_tpu_torch.ops import grouped_gemm
from tutel_tpu_torch.utils import tree_leaves, tree_replace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(tree, device):
    return tree_replace(tree, [t.to(device) for t in tree_leaves(tree)])


def _layer(device, e=8, m=128, h=256, dtype=torch.float32, bias=True):
    return moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        model_dim=m, dtype=dtype, device=device,
        experts={"type": "ffn", "num_experts_per_device": e,
                 "hidden_size_per_expert": h, "has_fc1_bias": bias,
                 "has_fc2_bias": bias})


def _rel(got, ref):
    return float((got.float().cpu() - ref.float().cpu()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.parametrize("sizes", [[3, 0, 5, 2], [16, 0, 0, 1]])
def test_grouped_gemm_bf16_matches_cpu(cuda, sizes):
    g = torch.Generator().manual_seed(len(sizes) + sum(sizes))
    lhs = torch.randn(24, 64, generator=g).to(torch.bfloat16)
    rhs = torch.randn(4, 64, 32, generator=g).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32)
    ref = grouped_gemm.grouped_gemm(lhs, rhs, gs)
    got = grouped_gemm.grouped_gemm(lhs.to(cuda), rhs.to(cuda), gs.to(cuda))
    assert _rel(got, ref) <= 1e-2
    assert not got[sum(sizes):].any()


@pytest.mark.parametrize("mega", [4, 8])
def test_megablocks_layer_on_the_card(cuda, mega):
    start = _layer("cpu").init(torch.Generator().manual_seed(mega))
    x = torch.randn(96, 128, generator=torch.Generator().manual_seed(1))
    ref, _ = _layer("cpu")(start, x, megablocks_size=mega)
    got, _ = _layer(cuda)(_on(start, cuda), x.to(cuda), megablocks_size=mega)
    assert _rel(got, ref) <= 1e-5
    # bfloat16: megablocks (torch._grouped_mm) against the padded bmm
    lay = _layer(cuda, e=16, m=256, h=512, dtype=torch.bfloat16, bias=False)
    p = lay.init(torch.Generator(device=cuda).manual_seed(2))
    xb = torch.randn(128, 256, device=cuda).to(torch.bfloat16)
    cap = lay.resolve_capacity(p, xb, megablocks_size=mega)
    a, _ = lay(p, xb, capacity_override=cap, megablocks_size=mega)
    b, _ = lay(p, xb, capacity_override=cap)
    err = ((a.float() - b.float()).abs().amax(1)
           / b.float().abs().amax(1).clamp_min(1e-30)).max()
    assert float(err) <= 2e-2


def _net_calls(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 4, 6, generator=g).to(dev)
    rows = torch.randn(12, 5, generator=g).to(dev)
    counts = torch.tensor([7]).to(dev)
    out = {f"a2a_{i}{o}": net.all_to_all(x, i, o)
           for i, o in ((1, 0), (0, 1), (2, 0), (0, 2))}
    out.update(
        sum=net.simple_all_reduce(x), max=net.simple_all_reduce(x, op="max"),
        a2a=net.simple_all_to_all(x),
        rs=net.simple_reduce_scatter(x, dim=1),
        ag=net.simple_all_gather(x, dim=2),
        zero=net.zero_gather(x.reshape(-1), full_shape=(8, 24)))
    out["v"], out["v_recv"] = net.batch_all_to_all_v(rows, counts,
                                                     output_size=10)
    out["v2"], out["v2_recv"] = net.batch_all_to_all_v_2dh(
        rows, counts, None, None, output_size=10)
    out["gv"], out["gv_counts"] = net.batch_all_gather_v(rows, 7,
                                                         output_size=9)
    xg = x.clone().requires_grad_(True)
    (net.all_to_all(xg, 1, 0) * (x + 1)).sum().backward()
    out["grad"] = xg.grad
    return {k: v.detach().cpu() for k, v in out.items()}


def _layer_step(device, start, x, cot, group=None):
    lay = moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
        model_dim=64, device=device, group=group, parallel_type="model",
        a2a_ffn_overlap_degree=2,
        experts={"type": "ffn", "num_experts_per_device": 4,
                 "hidden_size_per_expert": 128})
    leaves = [t.detach().to(device).requires_grad_(True)
              for t in tree_leaves(start)]
    params = lay.shard_params(tree_replace(start, leaves))
    out, l_aux = lay(params, x.to(device), training=True)
    ((out * cot.to(device)).sum() + 0.01 * l_aux).backward()
    return [out.detach().cpu()] + [t.grad.cpu() for t in leaves]


def test_world1_nccl_group(cuda):
    """A world-1 NCCL group from the environment torchrun sets: the
    collectives equal the CPU's without a group, and a layer's forward
    and backward under the group equal the CPU's."""
    if torch.distributed.is_initialized():
        pytest.skip("a process group is already initialized")
    ref = _net_calls("cpu")
    g = torch.Generator().manual_seed(3)
    start = _layer("cpu", e=4, m=64, h=128).init(g)
    x, cot = torch.randn(32, 64, generator=g), torch.randn(32, 64,
                                                           generator=g)
    ref_step = _layer_step("cpu", start, x, cot)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT",
                                            "RANK", "WORLD_SIZE")}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK="0", WORLD_SIZE="1")
    try:
        env = system.init_data_model_parallel(device="cuda")
        assert env.backend == "nccl" and env.global_size == 1
        got = _net_calls(cuda)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
        step = _layer_step(cuda, start, x, cot, group=env)
        for a, b in zip(step, ref_step):
            assert _rel(a, b) <= 1e-5
    finally:
        system.destroy()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
