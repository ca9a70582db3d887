"""Port parity: the port's helloworld trainer
(tutel_tpu_torch.examples.helloworld) on the CPU, started from the JAX
example's own parameters (`layer.init(PRNGKey(1))`) and input
(`normal(PRNGKey(0))`) through `convert.from_jax_params`, reproduces the
six golden loss trajectories of tests/golden_helloworld.json, which the
JAX example reproduces in tests/test_helloworld.py: within 1e-4 in
float32 and 1e-2 in bfloat16 (the tolerances of that test). The
expert-parallel flags run at one rank with the plain run's losses; flags
of later slices raise."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu import moe as jmoe
from tutel_tpu_torch import convert
from tutel_tpu_torch.examples import helloworld

torch.set_num_threads(1)

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__),
                                     "golden_helloworld.json")))
BASE = ["--batch_size", "4", "--num_tokens", "128", "--model_dim", "64",
        "--hidden_size", "64", "--num_steps", "10", "--num_devices", "1",
        "--device", "cpu"]


def _jax_start(args):
    """The JAX example's initial parameters and input for `args`."""
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[args.dtype]
    layer = jmoe.moe_layer(
        gate_type={"type": "top", "k": args.top, "fp32_gate": args.fp32_gate,
                   "capacity_factor": args.capacity_factor},
        experts={"type": args.expert_type,
                 "num_experts_per_device": args.num_local_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), dtype=dtype,
        group=jax.devices()[:1])
    params = layer.init(jax.random.PRNGKey(1))
    x = jax.random.normal(jax.random.PRNGKey(0),
                          (args.batch_size, args.num_tokens, args.model_dim),
                          dtype=jnp.float32).astype(dtype)
    return (convert.from_jax_params(params, "cpu"),
            convert.to_tensor(np.asarray(x), "cpu"))


@pytest.mark.parametrize("name,extra", [
    ("top1_fp32_e1", ["--top", "1", "--num_local_experts", "1"]),
    ("top1_fp32_e2", ["--top", "1", "--num_local_experts", "2"]),
    ("top2_fp32_e1", ["--top", "2", "--num_local_experts", "1"]),
    ("top2_fp32_e2", ["--top", "2", "--num_local_experts", "2"]),
    ("top2_bf16_e2", ["--top", "2", "--num_local_experts", "2",
                      "--dtype", "bfloat16"]),
    ("top2_fp32_e2_dropless", ["--top", "2", "--num_local_experts", "2",
                               "--capacity_factor", "0"]),
])
def test_golden_losses(name, extra):
    args = helloworld.build_args(BASE + extra)
    params, x = _jax_start(args)
    lines = []
    losses, avg = helloworld.run(args, log=lines.append, params=params, x=x)
    tol = 1e-2 if "bf16" in name else 1e-4
    np.testing.assert_allclose(losses, GOLDEN[name], rtol=tol, atol=tol)
    assert avg > 0 and sum(ln.startswith("STEP-") for ln in lines) == 10


def test_own_seeds_train():
    """Without params/x the port seeds its own generators; a float32 run
    repeats exactly and its loss falls at lr 1e-5."""
    args = helloworld.build_args(BASE[:-6] + ["--num_steps", "4",
                                              "--device", "cpu"])
    a, _ = helloworld.run(args, log=lambda *_: None)
    b, _ = helloworld.run(args, log=lambda *_: None)
    assert a == b and a[-1] < a[0]


def test_eval_runs_the_forward_only():
    args = helloworld.build_args(BASE + ["--eval", "--num_steps", "3"])
    params, x = _jax_start(args)
    losses, _ = helloworld.run(args, log=lambda *_: None, params=params, x=x)
    assert losses[0] == losses[1] == losses[2]
    np.testing.assert_allclose(losses[0], GOLDEN["top2_fp32_e2"][0],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flag", [
    ["--num_devices", "2"], ["--num_devices", "3"],
    ["--use_scan"]])
def test_flags_of_later_slices_raise(flag):
    """--num_devices must equal the world size (one rank here); --use_scan
    is a JAX compile strategy. (--checkpoint_path runs since slice 5b:
    tests/test_torch_checkpoint.py.)"""
    args = helloworld.build_args(BASE + flag)
    with pytest.raises(ValueError, match=flag[0]):
        helloworld.run(args, log=lambda *_: None)


@pytest.mark.parametrize("flag", [
    ["--parallel_type", "data"], ["--parallel_type", "model"],
    ["--parallel_type", "auto"], ["--use_2dh"],
    ["--a2a_ffn_overlap_degree", "2"]])
def test_parallel_flags_run_at_one_rank(flag):
    """The expert-parallel flags run without a process group; at one rank
    they all take the one-device body, so the losses are the plain run's
    bit for bit (the multi-rank runs: tests/test_torch_ep.py)."""
    args = helloworld.build_args(BASE + ["--num_steps", "3"])
    params, x = _jax_start(args)
    plain, _ = helloworld.run(args, log=lambda *_: None, params=params, x=x)
    got, _ = helloworld.run(helloworld.build_args(
        BASE + ["--num_steps", "3"] + flag), log=lambda *_: None,
        params=params, x=x)
    assert got == plain
