"""The port's helloworld_multiprocess and `system.maybe_init_distributed`:
two OS processes entered through `python -m tutel_tpu_torch.launcher.run`
with OpenMPI-style variables (as tests/test_launcher_e2e.py drives the JAX
launcher) print identical losses, flat and with `--use_2dh`; the example's
`run` at W = 2 gloo ranks (`testing.RankPool`) against the JAX layer's
training steps on 2 virtual devices, from the same parameters and input,
within 1e-5 relative; and the environment-driven start of the process
group runs once.

The ranks import this module, so jax is imported only inside the
functions the pytest process calls.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tutel_tpu_torch import convert
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(extra):
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    env.update({"PYTHONPATH": REPO, **extra})
    return env


def _communicate(procs, timeout):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return outs


@pytest.mark.parametrize("flags", [[], ["--use_2dh"]], ids=["flat", "2dh"])
def test_two_process_launch_identical_losses(flags):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tutel_tpu_torch.launcher.run", "-m",
         "tutel_tpu_torch.examples.helloworld_multiprocess", "--device",
         "cpu", "--num_steps", "3", *flags],
        cwd=REPO, env=_env({"OMPI_COMM_WORLD_SIZE": "2",
                            "OMPI_COMM_WORLD_RANK": str(rank),
                            "MASTER_ADDR": "127.0.0.1",
                            "MASTER_PORT": str(port)}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = _communicate(procs, 240)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    losses = []
    for out in outs:
        got = re.findall(r"STEP-\d+: loss = ([0-9.eE+-]+)", out)
        assert len(got) == 3, out
        losses.append([float(v) for v in got])
    assert losses[0] == losses[1], losses
    assert "[rank 0] world=2 ranks, 2 processes" in outs[0], outs[0]
    assert "[rank 1] world=2 ranks, 2 processes" in outs[1], outs[1]


def test_maybe_init_distributed_starts_once():
    """From the launcher's variables the group starts once: a second call,
    and init_data_model_parallel after it, join the running group."""
    code = (
        "import torch.distributed as dist\n"
        "from tutel_tpu_torch import system\n"
        "assert not dist.is_initialized()\n"
        "assert system.maybe_init_distributed('cpu')\n"
        "group = dist.group.WORLD\n"
        "assert system.maybe_init_distributed('cpu')\n"
        "env = system.init_data_model_parallel(device='cpu')\n"
        "assert dist.group.WORLD is group\n"
        "print(env.global_size, env.global_rank, env.backend)\n"
        "system.destroy()\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=_env({
            "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "0", "gloo"]


def test_maybe_init_distributed_without_a_source():
    code = ("import torch.distributed as dist\n"
            "from tutel_tpu_torch import system\n"
            "assert not system.maybe_init_distributed('cpu')\n"
            "assert not dist.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=_env({}))
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, str(tmp_path_factory.mktemp("ranks2")))
    yield p
    p.close()


def _rank_run(argv, params, x):
    from tutel_tpu_torch.examples import helloworld_multiprocess as ex
    return ex.run(ex.build_args(argv), log=lambda *_: None, params=params,
                  x=x)


def _jax_reference(use_2dh, steps):
    """The JAX example's training loop on 2 virtual devices: its layer,
    init(PRNGKey(0)), input normal(PRNGKey(1)); returns (global params,
    input, per-step losses)."""
    import jax
    import jax.numpy as jnp
    from tutel_tpu import moe as jmoe
    layer = jmoe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": 1,
                 "hidden_size_per_expert": 64},
        model_dim=32, seeds=(1, 1, 1), group=jax.devices()[:2],
        use_2dh=use_2dh, num_hosts=2 if use_2dh else None)
    start = layer.init(jax.random.PRNGKey(0))
    params = layer.shard_params(start)
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 32))
    losses = []
    for _ in range(steps):
        def loss_fn(p):
            out, l_aux = layer(p, x, key=jax.random.PRNGKey(2),
                               training=True)
            return jnp.mean(out.astype(jnp.float32) ** 2) + l_aux
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params = jax.tree.map(lambda p, g: p - 1e-2 * g.astype(p.dtype),
                              params, grads)
        losses.append(float(loss))
    return start, x, losses


@pytest.mark.parametrize("use_2dh", [False, True], ids=["flat", "2dh"])
def test_multiprocess_run_matches_jax(pool, use_2dh):
    start, x, ref = _jax_reference(use_2dh, 3)
    argv = ["--device", "cpu", "--num_steps", "3"] + \
        (["--use_2dh"] if use_2dh else [])
    got = pool.run(_rank_run, argv, convert.from_jax_params(start, "cpu"),
                   convert.to_tensor(np.asarray(x), "cpu"))
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], ref, rtol=1e-5)
