"""The port's launcher (`python -m tutel_tpu_torch.launcher.run`;
counterpart: tutel_tpu/launcher/run.py and tests/test_launcher_e2e.py).

`resolve_env` on each of its sources (explicit flags, OpenMPI's variables
with MASTER_ADDR[:MASTER_PORT], none) against the JAX launcher's choice of
the same address, world and rank, written under torch's names; then two
real processes entered through the launcher with OpenMPI-style variables
run the helloworld trainer over gloo (`--device cpu --num_devices 2`):
both join one world of two ranks and print the same losses.
"""

import argparse
import os
import re
import socket
import subprocess
import sys

import numpy as np

from tutel_tpu_torch.launcher import run as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(coordinator="", nnodes=1, node_rank=0):
    return argparse.Namespace(coordinator=coordinator, nnodes=nnodes,
                              node_rank=node_rank, module="m")


def _jax_view(env):
    """(address, world, rank) in the JAX launcher's variables."""
    if not env:
        return None
    return (env["TUTEL_TPU_COORDINATOR"], env["TUTEL_TPU_NUM_PROCESSES"],
            env["TUTEL_TPU_PROCESS_ID"])


def _torch_view(env):
    if not env:
        return None
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", env["WORLD_SIZE"],
            env["RANK"])


def test_resolve_env_sources():
    from tutel_tpu.launcher import run as jrun
    ompi = {"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "3",
            "OMPI_COMM_WORLD_LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.2",
            "MASTER_PORT": "6000"}
    cases = [(_args("host1:1234", 2, 1), {}),
             (_args("host1:1234", 2, 1), ompi),         # flags win
             (_args(), ompi),
             (_args(), {k: v for k, v in ompi.items() if k != "MASTER_PORT"}),
             (_args(), {k: v for k, v in ompi.items()
                        if not k.startswith("MASTER")}),
             (_args(), {})]
    for args, env in cases:
        got = trun.resolve_env(args, env)
        assert _torch_view(got) == _jax_view(jrun.resolve_env(args, env))
        if got:
            assert got["LOCAL_RANK"] == env.get("OMPI_COMM_WORLD_LOCAL_RANK",
                                                "0")
    assert trun.resolve_env(_args(), {"MASTER_ADDR": "a:1"}) == {}
    # MASTER_ADDR may carry the port itself
    got = trun.resolve_env(_args(), {**ompi, "MASTER_ADDR": "10.0.0.2:7"})
    assert _torch_view(got) == ("10.0.0.2:7", "4", "3")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


HELLO = ["--batch_size", "4", "--num_tokens", "32", "--model_dim", "32",
         "--hidden_size", "32", "--num_steps", "3", "--device", "cpu",
         "--num_devices", "2", "--top", "2"]


def test_two_process_launch_identical_losses():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTEST_CURRENT_TEST", "RANK", "WORLD_SIZE",
                            "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.update({"OMPI_COMM_WORLD_SIZE": "2",
                    "OMPI_COMM_WORLD_RANK": str(rank),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tutel_tpu_torch.launcher.run", "-m",
             "tutel_tpu_torch.examples.helloworld"] + HELLO,
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    losses = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert "world_size = 2" in out, out
        got = re.findall(r"STEP-\d+: loss = ([0-9.eE+-]+)", out)
        assert len(got) == 3, out
        losses.append([float(v) for v in got])
    assert losses[0] == losses[1], losses
    assert np.isfinite(losses[0]).all()
