"""Multi-host launcher (counterpart: tutel_tpu/launcher/run.py; reference:
tutel/launcher/run.py:6-35).

Maps the launch conventions onto the environment `torch.distributed`'s
env:// rendezvous reads (`system.init_data_model_parallel`) and execs the
target module: one process, as the JAX launcher runs one; LOCAL_RANK picks
its card. Sources for (address, world, rank), the first that applies:

  1. explicit flags --coordinator HOST:PORT / --nnodes / --node_rank;
  2. OpenMPI: OMPI_COMM_WORLD_SIZE / OMPI_COMM_WORLD_RANK with
     MASTER_ADDR[:MASTER_PORT] (LOCAL_RANK from
     OMPI_COMM_WORLD_LOCAL_RANK);
  3. none: the environment is left as it is, and the module runs on one
     rank (or joins what torchrun set).

Usage:
    mpiexec -host h1,h2 python3 -m tutel_tpu_torch.launcher.run \\
        -m tutel_tpu_torch.examples.helloworld --batch_size=16
"""

import argparse
import os
import sys


def resolve_env(args, env=None):
    """The rendezvous variables for `args` and the environment `env`
    (default os.environ): MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
    LOCAL_RANK, or {} without a source."""
    env = dict(env if env is not None else os.environ)
    local = env.get("OMPI_COMM_WORLD_LOCAL_RANK", "0")
    if args.coordinator:
        host, _, port = args.coordinator.rpartition(":")
        return {"MASTER_ADDR": host, "MASTER_PORT": port,
                "WORLD_SIZE": str(args.nnodes),
                "RANK": str(args.node_rank), "LOCAL_RANK": local}
    if "OMPI_COMM_WORLD_SIZE" in env:
        host, _, port = env.get("MASTER_ADDR", "127.0.0.1").partition(":")
        return {"MASTER_ADDR": host,
                "MASTER_PORT": port or env.get("MASTER_PORT", "8799"),
                "WORLD_SIZE": env["OMPI_COMM_WORLD_SIZE"],
                "RANK": env["OMPI_COMM_WORLD_RANK"], "LOCAL_RANK": local}
    return {}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", dest="module", type=str, required=True)
    parser.add_argument("--coordinator", type=str, default="")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node_rank", type=int, default=0)
    args, rest = parser.parse_known_args(argv)

    os.environ.update(resolve_env(args))
    os.execl(sys.executable, sys.executable, "-m", args.module, *rest)


if __name__ == "__main__":
    main()
