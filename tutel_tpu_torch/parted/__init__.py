"""Parted: SPMD auto-partitioning for single-program graphs (counterpart:
tutel_tpu/parted/).

Describe a computation as a graph of einsum-style nodes, search per-node
sharding states with the JAX package's analytical cost model
(`solver.solve_partition`, ranked alike in both packages), and compile the
chosen plan into a runnable program. The JAX package leaves the
collectives to GSPMD; here `compile_graph` lowers each plan to explicit
`net` collectives over a process group, as the reference's primitives did
(reference tutel/parted/spmdx.py:419-516, patterns.py:12-129). States: dim
index >= 0 (partitioned along that dim), REPLICATED (-1), ZERO (-2: a
parameter stored sharded on its leading dim and all-gathered on use).

    from tutel_tpu_torch import parted
    from tutel_tpu_torch.parted import spmdx
    parted.init(device="cpu")                 # the default group's ranks
    x = spmdx.data((512, 64), name="x")
    w = spmdx.param((64, 64), name="w")
    y = spmdx.custom("NM = NK, KM+", [x, w], name="y")
    (cost, cfg), = parted.optimize(y)
    prog = parted.compile_graph(y, cfg)
    out = prog(*prog.example_inputs())        # the full output, every rank
    print(prog.compiled_text())
"""

from .spmdx import (  # noqa: F401
    Graph, Node, Parser, Config, init, data, param, custom, optimize,
    compile as compile_graph, session, REPLICATED, ZERO,
)
from . import solver  # noqa: F401
