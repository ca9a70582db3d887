"""Port parity: ZeRO stage 1 (`net.ZeroOptimizer` over `torch.optim.Adam`)
and the `helloworld_zero` example at W = 2 and 4 gloo ranks
(`testing.RankPool`) against the JAX package's `net.ZeroOptimizer` over
`optax.adam` under shard_map, and its `examples.helloworld_zero.run`, on
W of the 8 virtual CPU devices.

Two ZeRO steps on a tree of uneven leaves (a 5 x 3 matrix does not split
over the ranks, so its shards are padded) with a different gradient on
every rank must give JAX's parameters (the gradients are summed over the
ranks, as psum_scatter sums them) within 1e-5; the example, from the JAX
example's parameters and input carried across by `convert`, JAX's losses
within 1e-5, and the optimizer state holds 1/W of each parameter.

The ranks import this module, so jax is imported only inside the
functions the pytest process calls (`_jax`).
"""

import numpy as np
import pytest
import torch

from tutel_tpu_torch import convert, net
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

SHAPES = {"a": (5, 3), "b": (8,), "c": (2, 2, 2)}
LR = 1e-2


def _jax():
    import jax
    import jax.numpy as jnp
    import optax
    from tutel_tpu import net as jnet
    return jax, jnp, optax, jnet


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(w):
        if w not in made:
            made[w] = RankPool(w, str(tmp_path_factory.mktemp(f"ranks{w}")))
        return made[w]
    yield get
    for p in made.values():
        p.close()


def _rank_steps(params, grads):
    """Two ZeRO steps, rank r's gradients grads[step][r]."""
    import torch.distributed as dist
    me = dist.get_rank()
    opt = net.ZeroOptimizer(torch.optim.Adam, None, lr=LR)
    state = opt.init(params)
    for g in grads:
        params, state = opt.step(params, {k: v[me] for k, v in g.items()},
                                 state)
    shard = {tuple(v["exp_avg"].shape) for v in state.state.values()}
    return {k: v.numpy() for k, v in params.items()}, shard


@pytest.mark.parametrize("w", [2, 4])
def test_zero_steps_match_optax_adam(pools, w):
    jax, jnp, optax, jnet = _jax()
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(w)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal((w,) + s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(2)]

    opt = jnet.ZeroOptimizer(optax.adam(LR), axis="z")
    mesh = Mesh(np.asarray(jax.devices()[:w]), ("z",))

    def body(p, g0, g1):
        state = opt.init(p, w)
        for g in (g0, g1):
            p, state = opt.step(p, jax.tree.map(lambda v: v[0], g), state, w)
        return p
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P("z"),
                                                         P("z")),
                              out_specs=P(), check_vma=False))
    ref = f(params, *grads)
    got = pools(w).run(
        _rank_steps, {k: torch.from_numpy(v) for k, v in params.items()},
        [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads])
    for new, shard in got:
        for k in SHAPES:
            np.testing.assert_allclose(new[k], np.asarray(ref[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        assert shard == {(-(-int(np.prod(s)) // w),)
                         for s in SHAPES.values()}


def _rank_hello(argv, params, x):
    from tutel_tpu_torch.examples import helloworld_zero
    lines = []
    losses = helloworld_zero.run(helloworld_zero.build_args(argv),
                                 log=lines.append, params=params, x=x)
    return losses, lines[-1]


@pytest.mark.parametrize("w", [2, 4])
def test_helloworld_zero_matches_jax(pools, monkeypatch, w):
    jax, _, _, _ = _jax()
    from tutel_tpu import moe as jmoe
    from tutel_tpu.examples import helloworld_zero as jhz
    argv = ["--num_steps", "3", "--device", "cpu"]
    devs = jax.devices()[:w]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: list(devs))
    ref_losses = []
    jparser = _jax_args(argv)
    final = jhz.run(jparser, log=lambda line: ref_losses.append(line))
    # the printed losses (5 decimals), and the last one in full
    ref = [float(line.split("= ")[1]) for line in ref_losses
           if line.startswith("STEP-")]
    jl = jmoe.moe_layer(
        gate_type={"type": "top", "k": jparser.top, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device":
                 jparser.num_experts,
                 "hidden_size_per_expert": jparser.hidden_size},
        model_dim=jparser.model_dim, seeds=(1, 1, 1), group=devs[:1])
    params = convert.from_jax_params(jl.init(jax.random.PRNGKey(1)), "cpu")
    x = convert.to_tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (jparser.batch_size * jparser.num_tokens,
                                jparser.model_dim))), "cpu")
    got = pools(w).run(_rank_hello, argv, params, x)
    for losses, check in got:
        np.testing.assert_allclose(losses, ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(losses[-1], final, rtol=1e-5, atol=1e-6)
        assert check.startswith(f"[Check] optimizer-state leaf is 1/{w} ")


def _jax_args(argv):
    """The JAX example's flags and defaults (its main parses sys.argv
    itself)."""
    import argparse
    parser = argparse.ArgumentParser()
    for name, value in (("batch_size", 8), ("num_tokens", 64),
                        ("model_dim", 128), ("hidden_size", 128),
                        ("num_experts", 2), ("top", 2), ("num_steps", 10)):
        parser.add_argument(f"--{name}", type=int, default=value)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--device", type=str, default="")
    return parser.parse_args(argv)
