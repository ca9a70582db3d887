"""Port parity: checkpoints (`tutel_tpu_torch.checkpoint`) against the JAX
package's `tutel_tpu.checkpoint`.

* Files: what either package's `serial.save_state` writes, the other's
  `load_state` reads bit for bit (nested namespaces, bfloat16 kept as
  float32 by the state dicts, integer markers).
* Resharding: a JAX layer's global state scattered by JAX to N per-rank
  states, gathered by the port to one (N -> 1) and scattered again to M
  (1 -> M), including M > E (expert slicing) and an N-rank sliced layout;
  every array bit for bit against JAX's own gather and scatter; the
  gathered state loaded into the port's layer at W = 1 and the M = 2
  shards into the port's layer at W = 2 gloo ranks (`testing.RankPool`),
  each forward within 1e-5 of JAX's on the original parameters.
* The CLIs `python -m tutel_tpu_torch.checkpoint.scatter|gather` with the
  JAX tools' flags: the same files as the JAX tools write, and a round
  trip bit for bit.
* The helloworld trainer's `--checkpoint_path`: two `--eval` resumes of a
  saved run give equal losses; a file the JAX trainer wrote resumes in
  the port with JAX's eval loss (1e-4, test_helloworld.py's tolerance);
  and at W = 2 the ranks' shards are gathered into the JAX trainer's
  global file (same keys and shapes, values within 1e-4 after the same
  three steps).

The ranks import this module, so jax is imported only inside the
functions the pytest process calls (`_jax`).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tutel_tpu_torch import checkpoint, convert
from tutel_tpu_torch import moe as tmoe
from tutel_tpu_torch.checkpoint import gather as tgather
from tutel_tpu_torch.checkpoint import reshard, scatter as tscatter, serial
from tutel_tpu_torch.testing import RankPool

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, H = 32, 64


def _jax():
    import jax
    import jax.numpy as jnp
    from tutel_tpu import checkpoint as jck
    from tutel_tpu import moe as jmoe
    return jax, jnp, jck, jmoe


def _kwargs(nle):
    """Dropless, so one rank and two give the same forward."""
    return dict(gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
                experts={"type": "ffn", "num_experts_per_device": nle,
                         "hidden_size_per_expert": H},
                model_dim=M, seeds=(1, 1, 1))


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


def _equal_states(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_files_cross_both_packages(tmp_path):
    _, _, jck, _ = _jax()
    rng = np.random.default_rng(0)
    state = {"model": {"moe.experts.fc1_w": rng.standard_normal(
        (2, 3, 4)).astype(np.float32),
        "moe._num_global_experts": np.asarray(2),
        "deep": {"ids": np.arange(5, dtype=np.int32)}},
        "step": np.float32(3.5)}
    for writer, reader in ((jck.serial, serial), (serial, jck.serial)):
        path = str(tmp_path / f"{writer.__name__}.npz")
        writer.save_state(path, state)
        _equal_states(serial.flatten_state(reader.load_state(path)),
                      serial.flatten_state(state))


# N -> 1 -> M: (global experts, N, M)
RESHARD = [(4, 4, 2), (2, 4, 2), (2, 2, 4), (1, 2, 1)]


def _rank_load_forward(nle, states, x):
    layer = tmoe.moe_layer(device="cpu", **_kwargs(nle))
    template = layer.shard_params(layer.init(torch.Generator()))
    params = layer.load_state_dict(template, states[dist.get_rank()],
                                   strict=True)
    n = x.shape[0] // dist.get_world_size()
    r = dist.get_rank()
    with torch.no_grad():
        return layer(params, x[r * n:(r + 1) * n])[0].numpy()


@pytest.mark.parametrize("e,n,m", RESHARD)
def test_reshard_jax_state_and_load_into_port(pools, e, n, m):
    jax, jnp, jck, jmoe = _jax()
    jl = jmoe.moe_layer(group=jax.devices()[:1], **_kwargs(e))
    jp = jl.init(jax.random.PRNGKey(e + n))
    full = jl.state_dict(jp)
    ranks = jck.reshard.scatter_state(full, n)           # JAX's N files
    merged = reshard.gather_states(ranks)                # port: N -> 1
    _equal_states(merged, jck.reshard.gather_states(ranks))
    _equal_states(merged, full)
    again = reshard.scatter_state(merged, m)             # port: 1 -> M
    for got, ref in zip(again, jck.reshard.scatter_state(full, m)):
        _equal_states(got, ref)

    x = np.random.default_rng(e).standard_normal((8, M)).astype(np.float32)
    ref, _ = jl(jp, jnp.asarray(x))
    one = tmoe.moe_layer(device="cpu", **_kwargs(e))
    loaded = one.load_state_dict(one.init(torch.Generator()), merged,
                                 strict=True)
    with torch.no_grad():
        out = one(loaded, torch.from_numpy(x))[0].numpy()
    tol = 1e-5 * np.max(np.abs(np.asarray(ref)))
    assert np.max(np.abs(out - np.asarray(ref))) <= tol
    if m == 2 and e % 2 == 0:                  # M ranks of E / M experts
        got = pools(2).run(_rank_load_forward, e // 2, again,
                           torch.from_numpy(x))
        assert np.max(np.abs(np.concatenate(got) - np.asarray(ref))) <= tol


def test_clis_match_the_jax_tools(tmp_path):
    jax, _, jck, jmoe = _jax()
    from tutel_tpu.checkpoint import gather as jgather, scatter as jscatter
    jl = jmoe.moe_layer(group=jax.devices()[:1], **_kwargs(4))
    root = {"model": serial.unflatten_state(
        jl.state_dict(jl.init(jax.random.PRNGKey(3)))),
        "step": np.asarray(7)}
    src = str(tmp_path / "all.npz")
    serial.save_state(src, root)
    for pkg, tool_s, tool_g in (("port", tscatter, tgather),
                                ("jax", jscatter, jgather)):
        tool_s.main(["--input", src, "--output_size", "2", "--outputs",
                     str(tmp_path / pkg / "{rank}-of-{size}.npz"),
                     "--namespace", "model"])
        tool_g.main(["--inputs", str(tmp_path / pkg / "{rank}-of-{size}.npz"),
                     "--input_size", "2", "--output",
                     str(tmp_path / pkg / "back.npz"), "--namespace",
                     "model"])
    for name in ("0-of-2.npz", "1-of-2.npz", "back.npz"):
        _equal_states(serial.flatten_state(serial.load_state(
            str(tmp_path / "port" / name))), serial.flatten_state(
            serial.load_state(str(tmp_path / "jax" / name))))
    _equal_states(serial.flatten_state(serial.load_state(
        str(tmp_path / "port" / "back.npz"))), serial.flatten_state(root))
    # the module entry points, as a user runs them
    out = str(tmp_path / "cli" / "{rank}-of-{size}.npz")
    for argv in (["tutel_tpu_torch.checkpoint.scatter", "--input", src,
                  "--output_size", "4", "--outputs", out, "--namespace",
                  "model"],
                 ["tutel_tpu_torch.checkpoint.gather", "--inputs", out,
                  "--input_size", "4", "--output",
                  str(tmp_path / "cli" / "back.npz"), "--namespace",
                  "model"]):
        run = subprocess.run([sys.executable, "-m"] + argv, cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "PYTHONPATH": REPO})
        assert run.returncode == 0, run.stderr
    _equal_states(serial.flatten_state(serial.load_state(
        str(tmp_path / "cli" / "back.npz"))), serial.flatten_state(root))


HELLO = ["--batch_size", "4", "--num_tokens", "32", "--model_dim", "32",
         "--hidden_size", "32", "--device", "cpu", "--top", "2"]


def _jax_start(args, w):
    jax, _, _, jmoe = _jax()
    jl = jmoe.moe_layer(
        gate_type={"type": "top", "k": args.top,
                   "capacity_factor": args.capacity_factor},
        experts={"type": "ffn",
                 "num_experts_per_device": args.num_local_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=jax.devices()[:w])
    params = convert.from_jax_params(jl.init(jax.random.PRNGKey(1)), "cpu")
    x = jax.random.normal(jax.random.PRNGKey(0), (
        args.batch_size, args.num_tokens, args.model_dim))
    return params, convert.to_tensor(np.asarray(x), "cpu")


def test_helloworld_save_and_resume(tmp_path):
    from tutel_tpu.examples import helloworld as jhello
    from tutel_tpu_torch.examples import helloworld
    path = str(tmp_path / "hw.npz")
    argv = HELLO + ["--num_devices", "1", "--checkpoint_path", path]
    params, x = _jax_start(helloworld.build_args(argv), 1)
    lines = []
    helloworld.run(helloworld.build_args(argv + ["--num_steps", "3"]),
                   log=lines.append, params=params, x=x)
    assert lines[-1] == f"Checkpoint saved to {path}."
    saved = serial.flatten_state(checkpoint.load_state(path))
    assert int(saved["_num_global_experts"]) == 2
    evals = []
    for _ in range(2):
        lines = []
        losses, _ = helloworld.run(helloworld.build_args(
            argv + ["--eval", "--num_steps", "2"]), log=lines.append,
            params=params, x=x)
        assert f"Checkpoint loaded from {path}." in lines
        evals.append(losses)
    assert evals[0] == evals[1] and evals[0][0] == evals[0][1]

    # a file the JAX trainer wrote resumes in the port with JAX's loss
    jpath = str(tmp_path / "jax.npz")
    jargv = HELLO + ["--num_devices", "1", "--checkpoint_path", jpath]
    jhello.run(jhello.build_args(jargv + ["--num_steps", "3"]),
               log=lambda *_: None)
    ref, _ = jhello.run(jhello.build_args(jargv + ["--eval", "--num_steps",
                                                   "1"]), log=lambda *_: None)
    got, _ = helloworld.run(helloworld.build_args(
        jargv + ["--eval", "--num_steps", "1"]), log=lambda *_: None,
        params=params, x=x)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _rank_hello_save(argv, params, x):
    from tutel_tpu_torch.examples import helloworld
    return helloworld.run(helloworld.build_args(argv), log=lambda *_: None,
                          params=params, x=x)[0]


def test_helloworld_two_ranks_write_the_jax_file(pools, tmp_path):
    """The ranks' shards gathered into one global file: the one the JAX
    trainer writes at --num_devices 2 (three SGD steps from the same
    start)."""
    from tutel_tpu.examples import helloworld as jhello
    from tutel_tpu_torch.examples import helloworld
    argv = HELLO + ["--num_devices", "2", "--num_steps", "3",
                    "--num_local_experts", "-2"]
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jhello.run(jhello.build_args(argv + ["--checkpoint_path", jpath]),
               log=lambda *_: None)
    params, x = _jax_start(helloworld.build_args(argv), 2)
    pools(2).run(_rank_hello_save, argv + ["--checkpoint_path", tpath],
                 params, x)
    ref = serial.flatten_state(serial.load_state(jpath))
    got = serial.flatten_state(serial.load_state(tpath))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
