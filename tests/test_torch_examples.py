"""Port parity: the single-device examples of slice 6c (helloworld_from_scratch,
helloworld_custom_gate_expert, helloworld_switch, helloworld_amp, moe_mnist,
moe_cifar10, serving_decode) on the CPU against the JAX examples, from the
JAX examples' own parameters and inputs through `convert`; the convnets'
"SAME" padding trap; and `MOELayer(scan_expert_func=, result_func=)` and
SKIP_MOE against the JAX layer.

The JAX examples' per-step losses are read from their jitted steps (they
log them rounded): `_JitRecorder` wraps `jax.jit` for the functions named,
on one device (`jax.devices` is narrowed for the run).

Tolerances: from_scratch and custom_gate_expert every step's loss within
1e-5 relative; the convnets' logged losses (steps 0 and 20) within 1e-4
relative, and the eval accuracy at each top_k of the port's trained
parameters within 2 of 1,024 test images of the JAX layer's on the same
parameters (a routing flip near a tie moves one image); switch's outputs and l_aux within 1e-5;
amp's bfloat16 losses within 2e-3 relative (bfloat16 rounds the
activations at other points in the two frameworks), and the loss falls;
serving_decode's MoE final states within 1e-5.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu import moe as jmoe
from tutel_tpu_torch import convert
from tutel_tpu_torch import moe as tmoe

torch.set_num_threads(1)


def _one_device(monkeypatch):
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])


class _JitRecorder:
    """Wraps `jax.jit` for functions of the given names: the output of
    every call made outside a trace is kept in `calls[name]`."""

    def __init__(self, monkeypatch, names):
        self.calls = {n: [] for n in names}
        real = jax.jit

        def jit(fun=None, **kw):
            if fun is None:
                return lambda f: jit(f, **kw)
            jf = real(fun, **kw)
            name = getattr(fun, "__name__", "")
            if name not in self.calls:
                return jf

            def wrapped(*a, **k):
                out = jf(*a, **k)
                if not any(isinstance(t, jax.core.Tracer)
                           for t in jax.tree.leaves(out)):
                    self.calls[name].append(out)      # not under a trace
                return out
            return wrapped
        monkeypatch.setattr(jax, "jit", jit)


def _params(tree):
    return convert.from_jax_params(tree, "cpu")


def _t(x):
    return convert.to_tensor(np.asarray(x), "cpu")


def _quiet(*_, **__):
    pass


# ---------------------------------------------------------------------------
# helloworld_from_scratch, helloworld_custom_gate_expert
# ---------------------------------------------------------------------------

def test_from_scratch_matches_jax(monkeypatch):
    from tutel_tpu.examples import helloworld_from_scratch as jex
    from tutel_tpu_torch.examples import helloworld_from_scratch as tex
    argv = ["--num_tokens", "64", "--model_dim", "64", "--hidden_size", "64",
            "--num_steps", "4"]
    args = tex.build_args(argv + ["--device", "cpu"])
    rec = _JitRecorder(monkeypatch, ["train_step"])
    jex.run(argparse.Namespace(**{**vars(args), "device": "cpu"}),
            log=_quiet)
    ref = [float(out[1]) for out in rec.calls["train_step"]]
    kg, k1, k2, kx = jax.random.split(jax.random.PRNGKey(0), 4)
    e, m, h = args.num_experts, args.model_dim, args.hidden_size
    params = {"wg": jax.random.normal(kg, (m, e)) * m ** -0.5,
              "fc1": jax.random.normal(k1, (e, m, h)) * m ** -0.5,
              "fc2": jax.random.normal(k2, (e, h, m)) * h ** -0.5}
    x = jax.random.normal(kx, (args.num_tokens, m))
    got = tex.run(args, log=_quiet, params=_params(params), x=_t(x))
    assert len(ref) == len(got) == 4
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_custom_gate_expert_matches_jax(monkeypatch):
    from tutel_tpu.examples import helloworld_custom_gate_expert as jex
    from tutel_tpu_torch.examples import helloworld_custom_gate_expert as tex
    argv = ["--num_tokens", "64", "--model_dim", "64", "--hidden_size", "64",
            "--num_steps", "3"]
    args = tex.build_args(argv + ["--device", "cpu"])
    rec = _JitRecorder(monkeypatch, ["loss_fn"])
    jex.run(args, log=_quiet)
    ref = [float(o) for o in rec.calls["loss_fn"] if np.ndim(o) == 0]
    gate_cls, expert_cls = jex.build_modules()
    layer = jmoe.moe_layer(
        gate_type={"type": "custom", "module": gate_cls, "k": args.top},
        experts={"type": "custom", "module": expert_cls,
                 "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=jax.devices()[:1])
    params = layer.init(jax.random.PRNGKey(1))
    x = jax.random.normal(jax.random.PRNGKey(0),
                          (args.num_tokens, args.model_dim))
    got = tex.run(args, log=_quiet, params=_params(params), x=_t(x))
    assert len(ref) == len(got) == 3
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_custom_modules_init_draws_shapes():
    """The torch custom gate and expert draw their own parameters in the
    JAX modules' shapes and types (the protocol's `init(generator, dtype,
    device)`)."""
    from tutel_tpu.examples import helloworld_custom_gate_expert as jex
    from tutel_tpu_torch.examples import helloworld_custom_gate_expert as tex
    args = tex.build_args(["--device", "cpu"])
    got = tex.build_layer(args, "cpu").init(torch.Generator().manual_seed(3))
    gate_cls, expert_cls = jex.build_modules()
    want = jmoe.moe_layer(
        gate_type={"type": "custom", "module": gate_cls, "k": args.top},
        experts={"type": "custom", "module": expert_cls,
                 "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1),
        group=jax.devices()[:1]).init(jax.random.PRNGKey(3))
    assert got["gates"][0]["proto"].shape == want["gates"][0]["proto"].shape
    for k, v in want["experts"].items():
        assert tuple(got["experts"][k].shape) == v.shape, k
        assert got["experts"][k].dtype == torch.float32


# ---------------------------------------------------------------------------
# helloworld_switch
# ---------------------------------------------------------------------------

def test_switch_matches_jax_layer(monkeypatch):
    """Each config's output and l_aux of the port's example against the
    JAX layer called at that config."""
    from tutel_tpu_torch.examples import helloworld_switch as tex
    args = tex.build_args(["--batch_size", "2", "--num_tokens", "64",
                           "--model_dim", "64", "--hidden_size", "64",
                           "--steps", "10", "--device", "cpu"])
    layer = jmoe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1),
        parallel_type="adaptive:1", group=jax.devices()[:1])
    params = layer.init(jax.random.PRNGKey(1))
    x = jax.random.normal(jax.random.PRNGKey(0),
                          (args.batch_size, args.num_tokens, args.model_dim))
    timings, outputs = tex.run(args, log=_quiet, params=_params(params),
                               x=_t(x))
    assert len(timings) == len(outputs) == 5
    assert all(len(ts) == 2 for ts in timings.values())
    for cfg in tex.CONFIGS:
        out, l_aux = layer(params, x, key=jax.random.PRNGKey(3), **cfg)
        got_out, got_aux = outputs[str(sorted(cfg.items()))]
        np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                                   rtol=1e-5, atol=1e-5, err_msg=str(cfg))
        np.testing.assert_allclose(got_aux, float(l_aux), rtol=1e-5)


# ---------------------------------------------------------------------------
# helloworld_amp
# ---------------------------------------------------------------------------

def test_amp_matches_jax(monkeypatch):
    from tutel_tpu.examples import helloworld_amp as jex
    from tutel_tpu_torch.examples import helloworld_amp as tex
    _one_device(monkeypatch)
    argv = ["--device", "cpu", "--num_steps", "6"]
    jargs = jex.build_args(argv)
    ref = jex.run(jargs, log=_quiet)
    layer = jmoe.moe_layer(
        gate_type={"type": "top", "k": jargs.top, "capacity_factor": 1.0},
        experts={"type": "ffn",
                 "num_experts_per_device": jargs.num_local_experts,
                 "hidden_size_per_expert": jargs.hidden_size},
        model_dim=jargs.model_dim, seeds=(1, 1, 1), dtype=jnp.float32,
        group=jax.devices()[:1])
    params = layer.init(jax.random.PRNGKey(1))
    x = jax.random.normal(jax.random.PRNGKey(0),
                          (jargs.batch_size * jargs.num_tokens,
                           jargs.model_dim), dtype=jnp.bfloat16)
    got = tex.run(tex.build_args(argv), log=_quiet, params=_params(params),
                  x=_t(x.astype(jnp.float32)))
    assert len(got) == 6 and got[-1] < got[0]
    np.testing.assert_allclose(got, ref, rtol=2e-3)


# ---------------------------------------------------------------------------
# moe_mnist, moe_cifar10
# ---------------------------------------------------------------------------

def test_same_padding_trap():
    """JAX's "SAME" at stride 2 on an even size pads (0, 1): the port's
    `conv_same_s2` matches it on OIHW kernels, and torch's padding=1 (the
    same output size) does not."""
    from tutel_tpu_torch.examples.moe_mnist import conv_same_s2
    rng = np.random.default_rng(0)
    for size in (28, 14, 32, 16, 8):
        x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
        w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
        want = np.asarray(jax.lax.conv_general_dilated(
            x, w, (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        wt = convert.hwio_to_oihw(torch.from_numpy(w))
        got = conv_same_s2(xt, wt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        wrong = torch.nn.functional.conv2d(xt, wt, stride=2, padding=1)
        assert wrong.shape == conv_same_s2(xt, wt).shape
        assert not np.allclose(wrong.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-3)


def _jax_convnet_layer(name, args):
    if name == "moe_mnist":
        return jmoe.moe_layer(
            gate_type={"type": "top", "k": args.top, "capacity_factor": 1.5},
            experts={"type": "ffn", "num_experts_per_device":
                     args.num_experts,
                     "hidden_size_per_expert": args.hidden_size,
                     "output_dim": 10, "activation_fn": jax.nn.relu},
            model_dim=32 * 7 * 7, seeds=(1, 1, 1), group=jax.devices()[:1])
    gate = ({"type": "cosine_top", "k": args.top, "capacity_factor": 1.5}
            if args.gate_type == "cosine" else
            {"type": "top", "k": args.top, "capacity_factor": 1.5})
    return jmoe.moe_layer(
        gate_type=gate,
        experts={"type": args.expert_type,
                 "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden_size,
                 "output_dim": 10},
        model_dim=128 * 4 * 4, seeds=(1, 1, 1), group=jax.devices()[:1])


def _jax_convnet_params(name, args):
    """The JAX example's `init_params(PRNGKey(1))`, rebuilt as it builds
    them."""
    k = jax.random.PRNGKey(1)
    layer = _jax_convnet_layer(name, args)
    if name == "moe_mnist":
        k1, k2, k3 = jax.random.split(k, 3)
        return {"conv1": jax.random.normal(k1, (3, 3, 1, 16)) * 0.1,
                "conv2": jax.random.normal(k2, (3, 3, 16, 32)) * 0.1,
                "moe": layer.init(k3)}
    dims = (3, 32, 64, 128)
    ks = jax.random.split(k, len(dims))
    convs = [jax.random.normal(ks[i], (3, 3, dims[i], dims[i + 1]))
             * (2.0 / (9 * dims[i])) ** 0.5 for i in range(len(dims) - 1)]
    return {"convs": convs, "moe": layer.init(ks[-1])}


def _jax_features(name, p, imgs):
    """The JAX examples' `features` (NHWC, HWIO kernels)."""
    convs = [p["conv1"], p["conv2"]] if name == "moe_mnist" else p["convs"]
    x = imgs[..., None] if name == "moe_mnist" else imgs
    for w in convs:
        x = jax.nn.relu(jax.lax.conv_general_dilated(
            x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                     "NHWC")))
    return x.reshape(x.shape[0], 1, -1)


def _jax_accuracies(name, args, layer, params, data):
    """The JAX examples' dynamic top-k eval of `params` (a port tree) with
    the JAX layer and features."""
    p = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params)
    if name == "moe_mnist":
        p["conv1"], p["conv2"] = (jnp.transpose(p[k], (2, 3, 1, 0))
                                  for k in ("conv1", "conv2"))
    else:
        p["convs"] = [jnp.transpose(w, (2, 3, 1, 0)) for w in p["convs"]]
    _, _, xte, yte = data
    bs, accs = args.batch_size, {}
    for k in sorted({1, 2, min(layer.num_global_experts, 8)}):
        correct = 0
        for i in range(0, len(xte) - bs + 1, bs):
            out, _ = layer(p["moe"], _jax_features(name, p, xte[i:i + bs]),
                           top_k=k, training=False)
            correct += int(jnp.sum(jnp.argmax(out[:, 0, :], axis=1)
                                   == yte[i:i + bs]))
        accs[k] = correct / (len(xte) // bs * bs)
    return accs


@pytest.mark.parametrize("name", ["moe_mnist", "moe_cifar10"])
def test_convnet_matches_jax(monkeypatch, name):
    """The logged losses against the JAX example's (its jitted step's), and
    the port's dynamic top-k eval of its trained parameters against the
    JAX layer's eval of the same parameters. (The two trainings are
    compared at the logged steps only: over a whole epoch a near-tie in the
    gate can part them, as a step-25 tie of 2e-5 between the second and
    third gate scores does in moe_mnist's batch 25.)"""
    import importlib
    jex = importlib.import_module(f"tutel_tpu.examples.{name}")
    tex = importlib.import_module(f"tutel_tpu_torch.examples.{name}")
    from tutel_tpu_torch.examples.moe_mnist import from_jax_params
    args = tex.build_args(["--epochs", "1", "--device", "cpu"])
    rec = _JitRecorder(monkeypatch, ["train_step"])
    jex.run(args, log=_quiet)
    ref = [float(out[1]) for out in rec.calls["train_step"]]
    data = tex.load_dataset("")
    for a, b in zip(data, jex.load_dataset("")):
        np.testing.assert_array_equal(a, b)
    jparams = _jax_convnet_params(name, args)
    accs, losses, _, trained = tex.run(args, log=_quiet,
                                       params=from_jax_params(jparams))
    assert sorted(losses) == [(0, 0), (0, 20)]
    for (_, step), loss in losses.items():
        np.testing.assert_allclose(loss, ref[step], rtol=1e-4)
    layer = _jax_convnet_layer(name, args)
    want = _jax_accuracies(name, args, layer, trained, data)
    assert sorted(accs) == sorted(want)
    for k, acc in accs.items():
        assert abs(acc - want[k]) * 1024 <= 2 + 1e-9, (k, acc, want[k])


# ---------------------------------------------------------------------------
# serving_decode
# ---------------------------------------------------------------------------

def _jax_lm_config(jargs):
    """The JAX example's LM configuration."""
    from tutel_tpu.models import TransformerMoEConfig as JConfig
    return JConfig(vocab_size=211, max_len=96, model_dim=64, num_heads=4,
                   num_layers=2, ffn_hidden=128, moe_every=2,
                   num_local_experts=jargs.experts // 2, top_k=2,
                   expert_hidden=128, capacity_factor=0.0)


def test_serving_decode_matches_jax():
    """The MoE engine's final states against JAX's engine over the same
    layer parameters and states; both engines of both examples finish
    every request (the LM's sampled tokens come from different
    generators)."""
    from tutel_tpu.examples import serving_decode as jex
    from tutel_tpu.models import TransformerMoE as JModel
    from tutel_tpu.serving import MoeDecodeEngine as JEngine
    from tutel_tpu.serving import Request as JRequest
    from tutel_tpu_torch.examples import serving_decode as tex
    argv = ["--experts", "8", "--model_dim", "64", "--batch", "16",
            "--requests", "20", "--chunk", "4", "--device", "cpu"]
    jargs = jex.build_args(argv)
    moe_stats, lm_stats = jex.run(jargs, log=_quiet)
    assert moe_stats["finished"] == 20 and lm_stats["finished"] == 12

    layer = jmoe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        experts={"type": "ffn", "num_experts_per_device": jargs.experts,
                 "hidden_size_per_expert": 2 * jargs.model_dim},
        model_dim=jargs.model_dim, seeds=(1, 1, 1), group=jax.devices()[:1])
    params = layer.init(jax.random.PRNGKey(0))
    states = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(1), i), (jargs.model_dim,)))
        for i in range(jargs.requests)])
    eng = JEngine(layer, params, max_batch=jargs.batch,
                  speculative_capacity=jargs.spec,
                  state_update="residual_norm")
    want = eng.run([JRequest(uid=i, state=states[i], remaining=12 + i % 5)
                    for i in range(jargs.requests)], chunk=jargs.chunk)

    cfg = tex.lm_config(tex.build_args(argv))
    jm = JModel(_jax_lm_config(jargs), group=jax.devices()[:1])
    lm_params = jm.init(jax.random.PRNGKey(2))
    t_moe, t_lm, finals, timing = tex.run(
        tex.build_args(argv), log=_quiet,
        params={"moe": _params(params), "lm": _params(lm_params)},
        x=torch.from_numpy(states))
    assert cfg.num_heads == 4 and cfg.model_dim // cfg.num_heads == 16
    assert t_moe["finished"] == 20 and t_lm["finished"] == 12
    assert t_lm["tokens"] == lm_stats["tokens"]
    assert timing["tokens_per_s"] > 0
    assert sorted(finals) == sorted(want)
    for uid, v in want.items():
        np.testing.assert_allclose(finals[uid].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=str(uid))


# ---------------------------------------------------------------------------
# MOELayer(scan_expert_func=, result_func=) and SKIP_MOE
# ---------------------------------------------------------------------------

GATES = {
    "top2": {"type": "top", "k": 2, "capacity_factor": 1.0},
    "dropless": {"type": "top", "k": 2, "capacity_factor": 0.0},
    "expert_choice": {"type": "expert_choice", "capacity_factor": 2.0},
}


def _layers(gate, **kw):
    common = dict(gate_type=GATES[gate],
                  experts={"type": "ffn", "num_experts_per_device": 4,
                           "hidden_size_per_expert": 32},
                  model_dim=32, seeds=(1, 1, 1))
    jl = jmoe.moe_layer(group=jax.devices()[:1], **common, **kw)
    tl = tmoe.moe_layer(group=[0], device="cpu", **common, **kw)
    return jl, tl


def test_scan_expert_func_sees_the_expert_parameters():
    seen = {"jax": [], "torch": []}
    jl, _ = _layers("top2", scan_expert_func=lambda n, p: seen["jax"].append(
        (n, tuple(p.shape))))
    _, tl = _layers("top2", scan_expert_func=lambda n, p: seen[
        "torch"].append((n, tuple(p.shape))))
    jl.init(jax.random.PRNGKey(0))
    tl.init(torch.Generator().manual_seed(0))
    assert sorted(seen["torch"]) == sorted(seen["jax"])
    assert [n for n, _ in sorted(seen["torch"])] == \
        ["fc1_b", "fc1_w", "fc2_b", "fc2_w"]


@pytest.mark.parametrize("gate", sorted(GATES))
def test_result_func_matches_jax(gate):
    jl, tl = _layers(gate, result_func=lambda y: 2 * y + 1)
    params = jl.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 32))
    out, l_aux = jl(params, x)
    got, got_aux = tl(_params(params), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(l_aux), rtol=1e-5,
                               atol=1e-7)
    plain_j, plain_t = _layers(gate)
    np.testing.assert_allclose(
        got.numpy(), 2 * plain_t(_params(params), _t(x))[0].numpy() + 1,
        rtol=1e-6, atol=1e-6)
    assert plain_j.result_func is None


@pytest.mark.parametrize("with_result", [False, True])
def test_skip_moe_matches_jax(monkeypatch, with_result):
    monkeypatch.setenv("SKIP_MOE", "1")
    kw = {"result_func": lambda y: 2 * y + 1} if with_result else {}
    jl, tl = _layers("top2", **kw)
    params = jl.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 4, 32))
    out, l_aux = jl(params, x)
    got, got_aux = tl(_params(params), _t(x))
    assert got.shape == (8, 4, 32) and float(got_aux) == float(l_aux) == 0.0
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    monkeypatch.setenv("SKIP_MOE", "0")
    _, tl_on = _layers("top2", **kw)
    assert not np.array_equal(tl_on(_params(params), _t(x))[0].numpy(),
                              np.asarray(out))
