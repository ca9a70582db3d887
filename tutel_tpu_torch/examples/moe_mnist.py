"""Convnet + MoE classifier on MNIST (counterpart:
tutel_tpu/examples/moe_mnist.py).

The JAX example's model: two 3x3 stride-2 convolutions with relu -> an
MoE layer whose 2-layer FFN experts are the classifier head (output_dim
10) -> log_softmax; nll + 0.01 * l_aux, plain SGD. The eval re-runs the
test set with top_k switched to 1 / 2 / min(E, 8) per call.

Two layouts follow JAX's, so that the same parameters give the same
numbers: JAX's "SAME" padding at stride 2 on an even size pads (0, 1)
(none before, one after), which here is `F.pad(x, (0, 1, 0, 1))` and a
convolution with padding 0 (padding=1 gives the same sizes and other
values); and the MoE layer's model_dim is the NHWC flatten [B, 7, 7, C],
so the NCHW features are permuted before the reshape. Conv kernels are
stored OIHW; `from_jax_params` converts the JAX example's HWIO ones.

Dataset: mnist.npz from --data_dir when it exists, else the JAX example's
deterministic synthetic digit-like images (the same numpy draws).

Run:  python -m tutel_tpu_torch.examples.moe_mnist --epochs 1
          [--device cpu]

`run(args, params=...)` takes the parameters from elsewhere (the tests pass
the JAX example's through `from_jax_params`); without them they are drawn
on the CPU from seed 1. Returns (the eval accuracy per top_k, the logged
losses {(epoch, step): loss}, seconds a training step, the trained
parameters).
"""

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from tutel_tpu_torch import convert, moe, system
from tutel_tpu_torch.utils import resolve_device, sgd_step, tree_leaves, \
    tree_replace


def load_dataset(data_dir, n_train=4096, n_test=1024):
    path = os.path.join(data_dir or "", "mnist.npz")
    if data_dir and os.path.exists(path):
        with np.load(path) as z:
            return (z["x_train"].astype(np.float32) / 255.0,
                    z["y_train"].astype(np.int32),
                    z["x_test"].astype(np.float32) / 255.0,
                    z["y_test"].astype(np.int32))
    # synthetic: 10 classes of noisy oriented-bar images
    rng = np.random.RandomState(0)

    def make(n):
        ys = rng.randint(0, 10, size=n).astype(np.int32)
        xs = rng.randn(n, 28, 28).astype(np.float32) * 0.3
        for i, y in enumerate(ys):
            xs[i, 2 + y * 2:5 + y * 2, 4:24] += 2.0    # class-coded bar
            xs[i, 4:24, 2 + y * 2:5 + y * 2] += 1.0
        return xs, ys
    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return xtr, ytr, xte, yte


def conv_same_s2(x, w):
    """JAX's conv_general_dilated(x, w, (2, 2), "SAME") on NCHW x of even
    height and width and an OIHW 3x3 kernel: pad (0, 1) on each axis."""
    return F.conv2d(F.pad(x, (0, 1, 0, 1)), w, stride=2)


def nhwc_flat(x):
    """NCHW features -> [B, 1, H * W * C] in JAX's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], 1, -1)


def from_jax_params(tree, device="cpu"):
    """The port's tree of a convnet example's JAX parameters: conv kernels
    HWIO -> OIHW, the MoE layer's leaves as they are."""
    out = convert.from_jax_params(tree, device)
    for name in ("conv1", "conv2"):
        if name in out:
            out[name] = convert.hwio_to_oihw(out[name])
    if "convs" in out:
        out["convs"] = [convert.hwio_to_oihw(w) for w in out["convs"]]
    return out


def train(args, layer, params, features, data, device, log):
    """The JAX examples' loop: SGD over the training set in batches of
    batch_size (losses logged every 20 steps), then the dynamic top-k
    eval; returns (accuracies, logged losses, seconds a step, the trained
    parameters)."""
    xtr, ytr, xte, yte = data
    params = tree_replace(params, [p.to(device) for p in
                                   tree_leaves(params)])

    def loss_fn(p, imgs, labels, top_k, training=True):
        out, l_aux = layer(p["moe"], features(p, imgs), top_k=top_k,
                           training=training)
        logits = torch.log_softmax(out[:, 0, :], dim=1)
        nll = -torch.mean(logits[torch.arange(labels.shape[0]), labels])
        return nll + 0.01 * l_aux, logits

    def batch(xs, ys, i):
        return (torch.from_numpy(xs[i:i + bs]).to(device),
                torch.from_numpy(ys[i:i + bs]).long().to(device))

    bs = args.batch_size
    losses, accs, step_times = {}, {}, []
    for epoch in range(args.epochs):
        for i in range(0, len(xtr) - bs + 1, bs):
            imgs, labels = batch(xtr, ytr, i)
            t0 = system.record_time()
            params, loss, _ = sgd_step(
                lambda p: loss_fn(p, imgs, labels, args.top)[0], params,
                args.lr)
            step_times.append(system.record_time(loss) - t0)
            if (i // bs) % 20 == 0:
                losses[(epoch, i // bs)] = float(loss)
                log(f"epoch {epoch} step {i // bs}: loss = "
                    f"{float(loss):.4f}")
        accs = {}
        with torch.no_grad():
            for k in sorted({1, 2, min(layer.num_global_experts, 8)}):
                correct = 0
                for i in range(0, len(xte) - bs + 1, bs):
                    imgs, labels = batch(xte, yte, i)
                    _, logits = loss_fn(params, imgs, labels, k, False)
                    correct += int(torch.sum(
                        torch.argmax(logits, dim=1) == labels))
                accs[k] = correct / (len(xte) // bs * bs)
                log(f"epoch {epoch}: eval top_k={k} accuracy = "
                    f"{accs[k]:.4f}")
    warm = step_times[1:] or step_times
    return accs, losses, sum(warm) / max(len(warm), 1), params


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--num_experts", type=int, default=4)
    parser.add_argument("--hidden_size", type=int, default=128)
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--data_dir", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


CONV_DIM = 32


def build_layer(args, device):
    return moe.moe_layer(
        gate_type={"type": "top", "k": args.top, "capacity_factor": 1.5},
        experts={"type": "ffn", "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden_size,
                 "output_dim": 10, "activation_fn": torch.relu},
        model_dim=CONV_DIM * 7 * 7, seeds=(1, 1, 1), group=[0],
        device=device)


def init_params(args, generator):
    return {"conv1": torch.randn((16, 1, 3, 3), generator=generator) * 0.1,
            "conv2": torch.randn((CONV_DIM, 16, 3, 3),
                                 generator=generator) * 0.1,
            "moe": build_layer(args, "cpu").init(generator)}


def features(p, imgs):
    x = imgs[:, None]                                  # [B, 1, 28, 28]
    x = torch.relu(conv_same_s2(x, p["conv1"]))
    x = torch.relu(conv_same_s2(x, p["conv2"]))        # [B, C, 7, 7]
    return nhwc_flat(x)                                # [B, 1, M]


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    layer = build_layer(args, device)
    if params is None:
        params = init_params(args, torch.Generator().manual_seed(1))
    return train(args, layer, params, features,
                 load_dataset(args.data_dir), device, log)


if __name__ == "__main__":
    run(build_args())
