"""Convnet + MoE classifier on CIFAR-10 (counterpart:
tutel_tpu/examples/moe_cifar10.py).

A 3-block convnet (3 -> 32 -> 64 -> 128 channels, 3x3 stride-2
convolutions with relu) ahead of an MoE head with the cosine gate
(`--gate_type cosine`, the default, or `top`) and `--expert_type` experts
(output_dim 10), the same loop and dynamic top-k eval as moe_mnist, whose
layout rules it shares: JAX's "SAME" stride-2 padding is (0, 1), the
features are flattened in NHWC order, and the kernels are stored OIHW
(`moe_mnist.from_jax_params` converts the JAX example's HWIO ones).

Dataset: cifar10.npz from --data_dir when it exists, else the JAX
example's deterministic synthetic color-texture images.

Run:  python -m tutel_tpu_torch.examples.moe_cifar10 --epochs 1
          [--device cpu]

`run(args, params=...)` as in moe_mnist; without params they are drawn on
the CPU from seed 1.
"""

import argparse
import os

import numpy as np
import torch

from tutel_tpu_torch import moe
from tutel_tpu_torch.examples.moe_mnist import (conv_same_s2, nhwc_flat,
                                                train)
from tutel_tpu_torch.utils import resolve_device

DIMS = (3, 32, 64, 128)


def load_dataset(data_dir, n_train=4096, n_test=1024):
    path = os.path.join(data_dir or "", "cifar10.npz")
    if data_dir and os.path.exists(path):
        with np.load(path) as z:
            return (z["x_train"].astype(np.float32) / 255.0,
                    z["y_train"].astype(np.int32),
                    z["x_test"].astype(np.float32) / 255.0,
                    z["y_test"].astype(np.int32))
    rng = np.random.RandomState(0)

    def make(n):
        ys = rng.randint(0, 10, size=n).astype(np.int32)
        xs = rng.randn(n, 32, 32, 3).astype(np.float32) * 0.3
        for i, y in enumerate(ys):
            xs[i, :, :, y % 3] += np.sin(
                np.arange(32) * (y + 1) * 0.4)[None, :].astype(np.float32)
        return xs, ys
    return make(n_train) + make(n_test)


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--num_experts", type=int, default=4)
    parser.add_argument("--hidden_size", type=int, default=256)
    parser.add_argument("--top", type=int, default=2)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--data_dir", type=str, default="")
    parser.add_argument("--gate_type", type=str, default="cosine")
    parser.add_argument("--expert_type", type=str, default="ffn")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def build_layer(args, device):
    gate = ({"type": "cosine_top", "k": args.top, "capacity_factor": 1.5}
            if args.gate_type == "cosine" else
            {"type": "top", "k": args.top, "capacity_factor": 1.5})
    return moe.moe_layer(
        gate_type=gate,
        experts={"type": args.expert_type,
                 "num_experts_per_device": args.num_experts,
                 "hidden_size_per_expert": args.hidden_size,
                 "output_dim": 10},
        model_dim=DIMS[-1] * 4 * 4, seeds=(1, 1, 1), group=[0],
        device=device)


def init_params(args, generator):
    convs = [torch.randn((DIMS[i + 1], DIMS[i], 3, 3), generator=generator)
             * (2.0 / (9 * DIMS[i])) ** 0.5 for i in range(len(DIMS) - 1)]
    return {"convs": convs, "moe": build_layer(args, "cpu").init(generator)}


def features(p, imgs):
    x = imgs.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    for w in p["convs"]:
        x = torch.relu(conv_same_s2(x, w))
    return nhwc_flat(x)                                # [B, 1, 4 * 4 * 128]


def run(args, log=print, params=None, x=None):
    device = resolve_device(args.device)
    layer = build_layer(args, device)
    if params is None:
        params = init_params(args, torch.Generator().manual_seed(1))
    return train(args, layer, params, features,
                 load_dataset(args.data_dir), device, log)


if __name__ == "__main__":
    run(build_args())
