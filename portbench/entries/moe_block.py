"""One MoE layer through `tutel_tpu_torch.moe.moe_layer`, the entry a
tutel user puts into a model, trained as the port's helloworld example
trains it: loss = nll(log_softmax(sum(y, -1)) over the token axis, at
token 0), `utils.sgd_step`."""

import torch

from tutel_tpu_torch import moe
from tutel_tpu_torch.utils import sgd_step

from portbench import weights


def layer(config, capacity_factor, device):
    port = config["port"]
    return moe.moe_layer(
        gate_type={"type": port["gate_type"], "k": port["top_k"],
                   "capacity_factor": capacity_factor},
        experts={"type": port["expert_type"],
                 "num_experts_per_device": port["num_local_experts"],
                 "hidden_size_per_expert": port["expert_hidden"]},
        model_dim=port["model_dim"], dtype=torch.bfloat16, device=device)


def helloworld_loss(out):
    """The helloworld objective of a layer output [B, T, M]."""
    logits = torch.log_softmax(torch.sum(out.float(), dim=2), dim=1)
    return -torch.mean(logits[:, 0])


class Trainer:
    def __init__(self, config, params, seed, device):
        self.layer = layer(config, params["capacity_factor"], device)
        self.params = train_weights(config, params, seed, device)
        self.lr = params["lr"]
        self.key = torch.Generator(device=device).manual_seed(1)

    def loss(self, params, batch):
        out, _ = self.layer(params, batch, key=self.key, training=True)
        return helloworld_loss(out)

    def step(self, batch):
        self.params, loss, grads = sgd_step(
            lambda p: self.loss(p, batch), self.params, self.lr)
        return loss, grads


def train_weights(config, params, seed, device):
    return weights.moe_block(config["port"], seed, device)


def train_pool(config, params, seed, device):
    return weights.activations(params["batches_in_pool"],
                               (params["batch"], params["seq"],
                                config["port"]["model_dim"]), seed, device)


def tokens_per_step(params):
    return params["batch"] * params["seq"]
