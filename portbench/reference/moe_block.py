"""Plain float32 reference of the MoE block cell: one MoE layer
(`moe.moe`, dropless) and the helloworld objective."""

import torch

from . import moe as moe_ref
from .numerics import Precision


def loss(params, x, port, prec=Precision()):
    """x [B, T, M] -> nll(log_softmax(sum(y, -1)) over T, at token 0)."""
    b, t, m = x.shape
    flat = x.float().reshape(-1, m)
    ex = params["experts"]
    y, _ = moe_ref.moe(flat, params["gates"][0]["wg"].float(),
                       ex["w1"], ex["w2"], ex["w3"], port["top_k"], prec)
    lg = torch.log_softmax(y.reshape(b, t, m).sum(dim=2), dim=1)
    return -torch.mean(lg[:, 0])
