"""Auxiliary load-balancing losses for MoE gating
(counterpart: tutel_tpu/ops/losses.py:19,43)."""

import math

import torch


def one_hot_with_dtype(indices, num_classes, dtype, hot_value=1.0):
    """One-hot with a configurable hot value."""
    classes = torch.arange(num_classes, device=indices.device)
    oh = (indices[..., None] == classes).to(dtype)   # no device sync
    return oh * hot_value if hot_value != 1.0 else oh


def gshard_loss(scores_w_noise, top_ids):
    """GShard load-balance loss: sum_e(me_e * ce_e) / S, with ce scaled by
    E/S through the one-hot hot value.

    scores_w_noise: [S, E] softmax scores; top_ids: [S, K] top-k expert ids
    (only the top-1 column is used).
    """
    num_samples, num_global_experts = scores_w_noise.shape
    mask = one_hot_with_dtype(
        top_ids[:, 0], num_global_experts, dtype=scores_w_noise.dtype,
        hot_value=num_global_experts / num_samples)
    me = torch.sum(scores_w_noise, dim=0)
    ce = torch.sum(mask, dim=0)
    return torch.sum(me * ce) / num_samples


def _normal_cdf(x, loc, scale):
    return 0.5 * (1.0 + torch.erf((x - loc) / (scale * math.sqrt(2.0))))


def load_importance_loss(scores_wo_noise, topk_logits, num_global_experts,
                         gate_noise):
    """Noisy top-k load + importance loss.

    scores_wo_noise: [S, E] softmax over un-noised logits; topk_logits:
    [S, K] noised logits at the top-k ids; gate_noise must be > 0.
    Variances are unbiased (ddof=1), as in the JAX function.
    """
    if not gate_noise > 0:
        raise ValueError("`gate_noise` must be > 0 for normalization in "
                         "load_importance_loss().")
    impi = torch.sum(scores_wo_noise.float(), dim=0)
    l_imp = torch.var(impi, correction=1) / (torch.mean(impi) ** 2 + 1e-10)

    threshold = topk_logits[:, -1].reshape(-1, 1).float()
    diff = scores_wo_noise.float() - threshold
    prob = _normal_cdf(diff, 0.0, gate_noise / num_global_experts)
    load = torch.sum(prob, dim=0)
    l_load = torch.var(load, correction=1) / (torch.mean(load) ** 2 + 1e-10)
    return (l_imp + l_load) / 2.0
