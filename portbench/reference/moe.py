"""Plain float32 MoE layer, dropless: softmax router, top-k renormalised
over the k chosen, GShard load-balance loss, and SwiGLU experts
silu(x W1) * (x W2) W3. Each expert computes every row routed to it."""

import torch

from .numerics import Precision


def route(x, wg, top_k, prec=Precision()):
    """x [S, M] -> (indices [S, k], gates [S, k] renormalised, l_aux)."""
    s = x.shape[0]
    logits = prec.mm(x, wg)
    scores = torch.softmax(logits, dim=1)
    e = scores.shape[1]
    top_v, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_v, top_i = top_v[:, :top_k], top_i[:, :top_k]
    me = scores.sum(dim=0)
    ce = torch.zeros(e, device=x.device).index_add(
        0, top_i[:, 0], torch.full((s,), e / s, device=x.device))
    l_aux = torch.sum(me * ce) / s
    gates = top_v / top_v.sum(dim=1, keepdim=True) if top_k > 1 else top_v
    return top_i, gates, l_aux


def swiglu(x, w1, w2, w3, prec=Precision()):
    return prec.mm(torch.nn.functional.silu(prec.mm(x, w1))
                   * prec.mm(x, w2), w3)


def moe(x, wg, w1, w2, w3, top_k, prec=Precision()):
    """x [S, M] float32, wg [M, E], w1 / w2 [E, M, H], w3 [E, H, M] ->
    (y [S, M], l_aux)."""
    top_i, gates, l_aux = route(x, wg, top_k, prec)
    y = torch.zeros_like(x)
    for e in range(w1.shape[0]):
        sel = top_i == e
        rows, ks = torch.nonzero(sel, as_tuple=True)
        if rows.numel() == 0:
            continue
        out = swiglu(x[rows], w1[e].float(), w2[e].float(), w3[e].float(),
                     prec)
        y = y.index_add(0, rows, out * gates[rows, ks][:, None])
    return y, l_aux

