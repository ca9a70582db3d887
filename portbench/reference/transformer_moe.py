"""Plain float32 forward of the port's Transformer-MoE language model, as
the configuration states it: pre-LN blocks (LayerNorm, eps 1e-5), learned
positions, grouped-query causal attention (query head h = m * kvh + g
reads KV group g), an MoE FFN in every block, a final LayerNorm and the
LM head tied to the embedding, with what the configuration states of
serving: INT4 expert weights and an INT8 KV cache, each through its
frozen formula (`numerics`), and dropless routing.

`logits` takes the benchmark's weight tree (bfloat16 values) and works
in float32 with TF32 off."""

import torch

from . import moe as moe_ref
from .numerics import Precision, int4_weight, int8_kv


def layer_norm(p, x):
    return torch.nn.functional.layer_norm(
        x, x.shape[-1:], p["scale"].float(), p["bias"].float(), 1e-5)


def attention(blk, x, nh, kvh, kv_int8, prec):
    b, t, d = x.shape
    hd = d // nh
    qkv = prec.mm(x, blk["wqkv"].float())
    q = qkv[..., :d].reshape(b, t, nh // kvh, kvh, hd)
    k = qkv[..., d:d + kvh * hd].reshape(b, t, kvh, hd)
    v = qkv[..., d + kvh * hd:].reshape(b, t, kvh, hd)
    if kv_int8:
        k, v = int8_kv(k), int8_kv(v)
    scores = prec.einsum("bqmgd,bkgd->bmgqk", q, k) * hd ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = prec.einsum("bmgqk,bkgd->bqmgd", probs, v).reshape(b, t, d)
    return prec.mm(out, blk["wo"].float())


def block(blk, x, shape, prec):
    nh, kvh, top_k = shape
    x = x + attention(blk, layer_norm(blk["ln1"], x), nh, kvh, True, prec)
    h = layer_norm(blk["ln2"], x)
    ex = blk["moe"]["experts"]
    w = [int4_weight(ex[k]) for k in ("w1", "w2", "w3")]
    flat = h.reshape(-1, h.shape[-1])
    y, _ = moe_ref.moe(flat, blk["moe"]["gates"][0]["wg"].float(), *w,
                       top_k, prec)
    return x + y.reshape(x.shape)


def hidden(params, tokens, port, prec=Precision()):
    """tokens [B, T] -> final hidden states [B, T, d] after the final
    LayerNorm."""
    t = tokens.shape[1]
    x = params["embed"].float()[tokens] + params["pos"].float()[:t][None]
    shape = (port["num_heads"], port["num_kv_heads"], port["top_k"])
    for blk in params["blocks"]:
        x = block(blk, x, shape, prec)
    return layer_norm(params["final_ln"], x)


def logits(params, tokens, port, prec=Precision()):
    """tokens [T] -> logits [T, V] in float32."""
    with torch.no_grad():
        h = hidden(params, tokens[None], port, prec=prec)
        return prec.mm(h[0], params["embed"].float().t())

