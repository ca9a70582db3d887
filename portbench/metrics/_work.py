"""The yardstick's arithmetic: the operations and bytes each layer's work
needs, from the shapes and counts seen at the layer's boundary, and the
card's peaks. Counts are of what the inputs need, not of what a kernel
happens to do: each input byte read once, each output byte written once,
rows that routing left empty and capacity padding not counted. A kernel
that replaces another is measured against the same work."""

BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
HBM = {"H200": 4.8e12, "H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
       "H100": 3.35e12}


def hbm_bytes_per_s(kind):
    for name, bw in HBM.items():
        if all(w in kind for w in name.split()):
            return bw
    raise RuntimeError(f"no memory bandwidth known for {kind!r}")


def bound_s(flops, moved, bandwidth, peak=BF16_PEAK):
    """The least time for `flops` operations and `moved` bytes."""
    return max(flops / peak, moved / bandwidth)


def expert_ffn(rows, m, h, weight_bits, act_bytes=2):
    """A SwiGLU expert layer's forward over `rows` [rows routed to each
    expert]: (FLOPs, bytes). Three products of 2 m h a row; the weights
    of every expert that got a row (INT4 / INT8 with float32 column
    scales, or bf16), the routed rows in and out."""
    n = sum(rows)
    hit = sum(1 for r in rows if r > 0)
    flops = 6.0 * m * h * n
    if weight_bits in (4, 8):
        w = 3.0 * m * h * weight_bits / 8 + 4.0 * (2 * h + m)
    else:
        w = 3.0 * m * h * act_bytes
    return flops, hit * w + 2.0 * n * m * act_bytes


def expert_ffn_train(rows, m, h, act_bytes=2):
    """Forward and backward of the same (bf16 weights): three times the
    forward's FLOPs; the weights read twice and their gradients written,
    and the routed rows in, out and their gradients both ways."""
    flops, _ = expert_ffn(rows, m, h, 16, act_bytes)
    n = sum(rows)
    hit = sum(1 for r in rows if r > 0)
    return 3.0 * flops, 3.0 * hit * 3.0 * m * h * act_bytes \
        + 6.0 * n * m * act_bytes


def kv_bytes(positions, kvh, hd, kv_bits):
    """K and V of `positions` cache rows: values and float32 scales."""
    scale = 2 * 4.0 * kvh if kv_bits in (4, 8) else 0.0
    return positions * (2.0 * kvh * hd * (kv_bits or 16) / 8 + scale)


def decode_attn(lengths, nh, kvh, hd, kv_bits, act_bytes=2):
    """One decode step's attention over rows reading `lengths` positions
    each: (FLOPs, bytes)."""
    total = sum(lengths)
    flops = 4.0 * nh * hd * total
    moved = kv_bytes(total, kvh, hd, kv_bits) \
        + 2.0 * len(lengths) * nh * hd * act_bytes
    return flops, moved


def prefill_attn(b, tc, start, nh, kvh, hd, kv_bits, act_bytes=2):
    """A prompt chunk of tc queries at positions start.. of b rows,
    causal: (FLOPs, bytes)."""
    pairs = b * (tc * start + tc * (tc + 1) // 2)
    flops = 4.0 * nh * hd * pairs
    moved = b * kv_bytes(start + tc, kvh, hd, kv_bits) \
        + 2.0 * b * tc * nh * hd * act_bytes
    return flops, moved


def lm_forward(port, tokens, attn_pairs, head_rows):
    """A TransformerMoE forward's matmul FLOPs: `tokens` through every
    block's projections and router, `attn_pairs` causal (query, key)
    pairs a block, top_k rows a token a block through the experts
    (dropless) and `head_rows` rows through the tied LM head."""
    d, nh, kvh = port["model_dim"], port["num_heads"], port["num_kv_heads"]
    e, h, k = port["num_local_experts"], port["expert_hidden"], \
        port["top_k"]
    layers = port["num_layers"]
    qkv = d + 2 * kvh * (d // nh)
    expert_rows = layers * k * tokens
    per_block = 2.0 * d * (qkv + d) + 2.0 * d * e
    return (layers * (per_block * tokens + 4.0 * d * attn_pairs)
            + 6.0 * d * h * expert_rows
            + 2.0 * d * port["vocab_size"] * head_rows)


def moe_block_forward(port, tokens, expert_rows=None):
    """One MoE layer's forward FLOPs: the router and the experts' rows."""
    d, e, h, k = port["model_dim"], port["num_local_experts"], \
        port["expert_hidden"], port["top_k"]
    if expert_rows is None:
        expert_rows = k * tokens
    return 2.0 * d * e * tokens + 6.0 * d * h * expert_rows
