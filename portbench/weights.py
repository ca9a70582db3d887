"""Seeded weights and inputs, made by the benchmark and handed to both
the program and the reference.

Every tensor is drawn on the device from one `torch.Generator` seeded by
`--seed`, in a few large calls in the type it is served in (bfloat16):
one buffer for the dense weights and one per layer for the experts, each
cut into views. The same seed on the same device gives the same bits, so
the reference regenerates what the program was given instead of reading
anything the program holds.
"""

import torch


def _fill(spec, gen, device, dtype):
    """One randn buffer cut into the leaves of `spec` ([(name, shape,
    std)]): {name: view scaled by std, in place}."""
    total = sum(_numel(shape) for _, shape, _ in spec)
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, std in spec:
        n = _numel(shape)
        out[name] = buf[at:at + n].view(*shape).mul_(std)
        at += n
    return out


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def lm(port, max_len, seed, device, dtype=torch.bfloat16):
    """The weights of a TransformerMoE in the port's tree ("embed", "pos",
    "final_ln", "blocks": [{"ln1", "ln2", "wqkv", "wo", "moe": {"gates":
    [{"wg"}], "experts": {"w1", "w2", "w3"}}}]); every block MoE."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, nh, kvh = port["model_dim"], port["num_heads"], port["num_kv_heads"]
    e, h, v = port["num_local_experts"], port["expert_hidden"], \
        port["vocab_size"]
    n_layers = port["num_layers"]
    qkv = d + 2 * kvh * (d // nh)
    dense = [("embed", (v, d), d ** -0.5), ("pos", (max_len, d), d ** -0.5)]
    for i in range(n_layers):
        dense += [(f"{i}.wqkv", (d, qkv), d ** -0.5),
                  (f"{i}.wo", (d, d), d ** -0.5),
                  (f"{i}.wg", (d, e), d ** -0.5)]
    w = _fill(dense, gen, device, dtype)

    def ln():
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}

    blocks = []
    for i in range(n_layers):
        blocks.append({"ln1": ln(), "ln2": ln(), "wqkv": w[f"{i}.wqkv"],
                       "wo": w[f"{i}.wo"],
                       "moe": {"gates": [{"wg": w[f"{i}.wg"]}],
                               "experts": experts(e, d, h, gen, device,
                                                  dtype)}})
    return {"embed": w["embed"], "pos": w["pos"], "final_ln": ln(),
            "blocks": blocks}


def experts(e, d, h, gen, device, dtype=torch.bfloat16):
    """SwiGLU expert weights w1, w2 [E, d, H] ~ N(0, 1/d), w3 [E, H, d] ~
    N(0, 1/H), from one randn call."""
    w = _fill([("w1", (e, d, h), d ** -0.5), ("w2", (e, d, h), d ** -0.5),
               ("w3", (e, h, d), h ** -0.5)], gen, device, dtype)
    return w


def moe_block(port, seed, device, dtype=torch.bfloat16):
    """The weights of one MoE layer in the port's tree ({"gates": [{"wg"}],
    "experts": {"w1", "w2", "w3"}})."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, e, h = port["model_dim"], port["num_local_experts"], \
        port["expert_hidden"]
    wg = _fill([("wg", (d, e), d ** -0.5)], gen, device, dtype)["wg"]
    return {"gates": [{"wg": wg}], "experts": experts(e, d, h, gen, device,
                                                      dtype)}


def activations(n, shape, seed, device, dtype=torch.bfloat16):
    """A pool of n input batches [n, *shape] ~ N(0, 1), one randn call, on
    a generator of its own (seed + 1)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    return torch.randn((n, *shape), generator=gen, device=device,
                       dtype=dtype)

