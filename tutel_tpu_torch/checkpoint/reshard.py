"""World-size mutation of MoE checkpoints (pure functions; counterpart:
tutel_tpu/checkpoint/reshard.py).

The reference's offline elastic checkpointing
(reference tutel/checkpoint/gather.py:34-76, scatter.py:29-52):

  * MoE entries are found by the `._num_global_experts` marker key; the
    expert param prefix is `<entry>.experts.`.
  * gather: N per-rank states -> 1 all-in-one state (expert params concat
    on the expert dim; sharded-expert slices re-joined on their shard dim).
  * scatter: 1 all-in-one state -> M per-rank states. Expert dim re-chunked
    when E % M == 0; when M > E each expert is sliced M/E-ways along its
    shard dim (expert-slicing model parallelism's parameter layout,
    reference scatter.py:40-47).

Difference from the reference, by design: the reference slices "the first
non-squeezable dim", which happens to be the hidden dim in its [E, H, M]
layout. The layout here is input-major ([E, M, H] fc1), so the shard dim
is carried explicitly per param name (`SHARD_DIMS`, matching
impls/moe_layer.py's `SHARD_AXES`), with the first-non-squeezable rule as
the fallback for unknown names.
"""

import numpy as np

MARKER = "._num_global_experts"

# leaf param name -> dim sliced across the ranks sharing one expert
# (must agree with impls/moe_layer.py SHARD_AXES)
SHARD_DIMS = {
    "fc1_w": 2, "fc1_b": 1, "fc2_w": 1, "fc2_b": 1,
    "w1": 2, "w2": 2, "w3": 1,
}


def _leaf_name(key, prefix):
    return key[len(prefix):]


def _shard_dim(leaf, shape):
    if leaf in SHARD_DIMS:
        return SHARD_DIMS[leaf]
    for j in range(1, len(shape)):
        if shape[j] > 1:
            return j
    return None


def find_expert_prefixes(state, default_num_global_experts=0):
    """{'<entry>.experts.': num_global_experts} from marker keys
    (reference gather.py:32-44)."""
    mutate = {}
    for k in state:
        if k == MARKER.lstrip(".") or k.endswith(MARKER):
            # '<entry>._num_global_experts' or a bare top-level marker
            entry = k[: -len(MARKER.lstrip("."))]
            mutate[entry + "experts."] = int(np.asarray(state[k]))
    missing = []
    if not mutate:
        if default_num_global_experts <= 0:
            raise ValueError(
                "Failed to detect a MoE layer in the checkpoint; the "
                "checkpoint may be in legacy format with field "
                "`_num_global_experts` missing. Provide "
                "--default_num_global_experts.")
        for k in state:
            if ".experts." in k:
                entry = k[: k.rindex(".experts.") + 1]
            elif k.startswith("experts."):
                entry = ""
            else:
                continue
            mutate[entry + "experts."] = default_num_global_experts
            missing.append(entry)
    return mutate, missing


def gather_states(states, default_num_global_experts=0):
    """N per-rank flat states -> one all-in-one flat state."""
    size = len(states)
    out = dict(states[0])
    mutate, missing = find_expert_prefixes(
        states[0], default_num_global_experts)
    for entry in missing:
        out[entry + MARKER.lstrip(".") if entry else MARKER.lstrip(".")] = \
            np.asarray(default_num_global_experts)
    for k in states[0]:
        prefix = next((e for e in mutate if k.startswith(e)), None)
        if prefix is None or k.endswith(MARKER):
            continue
        e_global = mutate[prefix]
        pieces = [np.asarray(s[k]) for s in states]
        if e_global % size == 0:
            cat = np.concatenate(pieces, axis=0)
            if cat.shape[0] != e_global:
                raise ValueError(
                    f"Unexpected group size of expert: {cat.shape[0]} vs "
                    f"{e_global}. Maybe the input size is wrong.")
        elif size % e_global == 0:
            # size/E consecutive ranks share each expert; re-join their
            # slices along the shard dim, then stack experts on dim 0.
            div = size // e_global
            dim = _shard_dim(_leaf_name(k, prefix), pieces[0].shape)
            experts = []
            for e in range(e_global):
                group = pieces[e * div:(e + 1) * div]
                if dim is None:
                    experts.append(group[0])
                else:
                    experts.append(np.concatenate(group, axis=dim))
            cat = np.concatenate(experts, axis=0)
        else:
            raise ValueError(
                f'Neither "global_experts({e_global}) / size({size})" nor '
                f'"size({size}) / global_experts({e_global})" divides '
                "evenly.")
        out[k] = cat
    return out


def scatter_state(state, size, default_num_global_experts=0):
    """One all-in-one flat state -> list of `size` per-rank flat states."""
    mutate, missing = find_expert_prefixes(state, default_num_global_experts)
    state = dict(state)
    for entry in missing:
        state[entry + MARKER.lstrip(".") if entry else MARKER.lstrip(".")] = \
            np.asarray(default_num_global_experts)
    expert_split = {}
    for k in state:
        prefix = next((e for e in mutate if k.startswith(e)), None)
        if prefix is None or k.endswith(MARKER):
            continue
        p = np.asarray(state[k])
        shape = p.shape
        if shape[0] % size == 0:
            p = p.reshape((size, shape[0] // size) + shape[1:])
        elif size % shape[0] == 0:
            divisor = size // shape[0]
            dim = _shard_dim(_leaf_name(k, prefix), shape)
            if dim is None:
                raise ValueError(
                    f"No sliceable dimension in parameter of shape {shape}.")
            if shape[dim] % divisor:
                raise ValueError(
                    f"Shard dim {dim} of shape {shape} must slice into "
                    f"{divisor} pieces evenly.")
            # [E, .., d, ..] -> [E, div, .., d/div, ..] -> [size, 1?, ...]
            p = p.reshape(shape[:dim] + (divisor, shape[dim] // divisor)
                          + shape[dim + 1:])
            p = np.moveaxis(p, dim, 1)
            p = p.reshape((size, 1) + shape[1:dim]
                          + (shape[dim] // divisor,) + shape[dim + 1:])
        else:
            raise ValueError(
                f'Neither "global_experts({shape[0]}) / size({size})" nor '
                f'"size({size}) / global_experts({shape[0]})" divides '
                "evenly.")
        expert_split[k] = p
    ranks = []
    for r in range(size):
        d = {}
        for k in state:
            d[k] = expert_split[k][r] if k in expert_split else state[k]
        ranks.append(d)
    return ranks
