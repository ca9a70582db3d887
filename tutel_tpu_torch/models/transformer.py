"""Decoder-only Transformer LM with MoE FFN blocks: training, inference and
serving (counterpart: tutel_tpu/models/transformer.py:26-214, 576-1404).

Same configuration, parameter tree and cache layout as the JAX model:
`params = model.init(generator)`, `logits, l_aux = model.apply(params,
tokens, key=None, training=False)`, and the training objective
`loss, (nll, l_aux) = model.loss(params, tokens)`; the KV cache is one
dict per block with flat slabs "k"/"v" [B, max_len, KVH * HD] (int8, or
INT4 split-half packed bytes [B, max_len, KVH * HD / 2], with f32 scales
"k_s"/"v_s" [B, KVH, max_len] when kv_bits is 8 or 4). Pre-LN blocks;
every `moe_every`-th block's FFN is an MoE layer
(`impls.moe_layer.MOELayer`).

The decode step has one structure on every device: each block's attention
runs kernel K6 (`ops.decode_attn.decode_attn`) with the token's fresh K/V
row injected, and the step's cache writes for all blocks go out at the
end in one launch of kernel K8 (`ops.kv_write.write_step`, through a
writer prepared once per cache, `ops.kv_write.prepare`). The prefill
runs kernel K7 (`ops.decode_attn.prefill_attn`) per block and prompt
chunk. On CPU tensors those functions run their plain twins; on CUDA
tensors they launch the kernels or raise. The cache is updated in place.

Over a process group (`group=`, `parallel_type=`, passed to every MoE
layer; :62-80) every rank runs the whole model on the whole batch, and
each MoE block runs expert parallelism: `_moe_call` pads the flattened
tokens to a multiple of the world size W (the padding masked by a scalar
`valid_tokens`, :190-212), hands the layer this rank's rows and
all-gathers its output. The gather's backward takes this rank's rows and
the row split's backward all-gathers, since every rank holds the same
loss; the l_aux gradient is counted once over the ranks.

Sequence parallelism (:258-570): `apply_seqpar` / `loss_seqpar` shard
the sequence over the MoE layers' group (P ranks, T/P positions each);
attention runs as the Ulysses all-to-all pair (`_attn_seqpar`) or as ring
attention (`_attn_ringpar`, K/V blocks rotated by `net.ppermute` under an
online softmax, one `ring_attention_step` a position), and each MoE block
takes the rank's rows through `MOELayer.local_forward`. The gradients of
the leaves every rank holds whole are summed over the group, as JAX's
shard_map transpose sums a replicated input's cotangent.

The JAX model's kernel-mode switches and XLA fallback paths
(`_attn_kernel_mode`, `_prefill_kernel_mode`, TUTEL_TPU_DECODE_ATTN,
TUTEL_TPU_PREFILL_ATTN, TUTEL_TPU_SKIP_KV_WRITE, the VMEM budget of the
batched write) were devices of the TPU compiler and are not ported.
"""

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import net, trace
from ..impls.moe_layer import MOELayer
from ..ops.activations import gelu
from ..ops.decode_attn import decode_attn, prefill_attn, unpack_int4
from ..ops import kv_write
from ..parallel import mesh as mesh_lib
from ..utils import matmul_f32, resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerMoEConfig:
    vocab_size: int = 256
    max_len: int = 256
    model_dim: int = 128
    num_heads: int = 4
    num_layers: int = 4
    ffn_hidden: int = 512
    moe_every: int = 2                 # every Nth block uses MoE FFN
    num_local_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.25
    expert_hidden: int = 512
    expert_type: str = "ffn"
    gate_type: str = "top"
    dtype: Any = torch.float32
    expert_kwargs: Any = None          # extra expert-module fields
    kv_bits: int = 0                   # 8 = INT8 KV cache, 4 = INT4 packed,
                                       # 0 = the model dtype
    num_kv_heads: int = 0              # grouped-query attention: K/V heads
                                       # (0 = num_heads); query head h
                                       # reads KV group h % num_kv_heads


class _TakeRows(torch.autograd.Function):
    """This rank's rows of a tensor every rank holds alike; the backward
    all-gathers the ranks' row gradients (each rank's rows reach the loss
    through that rank only)."""

    @staticmethod
    def forward(ctx, x, group, start, count):
        ctx.group = group
        return x[start:start + count]

    @staticmethod
    def backward(ctx, g):
        return net.simple_all_gather(g, ctx.group), None, None, None


class _GatherRows(torch.autograd.Function):
    """Every rank's slices of dim `dim`, in rank order; the backward keeps
    this rank's slice of the gradient (every rank computes the same loss
    from the gathered tensor, so its gradient is already the whole one)."""

    @staticmethod
    def forward(ctx, x, group, dim=0):
        ctx.group, ctx.dim, ctx.rows = group, dim, x.shape[dim]
        return net.simple_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        me = net.get_world_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.rows, ctx.rows), None, None


def dense_ffn(f, h, dtype):
    """The dense FFN block: gelu(h @ w1 + b1) @ w2 + b2. Both products stay
    in float32 through their bias (and the gelu), then round to `dtype`."""
    hdn = gelu(matmul_f32(h, f["w1"]) + f["b1"].float())
    o = matmul_f32(hdn.to(dtype), f["w2"]) + f["b2"].float()
    return o.to(dtype)


def layer_keys(moe_layers, key, device):
    """{MoE block index: its own torch.Generator} for the gate noise,
    seeded from draws of `key` (the JAX model folds its key with the block
    index); None gives every layer the default generator."""
    if key is None:
        return dict.fromkeys(moe_layers)
    seeds = torch.randint(0, 2 ** 62, (len(moe_layers),), generator=key,
                          device=key.device).tolist()
    return {i: torch.Generator(device=device).manual_seed(sd)
            for i, sd in zip(moe_layers, seeds)}


def _rank_rows(layer, h):
    """(this rank's rows of h's flattened tokens padded to a multiple of
    the world size, the token count n, the padded rows a rank)."""
    w = layer.world_size
    n = h.numel() // h.shape[-1]
    flat = h.reshape(n, h.shape[-1])
    pad = (-n) % w
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, flat.shape[1]))])
    rows = flat.shape[0] // w
    return _TakeRows.apply(flat, layer.world_group,
                           layer.rank_index * rows, rows), n, rows


def moe_call(layer, moe_params, h, **overrides):
    """The MoE layer on activations h [..., d], which every rank holds
    alike. Over W > 1 ranks the flattened tokens are padded to a multiple
    of W (a scalar `valid_tokens` masks the padding), the layer gets this
    rank's rows, and its output rows are all-gathered and trimmed
    (:190-212)."""
    w = layer.world_size
    if w <= 1:
        return layer(moe_params, h, **overrides)
    local, n, rows = _rank_rows(layer, h)
    if rows * w != n and "valid_tokens" not in overrides:
        overrides = {**overrides, "valid_tokens": n}
    out, l_aux = layer(moe_params, local, **overrides)
    out = _GatherRows.apply(out, layer.world_group)[:n].reshape(
        *h.shape[:-1], out.shape[-1])
    # every rank adds the same l_aux to the same loss: count its gradient
    # once over the ranks (the layer's all-reduce sums it)
    l_aux = l_aux.detach() + (l_aux - l_aux.detach()) / w
    return out, l_aux


def ring_attention_step(q, k_blk, v_blk, q_pos, k_pos, m, den, acc):
    """One ring position of `_attn_ringpar`'s online softmax, in float32
    and with no collective: the queries q [B, T/P, mq, kvh, hd] (query
    head j * kvh + g at [.., j, g, :]) against one K/V block [B, T/P, kvh,
    hd], causal by the global positions q_pos, k_pos [T/P]. The state is
    (running max m, denominator den) [B, mq, kvh, T/P] and the unnormalized
    output acc [B, T/P, mq, kvh, hd]; a row with no visible key yet keeps
    m = -inf (`safe_m` and `alpha` keep it finite). Returns the new state;
    the output is acc / den once every block is in (:389-416)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqmgd,bkgd->bmgqk", q.float(),
                          k_blk.float()) * scale
    mask = k_pos[None, :] <= q_pos[:, None]                       # [q, k]
    scores = torch.where(mask, scores, torch.full_like(scores,
                                                       float("-inf")))
    new_m = torch.maximum(m, scores.amax(dim=-1))
    safe_m = torch.where(torch.isfinite(new_m), new_m,
                         torch.zeros_like(new_m))
    p = torch.where(mask, torch.exp(scores - safe_m[..., None]),
                    torch.zeros_like(scores))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                        torch.zeros_like(m))
    den = den * alpha + p.sum(dim=-1)
    pv = torch.einsum("bmgqk,bkgd->bqmgd", p, v_blk.float())
    acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
    return new_m, den, acc


class TransformerMoE:
    """Functional model: `init(generator) -> params`, `apply(params,
    tokens)`, and the serving path `init_cache` / `prefill` /
    `apply_decode`. Runs on `device` (default "cuda", which raises
    without a GPU); its MoE layers run over `group` (a process group, a
    `system.ParallelEnv` or a list of ranks; None: the default group, or
    one rank without one) under `parallel_type`."""

    def __init__(self, config: TransformerMoEConfig, group=None,
                 parallel_type="adaptive:1", device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        if config.kv_bits not in (0, 8, 4):
            raise ValueError(f"kv_bits={config.kv_bits} (0, 8 or 4)")
        self.moe_layers: Dict[int, MOELayer] = {}
        for i in range(config.num_layers):
            if config.moe_every > 0 and (i + 1) % config.moe_every == 0:
                self.moe_layers[i] = MOELayer(
                    gate_type={"type": config.gate_type, "k": config.top_k,
                               "capacity_factor": config.capacity_factor},
                    experts={"type": config.expert_type,
                             "num_experts_per_device":
                                 config.num_local_experts,
                             "hidden_size_per_expert": config.expert_hidden,
                             **(config.expert_kwargs or {})},
                    model_dim=config.model_dim, dtype=config.dtype,
                    parallel_type=parallel_type, group=group,
                    device=self.device)
        self._kv_writer = None      # K8 prepared for the last cache written

    # ------------------------------------------------------------------

    @property
    def _kvh(self) -> int:
        """KV heads (grouped-query attention); == num_heads for MHA."""
        cfg = self.cfg
        kvh = cfg.num_kv_heads or cfg.num_heads
        if cfg.num_heads % kvh:
            raise ValueError(f"num_heads {cfg.num_heads} is not a multiple "
                             f"of num_kv_heads {kvh}")
        return kvh

    def _split_qkv(self, qkv, lead_shape):
        """The fused qkv projection -> q [.., nh, hd], k, v [.., kvh, hd]."""
        cfg = self.cfg
        nh, kvh = cfg.num_heads, self._kvh
        hd = cfg.model_dim // nh
        d, kvd = cfg.model_dim, kvh * hd
        q = qkv[..., :d].reshape(*lead_shape, nh, hd)
        k = qkv[..., d:d + kvd].reshape(*lead_shape, kvh, hd)
        v = qkv[..., d + kvd:].reshape(*lead_shape, kvh, hd)
        return q, k, v

    def init(self, generator=None) -> Dict[str, Any]:
        """Parameters on the model's device, drawn from `generator` (a
        torch.Generator on that device; None = a generator seeded with 0).
        Same distributions as the JAX model; the bits differ, so parity
        with it goes through `convert.from_jax_params`."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        d = cfg.model_dim
        scale = d ** -0.5
        qkv_dim = d + 2 * self._kvh * (d // cfg.num_heads)

        def normal(shape, std):
            return (torch.randn(shape, generator=generator,
                                device=self.device) * std).to(cfg.dtype)

        def ln():
            return {"scale": torch.ones(d, dtype=cfg.dtype,
                                        device=self.device),
                    "bias": torch.zeros(d, dtype=cfg.dtype,
                                        device=self.device)}

        params: Dict[str, Any] = {
            "embed": normal((cfg.vocab_size, d), scale),
            "pos": normal((cfg.max_len, d), scale),
            "final_ln": ln(), "blocks": []}
        for i in range(cfg.num_layers):
            block = {"ln1": ln(), "ln2": ln(),
                     "wqkv": normal((d, qkv_dim), scale),
                     "wo": normal((d, d), scale)}
            if i in self.moe_layers:
                block["moe"] = self.moe_layers[i].init(generator)
            else:
                h = cfg.ffn_hidden
                block["ffn"] = {
                    "w1": normal((d, h), scale),
                    "b1": torch.zeros(h, dtype=cfg.dtype, device=self.device),
                    "w2": normal((h, d), h ** -0.5),
                    "b2": torch.zeros(d, dtype=cfg.dtype, device=self.device)}
            params["blocks"].append(block)
        return params

    def shard_params(self, params):
        """This rank's parameters: each MoE block's experts sharded by its
        layer (`MOELayer.shard_params`), everything else whole. One rank:
        the params as they are."""
        blocks = [{**blk, "moe": self.moe_layers[i].shard_params(blk["moe"])}
                  if i in self.moe_layers else blk
                  for i, blk in enumerate(params["blocks"])]
        return {**params, "blocks": blocks}

    # ------------------------------------------------------------------

    @staticmethod
    def _ln(p, x):
        """LayerNorm: statistics in float32, normalize in x's dtype."""
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        r = torch.rsqrt(var + 1e-5)
        y = (x - mu.to(x.dtype)) * r.to(x.dtype)
        return y * p["scale"] + p["bias"]

    def _ffn(self, f, h):
        """The dense FFN block (`dense_ffn`) in the model dtype."""
        return dense_ffn(f, h, self.cfg.dtype)

    _rank_rows = staticmethod(_rank_rows)

    def _moe_call(self, i, moe_params, h, **overrides):
        """MoE layer i on activations h [..., d] (`moe_call`)."""
        return moe_call(self.moe_layers[i], moe_params, h, **overrides)

    def _probe(self, i, moe_params, h, top_k):
        """The dropless capacity layer i's routing of h needs (a device
        scalar, the largest over the ranks)."""
        layer = self.moe_layers[i]
        probe = layer.count_needed_traceable(top_k=top_k)
        if layer.world_size <= 1:
            return probe(moe_params, h)
        local, n, rows = self._rank_rows(layer, h)
        first = layer.rank_index * rows
        mask = torch.arange(first, first + rows, device=h.device) < n
        return probe(moe_params, local, None, mask)

    def _logits(self, params, x):
        """Tied-embedding logits; float32 for float32 models, else the
        model dtype (as the JAX model)."""
        return x @ params["embed"].to(x.dtype).t()

    def _attn(self, block, x):
        """Causal self-attention over a whole sequence x [B, T, d] (the
        full-forward oracle; the serving path uses the kernels)."""
        cfg = self.cfg
        b, t, d = x.shape
        nh, hd, kvh = cfg.num_heads, d // cfg.num_heads, self._kvh
        mq = nh // kvh
        q, k, v = self._split_qkv(x @ block["wqkv"], (b, t))
        # head h = m * kvh + g reads KV group g = h % kvh
        q = q.reshape(b, t, mq, kvh, hd)
        scores = torch.einsum("bqmgd,bkgd->bmgqk", q.float(), k.float())
        scores = scores * hd ** -0.5
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bmgqk,bkgd->bqmgd", probs, v).reshape(b, t, d)
        return out @ block["wo"]

    def _layer_keys(self, key):
        return layer_keys(self.moe_layers, key, self.device)

    def apply(self, params, tokens, key=None, training=False,
              moe_overrides: Optional[dict] = None):
        """tokens [B, T] -> (logits [B, T, V], l_aux_sum). key: a
        torch.Generator for the training gate noise."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, t = tokens.shape
        x = (params["embed"][tokens] + params["pos"][None, :t]).to(cfg.dtype)
        l_aux_sum = torch.zeros((), device=self.device)
        ov = dict(moe_overrides or {})
        keys = self._layer_keys(key if training else None)
        for i, block in enumerate(params["blocks"]):
            x = x + self._attn(block, self._ln(block["ln1"], x))
            h = self._ln(block["ln2"], x)
            if i in self.moe_layers:
                out, l_aux = self._moe_call(i, block["moe"], h, key=keys[i],
                                            training=training, **ov)
                x = x + out
                l_aux_sum = l_aux_sum + l_aux.float()
            else:
                x = x + self._ffn(block["ffn"], h)
        return self._logits(params, self._ln(params["final_ln"], x)), \
            l_aux_sum

    def loss(self, params, tokens, key=None, training=True, l_aux_wt=0.01,
             moe_overrides=None):
        """Next-token cross-entropy plus the weighted aux loss: returns
        (loss, (nll, l_aux)). Tokens up to max_len long run the full
        sequence and drop the last position's logits; longer ones (a
        dataset sized max_len + 1 for the shift) run tokens[:, :-1]."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        if tokens.shape[1] > self.cfg.max_len:
            logits, l_aux = self.apply(params, tokens[:, :-1], key=key,
                                       training=training,
                                       moe_overrides=moe_overrides)
            nll = self._nll(logits, tokens[:, 1:])
        else:
            logits, l_aux = self.apply(params, tokens, key=key,
                                       training=training,
                                       moe_overrides=moe_overrides)
            nll = self._nll_shifted(logits, tokens)
        return nll + l_aux_wt * l_aux, (nll, l_aux)

    @staticmethod
    def _nll_shifted(logits, tokens):
        """Shifted next-token nll over full-sequence logits: the [B, T]
        per-position losses are sliced, not the [B, T, V] logits."""
        tpad = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        return torch.mean(TransformerMoE._token_nll(logits, tpad)[:, :-1])

    @staticmethod
    def _nll(logits, targets):
        """mean(logsumexp - target logit): the cross-entropy, reduced in
        float32 with no [B, T, V] log-probability tensor."""
        return torch.mean(TransformerMoE._token_nll(logits, targets))

    @staticmethod
    def _token_nll(logits, targets):
        """[B, T] logsumexp(logits) - logits[target], in float32."""
        lse = torch.logsumexp(logits.float(), dim=-1)              # [B, T]
        tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
        return lse - tgt.float()

    # ------------------------------------------------------------------
    # Sequence parallelism (:258-570)
    # ------------------------------------------------------------------

    def _moe_mesh(self):
        """(the MoE layers' process group, its size P, this rank's index in
        it): the sequence shards over the same ranks as the experts."""
        layers = list(self.moe_layers.values())
        if not layers:
            raise ValueError(
                "apply_seqpar derives its mesh from the MoE layers; "
                "this model has none (moe_every=0)")
        l0 = layers[0]
        for layer in layers[1:]:
            if layer.world_size != l0.world_size or layer.ranks != l0.ranks:
                raise ValueError(
                    "all MoE layers must share one device group for "
                    "sequence parallelism")
        return l0.world_group, l0.world_size, l0.rank_index

    def _attn_seqpar(self, block, x, group):
        """Ulysses attention of this rank's positions x [B, T/P, d]: an
        all-to-all turns [B, T/P, heads, hd] into [B, T, heads/P, hd] (rank
        j's positions land at offset j * T/P), full causal attention runs
        there, and the inverse all-to-all brings the positions back. Under
        GQA the query heads travel group-major (position g * mq + j holds
        head j * kvh + g), so each rank gets whole KV groups (:279-341)."""
        cfg = self.cfg
        b, tl, d = x.shape
        nh, hd, kvh = cfg.num_heads, d // cfg.num_heads, self._kvh
        mq = nh // kvh
        q, k, v = self._split_qkv(x @ block["wqkv"], (b, tl))
        if mq > 1:
            perm = torch.tensor([j * kvh + g for g in range(kvh)
                                 for j in range(mq)], device=x.device)
            q = q.index_select(2, perm)
        # JAX's all_to_all(split_axis=2, concat_axis=1): heads scattered,
        # positions gathered
        q, k, v = (net.all_to_all(a, 1, 2, group) for a in (q, k, v))
        t, gl = q.shape[1], k.shape[2]
        q = q.reshape(b, t, gl, mq, hd)
        scores = torch.einsum("bqgmd,bkgd->bgmqk", q.float(), k.float())
        scores = scores * hd ** -0.5
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bgmqk,bkgd->bqgmd", probs, v).reshape(
            b, t, gl * mq, hd)
        out = net.all_to_all(out, 2, 1, group)
        if mq > 1:
            inv = torch.tensor([(h % kvh) * mq + h // kvh for h in range(nh)],
                               device=x.device)
            out = out.index_select(2, inv)
        return out.reshape(b, tl, d) @ block["wo"]

    def _attn_ringpar(self, block, x, group, sp, idx):
        """Ring attention of this rank's positions x [B, T/P, d]: the query
        block stays, the K/V block rotates P - 1 hops over `net.ppermute`
        (at step j the block in hand came from rank (idx - j) mod P), and
        `ring_attention_step` folds each block into a float32 online
        softmax. Each step is checkpointed (recomputed in the backward, as
        JAX's `jax.checkpoint`), the hops outside it, so no collective runs
        twice; every rank issues the same hops in the same order
        (:343-422)."""
        cfg = self.cfg
        b, tl, d = x.shape
        nh, hd, kvh = cfg.num_heads, d // cfg.num_heads, self._kvh
        mq = nh // kvh
        q, k, v = self._split_qkv(x @ block["wqkv"], (b, tl))
        q = q.reshape(b, tl, mq, kvh, hd)
        pos = torch.arange(tl, device=x.device)
        q_pos = idx * tl + pos
        m = torch.full((b, mq, kvh, tl), float("-inf"), device=x.device)
        den = torch.zeros((b, mq, kvh, tl), device=x.device)
        acc = torch.zeros((b, tl, mq, kvh, hd), device=x.device)
        kv = torch.stack([k, v])                 # one hop moves both
        for j in range(sp):
            m, den, acc = torch.utils.checkpoint.checkpoint(
                ring_attention_step, q, kv[0], kv[1], q_pos,
                ((idx - j) % sp) * tl + pos, m, den, acc,
                use_reentrant=False)
            if j < sp - 1:
                kv = net.ppermute(kv, 1, group)
        out = acc / den.permute(0, 3, 1, 2)[..., None]
        return out.to(x.dtype).reshape(b, tl, d) @ block["wo"]

    def _seqpar_axes(self):
        layer = next(iter(self.moe_layers.values()))
        return ("dcn", "ici") if layer._flat_2dh() else \
            mesh_lib.MoeMesh.EP_AXES

    def seqpar_specs(self, params):
        """(group, token axes, param specs, tokens spec, logits spec) of the
        sequence-parallel forward (:424-440). The param specs are a tree
        shaped like `params` in `MOELayer.param_specs`' form: () for a
        leaf every rank holds whole, the layer's own specs for each
        block's "moe"; the tokens [B, T] and the logits [B, T, V] are split
        along T over the token axes."""
        group, _, _ = self._moe_mesh()
        axes = self._seqpar_axes()

        def whole(tree):
            if isinstance(tree, dict):
                return {k: whole(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(whole(v) for v in tree)
            return ()
        blocks = []
        for i, block in enumerate(params["blocks"]):
            spec = {k: whole(v) for k, v in block.items() if k != "moe"}
            if "moe" in block:
                spec["moe"] = self.moe_layers[i].param_specs(block["moe"])
            blocks.append(spec)
        pspec = {"embed": (), "pos": (), "final_ln": whole(params["final_ln"]),
                 "blocks": blocks}
        return group, axes, pspec, (None, axes), (None, axes, None)

    def _sum_replicated_grads(self, params):
        """`params` with each differentiable leaf's gradient summed over
        the token axes its spec does not split (the identity forward of
        `net.allreduce_backward`): a whole leaf over the group in one
        all-reduce, an expert leaf split over every axis not at all."""
        layer = next(iter(self.moe_layers.values()))
        mesh = layer._hmesh if layer._flat_2dh() else \
            layer._meshes[max(layer.adaptive_degree, 1)]
        _, _, pspec, _, _ = self.seqpar_specs(params)

        def wrap(p, spec):
            if isinstance(p, dict):
                return {k: wrap(v, spec[k]) for k, v in p.items()}
            if isinstance(p, (list, tuple)):
                return type(p)(wrap(v, s) for v, s in zip(p, spec))
            if not (isinstance(p, torch.Tensor) and p.requires_grad):
                return p
            split = {a for entry in spec if entry is not None
                     for a in ((entry,) if isinstance(entry, str) else entry)}
            if not split:
                return net.allreduce_backward(p, layer.world_group)
            for a in mesh.names:
                if a not in split and mesh.size(a) > 1:
                    p = net.allreduce_backward(p, mesh.group(a))
            return p
        return wrap(params, pspec)

    @staticmethod
    def _check_attn_mode(attn_mode):
        if attn_mode not in ("ulysses", "ring"):
            raise ValueError(f"attn_mode={attn_mode!r} "
                             "(expected 'ulysses' or 'ring')")

    def _seqpar_local(self, params, tokens, key=None, training=False,
                      moe_overrides: Optional[dict] = None,
                      attn_mode: str = "ulysses"):
        """This rank's part of the sequence-parallel forward, at any P (one
        rank included): the global tokens [B, T] in (every rank holds them
        all), this rank's logits [B, T/P, V] of positions [idx * T/P,
        (idx + 1) * T/P) and l_aux_sum, the same on every rank, out.
        `params` holds this rank's shard of each MoE block
        (`shard_params`); at P > 1 the replicated leaves' gradients are
        summed over the group (:482-540)."""
        cfg = self.cfg
        self._check_attn_mode(attn_mode)
        group, sp, idx = self._moe_mesh()
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, t = tokens.shape
        if t % sp:
            raise ValueError(
                f"sequence length {t} must divide the {sp}-device "
                "SP world")
        if attn_mode == "ulysses" and self._kvh % sp:
            raise ValueError(
                f"num_kv_heads {self._kvh} must divide the {sp}-device "
                "SP world for attn_mode='ulysses' (its all-to-all "
                "shards whole KV groups; use 'ring' when P exceeds "
                "the KV head count)")
        ov = dict(moe_overrides or {})
        moe_fns = {i: layer.local_forward(
            capacity_factor=ov.get("capacity_factor"), top_k=ov.get("top_k"),
            capacity_override=ov.get("capacity_override"),
            training=training) for i, layer in self.moe_layers.items()}
        if sp > 1 and torch.is_grad_enabled():
            params = self._sum_replicated_grads(params)
        tl = t // sp
        x = (params["embed"][tokens[:, idx * tl:(idx + 1) * tl]]
             + params["pos"][None, idx * tl:(idx + 1) * tl]).to(cfg.dtype)
        keys = self._layer_keys(key if training else None)
        l_aux_sum = torch.zeros((), device=self.device)
        for i, block in enumerate(params["blocks"]):
            h = self._ln(block["ln1"], x)
            if attn_mode == "ring":
                x = x + self._attn_ringpar(block, h, group, sp, idx)
            else:
                x = x + self._attn_seqpar(block, h, group)
            h = self._ln(block["ln2"], x)
            if i in moe_fns:
                out, l_aux = moe_fns[i](block["moe"],
                                        h.reshape(-1, h.shape[-1]), keys[i])
                x = x + out.reshape(x.shape).to(cfg.dtype)
                l_aux_sum = l_aux_sum + l_aux.float()
            else:
                x = x + self._ffn(block["ffn"], h)
        logits = self._logits(params, self._ln(params["final_ln"], x))
        if sp > 1:
            # the layers' l_aux is already the mean over the group; this
            # mean (JAX's pmean) leaves it so and hands each rank 1/P of
            # its gradient, as JAX's transpose does
            l_aux_sum = net.allreduce_forward(l_aux_sum, group) / sp
        return logits, l_aux_sum

    def apply_seqpar(self, params, tokens, key=None, training=False,
                     moe_overrides: Optional[dict] = None,
                     attn_mode: str = "ulysses"):
        """Sequence-parallel forward: tokens [B, T] (every rank holds them
        all), T split over the P ranks of the MoE layers' group -> (logits
        [B, T, V], all-gathered along T, l_aux_sum). attn_mode "ulysses"
        needs num_kv_heads % P == 0; "ring" has no head bound. T % P must
        be 0, and the MoE capacity static (capacity_factor > 0 or
        capacity_override in `moe_overrides`). At P == 1 this is `apply`.
        The gather's backward keeps this rank's positions, so a loss every
        rank computes from the logits alike has the whole gradient."""
        self._check_attn_mode(attn_mode)
        group, sp, _ = self._moe_mesh()
        if sp == 1:
            return self.apply(params, tokens, key=key, training=training,
                              moe_overrides=moe_overrides)
        logits, l_aux = self._seqpar_local(
            params, tokens, key=key, training=training,
            moe_overrides=moe_overrides, attn_mode=attn_mode)
        return _GatherRows.apply(logits, group, 1), l_aux

    def loss_seqpar(self, params, tokens, key=None, training=True,
                    l_aux_wt=0.01, moe_overrides=None,
                    attn_mode: str = "ulysses"):
        """Sequence-parallel `loss`: (loss, (nll, l_aux)), the same on
        every rank. Tokens up to max_len long run the full sequence (T % P
        == 0), longer ones (a dataset of max_len + 1) tokens[:, :-1] ((T -
        1) % P == 0). Each rank sums the nll of its own positions against
        targets from the global tokens (rank i's last position predicts
        rank i + 1's first token; the sequence's last position has no
        target), and one all-reduce of that sum gives the mean over the B
        * (T - 1) targets, with no [B, T, V] gather (:548-570)."""
        self._check_attn_mode(attn_mode)
        if self._moe_mesh()[1] == 1:
            return self.loss(params, tokens, key=key, training=training,
                             l_aux_wt=l_aux_wt, moe_overrides=moe_overrides)
        return self._loss_seqpar_local(
            params, tokens, key=key, training=training, l_aux_wt=l_aux_wt,
            moe_overrides=moe_overrides, attn_mode=attn_mode)

    def _loss_seqpar_local(self, params, tokens, key=None, training=True,
                           l_aux_wt=0.01, moe_overrides=None,
                           attn_mode: str = "ulysses"):
        """`loss_seqpar` through the per-rank body at any P (one rank
        included)."""
        group, sp, idx = self._moe_mesh()
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, t = tokens.shape
        inputs = tokens[:, :-1] if t > self.cfg.max_len else tokens
        logits, l_aux = self._seqpar_local(
            params, inputs, key=key, training=training,
            moe_overrides=moe_overrides, attn_mode=attn_mode)
        tl = logits.shape[1]
        # the target of position p is token p + 1; the wrapped last one is
        # dropped below
        targets = torch.roll(tokens, -1, dims=1)[:, idx * tl:(idx + 1) * tl]
        tok_nll = self._token_nll(logits, targets)
        if idx == sp - 1 and inputs.shape[1] == t:
            tok_nll = tok_nll[:, :-1]
        nll = net.allreduce_forward(tok_nll.sum(), group) / (b * (t - 1))
        return nll + l_aux_wt * l_aux, (nll, l_aux)

    # ------------------------------------------------------------------
    # Incremental decode (KV cache): the serving path
    # ------------------------------------------------------------------

    def init_cache(self, batch: int):
        """Per-block KV cache for `batch` rows (module doc), on the
        model's device."""
        cfg = self.cfg
        kvh, hd = self._kvh, cfg.model_dim // cfg.num_heads
        dev = self.device
        if cfg.kv_bits == 0:
            return [{kk: torch.zeros(batch, cfg.max_len, kvh * hd,
                                     dtype=cfg.dtype, device=dev)
                     for kk in ("k", "v")} for _ in range(cfg.num_layers)]
        width = kvh * hd if cfg.kv_bits == 8 else kvh * hd // 2
        return [{"k": torch.zeros(batch, cfg.max_len, width,
                                  dtype=torch.int8, device=dev),
                 "v": torch.zeros(batch, cfg.max_len, width,
                                  dtype=torch.int8, device=dev),
                 "k_s": torch.ones(batch, kvh, cfg.max_len, device=dev),
                 "v_s": torch.ones(batch, kvh, cfg.max_len, device=dev)}
                for _ in range(cfg.num_layers)]

    @staticmethod
    def _kv_quantize(x):
        """Per-(row, head) symmetric INT8: x [N, kvh, hd] -> (int8 values,
        f32 scales [N, kvh])."""
        xf = x.float()
        s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-10)
        q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
        return q.to(torch.int8), s

    @staticmethod
    def _kv_quantize4(x):
        """Per-(row, head) symmetric INT4, nibble-packed: x [N, kvh, hd] ->
        (int8 [N, kvh*hd/2], f32 scales [N, kvh]) in the split-half layout
        (byte c = flat value c | flat value c + D/2 << 4)."""
        n = x.shape[0]
        xf = x.float()
        s = torch.clamp(xf.abs().amax(dim=-1) / 7.0, min=1e-10)
        q = torch.clamp(torch.round(xf / s[..., None]), -7, 7).to(
            torch.int32).reshape(n, -1)
        dp = q.shape[-1] // 2
        packed = (q[:, :dp] & 0xF) | ((q[:, dp:] & 0xF) << 4)   # 0 .. 255
        return ((packed + 128) % 256 - 128).to(torch.int8), s

    @staticmethod
    def _kv_dequant4(packed, scales, kvh, hd, read_len):
        """Inverse of `_kv_quantize4` over a cache window: packed
        [B, T, D/2] + scales [B, kvh, T] -> [B, read_len, kvh, hd] f32."""
        flat = unpack_int4(packed[:, :read_len]).float()
        vals = flat.reshape(*flat.shape[:2], kvh, hd)
        return vals * scales[:, :, :read_len].transpose(1, 2)[..., None]

    def _stored(self, x):
        """K or V rows [N, kvh, hd] in the cache's stored form:
        (values [N, row], scales [N, kvh] or None)."""
        n = x.shape[0]
        if self.cfg.kv_bits == 8:
            q, s = self._kv_quantize(x)
            return q.reshape(n, -1), s
        if self.cfg.kv_bits == 4:
            return self._kv_quantize4(x)
        return x.reshape(n, -1).contiguous(), None

    def _attn_step(self, block, x, layer_cache, pos, attn_len=None):
        """One-token attention: x [B, d] at positions pos [B] over the
        layer's cache. The cache is not written here: K6 takes the fresh
        K/V row directly, and the row comes back as the pending write,
        {"rows": (k, v), "cols": (k_scale, v_scale) or None}.

        attn_len bounds the cache read to the first attn_len positions,
        exact while every pos < attn_len."""
        cfg = self.cfg
        b, d = x.shape
        q, k, v = self._split_qkv(x @ block["wqkv"], (b,))
        kq, ks = self._stored(k)
        vq, vs = self._stored(v)
        quant = cfg.kv_bits != 0
        q = q.contiguous()
        with trace.span("tutel.attn.decode") as sp:
            if sp:
                sp.set(rows=b, window=attn_len or layer_cache["k"].shape[1])
            out = decode_attn(
                q, layer_cache["k"], layer_cache["v"], pos,
                k_scale=layer_cache.get("k_s"),
                v_scale=layer_cache.get("v_s"), attn_len=attn_len,
                kv_bits=cfg.kv_bits or 8, k_new=kq, v_new=vq,
                k_new_scale=ks, v_new_scale=vs)
        pending = {"rows": (kq, vq), "cols": (ks, vs) if quant else None}
        return out.reshape(b, d) @ block["wo"], pending

    def _flush_kv_writes(self, cache, pendings, pos):
        """Every block's deferred cache write in one K8 launch: 2L row
        caches and, for a quantized cache, 2L scale columns, through the
        writer prepared for this cache (prepared again when the cache is
        another)."""
        row_caches, rows, col_caches, cols = [], [], [], []
        for lc, pend in zip(cache, pendings):
            row_caches += [lc["k"], lc["v"]]
            rows += list(pend["rows"])
            if pend["cols"] is not None:
                col_caches += [lc["k_s"], lc["v_s"]]
                cols += list(pend["cols"])
        writer = self._kv_writer
        if writer is None or not writer.matches(row_caches, col_caches):
            writer = self._kv_writer = kv_write.prepare(row_caches,
                                                        col_caches)
        writer(rows, pos, cols)
        return cache

    def apply_decode(self, params, tokens, cache, pos,
                     moe_overrides: Optional[dict] = None,
                     capacity_probe: bool = False,
                     attn_len: Optional[int] = None):
        """One decode step: tokens [B] at positions pos [B].

        Returns (logits [B, V], cache, l_aux_sum); the cache is updated in
        place. Numerically the computation of `apply` at those positions.
        capacity_probe=True also returns a device int scalar: the most
        tokens any MoE layer's routing of this step sent to one expert
        (the dropless capacity the step needed). A position past max_len
        (an idle engine slot) reads the last positional row and writes
        nothing, as the JAX model's gather and scatter do."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        pos = torch.as_tensor(pos, device=self.device)
        x = (params["embed"][tokens]
             + params["pos"][pos.long().clamp(0, cfg.max_len - 1)]
             ).to(cfg.dtype)
        pos32 = pos.to(torch.int32)      # K6's and K8's positions, once a step
        l_aux_sum = torch.zeros((), device=self.device)
        ov = dict(moe_overrides or {})
        needed_max = torch.zeros((), dtype=torch.long, device=self.device)
        pendings = []
        for i, block in enumerate(params["blocks"]):
            a, pend = self._attn_step(block, self._ln(block["ln1"], x),
                                      cache[i], pos32, attn_len=attn_len)
            pendings.append(pend)
            x = x + a
            h = self._ln(block["ln2"], x)
            if i in self.moe_layers:
                if capacity_probe:
                    needed_max = torch.maximum(needed_max, self._probe(
                        i, block["moe"], h, ov.get("top_k")).long())
                out, l_aux = self._moe_call(i, block["moe"], h, **ov)
                x = x + out
                l_aux_sum = l_aux_sum + l_aux.float()
            else:
                x = x + self._ffn(block["ffn"], h)
        with trace.span("tutel.attn.kv_write") as sp:
            if sp:
                sp.set(rows=tokens.shape[0])
            self._flush_kv_writes(cache, pendings, pos32)
        logits = self._logits(params, self._ln(params["final_ln"], x))
        if capacity_probe:
            return logits, cache, l_aux_sum, needed_max
        return logits, cache, l_aux_sum

    def prefill(self, params, prompts, cache,
                moe_overrides: Optional[dict] = None, parallel: bool = True,
                prompt_lens=None):
        """Write prompts [B, Tp] into the cache (in place); returns
        (logits_last [B, V], cache), logits_last predicting the token
        after each prompt.

        prompt_lens [B] (parallel path only): each row's true prompt
        length when Tp is a padded length bucket; logits_last is then taken
        at prompt_lens[b] - 1. The padded tail's cache cells are written
        but masked out of every later read until decode rewrites them.

        parallel=True runs `_prefill_parallel` (chunks of 128 positions,
        one K7 call per block and chunk); parallel=False runs the loop of
        `apply_decode` over the prompt, kept as the oracle."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        if parallel:
            return self._prefill_parallel(params, prompts, cache,
                                          moe_overrides,
                                          prompt_lens=prompt_lens)
        if prompt_lens is not None:
            raise NotImplementedError(
                "prompt_lens requires the parallel prefill path (the loop "
                "oracle returns only the final step's logits)")
        b, tp = prompts.shape
        logits = None
        for t in range(tp):
            logits, cache, _ = self.apply_decode(
                params, prompts[:, t], cache,
                torch.full((b,), t, dtype=torch.int32, device=self.device),
                moe_overrides=moe_overrides, attn_len=tp)
        return logits, cache

    def _write_chunk(self, lc, k, v, start):
        """A prompt chunk's K/V rows [b, tc, kvh, hd] into the cache at
        positions start.., in the stored form."""
        b, tc, kvh, _ = k.shape
        for name, x in (("k", k), ("v", v)):
            vals, s = self._stored(x.reshape(b * tc, kvh, -1))
            lc[name][:, start:start + tc] = vals.reshape(b, tc, -1)
            if s is not None:
                lc[name + "_s"][:, :, start:start + tc] = \
                    s.reshape(b, tc, kvh).transpose(1, 2)

    def _prefill_chunk(self, params, x, cache, start, read_len, ov):
        """One prompt chunk x [b, tc, d] at positions start..: every block
        writes the chunk's K/V, then attends over the first read_len cache
        positions with K7. Returns the chunk's final hidden states."""
        cfg = self.cfg
        b, tc, d = x.shape
        for i, block in enumerate(params["blocks"]):
            q, k, v = self._split_qkv(
                self._ln(block["ln1"], x) @ block["wqkv"], (b, tc))
            lc = cache[i]
            self._write_chunk(lc, k, v, start)
            q = q.contiguous()
            with trace.span("tutel.attn.prefill") as sp:
                if sp:
                    sp.set(rows=b * tc, window=read_len)
                a = prefill_attn(q, lc["k"], lc["v"], start,
                                 k_scale=lc.get("k_s"), v_scale=lc.get("v_s"),
                                 attn_len=read_len, kv_bits=cfg.kv_bits or 8)
            x = x + a.reshape(b, tc, d) @ block["wo"]
            h = self._ln(block["ln2"], x)
            if i in self.moe_layers:
                x = x + self._moe_call(i, block["moe"], h, **ov)[0]
            else:
                x = x + self._ffn(block["ffn"], h)
        return x

    def _prefill_parallel(self, params, prompts, cache, moe_overrides,
                          tc: int = 128, prompt_lens=None):
        """Chunked-parallel prefill: chunks of `tc` positions, each one
        causal attention pass per block (its queries against the cache
        written so far and itself) and one MoE dispatch over b*tc tokens
        at the content-independent lossless capacity b*tc, so a caller's
        decode-scale capacity_override never mis-sizes the prompt routing.

        The chunks run in at most 4 segments; a segment's chunks read a
        window of the cache that covers its last chunk, rounded up to 128
        positions (the JAX model's segmented windows,
        tutel_tpu/models/transformer.py:1308-1331)."""
        cfg = self.cfg
        b, tp = prompts.shape
        tc = max(1, min(tc, tp))
        while -(-tp // tc) * tc > cfg.max_len:      # stay inside the cache
            tc = max(1, tc // 2)
        tp_pad = -(-tp // tc) * tc
        n_chunks = tp_pad // tc
        prompts_p = torch.nn.functional.pad(prompts, (0, tp_pad - tp))
        x_all = (params["embed"][prompts_p]
                 + params["pos"][None, :tp_pad]).to(cfg.dtype)
        ov = dict(moe_overrides or {})
        ov.pop("capacity_override", None)
        if "capacity_factor" not in ov:
            ov["capacity_override"] = b * tc
        nseg = min(4, n_chunks)
        hs, ci0 = [], 0
        for si in range(nseg):
            ce = n_chunks * (si + 1) // nseg
            window = min(tp_pad, -(-(ce * tc) // 128) * 128)
            for ci in range(ci0, ce):
                start = ci * tc
                hs.append(self._prefill_chunk(
                    params, x_all[:, start:start + tc], cache, start, window,
                    ov))
            ci0 = ce
        if prompt_lens is None:
            hl = hs[(tp - 1) // tc][:, (tp - 1) % tc]
        else:
            h_all = torch.cat(hs, dim=1)                     # [b, tp_pad, d]
            idx = torch.as_tensor(prompt_lens, device=self.device).long()
            idx = (idx - 1).clamp(0, tp_pad - 1)
            hl = h_all[torch.arange(b, device=self.device), idx]
        return self._logits(params, self._ln(params["final_ln"], hl)), cache
