"""Vision Transformer with MoE FFN blocks, ViT-MoE (counterpart:
tutel_tpu/models/vision.py).

Patch embedding -> pre-LN encoder blocks (bidirectional attention) with a
MoE FFN every `moe_every`-th block -> mean pool -> classifier. Same
configuration and parameter tree as the JAX model: `params =
model.init(generator)`, `logits, l_aux = model.apply(params, images)` on
images [B, H, W, C], and `loss, (nll, logits) = model.loss(params,
images, labels)`. Over a process group (`group=`) every rank runs the
whole model on the whole batch and each MoE block runs expert parallelism
on the rank's rows (`models.transformer.moe_call`).

Checkpoints nest each MoE layer's state under `blocks.{i}.moe.` with the
`_num_global_experts` markers (`moe_state_dict`), so
`checkpoint.reshard.scatter_state` / `gather_states` and the CLIs re-shard
them as the JAX tools do.
"""

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..impls.moe_layer import MOELayer
from ..utils import resolve_device
from .transformer import dense_ffn, layer_keys, moe_call


@dataclasses.dataclass(frozen=True)
class VisionMoEConfig:
    image_size: int = 32
    patch_size: int = 4
    in_channels: int = 3
    num_classes: int = 10
    model_dim: int = 64
    num_heads: int = 4
    num_layers: int = 4
    ffn_hidden: int = 128
    moe_every: int = 2
    num_local_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.25
    expert_hidden: int = 128
    dtype: Any = torch.float32

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


class VisionMoE:
    """Functional ViT-MoE: `init(generator) -> params`, `apply(params,
    images) -> (logits, l_aux_sum)`. Runs on `device` (default "cuda",
    which raises without a GPU); its MoE layers run over `group` under
    `parallel_type`, as `TransformerMoE`'s."""

    def __init__(self, config: VisionMoEConfig, group=None,
                 parallel_type="adaptive:1", device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self.moe_layers: Dict[int, MOELayer] = {}
        for i in range(config.num_layers):
            if config.moe_every > 0 and (i + 1) % config.moe_every == 0:
                self.moe_layers[i] = MOELayer(
                    gate_type={"type": "top", "k": config.top_k,
                               "capacity_factor": config.capacity_factor},
                    experts={"type": "ffn",
                             "num_experts_per_device":
                                 config.num_local_experts,
                             "hidden_size_per_expert": config.expert_hidden},
                    model_dim=config.model_dim, dtype=config.dtype,
                    parallel_type=parallel_type, group=group,
                    device=self.device)

    def init(self, generator=None) -> Dict[str, Any]:
        """Parameters on the model's device, drawn from `generator` (None:
        a generator seeded with 0). Same distributions as the JAX model;
        parity with it goes through `convert.from_jax_params`."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        d, p = cfg.model_dim, cfg.patch_size
        scale = d ** -0.5
        patch = p * p * cfg.in_channels

        def normal(shape, std):
            return (torch.randn(shape, generator=generator,
                                device=self.device) * std).to(cfg.dtype)

        def full(n, value):
            return torch.full((n,), value, dtype=cfg.dtype,
                              device=self.device)

        def ln():
            return {"scale": full(d, 1.0), "bias": full(d, 0.0)}

        params: Dict[str, Any] = {
            "patch_w": normal((patch, d), patch ** -0.5),
            "pos": normal((cfg.num_patches, d), scale),
            "head_w": normal((d, cfg.num_classes), scale),
            "final_ln": ln(), "blocks": []}
        for i in range(cfg.num_layers):
            block = {"ln1": ln(), "ln2": ln(),
                     "wqkv": normal((d, 3 * d), scale),
                     "wo": normal((d, d), scale)}
            if i in self.moe_layers:
                block["moe"] = self.moe_layers[i].init(generator)
            else:
                h = cfg.ffn_hidden
                block["ffn"] = {"w1": normal((d, h), scale),
                                "b1": full(h, 0.0),
                                "w2": normal((h, d), h ** -0.5),
                                "b2": full(d, 0.0)}
            params["blocks"].append(block)
        return params

    @staticmethod
    def _ln(p, x):
        """LayerNorm wholly in float32, rounded to x's dtype at the end."""
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)

    def _attn(self, block, x):
        """Bidirectional multi-head self-attention over x [B, N, d]."""
        b, t, d = x.shape
        nh = self.cfg.num_heads
        hd = d // nh
        q, k, v = (a.reshape(b, t, nh, hd)
                   for a in (x @ block["wqkv"]).chunk(3, dim=-1))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * hd ** -0.5
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return out.reshape(b, t, d) @ block["wo"]

    def _patchify(self, params, images):
        """images [B, H, W, C] -> patch embeddings plus positions [B, N, d]
        (the projection in float32)."""
        cfg = self.cfg
        b, hgt, wid, c = images.shape
        p = cfg.patch_size
        x = images.reshape(b, hgt // p, p, wid // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.num_patches,
                                                p * p * c)
        x = x.float() @ params["patch_w"].float()
        return (x + params["pos"][None].float()).to(cfg.dtype)

    def apply(self, params, images, key=None, training=False,
              moe_overrides: Optional[dict] = None):
        """images [B, H, W, C] -> (logits [B, num_classes] in float32,
        l_aux_sum). key: a torch.Generator for the training gate noise."""
        cfg = self.cfg
        images = torch.as_tensor(images, device=self.device)
        x = self._patchify(params, images)
        l_aux_sum = torch.zeros((), device=self.device)
        ov = dict(moe_overrides or {})
        keys = layer_keys(self.moe_layers, key if training else None,
                          self.device)
        for i, block in enumerate(params["blocks"]):
            x = x + self._attn(block, self._ln(block["ln1"], x))
            h = self._ln(block["ln2"], x)
            if i in self.moe_layers:
                out, l_aux = moe_call(self.moe_layers[i], block["moe"], h,
                                      key=keys[i], training=training, **ov)
                x = x + out
                l_aux_sum = l_aux_sum + l_aux.float()
            else:
                x = x + dense_ffn(block["ffn"], h, cfg.dtype)
        x = self._ln(params["final_ln"], x.mean(dim=1))
        return x.float() @ params["head_w"].float(), l_aux_sum

    def loss(self, params, images, labels, key=None, training=True,
             l_aux_wt=0.01, moe_overrides=None):
        """Cross-entropy at the labels plus the weighted aux loss: returns
        (loss, (nll, logits))."""
        logits, l_aux = self.apply(params, images, key=key,
                                   training=training,
                                   moe_overrides=moe_overrides)
        labels = torch.as_tensor(labels, device=self.device).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, labels[:, None]).mean()
        return nll + l_aux_wt * l_aux, (nll, logits)

    # checkpoint integration (SwinV2-MoE-style namespaced state)

    def moe_state_dict(self, params):
        """Flat {name: np.ndarray} of every MoE layer under
        `blocks.{i}.moe.`, with its `_num_global_experts` marker."""
        out = {}
        for i, layer in self.moe_layers.items():
            out.update(layer.state_dict(params["blocks"][i]["moe"],
                                        prefix=f"blocks.{i}.moe."))
        return out

    def load_moe_state_dict(self, params, state):
        """`params` with every MoE layer's entries taken from `state` (a
        `moe_state_dict`); the other parameters as they are."""
        blocks = list(params["blocks"])
        for i, layer in self.moe_layers.items():
            blocks[i] = {**blocks[i], "moe": layer.load_state_dict(
                blocks[i]["moe"], state, prefix=f"blocks.{i}.moe.")}
        return {**params, "blocks": blocks}
