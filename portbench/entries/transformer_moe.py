"""The port's TransformerMoE (`tutel_tpu_torch.models`), built from a
configuration file's "port" sizes, for serving (INT4 experts, INT8 KV
cache)."""

import torch

from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.ops import quant

from portbench import weights


def model(config, max_len, device, kv_bits):
    port = config["port"]
    cfg = TransformerMoEConfig(
        vocab_size=port["vocab_size"], max_len=max_len,
        model_dim=port["model_dim"], num_heads=port["num_heads"],
        num_kv_heads=port["num_kv_heads"], num_layers=port["num_layers"],
        ffn_hidden=port["ffn_hidden"], moe_every=port["moe_every"],
        num_local_experts=port["num_local_experts"], top_k=port["top_k"],
        expert_hidden=port["expert_hidden"],
        expert_type=port["expert_type"], gate_type=port["gate_type"],
        dtype=torch.bfloat16, kv_bits=kv_bits)
    return TransformerMoE(cfg, device=device)


def build_serve(config, max_len, seed, device):
    """(model, params): the seed's weights with every expert matrix
    quantized to INT4 by the port."""
    m = model(config, max_len, device, kv_bits=8)
    params = weights.lm(config["port"], max_len, seed, device)
    for blk in params["blocks"]:
        blk["moe"]["experts"] = quant.quantize_expert_params(
            blk["moe"]["experts"], 4)
    return m, params
