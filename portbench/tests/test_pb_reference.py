"""The plain reference agrees with the port's CPU path in float32 at a
tiny size: the LM's served logits (with the INT4 experts and the INT8
cache) and the MoE block's loss; and the reference imports nothing of
the port."""

import ast

import numpy as np
import torch

from portbench import harness, weights
from portbench.reference import moe_block as ref_block
from portbench.reference import transformer_moe as ref_lm
from portbench.tests.conftest import tiny_cell
from tutel_tpu_torch.ops import quant

F32 = torch.float32


def lm(cell, cpu, max_len, kv_bits):
    entry = harness.module("entries", "transformer_moe")
    model = entry.model(cell["config_data"], max_len, cpu, kv_bits)
    import dataclasses
    model.cfg = dataclasses.replace(model.cfg, dtype=F32)
    for layer in model.moe_layers.values():
        layer.dtype = F32
    return model


def test_served_logits_match_the_port(cpu):
    cell = tiny_cell("mixtral-8x7b.serve_decode")
    port = cell["config_data"]["port"]
    model = lm(cell, cpu, 64, 8)
    params = weights.lm(port, 64, 5, cpu, dtype=F32)
    ref_params = weights.lm(port, 64, 5, cpu, dtype=F32)
    for blk in params["blocks"]:
        blk["moe"]["experts"] = quant.quantize_expert_params(
            blk["moe"]["experts"], 4)
    seq = torch.from_numpy(np.random.default_rng(2).integers(
        0, port["vocab_size"], 24))
    cache = model.init_cache(1)
    prefill, cache = model.prefill(params, seq[None, :16], cache)
    got = [prefill[0]]
    for t in range(16, 23):
        out = model.apply_decode(params, seq[t:t + 1], cache,
                                 torch.tensor([t], dtype=torch.int32))
        got.append(out[0][0])
    want = ref_lm.logits(ref_params, seq[:23], port)[15:]
    assert torch.allclose(torch.stack(got), want, atol=2e-3, rtol=1e-3)


def test_moe_block_loss_matches_the_port(cpu):
    cell = tiny_cell("mellum2-12b-a2.5b.moe_train")
    port = cell["config_data"]["port"]
    entry = harness.module("entries", "moe_block")
    layer = entry.layer(cell["config_data"], 0.0, cpu)
    layer.dtype = F32
    params = weights.moe_block(port, 6, cpu, dtype=F32)
    x = weights.activations(1, (2, 64, port["model_dim"]), 6, cpu,
                            dtype=F32)[0]
    out, _ = layer(params, x, training=True)
    got = entry.helloworld_loss(out)
    want = ref_block.loss(params, x, port)
    assert abs(float(got) - float(want)) < 1e-5


def test_reference_imports_nothing_of_the_port():
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy"), (path, n)


def test_the_benchmarks_leaf_order_is_the_ports(cpu):
    """The training check pairs the port's gradients (in `sgd_step`'s
    order) with the reference's leaf by leaf."""
    from portbench import trees
    from tutel_tpu_torch.utils import tree_leaves, tree_replace
    port = tiny_cell("mellum2-12b-a2.5b.moe_train")["config_data"]["port"]
    tree = weights.moe_block(port, 1, cpu)
    assert all(a is b for a, b in zip(trees.leaves(tree),
                                       tree_leaves(tree)))
    new = [torch.full((1,), float(i)) for i in range(len(tree_leaves(tree)))]
    assert [float(t) for t in trees.leaves(trees.replace(tree, new))] == \
        [float(t) for t in tree_leaves(tree_replace(tree, new))]
