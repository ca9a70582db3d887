"""The yardstick's counts on shapes worked out by hand."""

import pytest

from portbench.metrics import _work


def test_expert_ffn_counts():
    # 2 experts hit of 3; 5 rows; m = 8, h = 16
    flops, moved = _work.expert_ffn([2, 0, 3], 8, 16, 4)
    assert flops == 6 * 8 * 16 * 5
    per_expert = 3 * 8 * 16 / 2 + 4 * (2 * 16 + 8)
    assert moved == 2 * per_expert + 2 * 5 * 8 * 2
    flops16, moved16 = _work.expert_ffn([1], 8, 16, 16)
    assert flops16 == 6 * 8 * 16 and moved16 == 3 * 8 * 16 * 2 + 2 * 8 * 2


def test_expert_ffn_train_is_three_forwards():
    f, _ = _work.expert_ffn([4, 4], 8, 16, 16)
    ft, mt = _work.expert_ffn_train([4, 4], 8, 16)
    assert ft == 3 * f
    assert mt == 3 * 2 * 3 * 8 * 16 * 2 + 6 * 8 * 8 * 2


def test_attention_counts():
    # two rows reading 3 and 5 positions, 4 heads of 8 over 2 KV groups
    flops, moved = _work.decode_attn([3, 5], 4, 2, 8, 8)
    assert flops == 4 * 4 * 8 * 8
    assert moved == 8 * (2 * 2 * 8 + 2 * 4 * 2) + 2 * 2 * 4 * 8 * 2
    # a chunk of 2 queries at start 3: pairs 4 + 5
    flops, moved = _work.prefill_attn(1, 2, 3, 4, 2, 8, 8)
    assert flops == 4 * 4 * 8 * 9
    assert moved == 5 * (2 * 2 * 8 + 2 * 4 * 2) + 2 * 2 * 4 * 8 * 2


def test_lm_forward_counts():
    port = dict(model_dim=8, num_heads=2, num_kv_heads=1, num_local_experts=4,
                expert_hidden=16, top_k=2, num_layers=3, vocab_size=10)
    qkv = 8 + 2 * 4
    per_block = 2 * 8 * (qkv + 8) + 2 * 8 * 4
    want = 3 * (per_block * 5 + 4 * 8 * 7) + 6 * 8 * 16 * 3 * 2 * 5 \
        + 2 * 8 * 10 * 2
    assert _work.lm_forward(port, 5, 7, 2) == want


def test_bound_and_bandwidth():
    assert _work.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert _work.hbm_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert _work.bound_s(989e12, 0, 1.0) == pytest.approx(1.0)
    assert _work.bound_s(0, 3.35e12, 3.35e12) == pytest.approx(1.0)
    with pytest.raises(RuntimeError):
        _work.hbm_bytes_per_s("some other card")
