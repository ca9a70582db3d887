"""The traffic and the inputs are the seed's: the same seed gives the same
requests, sizes and bits; another seed the same sizes in another order."""

import numpy as np
import torch

from portbench import harness, weights
from portbench.tests.conftest import tiny_cell


def serve_traffic():
    return harness.module("traffic", "closed_loop_serve")


def draw(seed, n=64):
    t = serve_traffic().Traffic(harness.cell(
        "mixtral-8x7b.serve_decode")["params"], 32000, seed)
    return [t.next() for _ in range(n)]


def test_serving_requests_repeat_by_seed():
    big = 2 ** 31 + 12345
    a, b = draw(big), draw(big)
    assert [len(r.prompt) for r in a] == [len(r.prompt) for r in b]
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_every_seed_gets_the_same_sizes():
    mod = serve_traffic()
    p = harness.cell("mixtral-8x7b.serve_decode")["params"]
    one, two = mod.Traffic(p, 32000, 1), mod.Traffic(p, 32000, 2)
    assert sorted(one.prompt_len) == sorted(two.prompt_len)
    assert sorted(one.out_len) == sorted(two.out_len)
    assert list(one.prompt_len) != list(two.prompt_len)
    band = mod.BAND
    runs_one = np.sort(one.prompt_len.reshape(-1, band), axis=1)
    runs_two = np.sort(two.prompt_len.reshape(-1, band), axis=1)
    assert np.array_equal(runs_one, runs_two)
    # each run holds one length from each band, so any window of
    # requests holds nearly the same prompt tokens whatever the seed
    sums = [mod.Traffic(p, 32000, s).prompt_len[512:900].sum()
            for s in (1, 2, 2 ** 31 + 7)]
    assert max(sums) - min(sums) < 0.01 * min(sums)
    lo, hi = p["prompt_len"]
    assert one.prompt_len.min() >= lo and one.prompt_len.max() <= hi


def test_weights_and_batches_repeat_by_seed(cpu):
    port = tiny_cell("mixtral-8x7b.serve_decode")["config_data"]["port"]
    a = weights.lm(port, 32, 7, cpu)
    b = weights.lm(port, 32, 7, cpu)
    c = weights.lm(port, 32, 8, cpu)
    assert torch.equal(a["blocks"][1]["moe"]["experts"]["w3"],
                       b["blocks"][1]["moe"]["experts"]["w3"])
    assert not torch.equal(a["embed"], c["embed"])
    x = weights.activations(2, (2, 8, 16), 7, cpu)
    assert torch.equal(x, weights.activations(2, (2, 8, 16), 7, cpu))
    assert not torch.equal(x[0], x[1])

