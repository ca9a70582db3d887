"""The location scan (`csrc/route_locations.cu`, through
`ops.routing.compute_locations`) on the GPU against its plain twin, the
one-hot cumsum `compute_locations_reference`, on the same card: locations
and counts bit for bit, on the one-tile and the three-pass paths, with the
warps' counters in shared memory and spilled to global memory, with and
without a token mask and a batch-prioritized order; and `extract_critical`
on the card against `extract_critical` on the CPU for the same scores.

These tests need an NVIDIA GPU and nvcc and skip without them (a CUDA
kernel has no CPU mode). This file imports no JAX; on a machine without
JAX run it as
`python -m pytest --noconftest tests/test_torch_route_locations_gpu.py`.
"""

import pytest
import torch

from tutel_tpu_torch.ops import routing

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the location scan has no CPU mode")
    return torch.device("cuda")


def _sorted_ids(s, e, k, device, seed):
    """[K, S] top-k ids as extract_critical hands them on: a transposed
    view of the stable sort's [S, E] index buffer."""
    g = torch.Generator(device=device).manual_seed(seed)
    scores = torch.rand(s, e, generator=g, device=device)
    _, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return idx[:, :k].t()


def _check(ids, e, mask=None, order=None):
    before = routing.compute_locations.launches
    loc, counts = routing.compute_locations(ids, e, mask, order)
    # one kernel launch up to one tile, three above
    assert routing.compute_locations.launches == before + (
        1 if ids.numel() <= routing.TILE else 3)
    torch.cuda.synchronize()
    ref_loc, ref_counts = routing.compute_locations_reference(
        ids, e, mask, order)
    assert loc.dtype == ref_loc.dtype == torch.int64
    assert counts.dtype == ref_counts.dtype == torch.int32
    assert torch.equal(loc, ref_loc)
    assert torch.equal(counts, ref_counts)


# (S, E, K): serve_decode's route (one tile), moe_train's (128 tiles),
# E = 6 / 96 (not powers of two), E = 2048 (the warps' counters spill to
# global memory) on one tile and on several, streams that end inside a
# tile, one token and one expert
SHAPES = [(512, 8, 2), (65536, 64, 8), (5000, 6, 2), (10001, 96, 4),
          (1000, 2048, 2), (6000, 2048, 3), (4097, 5, 1), (1, 4, 2),
          (3000, 1, 1)]


@pytest.mark.parametrize("s,e,k", SHAPES)
@pytest.mark.parametrize("masked,ordered", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_scan_matches_one_hot_twin(cuda, s, e, k, masked, ordered):
    k = min(k, e)
    ids = _sorted_ids(s, e, k, cuda, s + e + k)
    g = torch.Generator(device=cuda).manual_seed(7)
    mask = torch.rand(s, generator=g, device=cuda) < 0.8 if masked else None
    order = torch.randperm(s, generator=g, device=cuda) if ordered else None
    _check(ids, e, mask, order)
    _check(ids.contiguous(), e, mask, order)
    assert routing.scan_tiles(ids) == -(-k * s // routing.TILE)


@pytest.mark.parametrize("s,k", [(4096, 1), (20000, 1), (20000, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_every_routing_to_one_expert(cuda, s, k, masked):
    ids = torch.full((k, s), 3, dtype=torch.int64, device=cuda)
    mask = (torch.arange(s, device=cuda) % 3 != 0) if masked else None
    _check(ids, 8, mask)
    g = torch.Generator(device=cuda).manual_seed(1)
    order = torch.randperm(s, device=cuda, generator=g)
    _check(ids, 8, mask, order)


def test_ids_outside_the_experts_match_the_twin(cuda):
    """An id outside [0, E) has an all-zero one-hot row: location 0, no
    count (extract_critical never hands one on)."""
    ids = _sorted_ids(9000, 16, 2, cuda, 3).clone()
    ids[0, ::7] = -1
    ids[1, ::5] = 16
    _check(ids, 16)
    _check(ids, 16, torch.arange(9000, device=cuda) % 4 != 1)


def test_refuses_what_it_does_not_take(cuda):
    ids = _sorted_ids(64, 8, 2, cuda, 0)
    with pytest.raises(ValueError):
        routing.compute_locations(ids.int(), 8)
    with pytest.raises(ValueError):
        routing.compute_locations(ids, 8, torch.ones(63, dtype=torch.bool,
                                                     device=cuda))
    loc, counts = routing.compute_locations(ids[:, :0], 8)
    assert loc.shape == (2, 0) and torch.equal(
        counts.cpu(), torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("s,e,k,bpr,masked", [
    (512, 8, 2, False, False),
    (8192, 64, 8, False, False),
    (3000, 96, 4, True, True),
    (777, 6, 2, True, False),
])
def test_extract_critical_on_the_card_equals_the_cpu(cuda, s, e, k, bpr,
                                                     masked):
    g = torch.Generator().manual_seed(s + e)
    scores = torch.softmax(torch.randn(s, e, generator=g) * 2.0, dim=1)
    mask = (torch.arange(s) < s - s // 5) if masked else None
    got = {}
    for d in ("cpu", "cuda"):
        got[d] = routing.extract_critical(
            scores.to(d), k, 4 * s, batch_prioritized_routing=bpr,
            token_mask=None if mask is None else mask.to(d))
    (cpu, cpu_loss), (card, card_loss) = got["cpu"], got["cuda"]
    assert torch.equal(card.indices.cpu(), cpu.indices)
    assert torch.equal(card.locations.cpu(), cpu.locations)
    assert torch.equal(card.dispatch_count.cpu(), cpu.dispatch_count)
    # sums over k in another order: within float32 rounding
    assert torch.allclose(card.gates.cpu(), cpu.gates, rtol=1e-6, atol=1e-7)
    assert torch.allclose(card_loss.cpu(), cpu_loss, rtol=1e-5)
