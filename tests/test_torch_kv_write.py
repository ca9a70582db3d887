"""Port parity: the twin of kernel K8 (`write_step` in
tutel_tpu_torch.ops.kv_write) against the JAX package's Pallas write
kernel in interpret mode, on the same numpy inputs. A write is exact:
every cache must come out equal, byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.ops.kv_write_pallas import write_step as jwrite
from tutel_tpu_torch.ops import kv_write

torch.set_num_threads(1)


def _mk(rng, shape, dtype):
    if dtype == np.int8:
        return rng.integers(-100, 100, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_write_step_matches_pallas(dtype):
    """Two layers' K, V row caches and K, V scale columns in one call, at
    the first row, inside and at the edges of the Pallas kernel's 8-row
    and 128-lane windows, and the last row."""
    rng = np.random.default_rng(0)
    b, t, d, h = 6, 256, 256, 2
    rows_c = [_mk(rng, (b, t, d), dtype) for _ in range(4)]
    rows = [_mk(rng, (b, d), dtype) for _ in range(4)]
    cols_c = [_mk(rng, (b, h, t), np.float32) for _ in range(4)]
    cols = [_mk(rng, (b, h), np.float32) for _ in range(4)]
    pos = np.asarray([0, 3, 8, 128, 255, 127], np.int32)
    ref_r, ref_c = jwrite([jnp.asarray(c) for c in rows_c],
                          [jnp.asarray(r) for r in rows], jnp.asarray(pos),
                          col_caches=[jnp.asarray(c) for c in cols_c],
                          cols=[jnp.asarray(c) for c in cols],
                          interpret=True)
    tr = [torch.from_numpy(c.copy()) for c in rows_c]
    tc = [torch.from_numpy(c.copy()) for c in cols_c]
    got_r, got_c = kv_write.write_step(
        tr, [torch.from_numpy(r) for r in rows], torch.from_numpy(pos),
        col_caches=tc, cols=[torch.from_numpy(c) for c in cols])
    for got, ref, cache in zip(got_r + got_c, ref_r + ref_c, tr + tc):
        assert got is cache                           # updated in place
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_write_step_rows_only_packed_width_and_bfloat16():
    """A float cache writes its row caches alone; an INT4 cache row is
    half the logical width."""
    rng = np.random.default_rng(1)
    b, t = 4, 64
    for d, dtype in ((64, torch.int8), (96, torch.bfloat16)):
        cache = torch.from_numpy(_mk(rng, (b, t, d), np.float32) * 50).to(dtype)
        row = torch.from_numpy(_mk(rng, (b, d), np.float32) * 50).to(dtype)
        pos = torch.from_numpy(rng.integers(0, t, b))
        want = cache.clone()
        want[torch.arange(b), pos] = row
        (got,), cols = kv_write.write_step([cache], [row], pos)
        assert cols == [] and torch.equal(got, want)


def test_out_of_range_rows_are_not_written():
    """As an XLA scatter drops an out-of-range update, a row whose pos is
    outside the cache writes nothing (an idle engine slot)."""
    cache = torch.zeros(3, 8, 4)
    scales = torch.ones(3, 2, 8)
    kv_write.write_step([cache], [torch.full((3, 4), 5.0)],
                        torch.tensor([2, 8, -1]), col_caches=[scales],
                        cols=[torch.full((3, 2), 7.0)])
    assert torch.equal(cache[0, 2], torch.full((4,), 5.0))
    assert float(cache.abs().sum()) == 20.0
    assert torch.equal(scales[0, :, 2], torch.full((2,), 7.0))
    assert float(scales.sum()) == 3 * 16 - 2 + 14


def test_write_step_rejects_mismatched_tensors():
    with pytest.raises(ValueError, match="do not match"):
        kv_write.write_step([torch.zeros(2, 8, 4)], [torch.zeros(2, 3)],
                            torch.zeros(2))
    with pytest.raises(ValueError, match="one fresh tensor"):
        kv_write.write_step([torch.zeros(2, 8, 4)], [], torch.zeros(2))
    with pytest.raises(ValueError, match="cpu or cuda"):
        kv_write.write_step([torch.zeros(2, 8, 4, device="meta")],
                            [torch.zeros(2, 4, device="meta")],
                            torch.zeros(2))
