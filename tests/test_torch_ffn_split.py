"""The hidden split of the fused expert kernels K2 (`fused_ffn_quant`) and
K4 (`fused_swiglu_quant`) on the CPU: the slice plan the CUDA kernels share
(`fused_ffn.split_slices`, mirrored by `split_rows` in
`csrc/ffn_common.cuh`), `split_plan`'s choice of slices and row tiles, and
a plain-torch emulation of what the kernels compute with S slices (each
slice's hidden columns and its partial of the down projection, then the
partials summed in slice order, scaled and rounded once) against the twins
and against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs from a seed.

Tolerances, max |got - ref| / max |ref| over live rows: 1e-5 in float32
(the same products summed in another order); in bfloat16 2e-2, the bound
the kernels are held to, since a hidden value rounded the other way moves
the output by up to a bfloat16 step. The inputs are continuous random
values, so no activation input or rounding sits on a tie.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tutel_tpu.ops import fused_ffn_pallas as jfp
from tutel_tpu.ops import quant as jq
from tutel_tpu_torch import convert
from tutel_tpu_torch.ops import activations
from tutel_tpu_torch.ops import fused_ffn as tfp

torch.set_num_threads(1)

SPLITS = (1, 2, 3, 4, 8)
E, C, K, N, BW = 3, 6, 128, 96, 128              # N < BW: padding columns
COUNTS = np.array([6, 0, 3], np.int32)           # an empty expert, odd rows
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _packed_rows(bits, h):
    return h // 2 if bits == 4 else h


# -- the slice plan -----------------------------------------------------------

@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("h", [512, 1024, 2048])
@pytest.mark.parametrize("bits", [4, 8])
def test_every_hidden_column_has_one_slice(bits, h, split):
    """K = 512, H in {K, 2K, 4K}: the slices cover the down projection's
    packed rows in order, on SPLIT_UNIT boundaries, and each hidden column
    belongs to exactly one slice; at every tile width the columns of a
    slice lie in the first layer's tiles."""
    kr = _packed_rows(bits, h)
    slices = tfp.split_slices(kr, split)
    assert len(slices) == split and split <= tfp.max_split(kr)
    assert slices[0][0] == 0 and slices[-1][1] == kr
    for (p0, p1), (q0, _) in zip(slices, slices[1:] + [(kr, kr)]):
        assert p0 < p1 == q0
        assert split == 1 or (p0 % tfp.SPLIT_UNIT == 0
                              and p1 % tfp.SPLIT_UNIT == 0)
    owned = [j for p0, p1 in slices for j in tfp.slice_hidden(kr, bits, p0,
                                                               p1)]
    assert sorted(owned) == list(range(h))
    for bw in (128, 256, 512, 1024, 2048):
        if h % bw == 0:
            assert max(owned) // bw < h // bw
    assert tfp.split_smem(bits, 512, kr, 512, split, 4, 2) <= tfp.SMEM_BYTES


def test_split_plan_fills_the_card_at_decode_only():
    """At 132 SMs the LM decode step (64 tokens x top-2 on 32 experts of
    capacity 16; 32 tokens at capacity 8) takes 4-row tiles and the most
    slices whose expected live tiles fit in one wave of two blocks an SM;
    the MoE decode step, whose live tiles fill 2/3 of a wave, two; a
    prefill chunk (16,384 routed rows, 32 x 32 live tiles of 16 rows) is
    not split; a pinned split is kept; where 16 rows do not fit, fewer do;
    with no routed count every row counts as live."""
    lm = dict(bits=4, k=1024, kr=1024, n=1024, e=32, itemsize=2, sms=132)
    wave = tfp.BLOCKS_PER_SM * 132
    for c, routed, want in ((16, 128, 6), (8, 64, 8)):
        split, rows = tfp.split_plan(c=c, routed=routed, **lm)
        tiles = tfp.live_tiles(32, c, routed, 4)
        assert (split, rows) == (want, 4)
        assert tiles * split <= wave < tiles * (split + 1)
    assert tfp.split_plan(c=8192, routed=16384, **lm) == (1, 16)
    assert tfp.split_plan(c=8192, **lm) == (1, 16)
    assert tfp.split_plan(c=16, routed=128, split=3, **lm) == (3, 4)
    assert tfp.split_plan(c=8192, split=2, **lm) == (2, 16)
    assert tfp.split_plan(c=16, **lm) == (2, 4)       # 128 live tiles
    # the MoE server's decode step (512 routed rows on 128 experts): its
    # plan does not turn on the capacity, only on the rows
    moe = dict(bits=4, k=2048, kr=1024, n=2048, e=128, itemsize=2, sms=132)
    for c in (32, 33, 48):
        assert tfp.split_plan(c=c, routed=512, **moe) == (2, 4)
    # float32 at K = H = 2048 and S = 1: 16 rows of x and hidden do not fit
    assert tfp.split_plan(c=8192, **dict(moe, itemsize=4)) == (1, 8)
    # kr not a multiple of SPLIT_UNIT: never split
    assert tfp.max_split(48) == 1
    assert tfp.split_plan(bits=8, k=48, kr=48, n=48, e=1, c=4, itemsize=4,
                          sms=132) == (1, 4)


@pytest.mark.parametrize("e,c,routed", [
    (32, 16, 128), (32, 8, 64), (128, 32, 512), (128, 16, 256),
    (32, 8192, 16384), (4, 20, 3), (1, 8, 5)])
def test_live_tiles_is_the_mean_of_random_routings(e, c, routed):
    """The live tiles `split_plan` expects from a routed count are the mean
    over random routings of that many rows (numpy multinomial draws, the
    row counts clipped at the capacity), within 2%, for 4- and 16-row
    tiles."""
    rng = np.random.default_rng(e + c + routed)
    draws = np.minimum(rng.multinomial(routed, [1 / e] * e, size=4000), c)
    for rows in (4, 16):
        mean = float((-(-draws // rows)).sum(axis=1).mean())
        got = tfp.live_tiles(e, c, routed, rows)
        assert abs(got - mean) <= 0.02 * mean + 1e-9, (rows, got, mean)
    assert tfp.live_tiles(e, c, None, 4) == e * -(-c // 4)
    assert tfp.live_tiles(e, c, 0, 4) == 0


def test_wrappers_check_split_and_vec_on_the_cpu():
    """A split outside [1, Kr / SPLIT_UNIT] raises on the CPU too; the load
    width is the kernel's own choice (no `vec` argument); a pinned split
    or a routed count runs the twin there."""
    x, jst = _inputs("ffn", 4, 256, "float32")
    st = convert.from_jax_params(jst, "cpu")
    for fn in (tfp.fused_ffn_quant, tfp.fused_swiglu_quant):
        if fn is tfp.fused_swiglu_quant:
            x, jst = _inputs("swiglu", 4, 256, "float32")
            st = convert.from_jax_params(jst, "cpu")
        xt = torch.from_numpy(x)
        with pytest.raises(ValueError, match="split must be in"):
            fn(xt, st, split=5)                  # Kr = 128: at most 4
        with pytest.raises(ValueError, match="split must be in"):
            fn(xt, st, split=0)
        with pytest.raises(TypeError, match="vec"):
            fn(xt, st, vec=4)
        before = fn.launches
        fn(xt, st, split=4, routed=9)            # the twin, no launch
        assert fn.launches == before


# -- the split's arithmetic against the twins and the Pallas kernels ---------

@functools.lru_cache(maxsize=None)
def _inputs(kind, bits, h, dtype):
    """(x as float32 numpy, JAX stream) for one case, from a seed."""
    rng = np.random.default_rng(bits * 1000 + h + (kind == "swiglu"))
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    shapes = ((E, K, h), (E, h, N)) if kind == "ffn" else \
        ((E, K, h), (E, K, h), (E, h, N))
    ws = [jq.quantize(jnp.asarray(
        rng.standard_normal(s).astype(np.float32) * 0.05), bits)
        for s in shapes]
    if kind == "swiglu":
        return x, jfp.prepare_fused_swiglu(*ws, bw=BW)
    b1 = jnp.asarray(rng.standard_normal((E, h)).astype(np.float32) * 0.1)
    b2 = jnp.asarray(rng.standard_normal((E, N)).astype(np.float32) * 0.1)
    return x, jfp.prepare_fused_ffn(*ws, b1, b2, bw=BW)


@functools.lru_cache(maxsize=None)
def _pallas(kind, bits, h, dtype):
    """The JAX kernel's output in interpret mode, as float32 numpy."""
    x, jst = _inputs(kind, bits, h, dtype)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    if kind == "ffn":
        out = jfp.fused_ffn_quant(xj, jst, jnp.asarray(COUNTS),
                                  activation_fn=jax.nn.gelu, interpret=True)
    else:
        out = jfp.fused_swiglu_quant(xj, jst, jnp.asarray(COUNTS),
                                     interpret=True)
    return np.asarray(out, np.float32)


def _emulate_split(x, st, counts, split, swiglu):
    """What K2 (gelu, biases) or K4 (silu) computes with `split` slices:
    per slice the hidden columns it owns, rounded to x's dtype where the
    kernel rounds them, times the down projection's rows for those
    columns in float32; then the partials summed in slice order, scaled
    (and biased) once, rounded, rows past counts zeroed."""
    t1, t2, kr, bits = st.t1, st.t2, st.kr, st.bits
    q = tfp._unpacked(st).float()
    xp = tfp.relayout_x(x, bits, kr).float()
    w1, sb1 = tfp._tiles(st, q, 0, t1)
    if swiglu:
        w2, sb2 = tfp._tiles(st, q, t1, 2 * t1)
        wd, sbd = tfp._tiles(st, q, 2 * t1, 2 * t1 + t2)
    else:
        wd, sbd = tfp._tiles(st, q, t1, t1 + t2)
    total = None
    for p0, p1 in tfp.split_slices(kr, split):
        j = torch.tensor(tfp.slice_hidden(kr, bits, p0, p1))
        y1 = torch.bmm(xp, w1[:, :, j]) * sb1[:, 0:1, j]
        if swiglu:
            h = activations.silu(y1).to(x.dtype)
            y2 = torch.bmm(xp, w2[:, :, j]) * sb2[:, 0:1, j]
            h = (h.float() * y2).to(x.dtype)
        else:
            h = activations.gelu(y1 + sb1[:, 1:2, j]).to(x.dtype)
        part = torch.bmm(h.float(), wd[:, j, :])
        total = part if total is None else total + part
    out = total * sbd[:, 0:1]
    if not swiglu:
        out = out + sbd[:, 1:2]
    return tfp._live_out(out[..., :st.n], counts, x.dtype)


def _live_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    live = np.arange(C)[None, :, None] < COUNTS[:, None, None]
    scale = np.max(np.abs(np.where(live, ref, 0)))
    assert scale > 0
    return np.max(np.where(live, np.abs(got - ref), 0)) / scale


CASES = [(bits, h, split) for bits in (4, 8) for h in (K, 2 * K, 4 * K)
         for split in SPLITS if split <= tfp.max_split(_packed_rows(bits, h))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,h,split", CASES)
@pytest.mark.parametrize("kind", ["ffn", "swiglu"])
def test_split_matches_twin_and_pallas(kind, bits, h, split, dtype):
    x, jst = _inputs(kind, bits, h, dtype)
    st = convert.from_jax_params(jst, "cpu")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    counts = torch.from_numpy(COUNTS)
    got = _emulate_split(xt, st, counts, split, kind == "swiglu")
    if kind == "ffn":
        twin = tfp.fused_ffn_quant_reference(xt, st, counts, activations.gelu)
    else:
        twin = tfp.fused_swiglu_quant_reference(xt, st, counts)
    assert got.dtype == twin.dtype == xt.dtype
    assert got.shape == (E, C, N)
    got, twin = got.float().numpy(), twin.float().numpy()
    assert _live_err(got, twin) <= TOL[dtype]
    assert _live_err(got, _pallas(kind, bits, h, dtype)) <= TOL[dtype]
    assert _live_err(twin, _pallas(kind, bits, h, dtype)) <= TOL[dtype]
    dead = np.arange(C)[None, :, None] >= COUNTS[:, None, None]
    assert not np.any(np.where(dead, got, 0))
