"""The CUDA kernels K6 (`decode_attn`), K7 (`prefill_attn`) and K8
(`write_step`) against their plain PyTorch twins on the GPU, and the LM
serving engine on the GPU against the same engine on the CPU.

These tests need an NVIDIA GPU and nvcc and skip without them (a CUDA
kernel has no CPU mode). This file imports no JAX; on a machine without
JAX run it as `python -m pytest --noconftest tests/test_torch_attn_gpu.py`.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from tutel_tpu_torch.csrc import build
from tutel_tpu_torch.models import TransformerMoE, TransformerMoEConfig
from tutel_tpu_torch.ops import decode_attn as da
from tutel_tpu_torch.ops import kv_write, quant
from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _cache(g, b, t, kvh, hd, mode, dtype, dev):
    """(k, v, k_scale, v_scale) in the cache's stored form."""
    def one():
        x = torch.randn(b * t, kvh, hd, generator=g, device=dev)
        if mode == "float":
            return x.reshape(b, t, -1).to(dtype), None
        fn = (TransformerMoE._kv_quantize if mode == "int8"
              else TransformerMoE._kv_quantize4)
        vals, s = fn(x)
        return (vals.reshape(b, t, -1).contiguous(),
                s.reshape(b, t, kvh).transpose(1, 2).contiguous())
    (k, ks), (v, vs) = one(), one()
    return k, v, ks, vs


MODES = ["float", "int8", "int4"]


# splits of the 10-tile window: one slice; two, so pos 257 ends mid-slice
# (and mid-tile); ten, so rows at pos 0, 31 and 32 leave most slices empty
@pytest.mark.parametrize("split", [1, 2, 10])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("nh,kvh,hd", [(8, 2, 128), (4, 4, 64), (2, 1, 256),
                                       (6, 2, 64),        # 3 heads, padded to 4
                                       (6, 3, 64),        # INT4: a group
                                       (16, 2, 128),      # straddles halves;
                                       (8, 1, 256)])      # 8 heads a group
def test_decode_attn_kernel_matches_twin(cuda, mode, dtype, fresh, nh, kvh,
                                         hd, split):
    g = torch.Generator(device=cuda).manual_seed(hd + nh)
    b, t = 5, 320
    q = torch.randn(b, nh, hd, generator=g, device=cuda).to(dtype)
    k, v, ks, vs = _cache(g, b, t, kvh, hd, mode, dtype, cuda)
    pos = torch.tensor([0, 31, 32, 257, 299], device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, attn_len=300,
              kv_bits=4 if mode == "int4" else 8)
    if fresh:
        kn, vn, kns, vns = _cache(g, b, 1, kvh, hd, mode, dtype, cuda)
        kw.update(k_new=kn[:, 0].contiguous(), v_new=vn[:, 0].contiguous(),
                  k_new_scale=None if kns is None else kns[..., 0].contiguous(),
                  v_new_scale=None if vns is None else vns[..., 0].contiguous())
    before = da.decode_attn.launches
    got = da.decode_attn(q, k, v, pos, split=split, **kw)
    again = da.decode_attn(q, k, v, pos, split=split, **kw)
    torch.cuda.synchronize()
    assert da.decode_attn.launches == before + 2
    assert da.decode_attn.last_split == split
    assert torch.equal(got, again)                  # bitwise repeatable
    ref = da.decode_attn_reference(q, k, v, pos, **kw)
    assert got.dtype == dtype and _rel_err(got, ref) <= TOL[dtype]


def test_decode_attn_plan_at_the_lm_shape(cuda):
    """At the LM decode shape the plan splits the window (64 rows x 2 KV
    groups do not fill the card) and the split result agrees with S = 1
    and with the twin."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, nh, kvh, hd, t = 64, 8, 2, 128, 2048
    q = torch.randn(b, nh, hd, generator=g, device=cuda).to(torch.bfloat16)
    k, v, ks, vs = _cache(g, b, t, kvh, hd, "int8", torch.bfloat16, cuda)
    pos = torch.randint(0, t, (b,), generator=g, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, attn_len=t)
    assert da.residency("int8", torch.bfloat16, kvh, hd, 4,
                        cuda.index or 0) >= 1
    assert da.split_for(b, kvh, t, hd, 4, "int8", torch.bfloat16,
                        cuda.index or 0) > 1
    got = da.decode_attn(q, k, v, pos, **kw)
    assert da.decode_attn.last_split == da.split_for(
        b, kvh, t, hd, 4, "int8", torch.bfloat16, cuda.index or 0)
    one = da.decode_attn(q, k, v, pos, split=1, **kw)
    ref = da.decode_attn_reference(q, k, v, pos, **kw)
    assert _rel_err(got, ref) <= TOL[torch.bfloat16]
    assert _rel_err(got, one) <= TOL[torch.bfloat16]


def test_decode_attn_sass_has_no_convergence_instructions(cuda):
    """Every K6 instance's shuffles run on a warp the compiler proved
    converged: no WARPSYNC or ENDCOLLECTIVE in the SASS."""
    build.load("decode_attn")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(
        "decode_attn"))], capture_output=True, text=True, check=True).stdout
    assert "decode_attn_kernel" in sass and "decode_attn_merge" in sass
    assert "WARPSYNC" not in sass and "ENDCOLLECTIVE" not in sass


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh,hd,tq,start", [
    (8, 2, 128, 128, 256), (6, 2, 64, 37, 0), (4, 4, 256, 16, 100)])
def test_prefill_attn_kernel_matches_twin(cuda, mode, dtype, nh, kvh, hd, tq,
                                          start):
    g = torch.Generator(device=cuda).manual_seed(tq + start)
    b, t = 3, 512
    q = torch.randn(b, tq, nh, hd, generator=g, device=cuda).to(dtype)
    k, v, ks, vs = _cache(g, b, t, kvh, hd, mode, dtype, cuda)
    kw = dict(k_scale=ks, v_scale=vs, attn_len=start + tq + 70,
              kv_bits=4 if mode == "int4" else 8)
    before = da.prefill_attn.launches
    got = da.prefill_attn(q, k, v, start, **kw)
    torch.cuda.synchronize()
    assert da.prefill_attn.launches == before + 1
    ref = da.prefill_attn_reference(q, k, v, start, **kw)
    assert got.dtype == dtype and _rel_err(got, ref) <= TOL[dtype]


# bfloat16 queries run the tensor-core kernel: cases at its tile edges
# (64 query rows, K/V tiles of 64 positions, 32 at HD 256)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,nh,kvh,hd,tq,start,t,q_scale", [
    (3, 4, 4, 128, 64, 200, 512, 1.0),      # mq = 1 (nh == kvh)
    (2, 16, 2, 128, 40, 77, 512, 1.0),      # mq = 8: 8 positions a tile
    (3, 8, 2, 128, 1, 0, 512, 1.0),         # one query at position 0
    (2, 8, 2, 128, 128, 1536, 2048, 1.0),   # a window of 26 tiles
    (3, 8, 2, 128, 128, 256, 512, 8.0),     # large scores: online rescale
    (2, 8, 2, 64, 100, 300, 512, 1.0),      # HD 64
    (2, 4, 2, 256, 50, 130, 512, 1.0),      # HD 256
    (2, 3, 1, 128, 20, 90, 512, 1.0),       # one group: INT4 spans both nibbles
], ids=["mq1", "mq8", "tq1_start0", "long_window", "q_x8", "hd64", "hd256",
        "kvh1_mq3"])
def test_prefill_attn_kernel_matches_twin_bf16(cuda, mode, b, nh, kvh, hd,
                                               tq, start, t, q_scale):
    g = torch.Generator(device=cuda).manual_seed(7 * tq + start + hd)
    q = (torch.randn(b, tq, nh, hd, generator=g, device=cuda)
         * q_scale).to(torch.bfloat16)
    k, v, ks, vs = _cache(g, b, t, kvh, hd, mode, torch.bfloat16, cuda)
    kw = dict(k_scale=ks, v_scale=vs, attn_len=min(t, start + tq + 70),
              kv_bits=4 if mode == "int4" else 8)
    before = da.prefill_attn.launches
    got = da.prefill_attn(q, k, v, start, **kw)
    torch.cuda.synchronize()
    assert da.prefill_attn.launches == before + 1
    ref = da.prefill_attn_reference(q, k, v, start, **kw)
    assert got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, ref) <= TOL[torch.bfloat16]


def test_prefill_attn_library_runs_on_tensor_cores(cuda):
    """The built K7 library holds HMMA instructions (the bf16 kernel's
    mma.sync), read from its SASS with cuobjdump."""
    lib = build.library_path("prefill_attn")
    build.load("prefill_attn")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    assert sass.count("HMMA") > 0


def test_decode_attn_rejects_mismatched_shapes(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    b, t, nh, kvh, hd = 4, 64, 4, 2, 64
    q = torch.randn(b, nh, hd, generator=g, device=cuda)
    k, v, ks, vs = _cache(g, b, t, kvh, hd, "int8", torch.float32, cuda)
    kn, vn, kns, vns = _cache(g, b, 1, kvh, hd, "int8", torch.float32, cuda)
    pos = torch.full((b,), 10, device=cuda)
    kw = dict(k_scale=ks, v_scale=vs, k_new=kn[:, 0].contiguous(),
              v_new=vn[:, 0].contiguous(),
              k_new_scale=kns[..., 0].contiguous(),
              v_new_scale=vns[..., 0].contiguous())
    with pytest.raises(ValueError, match="rows"):
        da.decode_attn(q[:2], k, v, pos[:2], **kw)
    with pytest.raises(ValueError, match="pos must be"):
        da.decode_attn(q, k, v, pos[:3], **kw)
    with pytest.raises(ValueError, match="fresh row scales"):
        da.decode_attn(q, k, v, pos, **{**kw, "v_new_scale": kns[:3, :, 0]})
    # each check of the one pass raises its own message
    strided = k.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="k: expected a contiguous"):
        da.decode_attn(q, strided, v, pos, **kw)
    with pytest.raises(ValueError, match="v_scale: expected a contiguous"):
        da.decode_attn(q, k, v, pos, **{**kw, "v_scale": vs.cpu()})
    with pytest.raises(ValueError, match="k_new: expected a contiguous"):
        da.decode_attn(q, k, v, pos, **{**kw, "k_new": kw["k_new"].float()})
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        da.decode_attn(shifted, k, v, pos, **kw)
    # pos may lie on the host or be int64: the wrapper converts it
    want = da.decode_attn(q, k, v, pos, **kw)
    assert torch.equal(da.decode_attn(q, k, v, pos.cpu(), **kw), want)


def test_kv_write_kernel_is_exact(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, t = 6, 64
    rows_c = [torch.randint(-100, 100, (b, t, 256), generator=g, device=cuda,
                            dtype=torch.int8),
              torch.randn(b, t, 96, generator=g, device=cuda).to(torch.bfloat16),
              torch.randint(-100, 100, (b, t, 3), generator=g, device=cuda,
                            dtype=torch.int8)]
    rows = [torch.ones(b, c.shape[2], device=cuda).to(c.dtype) * 7
            for c in rows_c]
    cols_c = [torch.randn(b, 2, t, generator=g, device=cuda)]
    cols = [torch.full((b, 2), 9.0, device=cuda)]
    pos = torch.tensor([0, 1, 31, 63, 64, -1], device=cuda)   # 2 dropped
    want_r = [c.clone() for c in rows_c]
    want_c = [c.clone() for c in cols_c]
    kv_write.write_step_reference(want_r, rows, pos, want_c, cols)
    before = kv_write.write_step.launches
    kv_write.write_step(rows_c, rows, pos, col_caches=cols_c, cols=cols)
    torch.cuda.synchronize()
    assert kv_write.write_step.launches == before + 1
    for got, want in zip(rows_c + cols_c, want_r + want_c):
        assert torch.equal(got, want)


def _write_case(g, b, t, dev):
    """Two layers' K, V int8 row caches, their f32 scale columns, fresh
    rows and positions (two dropped: past the end and negative)."""
    rows_c = [torch.randint(-100, 100, (b, t, 256), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(4)]
    cols_c = [torch.randn(b, 2, t, generator=g, device=dev) for _ in range(4)]
    rows = [torch.randint(-100, 100, (b, 256), generator=g, device=dev,
                          dtype=torch.int8) for _ in range(4)]
    cols = [torch.randn(b, 2, generator=g, device=dev) for _ in range(4)]
    pos = torch.tensor([0, 5, 31, t - 1, t, -1], device=dev,
                       dtype=torch.int32)
    return rows_c, cols_c, rows, cols, pos


def test_prepared_kv_writer_matches_twin(cuda):
    """K8 through a prepared writer over two steps, exact against
    write_step_reference; a cache set reallocated between steps is not the
    writer's, and the model's flush prepares again for it."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, t = 6, 64
    rows_c, cols_c, rows, cols, pos = _write_case(g, b, t, cuda)
    want_r = [c.clone() for c in rows_c]
    want_c = [c.clone() for c in cols_c]
    writer = kv_write.prepare(rows_c, cols_c)
    before = kv_write.write_step.launches
    for step in range(2):
        kv_write.write_step_reference(want_r, rows, pos, want_c, cols)
        writer(rows, pos, cols)
        pos = pos + 1
        rows = [r + 1 for r in rows]
    torch.cuda.synchronize()
    assert kv_write.write_step.launches == before + 2
    for got, want in zip(rows_c + cols_c, want_r + want_c):
        assert torch.equal(got, want)
    new_r, new_c, rows, cols, pos = _write_case(g, b, t, cuda)
    assert writer.matches(rows_c, cols_c)
    assert not writer.matches(new_r, new_c)
    model = TransformerMoE(TransformerMoEConfig(
        vocab_size=97, max_len=t, model_dim=256, num_heads=2,
        num_kv_heads=2, num_layers=2, ffn_hidden=512, moe_every=0,
        kv_bits=8), device=cuda)
    for rc, cc in ((rows_c, cols_c), (new_r, new_c), (rows_c, cols_c)):
        cache = [{"k": rc[2 * i], "v": rc[2 * i + 1], "k_s": cc[2 * i],
                  "v_s": cc[2 * i + 1]} for i in range(2)]
        pend = [{"rows": (rows[2 * i], rows[2 * i + 1]),
                 "cols": (cols[2 * i], cols[2 * i + 1])} for i in range(2)]
        want_r = [c.clone() for c in rc]
        want_c = [c.clone() for c in cc]
        kv_write.write_step_reference(want_r, rows, pos, want_c, cols)
        model._flush_kv_writes(cache, pend, pos)
        torch.cuda.synchronize()
        assert model._kv_writer.matches(rc, cc)
        for got, want in zip(rc + cc, want_r + want_c):
            assert torch.equal(got, want)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_lm_engine_on_gpu_matches_cpu(cuda, kv_bits):
    """Greedy tokens of the whole serving path (K2, K6, K7, K8 on the card;
    the twins on the CPU), float32."""
    cfg = TransformerMoEConfig(
        vocab_size=97, max_len=256, model_dim=256, num_heads=2,
        num_kv_heads=1, num_layers=2, ffn_hidden=512, moe_every=2,
        num_local_experts=4, top_k=2, capacity_factor=0.0,
        expert_hidden=512, kv_bits=kv_bits)
    cpu_model = TransformerMoE(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    moe = params["blocks"][1]["moe"]
    moe["experts"] = quant.quantize_expert_params(moe["experts"], 4)
    gpu_model = TransformerMoE(cfg, device=cuda)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 97, n).astype(np.int32)
               for n in (5, 130, 77, 20, 9)]
    outs = []
    for model, p in ((cpu_model, params), (gpu_model, to(params, cuda))):
        eng = LmDecodeEngine(model, p, max_batch=4, speculative_capacity=2.0)
        outs.append(eng.run([LmRequest(uid=i, prompt=pr, max_new_tokens=12)
                             for i, pr in enumerate(prompts)], chunk=4))
    for uid, toks in outs[0].items():
        assert outs[1][uid].tolist() == toks.tolist(), uid
