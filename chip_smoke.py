#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (tutel_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from csrc/*.cu with nvcc, and the sources
     the runtime kernels of step 4 generate, all at once, timed; beside
     them K7's source once more with -Xptxas -v (registers, spills and
     shared memory of each template instance), and counts the
     tensor-core instructions (HMMA, HGMMA) in K7's library with
     cuobjdump -sass, failing if there are none; and for K1 (HMMA), K3 and
     K5 (IMMA) the same count per kernel instance and the instructions a
     lane issues per weight byte in each weight loop (gemm_tc_sass);
  3. holds each expert kernel against its plain PyTorch twin on the card
     in bfloat16, and times kernel, twin and a bf16 torch.bmm yardstick
     over the dequantized weights with CUDA events: K1 grouped_gemm_quant
     and K2 fused_ffn_quant at the decode server's shape (128 experts,
     2048 x 2048, INT4, capacity 32, the row counts of 512 routed tokens),
     at the same width with every row live, at a K < H shape, and at the
     LM server's expert shapes (a decode step and a prefill chunk of
     capacity 8192), K1 with the row tile and groups its plan picks from
     the routed rows, its profiled device ms, host microseconds and share
     of the bound, and two calls bitwise equal; K5 grouped_gemm_w8a8 (fc1
     as one GEMM, with the same timings and plan as K1) and K3
     fused_ffn_w8a8 (with its row tile), each held to max abs error 0
     against its twin with two calls bitwise equal, each with its whole
     call's device ms and its kernel's alone (K3 also the device ms of its
     wrapper's quantization of x), at the decode shape in INT4 and INT8,
     with every row
     live, and at K < H in INT8 with gelu; K4 fused_swiglu_quant at the
     SwiGLU LM's expert shapes (32 experts, 1024 x 2048 x 1024, INT4, silu;
     a decode step and a prefill chunk of 16,384 routed rows); K2 and K4
     also with the hidden split and row tile the wrapper chose, their
     profiled device ms per call (the kernel and a split call's combine),
     and a check that two calls are bitwise equal;
  4. holds the runtime kernels against their twins, timed the same way
     beside one PyTorch call: K9 jit.inject_kernel on a tiled x * s + 1
     injected as CUDA source (float32, [256, 128] and [16384, 2048];
     torch.addcmul), and K10 jit.pallas_kernel on squared ReLU and on the
     tanh-GELU formula lifted from torch ops (bfloat16 at the decode
     server's hidden [128, 32, 2048] and an LM prefill chunk's
     [32, 8192, 2048], float32 at [128, 32, 2048]; F.gelu for tanh-GELU),
     each also with its host_us (wall clock per call of 1,000 calls
     without a synchronize) and its library call's device ms and host_us,
     and K10 with its share of the bytes bound on the device; captures
     one K9 and one K10 call in a CUDA graph and replays it on new inputs
     against the twins (jit_graph); then calls the injected kernel on four
     [16384, 2048] inputs as a user would, counting its launches;
  5. serves 512 requests of 8-32 decode steps through MoeDecodeEngine at
     128 experts x 2048 x 2048, top-2, dropless, INT4, bfloat16, batch 256,
     residual_norm (the shape of benchmarks/bench_dropless_decode.py), with
     the fused kernel (auto_fuse=True), then a shorter run on the two-call
     path (auto_fuse=False); then both again with activation_bits=8 (W4A8,
     the w4a8 rows of benchmarks/round5_tpu_sweep.sh), whose fused run may
     launch only K3 and whose two-call run only K5; then 128 requests on
     the two-call path with squared ReLU lifted by jit.pallas_kernel as
     the experts' activation (K1, K10, K1 each step, and nothing else);
     each run counts every kernel's launches; between them one decode
     chunk of the two-call, the W4A8 fused and the W4A8 two-call server at
     256 slots under torch.profiler (moe_profile: device busy ms per step
     and busy share, K1's, K3's or K5's device ms per step and share, the
     top kernels);
  6. checks small engines on the card against the same engines on the CPU
     (INT4 weight-only within 1e-4, also two-call with the lifted squared
     ReLU; W4A8 within 2e-3);
  7. holds the attention kernels K6 decode_attn and K7 prefill_attn and the
     KV-cache write K8 against their twins at the LM server's shapes (64
     rows, 8 heads of 128, 2 KV groups, cache 2048; K6 with fresh rows over
     the whole window, K7 at a 128-query chunk starting at 1536, K8 as one
     step's 16 tensors), in INT8, bfloat16 and INT4 caches, and times each
     with its twin and a PyTorch yardstick (scaled_dot_product_attention,
     the 16 index_put_ calls); K6 also at 8 rows, each with the window
     split S its wrapper picks, its profiled device ms, host microseconds
     per call, share of the bytes bound and two calls bitwise equal; K8
     through the writer prepared for its caches, with device ms and host
     microseconds beside write_step's; K7 also with float32 queries (its
     CUDA-core kernel) over the INT8 cache, and with its achieved TFLOP/s
     and share of the bound;
  8. serves 64 prompts of 1664 tokens, 320 new tokens each, through
     LmDecodeEngine over a TransformerMoE at full width (vocabulary 32768,
     model_dim 1024, 8 heads, 2 KV heads, 4 layers with MoE in 1 and 3, 32
     INT4 experts of 2048, top-2, dropless, INT8 KV cache, bfloat16; the
     round-5 2k serving configuration of benchmarks/bench_lm_serving.py),
     after a short warm-up run, counting each kernel's launches; then
     traces one decode chunk with torch.profiler (device busy share, the
     kernels with the most device time) and one admission and prefill of
     the 64 prompts (K7's and the expert kernel's device time in the
     whole prefill, per launch, the busy share, the top kernels); then the
     same for the same LM with SwiGLU experts (expert_type="llama_ffn", 32
     INT4 experts of 2048), whose serve may launch only K4, K6, K7 and K8;
  9. checks small LM engines on the card against the same engines on the
     CPU (float32; two-layer experts with INT8 and float caches, SwiGLU
     experts with an INT8 cache): the same greedy tokens, and apply_decode
     logits within 1e-4;
 10. trains (slice 3; of the ported kernels only the location scan runs
     there, and each phase checks that no other launched): the helloworld
     trainer of
     tutel_tpu_torch/examples/helloworld.py at the JAX example's default
     width (16 x 512 tokens, model_dim 2048, hidden 2048, 2 experts,
     top-2, float32, capacity_factor 1.0, 10 SGD steps; helloworld_train:
     the losses, which must be finite and fall, the median step ms of the
     last 5 steps, TFLOP/s by the reference's formula, peak memory,
     allow_tf32 and a profiled step); two backward passes of
     fast_encode/fast_decode at that shape (top-1 dropping tokens, and
     top-2), which must give equal bits (dispatch_backward_bitwise); the
     same trainer on the card and on the CPU at model_dim 256, hidden 256,
     4 x 128 tokens, 10 steps (top-1, top-2, dropless top-2, top-2 of 4
     experts), losses within 1e-4 (train_vs_cpu); one TransformerMoE
     loss + backward + SGD(1e-3) step, 6 times (the first a warm-up
     left out of the median), at
     benchmarks/bench_lm_train.py's configuration (vocabulary 32768,
     model_dim 2048, 16 heads, 4 layers, FFN 8192, MoE in 2 of them with 8
     experts of 2048, top-2, capacity_factor 1.25, batch 32 x 512,
     bfloat16; lm_train: ms a step, tokens/s, the share of the 989 TFLOP/s
     bf16 peak by that benchmark's FLOP count, peak memory, a profiled
     step; it fails on a loss or gradient that is not finite); and a small
     float32 LM (2 layers, model_dim 128, vocabulary 512) trained 3 steps
     on the card and on the CPU, losses within 1e-4
     (small_lm_train_vs_cpu);
 11. runs slice 5a (no ported kernel but the location scan on its float
     path): the float decode
     layer (bench_dropless_decode.py --bits 0: 128 experts of 2048 x
     2048, top-2, dropless, 256 tokens, bfloat16) once with megablocks 8
     (two grouped GEMMs, torch._grouped_mm) and once padded (torch.bmm),
     every token within 2e-2, each path's ms and profiled device ms with
     its GEMM share, no K1-K10 launch; the same branch at a small width
     in float32 on the card against the CPU within 1e-5
     (megablocks_decode); then a world-1 NCCL process group from
     MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE through
     system.init_data_model_parallel: every collective of net (and the
     all-to-all's backward) on the card equal to the same call on the CPU
     (net_nccl); the helloworld trainer under the group with
     --parallel_type data, model, auto, adaptive:1 and with
     --a2a_ffn_overlap_degree 2, losses bitwise equal to step 10's
     group-less run, ms a step; one INT4 two-call expert-parallel layer
     forward at the decode shape under the group, K1 launched twice
     (ep_train_world1);
 12. runs slice 5b under the same group: ops.ragged_ep.ragged_ep_forward
     (the layer refuses ragged EP on one rank) with the decode layer's
     INT4 experts, gate and routing (256 tokens), every token within 2e-2
     of the layer's padded dropless forward (K1 two-call), launching K1
     exactly twice, and K2 exactly once with a prepared fused stream, each
     path's event and profiled device ms, and the ragged wrappers of K1
     and K2 against their twins at that exchange's rows
     (ragged_ep_world1); K1 at the decode shape on INT4 weights packed in
     2 and 4 K-blocks against its twin, and a float32 INT4 layer packed
     with sharded_count=2 on the card against the CPU within 1e-4
     (quant_sliced); examples/helloworld_zero.py at its defaults on the
     card against the CPU, losses within 1e-4, and its optimizer state's
     shard shape (zero_world1); the launcher starting the helloworld
     trainer at its default width for 5 steps with --checkpoint_path in a
     process of its own: its printed losses equal the first 5 of step
     10's group-less run, its file equals the same steps' file written
     here bit for bit, two --eval resumes give equal losses, and
     checkpoint.scatter to 2 files and checkpoint.gather back reproduce
     every array bit for bit, with ms a step (launcher_checkpoint); the
     small float32 LM of step 9 built with group= the world-1 group, whose
     engine's greedy tokens equal the group-less LM's (lm_world1); then it
     destroys the group;
 13. prints one JSON line per check and phase, the {"kernels": [...]} line
     (all eleven kernels; the launches of step 12's, step 14's, step
     16's and step 17's path runs added, not those of their kernel
     checks; step 15 launches only the location scan, and its launches
     there are left out), and last
     {"ok": true, "device": {...}};
 14. runs slice 6a under the same world-1 group, after step 12's phases
     and before the group is destroyed: the decode server's INT4 layer
     (128 experts x 2048 x 2048, relu, bfloat16, 256 tokens) with an
     expert-choice gate at capacity_factor 2.0 (C = 4), once on the
     two-call path, which must launch K1 exactly twice, and once on a
     prepared fused stream, which must launch K2 exactly once, each every
     token within 2e-2 of the same forward through the kernels' plain
     twins, two calls bitwise equal, with event and device ms, the
     kernel's share of the device time, the combine's device ms and the
     padded top-2 layer's device ms on the same weights beside it; the
     same layer at a small width in float32 on the card against the CPU
     within 1e-5 (ec_layer); LmDecodeEngine over the round-5 LM2K of
     step 8 built with gate_type="expert_choice" and capacity_factor 2.0
     (moe_overrides capacity_factor 2.0, so the prefill also runs two
     experts a token), 64 prompts of 1664 tokens, 64 new tokens each (cut
     from step 8's 320), which may launch only K2, K6, K7 and K8, with
     tokens/s, prefill_s, ms a decode step, tokens_sha1 and a profiled
     decode chunk (ec_lm_serve); small float32 EC engines on the card
     against the CPU: LmDecodeEngine's greedy tokens identical and
     apply_decode logits within 1e-4, MoeDecodeEngine within 1e-4
     (ec_engines_vs_cpu); examples/helloworld_expert_choice.py at
     helloworld's default width (16 x 512 tokens, 2048 x 2048, 4 experts,
     capacity_factor 2.0, float32, 10 steps; finite, falling losses, ms a
     step, TFLOP/s with 2 for min(k, E), peak memory) and at its defaults
     on the card against the CPU within 1e-4 (ec_train);
     helloworld_pipeline (GPipe) and helloworld_1f1b at one stage
     (model_dim 2048, hidden 2048, 4 experts, batch 4096, n_micro 8, 5
     steps, float32), each one's losses within 1e-5 of the same model
     trained with its microbatches in sequence, ms a step and peak
     memory, 1F1B's loss and gradients within 1e-5 of GPipe's, and a
     stage whose body is local_forward of a top-2 and of an EC layer
     against the sequential run (pipeline_world1);
 15. runs slices 6b and 6c (no ported kernel but the location scan on
     their paths; each phase checks that none of K1-K10 launched) under
     the same world-1 group,
     after step 14's phases and before the group is destroyed, with the
     CPU references computed before the group exists:
     benchmarks/bench_lm_train.py's model (step 10's lm_train, bf16, 32 x
     512 tokens): apply_seqpar at one rank equal to apply bit for bit, the
     per-rank sequence-parallel body forced at P = 1 in both attention
     modes (Ulysses and ring) against apply / loss (Ulysses' logits equal
     to apply's bit for bit; the ring's each token's logits within 2e-2 of
     max |logit|, up to 3% of the tokens past it by bf16 routing flips,
     and each position's median token over the batch within 1e-2, which
     a planted leak of one future key into the last 16 of the 512
     positions must fail; the nll within 1e-3;
     one backward per leaf in float32 with every token at every expert,
     where no top-k choice can flip: the difference's norm within 2e-3 of
     the leaf's, its largest entry within 2e-2 of the leaf's max), ms a
     forward + backward step (median of 5) and peak memory of each mode
     beside loss's (seqpar_world1); the ring's per-step function over 4
     blocks of one sequence of 512 in each rank's ring order, against
     full causal attention at that width (16 heads of 128, and 4 KV
     heads), float32 within 1e-5 and bf16 within 2e-2, forward and the
     gradients of q, k and v (ring_blocks); examples/seqpar_lm.py at its
     defaults, Ulysses and ring with 4 KV heads, losses within 1e-4 of
     the CPU's (seqpar_example); VisionMoE at VisionMoEConfig's defaults
     (32 x 32 x 3 images, patch 4, model_dim 64, 4 layers, MoE in 2 with
     4 experts of 128, top-2, float32) on 256 images for 20 Adam(1e-2)
     steps: finite, falling losses, the first 5 against the CPU's, ms a
     step, peak memory, and its MoE state through scatter_state(., 2) and
     gather_states back into the model bit for bit (vision_train); the
     host library built by g++ against ops/dispatch and ops/routing on
     the card (float32 within 1e-5, locations exact), then
     examples/moe_transformer_lm.py at its defaults (8 x 128 tokens,
     model_dim 128, 4 layers, 4 experts, top-2, 100 AdamW steps):
     falling losses, the first 10 against the CPU's, tokens/s
     (native_lm). Each example's and trainer's losses are held to the
     CPU's within 1e-4;
 16. runs slice 6c's second half under the same world-1 group, after step
     15's phases and before the group is destroyed, with the CPU results
     computed before the group exists (slice6c_cpu_refs); before it, with
     step 7's checks, K6 and K7 at head_dim 16 and 32 against their twins
     (small_head_dim_checks: serving_decode's LM shape, 8 rows, 4 heads of
     16, window 96, in float32, K7 over a 64-query bucket from 0; head_dim
     16 in bfloat16 with each cache; head_dim 32 over INT8), each with its
     ms, device ms, bound and SDPA's ms. Then examples/serving_decode.py
     at its defaults, whose LM decodes through K6, K7 and K8 at head_dim
     16 and which may launch nothing else: every request finishes, the
     MoE engine's final states within 1e-4 of the CPU's, the LM's tokens/s
     and ms a decode step (serving_decode); moe_mnist and moe_cifar10 at
     their defaults (2 epochs) with TF32 off in cuDNN, their epoch-0
     losses at steps 0 and 20 within 1e-4 of the CPU's, the eval
     accuracies, ms a step; helloworld_switch at its defaults, each
     config's output and l_aux within 1e-4 of the CPU's, first-call and
     warm ms; the single-rank trainers at their defaults
     (helloworld_from_scratch, helloworld_custom_gate_expert,
     helloworld_ddp, helloworld_ddp_tutel,
     helloworld_custom_expert_sharded with one expert a rank,
     helloworld_multiprocess; every step's loss within 1e-4 of the CPU's;
     helloworld_amp's bf16 losses within 1e-5 relative, and falling);
     helloworld_multiprocess through the launcher with
     OMPI_COMM_WORLD_SIZE=1 in a process of its own, printing the
     in-process run's losses; all_to_all_v (rows and counts equal to the
     CPU's) and bandwidth_test's GB/s at one rank (a copy on the card, not
     a link); tune_moe on the helloworld layer at its defaults, every
     candidate's output within 1e-5 of the default call's, each
     candidate's ms and the winner (autotune). Every phase but
     serving_decode checks that none of K1-K10 launched;
 17. runs parted under the same world-1 group, after step 16's phases and
     before the group is destroyed (parted_phase): tests/test_parted.py's
     MLP graph at helloworld's default width (x [8192, 2048], w1 and w2
     [2048, 2048], float32) with K10's squared ReLU as its activation
     node; optimize() returns the default plan; the default and five
     forced plans (data-parallel, the K-split FAR, ZERO, A2A + FAR, RS +
     AG) each list their collectives, issue them through NCCL, hold the
     output within 1e-4 of the graph as one plain torch chain on the card,
     launch K10 once a call and nothing else, and time execute()'s ms a
     step beside the chain's; then optimize(measure=True, top_k=3), its
     times sorted and positive (tools/parted_phases.py adds a profile).

Every top-k routing on the card (each MoE layer call, the dropless and
serving capacity probes) launches the location scan, `route_locations`
(ops/routing.py compute_locations; one kernel up to 4,096 routings,
three above): each phase above that routes counts its launches among
the kernels it must launch, and where a phase "may launch only" some
kernels, or none, the scan is the exception. After step 7's checks it is
held against its plain twin at the main path's routes (serve_decode's
2 x 512 over 8 experts, moe_train's 8 x 65,536 over 64), bit-exact,
with its ms, device ms, host us and bytes bound (check_route_locations);
moe_profile reads its launches and device ms a step.

Every failed check raises, so the script exits non-zero and prints no "ok"
line; without a GPU it exits non-zero at once.
"""

import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tutel_tpu_torch import jit, moe, system  # noqa: E402
from tutel_tpu_torch.csrc import build  # noqa: E402
from tutel_tpu_torch.examples import helloworld  # noqa: E402
from tutel_tpu_torch.models import TransformerMoE  # noqa: E402
from tutel_tpu_torch.models import TransformerMoEConfig  # noqa: E402
from tutel_tpu_torch.models import VisionMoE, VisionMoEConfig  # noqa: E402
from tutel_tpu_torch.models import transformer  # noqa: E402
from tutel_tpu_torch.ops import activations, fused_ffn, quant, w8a8  # noqa: E402
from tutel_tpu_torch.ops import decode_attn as da  # noqa: E402
from tutel_tpu_torch.ops import grouped_gemm_quant as gq  # noqa: E402
from tutel_tpu_torch.ops import dispatch, kv_write, routing  # noqa: E402
from tutel_tpu_torch.serving import LmDecodeEngine, LmRequest  # noqa: E402
from tutel_tpu_torch.serving import MoeDecodeEngine, Request  # noqa: E402
from tutel_tpu_torch.utils import (  # noqa: E402
    sgd_step, tree_leaves, tree_replace)

SEED = 0
BF16_TOL = 2e-2            # max |kernel - twin| / max |twin|, bfloat16
# the same in float32: CUDA's expf/tanhf/erff may differ from PyTorch's by
# an ulp or so
F32_TOL = 1e-5
SMALL_TOL = 1e-4           # GPU engine vs CPU engine, float32
# the W4A8 engine: a last-bit difference of a state between the devices
# can move one int8 activation of a later step by one quantization step
W8A8_TOL = 2e-3
BF16_PEAK = 989e12         # H100 SXM dense bf16 tensor-core FLOP/s
INT8_PEAK = 1979e12        # H100 SXM dense int8 tensor-core OP/s
F32_PEAK = 67e12           # H100 SXM float32 FLOP/s outside the tensor cores
REPS = 20


def hbm_bytes_per_s(name):
    """Data-sheet memory bandwidth of the card named by nvidia-smi."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H100" in name:
        return 3.35e12
    raise RuntimeError(f"no memory bandwidth known for {name!r}")


def median_ms(fn, reps=REPS):
    """Median over `reps` single calls, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls=1000):
    """Wall-clock microseconds per call of `calls` back-to-back calls
    without a synchronize, after a warm-up: what a call costs the host
    (where the device's work per call is longer, the launch queue fills
    and this reads the device's pace instead)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def device_events(fn, reps, enough, what):
    """[(name, ms)] of the device events of `reps` calls, from
    torch.profiler, traced again (up to 4 times) while `enough(events)`
    is false: a trace now and then holds no kernel (two in a row have been
    seen on an H100), or loses some. `what` names the events sought."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                  for e in prof.events() if str(e.device_type).endswith("CUDA")]
        if enough(events):
            return events
        print(json.dumps({"profiler_retry": what,
                          "reason": f"the trace held {len(events)} device "
                                    f"events for {reps} calls"}),
              flush=True)
    raise RuntimeError(f"the profiler saw no launch of {what}")


def whole_calls(reps):
    """`enough` of a trace of whole calls: every call launches the same
    kernels, so it holds a multiple of `reps` of them."""
    return lambda events: events and len(events) % reps == 0


def device_ms(fn, symbol, reps=REPS):
    """Mean device time of the kernels whose name holds `symbol` (per
    launch), or of all the call's kernels with symbol=None (per call), from
    torch.profiler over `reps` calls: the wrapper's host time, which the
    event-timed median_ms includes, is left out."""
    if symbol is None:
        events = device_events(fn, reps, whole_calls(reps), "every kernel")
        return sum(ms for _, ms in events) / reps
    events = device_events(fn, reps, lambda ev: any(
        symbol in name for name, _ in ev), symbol)
    spans = [ms for name, ms in events if symbol in name]
    return sum(spans) / len(spans)


def start_ptxas(name="prefill_attn"):
    """Start nvcc on csrc/<name>.cu once more with -Xptxas -v (into a
    library of its own, beside the real build); ptxas_report reads it."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"{name}-ptxas.{os.getpid()}.so"
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def instance(mangled):
    """A K7 kernel instance's short name from its mangled symbol:
    prefill_attn_kernel_tc<MODE, HD> or prefill_attn_kernel<float, MODE,
    HD>."""
    args = re.findall(r"Li(\d+)E", mangled)
    if "prefill_attn_kernel_tc" in mangled:
        return f"prefill_attn_kernel_tc<{', '.join(args)}>"
    return f"prefill_attn_kernel<float, {', '.join(args)}>"


def ptxas_report(started):
    """Registers and spill bytes of each kernel instance, from ptxas -v."""
    proc, out = started
    log, _ = proc.communicate()
    if out.exists():
        out.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{log}")
    report, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = report.setdefault(instance(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            cur = None
    return report


def sass_counts(name="prefill_attn", opcodes=("HMMA", "HGMMA")):
    """Tensor-core instructions in each kernel of a built library, from
    cuobjdump -sass; raises unless every tensor-core instance (and so the
    library) has some."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        counts[instance(part.split(None, 1)[0])] = {
            op: len(re.findall(rf"\b{op}\.", part)) for op in opcodes}
    total = sum(sum(c.values()) for c in counts.values())
    idle = [k for k, c in counts.items()
            if k.startswith("prefill_attn_kernel_tc") and not sum(c.values())]
    if total == 0 or idle:
        raise RuntimeError(f"{name}: no tensor-core instruction in {idle or 'the library'}")
    return {"total": {op: sum(c[op] for c in counts.values())
                      for op in opcodes}, "per_kernel": counts}


def mma_sass(name, stem, op):
    """The SASS of each `stem` kernel instance of csrc/<name>.cu's built
    library (cuobjdump -sass): its count of the tensor-core opcode `op`
    (HMMA, IMMA), and its weight loops, the innermost loops (a branch back
    to an earlier address with no smaller loop inside) that hold `op` and
    a load through the read-only path: their instructions, the bytes those
    loads bring a lane per pass, and the instructions per weight byte.
    Raises unless every instance has `op`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        head = part.split(None, 1)[0]
        if stem not in head:
            continue
        code = [(int(m.group(1), 16), m.group(3), m.group(4)) for m in
                re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                            r"([A-Z][A-Z0-9_.]*)([^;]*);", part)]
        loops = []
        for addr, opc, args in code:
            t = re.search(r"0x([0-9a-f]+)", args)
            if opc.startswith("BRA") and t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        found = []
        for lo, hi in loops:
            if any(lo <= a and b <= hi and (a, b) != (lo, hi)
                   for a, b in loops):
                continue
            body = [opc for a, opc, _ in code if lo <= a <= hi]
            loads = [o for o in body if o.startswith("LDG") and "CONSTANT" in o]
            if not loads or not any(o.startswith(op) for o in body):
                continue
            nbytes = sum(16 if ".128" in o else 8 if ".64" in o else 4
                         for o in loads)
            found.append({"instructions": len(body), "load_bytes": nbytes,
                          "per_weight_byte": len(body) / nbytes,
                          op: sum(o.startswith(op) for o in body)})
        dtype = ("bf16, " if "bfloat16" in head
                 else "f32, " if re.search(r"IfL", head) else "")
        args = ", ".join(re.findall(r"Li(\d+)E", head))
        out[f"{stem}<{dtype}{args}>"] = {
            op: sum(o.startswith(op) for _, o, _ in code),
            "weight_loops": found}
    if not out or any(not v[op] for v in out.values()):
        raise RuntimeError(f"{name}: an instance of {stem} has no {op}")
    return out


def errors(got, ref, counts):
    """(max abs error, max abs error / max |ref|) over rows < counts."""
    live = (torch.arange(ref.shape[1], device=ref.device)[None, :, None]
            < counts.to(ref.device)[:, None, None])
    diff = torch.where(live, (got.float() - ref.float()).abs(), 0.0).max()
    scale = torch.where(live, ref.float().abs(), 0.0).max()
    return float(diff), float(diff / scale)


def bound(moved, ops, bandwidth, peak=BF16_PEAK):
    """The least time for `moved` bytes and `ops` operations, and which of
    the two sets it."""
    by_bytes = moved / bandwidth >= ops / peak
    return {"bytes": moved, "ops": ops,
            "bound_ms": 1e3 * max(moved / bandwidth, ops / peak),
            "bound_by": "bytes" if by_bytes else "operations"}


def split_of(x, stream, routed):
    """The hidden split and row tile K2/K4 choose for x and the stream
    with `routed` rows routed to the experts."""
    e, c, _ = x.shape
    split, rows = fused_ffn.split_plan(
        stream.bits, stream.k, stream.kr, stream.n, e, c, x.element_size(),
        fused_ffn.sm_count(x.device.index), routed=routed)
    return {"split": split, "tile_rows": rows}


K1_DESIGN = ("tensor cores: mma.sync m16n8k16 bf16, the weights as M, "
             "INT4 widened in registers, 4 warps split K, x staged a chunk "
             "at a time")
K3_DESIGN = ("tensor cores: mma.sync m16n8k32 s8, the weights as M, one "
             "block per (expert, row tile), register double buffer")
K5_DESIGN = ("tensor cores: mma.sync m16n8k32 s8, the weights as M, K1's "
             "grid, x quantized per row inside the kernel (one launch), "
             "once for up to 4 strips a block")


def timed_gemm(record, kernel, symbol, plain, bmm, bounds):
    """A grouped GEMM's check with its timings: event ms, device ms (every
    kernel of the call, and the kernel `symbol` alone, from one trace),
    the device events a call and their names, host microseconds (200
    calls without a synchronize), its share of the bound on the device,
    and the plain twin and the bf16 torch.bmm yardstick."""
    events = device_events(kernel, REPS, whole_calls(REPS), "every kernel")
    own = [ms for name, ms in events if symbol in name]
    if not own:
        raise RuntimeError(f"the profiler saw no launch of {symbol}")
    dev = sum(ms for _, ms in events) / REPS
    return {**record, "ms": median_ms(kernel), "device_ms": dev,
            "kernel_device_ms": sum(own) / len(own),
            "kernels_per_call": len(events) / REPS,
            "call_kernels": sorted({name for name, _ in events}),
            "host_us": host_us(kernel, calls=200),
            "plain_ms": median_ms(plain), "bf16_bmm_ms": median_ms(bmm),
            **bounds, "bound_share": bounds["bound_ms"] / dev}


def check_kernels(shape, bandwidth):
    """Both kernels against their twins at one shape; returns two dicts."""
    name, e, c, k, h, n, rows, bias, act = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    w1 = quant.quantize(torch.randn(e, k, h, generator=g, device=dev) * 0.02, 4)
    w2 = quant.quantize(torch.randn(e, h, n, generator=g, device=dev) * 0.02, 4)
    b1 = torch.randn(e, h, generator=g, device=dev) * 0.1 if bias else None
    b2 = torch.randn(e, n, generator=g, device=dev) * 0.1 if bias else None
    stream = fused_ffn.prepare_fused_ffn(w1, w2, b1, b2)
    x = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)
    live_rows = int(counts.sum())
    live_experts = int((counts > 0).sum())
    act_fn = getattr(activations, act)
    out = []

    # K1 on fc1: x [E, C, K] @ W1 [K, H], told the routed rows as the MoE
    # layer tells it (they pick the row tile)
    def k1():
        return gq.grouped_gemm_quant(x, w1, counts, routed=live_rows)
    got, again = k1(), k1()
    ref = gq.grouped_gemm_quant_reference(x, w1, counts)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref, counts)
    if not torch.equal(got, again):
        raise RuntimeError(f"two K1 calls at {name} differ")
    w1_dense = quant.dequantize(w1, torch.bfloat16)
    moved = (live_experts * (w1.values[0].numel() + 4 * h)
             + live_rows * k * 2 + e * c * h * 2 + 4 * e)
    ops = 2 * live_rows * k * h
    out.append(timed_gemm(
        {"name": "grouped_gemm_quant", "shape": name,
         "E": e, "C": c, "K": k, "N": h, "live_rows": live_rows,
         "plan": gq.tc_plan(e, c, live_rows), "design": K1_DESIGN,
         "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": BF16_TOL,
         "bitwise_repeat": True},
        k1, "gmm_quant_kernel",
        lambda: gq.grouped_gemm_quant_reference(x, w1, counts),
        lambda: torch.bmm(x, w1_dense), bound(moved, ops, bandwidth)))
    del w1_dense

    # K2: act(x @ W1 + b1) @ W2 + b2, told the routed rows as the MoE
    # layer tells it (no count is clipped at these shapes)
    def k2():
        return fused_ffn.fused_ffn_quant(x, stream, counts,
                                         activation_fn=act_fn,
                                         routed=live_rows)
    got, again = k2(), k2()
    ref = fused_ffn.fused_ffn_quant_reference(x, stream, counts, act_fn)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref, counts)
    if not torch.equal(got, again):
        raise RuntimeError(f"two K2 calls at {name} differ")
    w1_dense = quant.dequantize(w1, torch.bfloat16)
    w2_dense = quant.dequantize(w2, torch.bfloat16)
    # the bytes K2 must read: fc1's packed rows that meet x (K/2 of Kr),
    # fc2's columns below N, and their scale and bias rows
    weights = (k * h + h * n) // 2 + 8 * (h + n)
    moved = (live_experts * weights + live_rows * k * 2
             + e * c * n * 2 + 4 * e)
    ops = 2 * live_rows * (k * h + h * n)
    out.append({
        "name": "fused_ffn_quant", "shape": name,
        "E": e, "C": c, "K": k, "H": h, "N": n, "live_rows": live_rows,
        "activation": act, "bias": bias, **split_of(x, stream, live_rows),
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": BF16_TOL,
        "bitwise_repeat": True,
        "ms": median_ms(k2), "device_ms": device_ms(k2, None),
        "plain_ms": median_ms(lambda: fused_ffn.fused_ffn_quant_reference(
            x, stream, counts, act_fn)),
        "bf16_bmm_ms": median_ms(lambda: torch.bmm(
            act_fn(torch.bmm(x, w1_dense)), w2_dense)),
        **bound(moved, ops, bandwidth)})
    for r in out:
        if not r["max_rel_err"] <= BF16_TOL:
            raise RuntimeError(f"{r['name']} at {name} disagrees with its "
                               f"twin: {r['max_rel_err']} > {BF16_TOL}")
    return out


def check_w8a8_kernels(shape, bandwidth):
    """K5 (fc1 as one GEMM) and K3 (the whole FFN) against their twins at
    one shape; returns two dicts. Integer products are held to the card's
    int8 peak; the bytes that bound them are the live experts' weights."""
    name, e, c, k, h, n, rows, bias, act, bits = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    w1 = quant.quantize(torch.randn(e, k, h, generator=g, device=dev) * 0.02,
                        bits)
    w2 = quant.quantize(torch.randn(e, h, n, generator=g, device=dev) * 0.02,
                        bits)
    b1 = torch.randn(e, h, generator=g, device=dev) * 0.1 if bias else None
    b2 = torch.randn(e, n, generator=g, device=dev) * 0.1 if bias else None
    stream = fused_ffn.prepare_fused_ffn(w1, w2, b1, b2)
    x = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)
    live_rows = int(counts.sum())
    live_experts = int((counts > 0).sum())
    act_fn = getattr(activations, act)
    base = {"shape": name, "E": e, "C": c, "K": k, "live_rows": live_rows,
            "bits": bits, "tol": BF16_TOL}
    out = []

    # K5 on fc1, told the routed rows as the MoE layer tells it (they pick
    # the row tile); x is quantized inside the kernel
    def k5():
        return w8a8.grouped_gemm_w8a8(x, w1, counts, routed=live_rows)
    got, again = k5(), k5()
    ref = w8a8.grouped_gemm_w8a8_reference(x, w1, counts)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref, counts)
    # the twin's quantization, exact integer sums and the twin's rescales
    if abs_err != 0 or not torch.equal(got, again):
        raise RuntimeError(f"K5 at {name}: max |kernel - twin| {abs_err} "
                           f"(must be 0), or two calls differ")
    w1_dense = quant.dequantize(w1, torch.bfloat16)
    moved = (live_experts * (k * h * bits // 8 + 4 * h) + live_rows * k * 2
             + e * c * h * 2 + 4 * e)
    out.append(timed_gemm(
        {"name": "grouped_gemm_w8a8", **base, "N": h,
         "plan": w8a8.k5_plan(e, c, k, h, bits, fused_ffn.sm_count(0),
                              live_rows), "design": K5_DESIGN,
         "max_abs_err": abs_err, "max_rel_err": rel_err,
         "bitwise_repeat": True},
        k5, "gmm_w8a8_kernel",
        lambda: w8a8.grouped_gemm_w8a8_reference(x, w1, counts),
        lambda: torch.bmm(x, w1_dense),
        bound(moved, 2 * live_rows * k * h, bandwidth, INT8_PEAK)))
    # x is quantized inside the kernel: the call is that one launch
    if out[-1]["kernels_per_call"] != 1:
        raise RuntimeError(f"K5 at {name}: a call launched "
                           f"{out[-1]['call_kernels']}, "
                           f"{out[-1]['kernels_per_call']} a call, not one")

    def k3():
        return fused_ffn.fused_ffn_w8a8(x, stream, counts,
                                        activation_fn=act_fn,
                                        routed=live_rows)
    got, again = k3(), k3()
    ref = fused_ffn.fused_ffn_w8a8_reference(x, stream, counts, act_fn)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref, counts)
    # the integer sums are exact and the rescales the twin's: bit for bit
    if abs_err != 0 or not torch.equal(got, again):
        raise RuntimeError(f"K3 at {name}: max |kernel - twin| {abs_err} "
                           f"(must be 0), or two calls differ")
    w2_dense = quant.dequantize(w2, torch.bfloat16)
    weights = (k * h + h * n) * bits // 8 + 8 * (h + n)  # values, scale, bias
    moved = (live_experts * weights + live_rows * k * 2 + e * c * n * 2
             + 4 * e)
    dev = device_ms(k3, None)
    bounds = bound(moved, 2 * live_rows * (k * h + h * n), bandwidth,
                   INT8_PEAK)
    out.append({
        "name": "fused_ffn_w8a8", **base, "H": h, "N": n,
        "activation": act, "bias": bias,
        "tile_rows": fused_ffn.tile_rows_w8a8(h, e, c, live_rows),
        "design": K3_DESIGN,
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "bitwise_repeat": True,
        "ms": median_ms(k3), "device_ms": dev,
        # the kernel alone, and the wrapper's quantization of x before it
        "kernel_device_ms": device_ms(k3, "fused_w8a8_kernel"),
        "quantize_ms": device_ms(lambda: quant.quantize_activations(x), None),
        "plain_ms": median_ms(lambda: fused_ffn.fused_ffn_w8a8_reference(
            x, stream, counts, act_fn)),
        "bf16_bmm_ms": median_ms(lambda: torch.bmm(
            act_fn(torch.bmm(x, w1_dense)), w2_dense)),
        **bounds, "bound_share": bounds["bound_ms"] / dev})
    for r in out:
        if not r["max_rel_err"] <= BF16_TOL:
            raise RuntimeError(f"{r['name']} at {name} disagrees with its "
                               f"twin: {r['max_rel_err']} > {BF16_TOL}")
    return out


def check_swiglu_kernel(shape, bandwidth):
    """K4 against its twin at one of the SwiGLU LM's expert shapes. Only
    the stream's live bytes bound it: the padding of the W1/W2 tiles past
    K/2 packed rows and of the W3 tiles past N columns is never read."""
    name, e, c, k, h, n, rows, bits = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    ws = [quant.quantize(torch.randn(*s, generator=g, device=dev) * 0.02,
                         bits) for s in ((e, k, h), (e, k, h), (e, h, n))]
    stream = fused_ffn.prepare_fused_swiglu(*ws)
    x = torch.randn(e, c, k, generator=g, device=dev).to(torch.bfloat16)
    counts = torch.tensor(rows, dtype=torch.int32, device=dev)
    live_rows = int(counts.sum())
    live_experts = int((counts > 0).sum())
    def k4():
        return fused_ffn.fused_swiglu_quant(x, stream, counts,
                                            routed=live_rows)
    got, again = k4(), k4()
    ref = fused_ffn.fused_swiglu_quant_reference(x, stream, counts)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref, counts)
    if not torch.equal(got, again):
        raise RuntimeError(f"two K4 calls at {name} differ")
    del ref, again
    dense = [quant.dequantize(w, torch.bfloat16) for w in ws]
    weights = (2 * k * h + h * n) * bits // 8 + 4 * (2 * h + n)
    moved = (live_experts * weights + live_rows * k * 2 + e * c * n * 2
             + 4 * e)
    silu = activations.silu
    r = {"name": "fused_swiglu_quant", "shape": name, "E": e, "C": c, "K": k,
         "H": h, "N": n, "live_rows": live_rows, "bits": bits,
         "bw": stream.bw, **split_of(x, stream, live_rows),
         "max_abs_err": abs_err,
         "max_rel_err": rel_err, "tol": BF16_TOL, "bitwise_repeat": True,
         "ms": median_ms(k4), "device_ms": device_ms(k4, None),
         "plain_ms": median_ms(lambda: fused_ffn.fused_swiglu_quant_reference(
             x, stream, counts)),
         "bf16_bmm_ms": median_ms(lambda: torch.bmm(
             silu(torch.bmm(x, dense[0])) * torch.bmm(x, dense[1]),
             dense[2])),
         **bound(moved, 2 * live_rows * (2 * k * h + h * n), bandwidth)}
    if not rel_err <= BF16_TOL:
        raise RuntimeError(f"fused_swiglu_quant at {name} disagrees with its "
                           f"twin: {rel_err} > {BF16_TOL}")
    return r


# -- the runtime kernels: K9, K10 --------------------------------------------

def scale_source(rows, cols, tile_rows):
    """A user's kernel for K9: `o = x * s[0] + 1` over [rows, cols]
    float32 (test_facade's injected kernel), one tile of tile_rows rows per
    block, 16-byte loads."""
    return f"""
// [thread_extent] blockIdx.x = {rows // tile_rows}
// [thread_extent] threadIdx.x = 256
__global__ void __launch_bounds__(256)
scale_plus_one(const float4* __restrict__ x, const float* __restrict__ s,
               float4* __restrict__ o) {{
  const float k = s[0];
  const long long base = (long long)blockIdx.x * {tile_rows * cols // 4};
  for (int i = threadIdx.x; i < {tile_rows * cols // 4}; i += blockDim.x) {{
    float4 v = x[base + i];
    v.x = v.x * k + 1.f; v.y = v.y * k + 1.f;
    v.z = v.z * k + 1.f; v.w = v.w * k + 1.f;
    o[base + i] = v;
  }}
}}
"""


def scale_plus_one(x, s):
    return x * s[0, 0] + 1


def inject_scale(rows, cols, tile_rows):
    return jit.inject_kernel(scale_source(rows, cols, tile_rows),
                             out_shape=((rows, cols), torch.float32),
                             plain=scale_plus_one)


def check_inject_kernel(f, rows, cols, bandwidth):
    """K9 against its twin: each element read and written once, a multiply
    and an add on it."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    x = torch.randn(rows, cols, generator=g, device="cuda")
    s = torch.full((1, 1), 3.0, device="cuda")
    got, ref = f(x, s), scale_plus_one(x, s)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, ref)
    one = torch.ones((), device="cuda")

    def library():
        return torch.addcmul(one, x, s)
    r = {"name": "inject_kernel", "shape": f"{rows}x{cols}",
         "dtype": "float32", "max_abs_err": abs_err, "max_rel_err": err,
         "tol": F32_TOL, "ms": median_ms(lambda: f(x, s)),
         "device_ms": device_ms(lambda: f(x, s), "scale_plus_one"),
         "host_us": host_us(lambda: f(x, s)),
         "plain_ms": median_ms(lambda: scale_plus_one(x, s)),
         "library_ms": median_ms(library),
         "library_device_ms": device_ms(library, None),
         "library_host_us": host_us(library),
         **bound(2 * x.numel() * 4 + 4, 2 * x.numel(), bandwidth, F32_PEAK)}
    if not err <= F32_TOL:
        raise RuntimeError(f"inject_kernel at {rows}x{cols} disagrees with "
                           f"its twin: {err} > {F32_TOL}")
    return r


def check_pallas_kernel(label, kernel, shape, dtype, bandwidth, library):
    """K10 against its twin fn(x), which rounds after every op where the
    kernel rounds once; one operation per lifted step and element bounds
    it from the arithmetic side."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    x = torch.randn(*shape, generator=g, device="cuda").to(dtype)
    got, ref = kernel(x), kernel.fn(x)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, ref)
    del got, ref
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    r = {"name": "pallas_kernel", "function": label,
         "shape": f"{label}_{str(dtype)[6:]}_{'x'.join(map(str, shape))}",
         "max_abs_err": abs_err, "max_rel_err": err, "tol": tol,
         "ms": median_ms(lambda: kernel(x)),
         "device_ms": device_ms(lambda: kernel(x), "tt_elementwise"),
         "host_us": host_us(lambda: kernel(x)),
         "plain_ms": median_ms(lambda: kernel.fn(x)),
         "library_ms": None, "library_device_ms": None,
         "library_host_us": None,
         **bound(2 * x.numel() * x.element_size(),
                 x.numel() * len(kernel.lifted.steps), bandwidth, F32_PEAK)}
    if library is not None:
        r.update(library_ms=median_ms(lambda: library(x)),
                 library_device_ms=device_ms(lambda: library(x), None),
                 library_host_us=host_us(lambda: library(x)))
    r["bound_share"] = r["bound_ms"] / r["device_ms"]
    if not err <= tol:
        raise RuntimeError(f"pallas_kernel ({label}) at {shape} disagrees "
                           f"with its twin: {err} > {tol}")
    return r


def jit_graph(f, kernel):
    """One K9 call (`f`, [16384, 2048] f32) and one K10 call (`kernel`,
    [128, 32, 2048] bf16) captured in a CUDA graph, then replayed on new
    inputs copied into the captured ones, each against its twin."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 33)
    x = torch.randn(16384, 2048, generator=g, device="cuda")
    s = torch.full((1, 1), 3.0, device="cuda")
    h = torch.randn(128, 32, 2048, generator=g, device="cuda").to(
        torch.bfloat16)
    side = torch.cuda.Stream()     # warm up beside the capture's stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        f(x, s)
        kernel(h)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, z = f(x, s), kernel(h)
    k9 = k10 = 0.0
    for _ in range(2):
        x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        h.copy_(torch.randn(h.shape, generator=g, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        k9 = max(k9, rel_err(y, scale_plus_one(x, s))[1])
        k10 = max(k10, rel_err(z, kernel.fn(h))[1])
    if not (k9 <= F32_TOL and k10 <= BF16_TOL):
        raise RuntimeError(f"a replayed graph disagrees with the twins: "
                           f"K9 {k9}, K10 {k10}")
    return {"phase": "jit_graph", "replays": 2,
            "inject_kernel_max_rel_err": k9, "pallas_kernel_max_rel_err": k10,
            "replay_ms": median_ms(graph.replay),
            "eager_ms": median_ms(lambda: (f(x, s), kernel(h)))}


def decode_layer(activation_bits, activation_fn=None):        # None: relu
    """The decode server's MoE layer (benchmarks/bench_dropless_decode.py):
    128 experts x 2048 x 2048, top-2, dropless, bfloat16; W4A8 with
    activation_bits=8."""
    return moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        model_dim=2048, dtype=torch.bfloat16, device="cuda",
        experts={"type": "ffn", "num_experts_per_device": 128,
                 "hidden_size_per_expert": 2048, "has_fc1_bias": False,
                 "has_fc2_bias": False, "activation_bits": activation_bits,
                 "activation_fn": activation_fn})


def decode_params(layer):
    """Random weights from SEED, the experts' quantized INT4."""
    params = layer.init(torch.Generator(device="cuda").manual_seed(SEED))
    params["experts"] = quant.quantize_expert_params(params["experts"], 4)
    return params


def serve(layer, params, n_requests, steps, auto_fuse, seed):
    """Run requests through a fresh engine and check every output;
    returns (engine, seconds)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    states = torch.randn(n_requests, layer.model_dim, generator=g,
                         device="cuda").to(layer.dtype)
    lengths = np.random.default_rng(seed).integers(steps[0], steps[1] + 1,
                                                   n_requests)
    eng = MoeDecodeEngine(layer, params, max_batch=256, auto_fuse=auto_fuse,
                          state_update="residual_norm")
    reqs = [Request(uid=i, state=states[i], remaining=int(lengths[i]))
            for i in range(n_requests)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finals = eng.run(reqs, chunk=8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if len(finals) != n_requests:
        raise RuntimeError(f"{len(finals)} of {n_requests} requests finished")
    for uid, out in finals.items():
        if out.shape != (layer.model_dim,) or not torch.isfinite(
                out.float()).all():
            raise RuntimeError(f"request {uid}: bad output {out.shape}")
    return eng, seconds


def small_engine_check(activation_bits=0, tol=SMALL_TOL, activation_fn=None,
                       gate=None):
    """A small INT4 engine on the card (kernels) against the same engine on
    the CPU (plain twins), float32, fused and two-call paths; W4A8 with
    activation_bits=8. A lifted activation_fn runs the two-call path only:
    the fused kernels take activation codes. gate: the gate_type (None:
    top-2, dropless)."""
    kw = dict(gate_type=gate or {"type": "top", "k": 2,
                                 "capacity_factor": 0.0},
              experts={"type": "ffn", "num_experts_per_device": 8,
                       "hidden_size_per_expert": 512,
                       "activation_bits": activation_bits,
                       "activation_fn": activation_fn},     # None: relu
              model_dim=256)
    cpu_layer, gpu_layer = (moe.moe_layer(device=d, **kw)
                            for d in ("cpu", "cuda"))
    params = cpu_layer.init(torch.Generator().manual_seed(SEED))
    params["experts"] = quant.quantize_expert_params(params["experts"], 4)
    gpu_params = {"gates": [{"wg": params["gates"][0]["wg"].cuda()}],
                  "experts": {k: v.to("cuda")
                              for k, v in params["experts"].items()}}
    states = np.random.default_rng(SEED).standard_normal((24, 256)).astype(
        np.float32)
    worst = 0.0
    for auto_fuse in (True, False) if activation_fn is None else (False,):
        finals = []
        for layer, p in ((cpu_layer, params), (gpu_layer, gpu_params)):
            eng = MoeDecodeEngine(layer, p, max_batch=16, auto_fuse=auto_fuse,
                                  state_update="residual_norm")
            finals.append(eng.run([Request(uid=i, state=states[i],
                                           remaining=2 + i % 3)
                                   for i in range(24)], chunk=2))
        for uid, ref in finals[0].items():
            err = float((finals[1][uid].float() - ref).abs().max()
                        / ref.abs().max())
            worst = max(worst, err)
    if not worst <= tol:
        raise RuntimeError(f"GPU engine (activation_bits={activation_bits}) "
                           f"disagrees with the CPU engine: {worst} > {tol}")
    return worst

# -- the LM serving path: K6, K7, K8 ----------------------------------------

# the LM server's attention shapes (benchmarks/bench_lm_serving.py, 2k)
ATT = dict(b=64, nh=8, kvh=2, hd=128, t=2048)
BYTES_PER_VALUE = {"int8": 1.0, "bfloat16": 2.0, "int4": 0.5, "float32": 4.0}
# serving_decode's LM (examples/serving_decode.py): 8 slots, 4 heads of 16,
# one group a head, a window of 96 positions
ATT_EXAMPLE = dict(b=8, nh=4, kvh=4, hd=16, t=96)


def kv_cache(g, b, t, kvh, hd, mode, deq_dtype=torch.bfloat16):
    """Random K or V cache of b x t rows in the stored form of `mode`:
    (values, scales or None, the same values dequantized to deq_dtype as
    [B, KVH, T, HD])."""
    x = torch.randn(b * t, kvh, hd, generator=g, device="cuda")
    if mode in ("bfloat16", "float32"):
        vals = x.to(getattr(torch, mode))
        return vals.reshape(b, t, -1), None, vals.reshape(
            b, t, kvh, hd).transpose(1, 2)
    fn = (TransformerMoE._kv_quantize if mode == "int8"
          else TransformerMoE._kv_quantize4)
    vals, sc = fn(x)
    ints = vals if mode == "int8" else da.unpack_int4(vals)
    deq = (ints.float().reshape(b * t, kvh, hd) * sc[..., None]).to(
        deq_dtype)
    return (vals.reshape(b, t, -1).contiguous(),
            sc.reshape(b, t, kvh).transpose(1, 2).contiguous(),
            deq.reshape(b, t, kvh, hd).transpose(1, 2))


def rel_err(got, ref):
    diff = float((got.float() - ref.float()).abs().max())
    return diff, diff / float(ref.float().abs().max())


def sdpa_ms(q, k_heads, v_heads, mask, profiled=False):
    """scaled_dot_product_attention over K/V already tiled to the query
    heads (head h reads group h % KVH: `.repeat`, not repeat_interleave);
    with profiled=True (event ms, device ms of all its kernels)."""
    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k_heads, v_heads, attn_mask=mask)
    ms = median_ms(call)
    return (ms, device_ms(call, None)) if profiled else ms


def check_decode_attn(mode, bandwidth, b=ATT["b"], shape=ATT,
                      dtype=torch.bfloat16):
    """K6 with fresh rows over the whole window: every row at pos W - 1;
    two calls must be bitwise equal. `shape` (B aside) and the query type
    default to the LM server's; a float cache is stored in the query's
    type ("bfloat16" or "float32")."""
    nh, kvh, hd, t = (shape[k] for k in ("nh", "kvh", "hd", "t"))
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q = torch.randn(b, nh, hd, generator=g, device="cuda").to(dtype)
    k, ks, kd = kv_cache(g, b, t, kvh, hd, mode, dtype)
    v, vs, vd = kv_cache(g, b, t, kvh, hd, mode, dtype)
    kn, kns, _ = kv_cache(g, b, 1, kvh, hd, mode)
    vn, vns, _ = kv_cache(g, b, 1, kvh, hd, mode)
    pos = torch.full((b,), t - 1, dtype=torch.int32, device="cuda")
    kw = dict(k_scale=ks, v_scale=vs, attn_len=t,
              kv_bits=4 if mode == "int4" else 8, k_new=kn[:, 0].contiguous(),
              v_new=vn[:, 0].contiguous(),
              k_new_scale=None if kns is None else kns[..., 0].contiguous(),
              v_new_scale=None if vns is None else vns[..., 0].contiguous())
    def call():
        return da.decode_attn(q, k, v, pos, **kw)

    got, again = call(), call()
    split = da.decode_attn.last_split          # the S these calls launched
    ref = da.decode_attn_reference(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise RuntimeError(f"decode_attn ({mode}, B={b}): two calls differ")
    abs_err, err = rel_err(got, ref)
    live = b * (t - 1)                       # cache positions read
    per_pos = 2 * kvh * hd * BYTES_PER_VALUE[mode] + (
        0 if mode in ("bfloat16", "float32") else 2 * kvh * 4)
    fresh = 2 * b * (kvh * hd * BYTES_PER_VALUE[mode]
                     + (0 if mode in ("bfloat16", "float32") else 4 * kvh))
    moved = live * per_pos + fresh + 2 * q.numel() * q.element_size() + 4 * b
    ops = 4 * nh * hd * (live + b)
    mask = (torch.arange(t, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    mq = nh // kvh
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    r = {"name": "decode_attn", "cache": mode, "dtype": str(dtype)[6:],
         "B": b, "NH": nh, "KVH": kvh,
         "HD": hd, "W": t, "fresh": True, "split": split,
         "max_abs_err": abs_err, "max_rel_err": err, "tol": tol,
         "bitwise_repeat": True, "ms": median_ms(call),
         # every kernel of the call (the main kernel and, split, the merge)
         "device_ms": device_ms(call, None), "host_us": host_us(call),
         "plain_ms": median_ms(
             lambda: da.decode_attn_reference(q, k, v, pos, **kw)),
         **bound(moved, ops, bandwidth,
                 BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK)}
    r["bound_share"] = r["bound_ms"] / r["device_ms"]
    key = ("library_ms" if mode in ("bfloat16", "float32")
           else "sdpa_dequant_ms")
    r[key] = sdpa_ms(q[:, :, None], kd.repeat(1, mq, 1, 1),
                     vd.repeat(1, mq, 1, 1), mask)
    if not err <= tol:
        raise RuntimeError(f"decode_attn ({mode}, HD {hd}) disagrees with "
                           f"its twin: {err} > {tol}")
    return r


def check_prefill_attn(mode, bandwidth, tq=128, start=1536,
                       dtype=torch.bfloat16, shape=ATT):
    """K7 for the last prompt chunk of a 1664-token prefill (by default;
    `shape` and tq / start give others): bfloat16 queries run its
    tensor-core kernel, float32 ones its CUDA-core kernel (held to the
    float32 rate outside the tensor cores)."""
    b, nh, kvh, hd, t = (shape[k] for k in ("b", "nh", "kvh", "hd", "t"))
    w = start + tq
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    q = torch.randn(b, tq, nh, hd, generator=g, device="cuda").to(dtype)
    k, ks, kd = kv_cache(g, b, t, kvh, hd, mode, dtype)
    v, vs, vd = kv_cache(g, b, t, kvh, hd, mode, dtype)
    kw = dict(k_scale=ks, v_scale=vs, attn_len=w,
              kv_bits=4 if mode == "int4" else 8)
    got = da.prefill_attn(q, k, v, start, **kw)
    ref = da.prefill_attn_reference(q, k, v, start, **kw)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, ref)
    per_pos = 2 * kvh * hd * BYTES_PER_VALUE[mode] + (
        0 if mode in ("bfloat16", "float32") else 2 * kvh * 4)
    moved = b * w * per_pos + 2 * q.numel() * q.element_size()
    live = sum(min(w, start + i + 1) for i in range(tq))  # per (b, head)
    ops = 4 * b * nh * hd * live
    mask = (torch.arange(w, device="cuda")[None, :]
            <= start + torch.arange(tq, device="cuda")[:, None])
    mq = nh // kvh
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    ms = median_ms(lambda: da.prefill_attn(q, k, v, start, **kw))
    r = {"name": "prefill_attn", "cache": mode, "dtype": str(dtype)[6:],
         "B": b, "TQ": tq, "start": start, "NH": nh, "KVH": kvh, "HD": hd,
         "W": w, "max_abs_err": abs_err, "max_rel_err": err, "tol": tol,
         "ms": ms, "plain_ms": median_ms(
             lambda: da.prefill_attn_reference(q, k, v, start, **kw)),
         **bound(moved, ops, bandwidth,
                 BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK)}
    r["tflops"] = ops / (ms * 1e-3) / 1e12
    r["bound_share"] = r["bound_ms"] / ms
    # the kernel alone, without the wrapper's host time
    r["device_ms"] = device_ms(lambda: da.prefill_attn(q, k, v, start, **kw),
                               "prefill_attn_kernel")
    r["device_tflops"] = ops / (r["device_ms"] * 1e-3) / 1e12
    key = ("library_ms" if mode == str(dtype)[6:] else "sdpa_dequant_ms")
    r[key], r["sdpa_device_ms"] = sdpa_ms(
        q.transpose(1, 2), kd[:, :, :w].repeat(1, mq, 1, 1),
        vd[:, :, :w].repeat(1, mq, 1, 1), mask, profiled=True)
    if not err <= tol:
        raise RuntimeError(f"prefill_attn ({mode}, {dtype}) disagrees with "
                           f"its twin: {err} > {tol}")
    return r


def small_head_dim_checks(bandwidth):
    """K6 and K7 at head_dim 16 and 32 (step 16), each line with its ms,
    bound and SDPA's time: serving_decode's LM shape in float32 (K7 over a
    64-query prompt bucket from position 0), head_dim 16 in bfloat16 with
    each cache, and head_dim 32 over an INT8 cache."""
    for shape, modes, dtype in (
            (ATT_EXAMPLE, ("float32",), torch.float32),
            (ATT_EXAMPLE, ("bfloat16", "int8", "int4"), torch.bfloat16),
            (dict(ATT_EXAMPLE, hd=32), ("int8",), torch.bfloat16)):
        for mode in modes:
            for r in (check_decode_attn(mode, bandwidth, b=shape["b"],
                                        shape=shape, dtype=dtype),
                      check_prefill_attn(mode, bandwidth, tq=64, start=0,
                                         dtype=dtype, shape=shape)):
                print(json.dumps({"phase": "small_head_dim", **r}),
                      flush=True)
        torch.cuda.empty_cache()


def check_kv_write(bandwidth, layers=4):
    """K8 as one decode step of the LM server: per layer K, V int8
    [64, 2048, 256] and their scales f32 [64, 2, 2048]; exact, through
    write_step and through the writer prepared for the caches (the
    decode step's route), timed through the prepared writer."""
    b, kvh, hd, t = (ATT[k] for k in ("b", "kvh", "hd", "t"))
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows_c = [torch.randint(-127, 128, (b, t, kvh * hd), generator=g,
                            device="cuda", dtype=torch.int8)
              for _ in range(2 * layers)]
    cols_c = [torch.rand(b, kvh, t, generator=g, device="cuda")
              for _ in range(2 * layers)]
    rows = [torch.randint(-127, 128, (b, kvh * hd), generator=g,
                          device="cuda", dtype=torch.int8)
            for _ in range(2 * layers)]
    cols = [torch.rand(b, kvh, generator=g, device="cuda")
            for _ in range(2 * layers)]
    pos = torch.randint(0, t, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    writer = kv_write.prepare(rows_c, cols_c)
    diff = 0.0
    for write in (lambda: kv_write.write_step(rows_c, rows, pos,
                                              col_caches=cols_c, cols=cols),
                  lambda: writer(rows, pos, cols)):
        want_r = [c.clone() for c in rows_c]
        want_c = [c.clone() for c in cols_c]
        kv_write.write_step_reference(want_r, rows, pos, want_c, cols)
        write()
        torch.cuda.synchronize()
        diff = max([diff] + [float((a.float() - w.float()).abs().max())
                             for a, w in zip(rows_c + cols_c,
                                             want_r + want_c)])
        rows = [r + 1 for r in rows]
        cols = [c + 1 for c in cols]
    if diff != 0:
        raise RuntimeError(f"kv_write is not exact: max diff {diff}")
    ids, pl = torch.arange(b, device="cuda"), pos.long()

    def index_put():
        for c, r in zip(rows_c, rows):
            c.index_put_((ids, pl), r)
        for c, s in zip(cols_c, cols):
            c[ids, :, pl] = s

    moved = 2 * sum(r.numel() * r.element_size() for r in rows + cols) + 4 * b
    def step():
        writer(rows, pos, cols)

    return {"name": "kv_write", "tensors": len(rows_c) + len(cols_c),
            "B": b, "max_abs_err": diff, "max_rel_err": diff, "tol": 0.0,
            "ms": median_ms(step), "device_ms": device_ms(step, None),
            "host_us": host_us(step),
            "write_step_ms": median_ms(lambda: kv_write.write_step(
                rows_c, rows, pos, col_caches=cols_c, cols=cols)),
            "write_step_host_us": host_us(lambda: kv_write.write_step(
                rows_c, rows, pos, col_caches=cols_c, cols=cols)),
            "plain_ms": median_ms(lambda: kv_write.write_step_reference(
                rows_c, rows, pos, cols_c, cols)),
            "library_ms": median_ms(index_put),
            "bytes": moved, "ops": 0, "bound_ms": 1e3 * moved / bandwidth,
            "bound_by": "bytes"}


def check_route_locations(bandwidth):
    """The location scan against its plain twin (the int64 one-hot and
    aten's cumsum) at the main path's routes: serve_decode's, K = 2 of 8
    experts over 512 tokens (one tile, one launch), and moe_train's, K = 8
    of 64 over 65,536 (128 tiles, three launches); the ids a transposed
    view of a stable sort of random scores, as extract_critical hands them
    on. Locations and counts bit-exact, two calls equal; its launches a
    call, ms, device ms a call (every kernel of the call), host us and
    share of the bytes bound (ids read, locations and counts written);
    the twin's ms and device ms."""
    out = []
    for label, s, e, k in (("decode", 512, 8, 2), ("train", 65536, 64, 8)):
        g = torch.Generator(device="cuda").manual_seed(SEED + 70)
        scores = torch.rand(s, e, generator=g, device="cuda")
        ids = torch.sort(scores, dim=1, descending=True,
                         stable=True)[1][:, :k].t()

        def scan():
            return routing.compute_locations(ids, e)

        def plain():
            return routing.compute_locations_reference(ids, e)

        reset_launches()
        got = scan()
        n = routing.compute_locations.launches
        twice, want = scan(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(got, want, twice)):
            raise RuntimeError(f"the location scan at {label} [{k} x {s}] "
                               f"x {e}: not equal to its twin, or two "
                               f"calls differ")
        moved = 2 * ids.numel() * 8 + e * 4
        dev = device_ms(scan, None)
        out.append({
            "name": "compute_locations", "shape": label, "S": s, "E": e,
            "K": k, "tiles": routing.scan_tiles(ids), "launches_a_call": n,
            "max_abs_err": 0, "max_rel_err": 0, "tol": 0.0,
            "ms": median_ms(scan), "device_ms": dev, "host_us": host_us(scan),
            "plain_ms": median_ms(plain, reps=5),
            "plain_device_ms": device_ms(plain, None, reps=5),
            "bytes": moved, "ops": 0, "bound_ms": 1e3 * moved / bandwidth,
            "bound_by": "bytes", "bound_share": 1e3 * moved / bandwidth / dev,
            "library_ms": None})
    return out


LM_CONFIG = dict(vocab_size=32768, max_len=2048, model_dim=1024, num_heads=8,
                 num_kv_heads=2, num_layers=4, ffn_hidden=4096, moe_every=2,
                 num_local_experts=32, top_k=2, capacity_factor=0.0,
                 expert_hidden=2048, kv_bits=8)


def lm_params(model, generator):
    """Random LM weights from a seeded generator, experts quantized INT4."""
    params = model.init(generator)
    for blk in params["blocks"]:
        if "moe" in blk:
            blk["moe"]["experts"] = quant.quantize_expert_params(
                blk["moe"]["experts"], 4)
    return params


# every ported kernel's wrapper, which counts its launches
KERNELS = {"grouped_gemm_quant": gq.grouped_gemm_quant,
           "fused_ffn_quant": fused_ffn.fused_ffn_quant,
           "fused_ffn_w8a8": fused_ffn.fused_ffn_w8a8,
           "fused_swiglu_quant": fused_ffn.fused_swiglu_quant,
           "grouped_gemm_w8a8": w8a8.grouped_gemm_w8a8,
           "decode_attn": da.decode_attn, "prefill_attn": da.prefill_attn,
           "kv_write": kv_write.write_step,
           "inject_kernel": jit.inject_kernel,
           "pallas_kernel": jit.pallas_kernel,
           "compute_locations": routing.compute_locations}
# the location scan: every top-k routing on the card launches it (the
# route of each MoE layer call, the dropless and serving probes), so a
# phase that routes lists it among the kernels it must launch; its
# counter counts kernel launches (one a call up to one tile, three above)
ROUTE = "compute_locations"
# K10's functions: squared ReLU (Primer; Nemotron-4) and tanh-GELU written
# from torch ops
SQUARED_RELU = jit.pallas_kernel(lambda v: torch.relu(v) ** 2)
GELU_TANH = jit.pallas_kernel(lambda v: 0.5 * v * (1 + torch.tanh(
    0.7978845608 * (v + 0.044715 * v ** 3))))


def reset_launches():
    for f in KERNELS.values():
        f.launches = 0


def read_launches(path, must):
    """Every kernel's launches since reset_launches(); raises unless the
    kernels in `must` ran and no other did."""
    counts = {k: f.launches for k, f in KERNELS.items()}
    if any(counts[k] <= 0 for k in must) or any(
            counts[k] != 0 for k in counts if k not in must):
        raise RuntimeError(f"the {path} run launched {counts}, expected "
                           f"only {sorted(must)}")
    return counts


def lm_serve(model, params, n_requests, prompt_len, new_tokens, seed,
             moe_overrides=None):
    """Serve n_requests prompts through a fresh LmDecodeEngine of 64 slots
    (chunk 16, speculative capacity 4.0, off for an expert-choice gate):
    admit and prefill them all, then decode until every request finishes.
    Returns the phase's numbers."""
    rng = np.random.default_rng(seed)
    reqs = [LmRequest(uid=i, prompt=rng.integers(
        0, model.cfg.vocab_size, prompt_len).astype(np.int32),
        max_new_tokens=new_tokens) for i in range(n_requests)]
    eng = LmDecodeEngine(model, params, max_batch=64,
                         speculative_capacity=4.0,
                         moe_overrides=moe_overrides)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        if not eng.try_add(r):
            raise RuntimeError("the LM phase admits every request at once")
    eng._flush_admissions()              # what the first step_chunk does
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    while eng.active:
        eng.step_chunk(16)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = eng._generated
    if len(out) != n_requests or any(
            len(toks) != new_tokens or not all(
                0 <= tok < model.cfg.vocab_size for tok in toks)
            for toks in out.values()):
        raise RuntimeError("the LM phase did not generate every token")
    tokens = sum(len(toks) for toks in out.values())
    return {"requests": n_requests, "prompt_len": prompt_len,
            "new_tokens": new_tokens, "tokens": tokens,
            "tokens_sha1": tokens_sha1(out),
            "prefill_s": t1 - t0, "decode_steps": eng.stats["steps"],
            "decode_s": t2 - t1,
            "ms_per_decode_step": 1e3 * (t2 - t1) / eng.stats["steps"],
            "seconds": t2 - t0, "tokens_per_s": tokens / (t2 - t0),
            "spec_retries": eng.stats["spec_retries"]}


def tokens_sha1(generated):
    """SHA-1 of an engine's generated tokens ({uid: tokens}), in uid order:
    equal digests are the same greedy tokens."""
    toks = [np.asarray(generated[u], np.int64) for u in sorted(generated)]
    return hashlib.sha1(np.concatenate(toks).tobytes()).hexdigest()


# the CUDA symbols of each ported kernel on the LM paths: the kernel each
# launch runs once (K7's two kernels, prefill_attn_kernel and
# prefill_attn_kernel_tc, share the stem), then K2's and K4's combine and
# K6's merge of a split call
SYMBOLS = {"grouped_gemm_quant": ("gmm_quant_kernel",),
           "fused_ffn_w8a8": ("fused_w8a8_kernel",),
           "grouped_gemm_w8a8": ("gmm_w8a8_kernel",),
           "fused_ffn_quant": ("fused_ffn_kernel", "fused_ffn_combine"),
           "fused_swiglu_quant": ("fused_swiglu_kernel",
                                  "fused_swiglu_combine"),
           "decode_attn": ("decode_attn_kernel", "decode_attn_merge"),
           "prefill_attn": ("prefill_attn_kernel",),
           "kv_write": ("kv_write_kernel",),
           "compute_locations": ("route_tile_kernel", "route_scan_kernel")}


def of_kernel(name, symbols):
    """Whether a profiled kernel's name belongs to one of `symbols`."""
    return any(s in name for s in symbols)


def device_time(prof):
    """From a torch.profiler trace: (device us by kernel name, launches by
    kernel name, busy us, span us, device events)."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    if not spans:
        raise RuntimeError("the profiler recorded no device time")
    busy, cur, by_name, n_by_name = 0.0, None, {}, {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        n_by_name[name] = n_by_name.get(name, 0) + 1
        if cur is None or start > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += cur[1] - cur[0]
    return by_name, n_by_name, busy, spans[-1][1] - spans[0][0], len(spans)


def lm_profile(model, params, seed, steps=16, moe_overrides=None):
    """One decode chunk of the full-width LM engine (64 slots, 1664-token
    prompts) under torch.profiler: the device's busy share of the chunk's
    span and the kernels with the most device time. The profiler slows the
    host, so the busy share is a lower bound for an unprofiled chunk."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed)
    eng = LmDecodeEngine(model, params, max_batch=64,
                         speculative_capacity=4.0,
                         moe_overrides=moe_overrides)
    for i in range(64):
        eng.try_add(LmRequest(uid=i, prompt=rng.integers(
            0, model.cfg.vocab_size, 1664).astype(np.int32),
            max_new_tokens=3 * steps))
    eng.step_chunk(steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step_chunk(steps)
        torch.cuda.synchronize()
    by_name, _, busy, span, events = device_time(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ported = {k: sum(t for n, t in by_name.items() if of_kernel(n, s))
              / 1e3 / steps for k, s in SYMBOLS.items()}
    return {"steps": steps, "device_events": events,
            "device_busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "busy_share": busy / span,
            "top_kernels_ms_per_step": [[n[:70], t / 1e3 / steps]
                                        for n, t in top],
            "ported_kernels_ms_per_step": ported}


def moe_profile(layer, params, auto_fuse, kernel, seed, steps=8):
    """One decode chunk of the MoE server at a full batch (256 slots,
    residual_norm, 512 routed rows a step) under torch.profiler, after a
    chunk of warm-up: the device's busy ms per step and busy share of the
    chunk's span, the expert kernel's launches and device ms per step, and
    the kernels with the most device time. The profiler slows the host, so
    the busy share is a lower bound for an unprofiled chunk. A trace that
    lost some of the kernel's launches (the profiler now and then drops
    events on an H100, as `device_events` says) is taken again, on the
    next chunk, up to 4 times."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(seed)
    states = torch.randn(256, layer.model_dim, generator=g,
                         device="cuda").to(layer.dtype)
    eng = MoeDecodeEngine(layer, params, max_batch=256, auto_fuse=auto_fuse,
                          state_update="residual_norm")
    for i in range(256):
        eng.try_add(Request(uid=i, state=states[i], remaining=6 * steps))
    eng.step_chunk(steps)
    torch.cuda.synchronize()
    for attempt in range(4):
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step_chunk(steps)
            torch.cuda.synchronize()
        counts = read_launches(f"moe_profile {kernel}", {kernel, ROUTE})
        by_name, n_by_name, busy, span, events = device_time(prof)
        seen = sum(c for n, c in n_by_name.items()
                   if SYMBOLS[kernel][0] in n)
        if seen == counts[kernel]:
            break
        print(json.dumps({"profiler_retry": f"moe_profile {kernel}",
                          "reason": f"the trace held {seen} of the "
                                    f"{counts[kernel]} launches"}),
              flush=True)
    else:
        raise RuntimeError(f"the profiler saw {seen} launches of {kernel}, "
                           f"its wrapper counted {counts[kernel]}")
    ms = sum(t for n, t in by_name.items()
             if of_kernel(n, SYMBOLS[kernel])) / 1e3
    route_ms = sum(t for n, t in by_name.items()
                   if of_kernel(n, SYMBOLS[ROUTE])) / 1e3
    route_seen = sum(c for n, c in n_by_name.items()
                     if of_kernel(n, SYMBOLS[ROUTE]))
    return {"steps": steps, "kernel": kernel, "launches": counts[kernel],
            "route_launches": counts[ROUTE],
            "route_launches_traced": route_seen,
            "route_ms_per_step": route_ms / steps,
            "device_events": events, "device_busy_ms_per_step":
            busy / 1e3 / steps, "span_ms": span / 1e3,
            "busy_share": busy / span,
            f"{kernel}_ms_per_step": ms / steps,
            f"{kernel}_share": ms / (busy / 1e3),
            "top_kernels_ms_per_step": [[n[:70], t / 1e3 / steps] for n, t in
                                        sorted(by_name.items(),
                                               key=lambda kv: -kv[1])[:6]]}


def moe_profiles(layer, layer_w4a8, params, smi):
    """`moe_profile` of the two-call path (K1 twice a step), the W4A8
    fused path (K3 once a step) and the W4A8 two-call path (K5 twice a
    step), one JSON line each."""
    for lay, auto_fuse, kernel in ((layer, False, "grouped_gemm_quant"),
                                   (layer_w4a8, True, "fused_ffn_w8a8"),
                                   (layer_w4a8, False, "grouped_gemm_w8a8")):
        print(json.dumps({"phase": "moe_profile", "auto_fuse": auto_fuse,
                          **moe_profile(lay, params, auto_fuse, kernel,
                                        SEED + 9), "card": smi}), flush=True)


def lm_prefill_profile(model, params, seed, ffn_kernel, moe_overrides=None):
    """One admission and prefill of 64 prompts of 1664 tokens (13 chunks
    of 128) into a fresh full-width LM engine under torch.profiler: the
    device time of K7 and of the expert kernel in the whole prefill, in
    all and per launch, the busy share and the kernels with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed)
    eng = LmDecodeEngine(model, params, max_batch=64,
                         speculative_capacity=4.0,
                         moe_overrides=moe_overrides)
    reqs = [LmRequest(uid=i, prompt=rng.integers(
        0, model.cfg.vocab_size, 1664).astype(np.int32), max_new_tokens=16)
        for i in range(64)]
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in reqs:
            eng.try_add(r)
        eng._flush_admissions()
        torch.cuda.synchronize()
    launches = {k: f.launches for k, f in KERNELS.items() if f.launches}
    by_name, n_by_name, busy, span, events = device_time(prof)
    out = {"requests": 64, "prompt_len": 1664, "launches": launches,
           "device_events": events, "device_busy_ms": busy / 1e3,
           "span_ms": span / 1e3, "busy_share": busy / span}
    for name in ("prefill_attn", ffn_kernel):
        ms = sum(t for n, t in by_name.items()
                 if of_kernel(n, SYMBOLS[name])) / 1e3
        n = sum(c for k, c in n_by_name.items() if SYMBOLS[name][0] in k)
        if n != launches.get(name):
            raise RuntimeError(f"the profiler saw {n} launches of {name}, "
                               f"its wrapper counted {launches.get(name)}")
        out[f"{name}_ms"] = ms
        out[f"{name}_ms_per_launch"] = ms / n
        out[f"{name}_share"] = ms / (busy / 1e3)
    out["top_kernels_ms"] = [[n[:70], t / 1e3] for n, t in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:8]]
    return out


def small_lm_check(expert_type="ffn", kv_modes=(8, 0), gate_type="top",
                   capacity_factor=0.0):
    """A small LM engine on the card against the same engine on the CPU,
    float32, with INT4 experts of `expert_type` and the given caches:
    greedy tokens identical, and apply_decode logits (after the same
    prefill) within SMALL_TOL."""
    worst = 0.0
    for kv_bits in kv_modes:
        cfg = TransformerMoEConfig(
            vocab_size=97, max_len=256, model_dim=256, num_heads=2,
            num_kv_heads=1, num_layers=2, ffn_hidden=512, moe_every=2,
            num_local_experts=4, top_k=2, capacity_factor=capacity_factor,
            expert_hidden=512, kv_bits=kv_bits, expert_type=expert_type,
            gate_type=gate_type)
        models = [TransformerMoE(cfg, device=d) for d in ("cpu", "cuda")]
        params = lm_params(models[0], torch.Generator().manual_seed(SEED))

        def to_cuda(tree):
            if isinstance(tree, dict):
                return {k: to_cuda(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [to_cuda(v) for v in tree]
            return tree.to("cuda")

        gparams = to_cuda(params)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, 97, n).astype(np.int32)
                   for n in (5, 130, 77, 20, 9, 200)]
        toks, logits = [], []
        for model, p in zip(models, (params, gparams)):
            eng = LmDecodeEngine(model, p, max_batch=4,
                                 speculative_capacity=2.0)
            toks.append(eng.run([LmRequest(uid=i, prompt=pr,
                                           max_new_tokens=10)
                                 for i, pr in enumerate(prompts)], chunk=4))
            pr = torch.from_numpy(np.stack([prompts[0], prompts[3][:5]]))
            cache = model.init_cache(2)
            _, cache = model.prefill(eng.params, pr, cache)
            steps = []
            for i in range(3):
                lg, cache, _ = model.apply_decode(
                    eng.params, pr[:, i], cache, torch.full((2,), 5 + i))
                steps.append(lg.cpu())
            logits.append(torch.stack(steps))
        for uid, ref in toks[0].items():
            if toks[1][uid].tolist() != ref.tolist():
                raise RuntimeError(f"LM engine on the card (kv_bits="
                                   f"{kv_bits}) generated other tokens "
                                   f"for request {uid}")
        err = float((logits[1] - logits[0]).abs().max()
                    / logits[0].abs().max())
        worst = max(worst, err)
    if not worst <= SMALL_TOL:
        raise RuntimeError(f"apply_decode on the card disagrees with the "
                           f"CPU: {worst} > {SMALL_TOL}")
    return worst


# ---------------------------------------------------------------------------
# Training (slice 3): no ported kernel but the location scan lies on
# this path
# ---------------------------------------------------------------------------

# benchmarks/bench_lm_train.py:34-46: its model and batch
LM_TRAIN_CONFIG = dict(vocab_size=32768, max_len=512, model_dim=2048,
                       num_heads=16, num_layers=4, ffn_hidden=8192,
                       moe_every=2, num_local_experts=8, top_k=2,
                       capacity_factor=1.25, expert_hidden=2048)
LM_TRAIN_BATCH = (32, 512)
TRAIN_TOL = 1e-4           # card vs CPU losses, float32, TF32 off


def on(tree, device):
    return tree_replace(tree, [t.to(device) for t in tree_leaves(tree)])


# coarse kinds of device kernels, first match wins
KERNEL_KINDS = (("gemm", ("gemm", "nvjet", "xmma", "cutlass", "magma",
                          "gemv")),
                ("cumsum", ("scan_outer_dim", "scan_inner_dim")),
                ("softmax", ("softmax",)),
                ("reduce", ("reduce_kernel",)),
                ("index", ("index", "gather", "scatter")),
                ("copy", ("copy", "Memcpy", "Memset")),
                ("elementwise", ("elementwise",)))


def profiled(fn):
    """fn() under torch.profiler: device busy ms, span ms, busy share, the
    device ms of each kind of kernel (KERNEL_KINDS) and the kernels with
    the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, _, busy, span, events = device_time(prof)
    kinds = {}
    for name, us in by_name.items():
        kind = next((k for k, marks in KERNEL_KINDS
                     if any(m in name for m in marks)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
    return {"device_events": events, "device_busy_ms": busy / 1e3,
            "span_ms": span / 1e3, "busy_share": busy / span,
            "ms_by_kind": kinds,
            "top_kernels_ms": [[n[:70], t / 1e3] for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:12]]}


def helloworld_train(smi):
    """The port's helloworld trainer at the JAX example's default width on
    the card, seeded by the trainer itself."""
    args = helloworld.build_args(["--num_steps", "10", "--device", "cuda"])
    lines = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, _ = helloworld.run(args, log=lines.append)
    launches = read_launches("helloworld_train", {ROUTE})
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"helloworld losses {losses}: not finite, or "
                           "the last is not below the first")
    step_s = [float(re.search(r"step_time = ([0-9.]+) sec", ln).group(1))
              for ln in lines if ln.startswith("STEP-")]
    median_s = statistics.median(step_s[-5:])
    flops = (args.batch_size * args.num_tokens * args.model_dim
             * args.hidden_size * 4 * 3 * min(args.top,
                                               args.num_local_experts))
    two = helloworld.build_args(["--num_steps", "2", "--device", "cuda"])
    params, x = helloworld.start(two, "cuda")
    prof = profiled(lambda: helloworld.run(two, log=lambda *_: None,
                                           params=params, x=x))
    return {"phase": "helloworld_train",
            "config": {k: getattr(args, k) for k in (
                "batch_size", "num_tokens", "model_dim", "hidden_size",
                "num_local_experts", "top", "dtype", "capacity_factor",
                "num_steps")},
            "losses": losses, "step_ms": [t * 1e3 for t in step_s],
            "median_step_ms_last5": median_s * 1e3,
            "tflops": flops / median_s / 1e12,
            "f32_peak_share": flops / median_s / F32_PEAK,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "launches": launches, "profile_2_steps": prof, "card": smi}


def dispatch_backward_bitwise(s=8192, e=2, m=2048):
    """Two backward passes of fast_encode (gates at encode) and fast_decode
    (gates at decode) at the helloworld shape must give equal bits: top-1
    at capacity_factor 1.0 (tokens dropped) and top-2."""
    out = {}
    for k in (1, 2):
        g = torch.Generator(device="cuda").manual_seed(SEED + k)
        scores = torch.softmax(torch.randn(s, e, generator=g, device="cuda"),
                               dim=1)
        cap = routing.compute_static_capacity(s, e, k, 1.0)
        crit, _ = routing.extract_critical(scores, k, cap)
        x, cot = (torch.randn(s, m, generator=g, device="cuda")
                  for _ in range(2))
        w = torch.randn(e, 1, m, generator=g, device="cuda")
        grads = []
        for _ in range(2):
            xx = x.clone().requires_grad_(True)
            gates = crit.gates.clone().requires_grad_(True)
            c = crit._replace(gates=gates)
            y = dispatch.fast_encode(xx, c, False) * w
            grads.append(torch.autograd.grad(
                dispatch.fast_decode(y, c, True), (xx, gates), cot))
        if not all(torch.equal(a, b) for a, b in zip(*grads)):
            raise RuntimeError(f"two dispatch backward passes (top-{k}) "
                               "differ")
        out[f"top{k}"] = {"capacity": cap, "dropped": int(
            (crit.locations >= cap).sum()), "bitwise_equal": True}
    return out


def train_vs_cpu():
    """The helloworld trainer on the card and on the CPU from the same
    start: losses within TRAIN_TOL (relative and absolute)."""
    base = ["--batch_size", "4", "--num_tokens", "128", "--model_dim", "256",
            "--hidden_size", "256", "--num_steps", "10"]
    out = {}
    for name, extra in (("top1", ["--top", "1"]), ("top2", ["--top", "2"]),
                        ("top2_dropless", ["--top", "2",
                                           "--capacity_factor", "0"]),
                        ("top2_e4", ["--top", "2",
                                     "--num_local_experts", "4"])):
        losses = {}
        for dev in ("cpu", "cuda"):
            args = helloworld.build_args(base + extra + ["--device", dev])
            params, x = helloworld.start(args, "cpu")
            losses[dev] = np.array(helloworld.run(
                args, log=lambda *_: None, params=on(params, dev),
                x=x.to(dev))[0])
        if not np.allclose(losses["cuda"], losses["cpu"], rtol=TRAIN_TOL,
                           atol=TRAIN_TOL):
            raise RuntimeError(f"train_vs_cpu {name}: {losses}")
        out[name] = {"max_abs_diff": float(np.max(np.abs(
            losses["cuda"] - losses["cpu"]))),
            "losses_cuda": losses["cuda"].tolist()}
    return out


def lm_sgd_step(model, params, tokens, lr=1e-3):
    """One TransformerMoE.loss + backward + SGD step: (new params, loss,
    a device flag: loss and every gradient finite)."""
    params, loss, grads = sgd_step(
        lambda p: model.loss(p, tokens, training=True)[0], params, lr)
    finite = torch.stack([torch.isfinite(g).all() for g in grads]
                         + [torch.isfinite(loss)]).all()
    return params, loss, finite


def lm_train(smi, steps=6):
    """bench_lm_train.py's model and batch in bfloat16 on the card: `steps`
    SGD steps on tokens from a numpy seed (rolled by the step, as that
    benchmark does), the first a warm-up that the median leaves out, then
    one more under torch.profiler."""
    cfg = TransformerMoEConfig(**LM_TRAIN_CONFIG, dtype=torch.bfloat16)
    model = TransformerMoE(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in tree_leaves(params))
    b, t = LM_TRAIN_BATCH
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (b, t))).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses, finite = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss, ok = lm_sgd_step(model, params,
                                       torch.roll(tokens, i, dims=1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        finite.append(bool(ok))
    launches = read_launches("lm_train", {ROUTE})
    if not all(finite):
        raise RuntimeError(f"lm_train: a loss or gradient is not finite "
                           f"(steps {finite}, losses {losses})")
    # bench_lm_train.py:72-86: matmul FLOPs of T - 1 positions, x3
    d, tt = cfg.model_dim, t - 1
    n_moe = sum(1 for i in range(cfg.num_layers) if (i + 1) % 2 == 0)
    per_tok = (cfg.num_layers * (8 * d * d + 4 * tt * d)
               + (cfg.num_layers - n_moe) * 4 * d * cfg.ffn_hidden
               + n_moe * min(cfg.top_k, cfg.num_local_experts) * 4 * d
               * cfg.expert_hidden + 2 * d * cfg.vocab_size)
    tokens_per_step = b * tt
    flops_step = 3 * per_tok * tokens_per_step
    step_s = statistics.median(times[1:])
    prof = profiled(lambda: lm_sgd_step(model, params,
                                        torch.roll(tokens, steps, dims=1)))
    return {"phase": "lm_train", "config": {**LM_TRAIN_CONFIG,
                                            "batch": b, "seq": t,
                                            "dtype": "bfloat16"},
            "params": n_params, "losses": losses,
            "warmup_step_ms": times[0] * 1e3,
            "step_ms": [x * 1e3 for x in times[1:]],
            "median_step_ms": step_s * 1e3,
            "tokens_per_s": tokens_per_step / step_s,
            "analytic_gflops_per_step": flops_step / 1e9,
            "bf16_peak_share": flops_step / step_s / BF16_PEAK,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "profile_1_step": prof, "card": smi}


def small_lm_train_vs_cpu(steps=3):
    """A small float32 LM trained `steps` SGD steps on the card and on the
    CPU from the same start: losses within TRAIN_TOL."""
    cfg = TransformerMoEConfig(
        vocab_size=512, max_len=64, model_dim=128, num_heads=4,
        num_kv_heads=2, num_layers=2, ffn_hidden=256, moe_every=2,
        num_local_experts=4, top_k=2, capacity_factor=1.25,
        expert_hidden=256)
    start = TransformerMoE(cfg, device="cpu").init(
        torch.Generator().manual_seed(SEED))
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (4, 64)))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = TransformerMoE(cfg, device=dev)
        params, toks, ls = on(start, dev), tokens.to(dev), []
        for i in range(steps):
            params, loss, _ = lm_sgd_step(model, params,
                                          torch.roll(toks, i, dims=1))
            ls.append(float(loss))
        losses[dev] = np.array(ls)
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=TRAIN_TOL,
                       atol=TRAIN_TOL):
        raise RuntimeError(f"small LM training on the card disagrees with "
                           f"the CPU: {losses}")
    return {"phase": "small_lm_train_vs_cpu", "losses_cuda":
            losses["cuda"].tolist(), "max_abs_diff": float(np.max(np.abs(
                losses["cuda"] - losses["cpu"]))), "tol": TRAIN_TOL}


def training_phases(smi):
    """Slice 3's phases, in order; each prints its JSON line. Returns the
    helloworld trainer's losses (the group-less run)."""
    hello = helloworld_train(smi)
    print(json.dumps(hello), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "dispatch_backward_bitwise",
                      **dispatch_backward_bitwise()}), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "train_vs_cpu", "tol": TRAIN_TOL,
                      "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                      **train_vs_cpu()}), flush=True)
    print(json.dumps(lm_train(smi)), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps(small_lm_train_vs_cpu()), flush=True)
    return hello["losses"]


MEGA_SIZE = 8
MEGA_TOL = 1e-5            # megablocks on the card vs the CPU, float32


def per_token_rel_err(got, ref):
    """The largest over tokens (rows) of max |got - ref| / max |ref|."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs().amax(1)
                  / ref.abs().amax(1).clamp_min(1e-30)).max())


def megablocks_decode(smi):
    """One forward of the float decode layer (bench_dropless_decode.py
    --bits 0: 128 experts of 2048 x 2048, no biases, top-2, dropless, 256
    tokens, bfloat16, capacity_override from resolve_capacity) with
    megablocks_size 8 and 0 (the padded bmm): every token within BF16_TOL,
    each path's event ms, profiled device ms per call and GEMM share, and
    no launch of K1-K10; then the layer at a small width in float32 on the
    card against the CPU, within MEGA_TOL."""
    layer = decode_layer(0)
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    params = layer.init(g)
    x = torch.randn(256, 2048, generator=g, device="cuda").to(torch.bfloat16)
    cap = layer.resolve_capacity(params, x, megablocks_size=MEGA_SIZE)
    outs, report = {}, {"capacity": cap}
    for mega in (MEGA_SIZE, 0):
        def call(m=mega):
            return layer(params, x, capacity_override=cap,
                         megablocks_size=m)[0]
        reset_launches()
        outs[mega] = call()
        torch.cuda.synchronize()
        read_launches(f"megablocks_decode {mega}", {ROUTE})
        prof = profiled(lambda: [call() for _ in range(REPS)])
        gemm = prof["ms_by_kind"].get("gemm", 0.0) / REPS
        report[f"megablocks_{mega}"] = {
            "ms": median_ms(call), "device_ms": prof["device_busy_ms"] / REPS,
            "gemm_device_ms": gemm,
            "gemm_share": gemm * REPS / prof["device_busy_ms"],
            "busy_share": prof["busy_share"],
            "top_kernels_ms": prof["top_kernels_ms"][:6]}
    err = per_token_rel_err(outs[MEGA_SIZE], outs[0])
    if not (torch.isfinite(outs[MEGA_SIZE].float()).all() and
            err <= BF16_TOL):
        raise RuntimeError(f"megablocks {MEGA_SIZE} against the padded "
                           f"path: per-token error {err}")
    del layer, params, outs
    torch.cuda.empty_cache()
    small = {}
    for dev in ("cpu", "cuda"):
        lay = moe.moe_layer(
            gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
            model_dim=128, device=dev,
            experts={"type": "ffn", "num_experts_per_device": 8,
                     "hidden_size_per_expert": 256})
        if dev == "cpu":
            start = lay.init(torch.Generator().manual_seed(SEED + 41))
            xs = torch.randn(96, 128, generator=torch.Generator().manual_seed(
                SEED + 42))
        small[dev] = lay(on(start, dev), xs.to(dev),
                         megablocks_size=MEGA_SIZE)[0].cpu()
    small_err = float((small["cuda"] - small["cpu"]).abs().max()
                      / small["cpu"].abs().max())
    if small_err > MEGA_TOL:
        raise RuntimeError(f"megablocks float32 on the card against the "
                           f"CPU: {small_err}")
    return {"phase": "megablocks_decode", "megablocks_size": MEGA_SIZE,
            **report, "per_token_rel_err": err, "tol": BF16_TOL,
            "small_f32_vs_cpu": small_err, "small_tol": MEGA_TOL,
            "launches": 0, "card": smi}


def net_calls(dev):
    """Every collective of net at world size 1 on inputs made on the CPU
    from a seed and moved to `dev`, with the all-to-all's backward; the
    results on the CPU."""
    from tutel_tpu_torch import net
    g = torch.Generator().manual_seed(SEED + 43)
    x = torch.randn(8, 4, 6, generator=g).to(dev)
    rows = torch.randn(12, 5, generator=g).to(dev)
    counts = torch.tensor([7]).to(dev)
    group = None
    out = {"size": torch.tensor(net.get_world_size()),
           "rank": torch.tensor(net.get_world_rank())}
    for i, o in ((1, 0), (0, 1), (2, 0), (0, 2), (2, 1)):
        out[f"a2a_{i}{o}"] = net.all_to_all(x, i, o)
    for i, o in ((1, 0), (0, 1)):
        out[f"a2a_2dh_{i}{o}"] = net.all_to_all_2dh(x, i, o, group, group)
    for op in ("sum", "max", "min"):
        out[f"all_reduce_{op}"] = net.simple_all_reduce(x, op=op)
    out.update(
        a2a=net.simple_all_to_all(x), single=net.all_to_all_single(x),
        split=net.simple_split(x, dim=1),
        reduce_scatter=net.simple_reduce_scatter(x, dim=1),
        all_gather=net.simple_all_gather(x, dim=2),
        allreduce_forward=net.allreduce_forward(x),
        allreduce_backward=net.allreduce_backward(x),
        pre=net.pre_expert_permute(x, group),
        post=net.post_expert_permute(x, group),
        zero_gather=net.zero_gather(x.reshape(-1), full_shape=(8, 24)),
        zero_scatter=net.zero_scatter(x)[0])
    out["a2a_v"], out["a2a_v_recv"] = net.batch_all_to_all_v(
        rows, counts, output_size=10)
    out["a2a_v_2dh"], out["a2a_v_2dh_recv"] = net.batch_all_to_all_v_2dh(
        rows, counts, group, group, output_size=10)
    out["gather_v"], out["gather_v_counts"] = net.batch_all_gather_v(
        rows, 7, output_size=9)
    xg = x.clone().requires_grad_(True)
    (net.all_to_all(xg, 1, 0) * (x + 1)).sum().backward()
    out["a2a_grad"] = xg.grad
    return {k: v.detach().cpu() for k, v in out.items()}


def init_world1():
    """A world-1 NCCL process group from the environment torchrun would
    set (MASTER_ADDR 127.0.0.1, a free port, RANK 0, WORLD_SIZE 1)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    return system.init_data_model_parallel(device="cuda")


def net_nccl(cpu_ref, env):
    """net's collectives on the card through the world-1 NCCL group,
    equal to the same calls on the CPU without a group."""
    t0 = time.perf_counter()
    got = net_calls("cuda")
    unequal = sorted(k for k in cpu_ref if not torch.equal(got[k],
                                                           cpu_ref[k]))
    if unequal:
        raise RuntimeError(f"net on the card through NCCL differs from the "
                           f"CPU in {unequal}")
    return {"phase": "net_nccl", "backend": env.backend,
            "world_size": env.global_size, "calls": len(got),
            "equal": True, "seconds": time.perf_counter() - t0}


def ep_train_world1(smi, env, plain_losses):
    """The helloworld trainer at its default width under the world-1 NCCL
    group with each parallel type and with overlap 2: at one rank every
    one takes the one-device body, so its losses equal the group-less
    run's (plain_losses) bit for bit; then one INT4 two-call pure-EP layer
    forward (the decode layer, 256 tokens) under the group, which must
    launch K1 twice and nothing else but the location scan."""
    runs = {}
    for name, extra in (("data", ["--parallel_type", "data"]),
                        ("model", ["--parallel_type", "model"]),
                        ("auto", ["--parallel_type", "auto"]),
                        ("adaptive_1", ["--parallel_type", "adaptive:1"]),
                        ("overlap_2", ["--a2a_ffn_overlap_degree", "2"])):
        args = helloworld.build_args(["--num_steps", "10", "--device",
                                      "cuda", "--num_devices", "1"] + extra)
        lines = []
        reset_launches()
        losses, _ = helloworld.run(args, log=lines.append)
        read_launches(f"ep_train_world1 {name}", {ROUTE})
        if losses != plain_losses:
            raise RuntimeError(f"ep_train_world1 {name}: losses {losses} "
                               f"differ from the group-less {plain_losses}")
        step_s = [float(re.search(r"step_time = ([0-9.]+) sec", ln).group(1))
                  for ln in lines if ln.startswith("STEP-")]
        runs[name] = {"median_step_ms_last5":
                      statistics.median(step_s[-5:]) * 1e3,
                      "bitwise_equal": True}
        torch.cuda.empty_cache()
    layer = moe.moe_layer(
        gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
        model_dim=2048, dtype=torch.bfloat16, device="cuda", group=env,
        parallel_type="model",
        experts={"type": "ffn", "num_experts_per_device": 128,
                 "hidden_size_per_expert": 2048, "has_fc1_bias": False,
                 "has_fc2_bias": False})
    params = layer.shard_params(decode_params(layer))
    x = torch.randn(256, 2048, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 44), device="cuda").to(
        torch.bfloat16)
    reset_launches()
    out, l_aux = layer(params, x)
    torch.cuda.synchronize()
    counts = read_launches("ep_train_world1 quantized",
                           {"grouped_gemm_quant", ROUTE})
    if counts["grouped_gemm_quant"] != 2 or not (
            torch.isfinite(out.float()).all() and out.shape == x.shape):
        raise RuntimeError(f"the quantized EP layer: launches {counts}, "
                           f"output {tuple(out.shape)}")
    return {"phase": "ep_train_world1", "world_size": env.global_size,
            "backend": env.backend, "runs": runs,
            "plain_losses": plain_losses,
            "quantized_ep_forward": {"launches": counts,
                                     "l_aux": float(l_aux)},
            "card": smi}


# ---------------------------------------------------------------------------
# Slice 5b: ragged expert parallelism, quantized experts under slicing,
# ZeRO, the launcher and checkpoints, the LM over a group
# ---------------------------------------------------------------------------

RAGGED_TOL = 2e-2          # ragged against padded, per token, bfloat16
ZERO_TOL = 1e-4            # helloworld_zero card vs CPU losses, float32


def busy_ms(fn, reps=REPS):
    """Device busy ms a call over `reps` calls, from torch.profiler: for
    calls whose kernel count varies from call to call (the ragged
    exchange's NCCL and copy events), where device_ms cannot count whole
    calls."""
    return profiled(lambda: [fn() for _ in range(reps)])[
        "device_busy_ms"] / reps


def ragged_relayout(rows, gs, c_max):
    """The dense [E, c_max, K] view of ragged rows, and its inverse."""
    from tutel_tpu_torch.ops import ragged
    gs, starts = ragged.ragged_starts(gs)
    return (ragged.ragged_to_dense(rows, gs, starts, c_max),
            lambda y: ragged.dense_to_ragged(y, gs, starts, c_max,
                                             rows.shape[0]))


def ragged_kernel_checks(params, rows, gs, bandwidth):
    """grouped_gemm_quant_ragged (K1) and fused_ffn_quant_ragged (K2) at
    the decode layer's ragged exchange (rows grouped by expert) against
    their plain twins on the same inputs on the card, each twice (bitwise
    equal), with event and profiled device ms beside the twin's."""
    w1, w2 = params["fc1_w"], params["fc2_w"]
    stream = params["fused_stream"]
    n, c_max = rows.shape[0], rows.shape[0]
    dense, back = ragged_relayout(rows, gs, c_max)
    counts = gs.clamp(max=c_max)
    live = int(gs.sum())
    out = {}
    for name, kernel, plain in (
            ("grouped_gemm_quant_ragged",
             lambda: gq.grouped_gemm_quant_ragged(rows, w1, gs, c_max),
             lambda: back(gq.grouped_gemm_quant_reference(dense, w1,
                                                          counts))),
            ("fused_ffn_quant_ragged",
             lambda: fused_ffn.fused_ffn_quant_ragged(
                 rows, stream, gs, c_max, activation_fn=activations.relu),
             lambda: back(fused_ffn.fused_ffn_quant_reference(
                 dense, stream, counts, activations.relu)))):
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise RuntimeError(f"two {name} calls differ")
        diff = float((got.float() - ref.float()).abs().max())
        rel = diff / float(ref.float().abs().max())
        if not rel <= BF16_TOL:
            raise RuntimeError(f"{name} disagrees with its twin: {rel}")
        out[name] = {"rows": n, "live_rows": live, "max_abs_err": diff,
                     "max_rel_err": rel, "tol": BF16_TOL,
                     "bitwise_repeat": True, "ms": median_ms(kernel),
                     "device_ms": busy_ms(kernel),
                     "plain_ms": median_ms(plain)}
    return out


def ragged_ep_world1(smi, bandwidth):
    """ops.ragged_ep.ragged_ep_forward under the world-1 group (the layer
    refuses ragged EP on one rank, as JAX's does) with the decode layer's
    INT4 experts (128 x 2048 x 2048, top-2, dropless, 256 tokens, bf16),
    its own gate and routing and `apply_grouped`: every token within
    RAGGED_TOL of the layer's padded dropless forward (K1 two-call); the
    ragged path launches K1 exactly twice, or K2 once with a prepared
    fused stream; event and profiled device ms of each path; and the two
    ragged wrappers against their twins at this exchange's rows."""
    from tutel_tpu_torch.ops import ragged as ragged_ops, ragged_ep
    layer = decode_layer(0)
    params = decode_params(layer)
    fused = {**params, "experts": fused_ffn.prepare_fused_ffn_params(
        params["experts"])}
    x = torch.randn(256, 2048, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 50), device="cuda").to(
        torch.bfloat16)
    cap = layer.resolve_capacity(params, x)
    max_recv = layer.resolve_max_recv(params, x)
    with torch.no_grad():
        crit, _ = layer._routing(params["gates"][0], x, 0, 2, cap,
                                 with_loss=False)

        def padded():
            return layer(params, x, capacity_override=cap)[0]

        def ragged(p):
            return lambda: ragged_ep.ragged_ep_forward(
                x, crit, p["experts"], layer.experts.apply_grouped, None,
                max_recv, is_postscore=layer.is_postscore)
        ref = padded()
        report = {"capacity": cap, "max_recv": max_recv}
        counts = {}
        for path, p, kernel, n in (("two_call", params, "grouped_gemm_quant",
                                    2),
                                   ("fused", fused, "fused_ffn_quant", 1)):
            reset_launches()
            out = ragged(p)()
            torch.cuda.synchronize()
            counts[path] = read_launches(f"ragged_ep_world1 {path}",
                                         {kernel})
            if counts[path][kernel] != n:
                raise RuntimeError(f"ragged EP {path} launched "
                                   f"{counts[path]}: expected {kernel} x {n}")
            err = per_token_rel_err(out, ref)
            if not (torch.isfinite(out.float()).all() and err <= RAGGED_TOL):
                raise RuntimeError(f"ragged EP {path} against the padded "
                                   f"path: per-token error {err}")
            report[f"ragged_{path}"] = {
                "per_token_rel_err": err, "launches": counts[path],
                "ms": median_ms(ragged(p)),
                "device_ms": busy_ms(ragged(p))}
        report["padded"] = {"ms": median_ms(padded),
                            "device_ms": busy_ms(padded)}
        # at one rank the exchange hands the experts the routed rows as
        # they are, grouped by expert
        rows = ragged_ops.encode_ragged(x, ragged_ops.make_ragged(crit))
        wrappers = ragged_kernel_checks(fused["experts"], rows,
                                        crit.dispatch_count, bandwidth)
    return {"phase": "ragged_ep_world1", "tol": RAGGED_TOL, **report,
            "wrappers": wrappers, "card": smi}, {
        k: counts["two_call"][k] + counts["fused"][k] for k in KERNELS}


def quant_sliced(smi, bandwidth):
    """K1 at the decode shape with INT4 weights packed in 2 and 4 K-blocks
    (the layout the r == 0 regather of K-sliced INT4 weights gives)
    against its twin, to K1's criterion (BF16_TOL, two calls bitwise
    equal); then a world-1 float32 INT4 layer at a small width whose
    weights were packed with sharded_count=2, on the card against the
    CPU within SMALL_TOL. Returns the layer's launches only: the kernel
    checks do not count as launches of a path."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    routed = np.random.default_rng(SEED).multinomial(512, [1 / 128] * 128)
    counts = torch.tensor(np.minimum(routed, 32), dtype=torch.int32,
                          device=dev)
    x = torch.randn(128, 32, 2048, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(128, 2048, 2048, generator=g, device=dev) * 0.02
    blocks = {}
    for nb in (2, 4):
        qw = quant.quantize(w, 4, shard_blocks=nb)

        def k1(qw=qw):
            return gq.grouped_gemm_quant(x, qw, counts, routed=512)
        got, again = k1(), k1()
        ref = gq.grouped_gemm_quant_reference(x, qw, counts)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, ref, counts)
        if not torch.equal(got, again) or not rel_err <= BF16_TOL:
            raise RuntimeError(f"K1 with {nb} INT4 blocks: error {rel_err}, "
                               f"repeat equal {torch.equal(got, again)}")
        blocks[nb] = {"max_abs_err": abs_err, "max_rel_err": rel_err,
                      "tol": BF16_TOL, "bitwise_repeat": True,
                      "ms": median_ms(k1),
                      "device_ms": device_ms(k1, "gmm_quant_kernel")}
    del w
    outs = {}
    for d in ("cpu", "cuda"):
        lay = moe.moe_layer(
            gate_type={"type": "top", "k": 2, "capacity_factor": 0.0},
            model_dim=128, device=d,
            experts={"type": "ffn", "num_experts_per_device": 8,
                     "hidden_size_per_expert": 256})
        if d == "cpu":
            p = lay.init(torch.Generator().manual_seed(SEED + 52))
            p["experts"] = quant.quantize_expert_params(p["experts"], 4,
                                                        sharded_count=2)
            xs = torch.randn(96, 128, generator=torch.Generator().manual_seed(
                SEED + 53))
        reset_launches()
        with torch.no_grad():
            outs[d] = lay(on(p, d), xs.to(d))[0].cpu()
        if d == "cuda":
            layer_launches = read_launches("quant_sliced layer",
                                           {"grouped_gemm_quant", ROUTE})
    err = float((outs["cuda"] - outs["cpu"]).abs().max()
                / outs["cpu"].abs().max())
    if not err <= SMALL_TOL:
        raise RuntimeError(f"the sharded_count=2 INT4 layer on the card "
                           f"against the CPU: {err}")
    return {"phase": "quant_sliced", "k1_blocks": blocks,
            "fc2_blocks": p["experts"]["fc2_w"].blocks,
            "layer_vs_cpu": err, "layer_tol": SMALL_TOL,
            "layer_launches": layer_launches, "card": smi}, layer_launches


def zero_run(device):
    """helloworld_zero at its own defaults on `device`: (losses, the
    [Check] line)."""
    from tutel_tpu_torch.examples import helloworld_zero
    lines = []
    losses = helloworld_zero.run(helloworld_zero.build_args(
        ["--device", device]), log=lines.append)
    return losses, lines[-1]


def zero_world1(smi, cpu_ref):
    """helloworld_zero on the card under the world-1 group against its
    CPU run (cpu_ref, made before the group), losses within ZERO_TOL."""
    reset_launches()
    losses, check = zero_run("cuda")
    launches = read_launches("zero_world1", {ROUTE})
    err = max(abs(a - b) for a, b in zip(losses, cpu_ref[0]))
    if not (err <= ZERO_TOL and check == cpu_ref[1]):
        raise RuntimeError(f"helloworld_zero on the card {losses} against "
                           f"the CPU {cpu_ref[0]}: {err}; {check}")
    return {"phase": "zero_world1", "losses": losses,
            "cpu_losses": cpu_ref[0], "max_abs_err": err, "tol": ZERO_TOL,
            "state_leaf": check, "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32, "launches": launches,
            "card": smi}


def run_module(argv, timeout=300, env=None):
    """`python -m argv...` from the checkout's root, with `env` over the
    environment; its standard output. Raises with its output when it
    fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m"] + argv, cwd=root,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": root,
                               **(env or {})})
    if proc.returncode:
        raise RuntimeError(f"python -m {' '.join(argv)} failed "
                           f"({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return proc.stdout


def launcher_checkpoint(smi, plain_losses):
    """The launcher starts the helloworld trainer at its default width for
    5 steps with --checkpoint_path in a process of its own (its own
    world-1 NCCL group, --coordinator 127.0.0.1:<free port>): the losses
    it prints equal the first 5 of helloworld_train's group-less run
    printed alike (its log's %.5f), and its file equals, bit for bit, the
    one the same 5 steps write in this process, whose float losses equal
    the group-less run's bit for bit; two --eval resumes give equal losses;
    and checkpoint.scatter to 2 files and checkpoint.gather back
    reproduce every array bit for bit."""
    import socket
    import tempfile
    from tutel_tpu_torch import checkpoint
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        path = os.path.join(tmp, "hw.npz")
        out = run_module([
            "tutel_tpu_torch.launcher.run", "--coordinator",
            f"127.0.0.1:{port}", "--nnodes", "1", "--node_rank", "0", "-m",
            "tutel_tpu_torch.examples.helloworld", "--num_steps", "5",
            "--checkpoint_path", path])
        printed = re.findall(r"STEP-\d+: loss = ([0-9.]+)", out)
        step_s = [float(v) for v in re.findall(
            r"STEP-\d+: .*step_time = ([0-9.]+) sec", out)]
        want = ["%.5f" % v for v in plain_losses[:5]]
        if printed != want or not os.path.exists(path):
            raise RuntimeError(f"the launched helloworld printed {printed}, "
                               f"expected {want}")
        here = os.path.join(tmp, "here.npz")
        reset_launches()
        here_losses = helloworld.run(helloworld.build_args(
            ["--num_steps", "5", "--checkpoint_path", here]),
            log=lambda *_: None)[0]
        launches = read_launches("launcher_checkpoint", {ROUTE})
        if list(here_losses) != list(plain_losses[:5]):
            raise RuntimeError(f"5 steps with --checkpoint_path lost "
                               f"{here_losses}, the group-less run "
                               f"{plain_losses[:5]}")
        flat = checkpoint.serial.flatten_state(checkpoint.load_state(path))
        ref = checkpoint.serial.flatten_state(checkpoint.load_state(here))
        unequal = sorted(k for k in ref if not np.array_equal(flat[k],
                                                              ref[k]))
        if sorted(flat) != sorted(ref) or unequal:
            raise RuntimeError(f"the launched run's checkpoint differs in "
                               f"{unequal}")
        evals = [helloworld.run(helloworld.build_args(
            ["--num_steps", "2", "--eval", "--checkpoint_path", path]),
            log=lambda *_: None)[0] for _ in range(2)]
        if evals[0] != evals[1]:
            raise RuntimeError(f"two --eval resumes differ: {evals}")
        parts = os.path.join(tmp, "parts", "{rank}-of-{size}.npz")
        back = os.path.join(tmp, "back.npz")
        run_module(["tutel_tpu_torch.checkpoint.scatter", "--input", path,
                    "--output_size", "2", "--outputs", parts])
        run_module(["tutel_tpu_torch.checkpoint.gather", "--inputs", parts,
                    "--input_size", "2", "--output", back])
        again = checkpoint.serial.flatten_state(checkpoint.load_state(back))
        flat = checkpoint.serial.flatten_state(checkpoint.load_state(path))
        if sorted(again) != sorted(flat) or any(
                not np.array_equal(again[k], flat[k])
                or again[k].dtype != flat[k].dtype for k in flat):
            raise RuntimeError("scatter to 2 files and gather back changed "
                               "the checkpoint")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "launcher_checkpoint", "losses": printed,
            "equal_at_printed_precision": True,
            "checkpoint_bitwise_equal": True,
            "in_process_losses_bitwise_equal": True,
            "eval_losses": evals[0], "round_trip_arrays": len(flat),
            "step_ms": [t * 1e3 for t in step_s],
            "median_step_ms_after_first": statistics.median(step_s[1:]) * 1e3,
            "launches": launches, "card": smi}


def lm_world1(smi, env):
    """The small float32 LM of the LM engine check (INT4 experts, INT8
    cache) built with group= the world-1 group: its engine's greedy
    tokens equal the group-less model's engine's."""
    cfg = TransformerMoEConfig(
        vocab_size=97, max_len=256, model_dim=256, num_heads=2,
        num_kv_heads=1, num_layers=2, ffn_hidden=512, moe_every=2,
        num_local_experts=4, top_k=2, capacity_factor=0.0,
        expert_hidden=512, kv_bits=8)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, 97, n).astype(np.int32)
               for n in (5, 130, 77, 20, 9, 200)]
    toks = {}
    for label, group in (("group", env), ("group_less", None)):
        model = TransformerMoE(cfg, group=group, device="cuda")
        params = lm_params(model, torch.Generator(device="cuda").manual_seed(
            SEED))
        reset_launches()
        eng = LmDecodeEngine(model, params, max_batch=4,
                             speculative_capacity=2.0)
        toks[label] = {k: v.tolist() for k, v in eng.run(
            [LmRequest(uid=i, prompt=pr, max_new_tokens=10)
             for i, pr in enumerate(prompts)], chunk=4).items()}
        if label == "group":
            launches = read_launches("lm_world1", {
                "fused_ffn_quant", "decode_attn", "prefill_attn",
                "kv_write", ROUTE})
    if toks["group"] != toks["group_less"]:
        raise RuntimeError("the LM over the world-1 group generated other "
                           "tokens than the group-less LM")
    return {"phase": "lm_world1", "requests": len(prompts),
            "greedy_tokens": "identical", "launches": launches,
            "card": smi}, launches


def slice5b_phases(smi, env, plain_losses, bandwidth, zero_cpu):
    """Slice 5b's phases under the world-1 group, each printing its JSON
    line; returns the kernels' launches in them."""
    total = {k: 0 for k in KERNELS}
    for phase in (lambda: ragged_ep_world1(smi, bandwidth),
                  lambda: quant_sliced(smi, bandwidth),
                  lambda: (zero_world1(smi, zero_cpu), None),
                  lambda: (launcher_checkpoint(smi, plain_losses), None),
                  lambda: lm_world1(smi, env)):
        line, counts = phase()
        print(json.dumps(line), flush=True)
        for k, n in (counts or {}).items():
            total[k] += n
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Slice 6a: expert-choice routing, local_forward / param_specs, pipelines
# ---------------------------------------------------------------------------

EC_CF = 2.0                # expert choice: two experts a token on average


def ec_decode_layer(group=None):
    """The decode server's INT4 layer (128 experts x 2048 x 2048, no biases,
    relu, bfloat16) with an expert-choice gate at EC_CF."""
    return moe.moe_layer(
        gate_type={"type": "expert_choice", "capacity_factor": EC_CF},
        model_dim=2048, dtype=torch.bfloat16, device="cuda", group=group,
        experts={"type": "ffn", "num_experts_per_device": 128,
                 "hidden_size_per_expert": 2048, "has_fc1_bias": False,
                 "has_fc2_bias": False})


def ec_routing(layer, params, x):
    """The layer's expert-choice routing of x at EC_CF (one rank)."""
    from tutel_tpu_torch.ops import expert_choice as ec_ops
    scores = torch.softmax(layer.gates[0].apply(params["gates"][0], x), 1)
    cap = max(1, int(EC_CF * x.shape[0] / layer.num_global_experts))
    return ec_ops.expert_choice_routing(scores, cap)


def ec_twin(layer, params, x):
    """The expert-choice forward of `layer` with its experts through the
    kernels' plain twins (K2's over a fused stream, else K1's twice)."""
    from tutel_tpu_torch.ops import expert_choice as ec_ops
    ec = ec_routing(layer, params, x)
    y = ec_ops.ec_encode(x, ec)
    ex = params["experts"]
    if "fused_stream" in ex:
        y = fused_ffn.fused_ffn_quant_reference(y, ex["fused_stream"], None,
                                                activations.relu)
    else:
        y = gq.two_call_ffn(lambda a, w, c: gq.grouped_gemm_quant_reference(
            a, w, c), y, ex, None, activations.relu, layer.model_dim)
    return ec_ops.ec_decode(y, ec, x.shape[0])


def kernel_ms(fn, name, reps=REPS):
    """(device busy ms a call, device ms a call of `name`'s kernels) from
    torch.profiler over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name, _, busy, _, _ = device_time(prof)
    mine = sum(t for n, t in by_name.items() if of_kernel(n, SYMBOLS[name]))
    return busy / 1e3 / reps, mine / 1e3 / reps


def to_device(tree, device):
    """A parameter tree on `device`, quantized weights and streams
    included."""
    import dataclasses
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name).to(device)
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree.to(device)


def ec_small_layer_vs_cpu():
    """The EC layer at a small width (16 INT4 experts of 256 x 512, 64
    tokens) in float32 on the card against the CPU, two-call and fused:
    the largest max |card - cpu| / max |cpu|."""
    kw = dict(gate_type={"type": "expert_choice", "capacity_factor": EC_CF},
              experts={"type": "ffn", "num_experts_per_device": 16,
                       "hidden_size_per_expert": 512},
              model_dim=256)
    cpu, card = (moe.moe_layer(device=d, **kw) for d in ("cpu", "cuda"))
    params = cpu.init(torch.Generator().manual_seed(SEED))
    params["experts"] = quant.quantize_expert_params(params["experts"], 4)
    fused = {**params, "experts": fused_ffn.prepare_fused_ffn_params(
        params["experts"])}
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(SEED))
    worst = 0.0
    with torch.no_grad():
        for p in (params, fused):
            ref, _ = cpu(p, x)
            got, _ = card(to_device(p, "cuda"), x.to("cuda"))
            worst = max(worst, float((got.cpu() - ref).abs().max()
                                     / ref.abs().max()))
    if not worst <= F32_TOL:
        raise RuntimeError(f"the float32 EC layer on the card disagrees with "
                           f"the CPU: {worst} > {F32_TOL}")
    return worst


def ec_layer(smi):
    """The expert-choice decode layer (256 tokens, C = 4) on the two-call
    path (exactly K1 x 2) and on a fused stream (exactly K2 x 1): every
    token within BF16_TOL of the same forward through the twins, two calls
    bitwise equal, event and device ms, the kernel's share and the
    combine's device ms; the padded top-2 layer's device ms beside them
    (the same weights, its dropless capacity); then the small float32
    layer against the CPU."""
    from tutel_tpu_torch.ops import expert_choice as ec_ops
    layer = ec_decode_layer()
    params = decode_params(layer)
    fused = {**params, "experts": fused_ffn.prepare_fused_ffn_params(
        params["experts"])}
    x = torch.randn(256, 2048, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 60), device="cuda").to(
        torch.bfloat16)
    report, total = {}, {k: 0 for k in KERNELS}
    with torch.no_grad():
        ec = ec_routing(layer, params, x)
        report["capacity"] = ec.capacity
        for path, p, kernel, n in (("two_call", params, "grouped_gemm_quant",
                                    2),
                                   ("fused", fused, "fused_ffn_quant", 1)):
            def fwd(p=p):
                return layer(p, x)[0]
            reset_launches()
            out = fwd()
            torch.cuda.synchronize()
            counts = read_launches(f"ec_layer {path}", {kernel})
            if counts[kernel] != n:
                raise RuntimeError(f"the EC layer's {path} path launched "
                                   f"{counts}: expected {kernel} x {n}")
            for k, c in counts.items():
                total[k] += c
            if not torch.equal(out, fwd()):
                raise RuntimeError(f"two EC {path} forwards differ")
            ref = ec_twin(layer, p, x)
            err = per_token_rel_err(out, ref)
            if not (torch.isfinite(out.float()).all() and err <= BF16_TOL):
                raise RuntimeError(f"the EC {path} forward against its twin "
                                   f"path: per-token error {err}")
            busy, mine = kernel_ms(fwd, kernel)
            report[path] = {
                "launches": counts, "per_token_rel_err": err,
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                "bitwise_repeat": True, "ms": median_ms(fwd),
                "device_ms": busy, "kernel_device_ms": mine,
                "kernel_share": mine / busy,
                "twin_ms": median_ms(lambda p=p: ec_twin(layer, p, x))}
        y = torch.randn(128, ec.capacity, 2048, generator=torch.Generator(
            device="cuda").manual_seed(SEED + 61), device="cuda").to(
            torch.bfloat16)
        report["combine_device_ms"] = busy_ms(
            lambda: ec_ops.ec_decode(y, ec, 256))
        top2 = decode_layer(0)
        cap = top2.resolve_capacity(params, x)
        report["top2_padded"] = {"capacity": cap, "device_ms": busy_ms(
            lambda: top2(params, x, capacity_override=cap)),
            "ms": median_ms(lambda: top2(params, x, capacity_override=cap))}
    report["small_float32_vs_cpu"] = ec_small_layer_vs_cpu()
    return {"phase": "ec_layer", "tokens": 256, "experts": 128,
            "capacity_factor": EC_CF, "tol": BF16_TOL, "f32_tol": F32_TOL,
            **report, "card": smi}, total


EC_LM_NEW_TOKENS = 64      # the top-2 serve's 320, cut to keep the run short


def ec_lm_serve(smi):
    """LM2K with an expert-choice gate at EC_CF (its own capacity_factor 0.0
    would fail EC's cf > 0): 64 prompts of 1664 tokens, EC_LM_NEW_TOKENS new
    each, chunk 16, with moe_overrides capacity_factor EC_CF, so the prefill
    runs two experts a token too (without it the engine's prefill passes
    capacity_override = its chunk's tokens, which the EC rule takes as C:
    every expert takes every prompt token). Launches only K2, K6, K7, K8."""
    lm = TransformerMoE(TransformerMoEConfig(**{
        **LM_CONFIG, "gate_type": "expert_choice",
        "capacity_factor": EC_CF}, dtype=torch.bfloat16), device="cuda")
    lm_p = lm_params(lm, torch.Generator(device="cuda").manual_seed(SEED))
    ov = {"capacity_factor": EC_CF}
    warm = lm_serve(lm, lm_p, 64, 1664, 16, SEED + 1, ov)
    reset_launches()
    run = lm_serve(lm, lm_p, 64, 1664, EC_LM_NEW_TOKENS, SEED, ov)
    counts = read_launches("ec_lm serve", {"fused_ffn_quant", "decode_attn",
                                           "prefill_attn", "kv_write"})
    prof = lm_profile(lm, lm_p, SEED + 2, moe_overrides=ov)
    prefill = lm_prefill_profile(lm, lm_p, SEED + 3, "fused_ffn_quant", ov)
    del lm, lm_p
    return {"phase": "ec_lm_serve", "moe_overrides": ov,
            "warmup_seconds": warm["seconds"], **run, "launches": counts,
            "decode_profile": prof, "prefill_profile": prefill,
            "card": smi}, counts


def ec_engines_vs_cpu():
    """Small float32 engines with an expert-choice gate on the card against
    the CPU: the LM engine's greedy tokens identical and apply_decode
    logits within SMALL_TOL, the MoE engine's outputs within SMALL_TOL."""
    gate = {"type": "expert_choice", "capacity_factor": EC_CF}
    return {"phase": "ec_engines_vs_cpu", "tol": SMALL_TOL,
            "lm_max_rel_err": small_lm_check(kv_modes=(8,),
                                             gate_type="expert_choice",
                                             capacity_factor=EC_CF),
            "greedy_tokens": "identical",
            "moe_max_rel_err": small_engine_check(gate=gate)}


def ec_example_args(device, full):
    from tutel_tpu_torch.examples import helloworld_expert_choice as hec
    argv = ["--device", device]
    if full:   # helloworld's default width, the example's experts and cf
        argv += ["--batch", "16", "--num_tokens", "512", "--model_dim",
                 "2048", "--hidden_size", "2048", "--num_steps", "10"]
    return hec, hec.build_args(argv)


def timed_run(module, args):
    """module.run(args) with the host time between its step lines (each
    line follows a loss read back to the host): (losses, step ms)."""
    marks = [time.perf_counter()]

    def log(line):
        if line.startswith("STEP-"):
            marks.append(time.perf_counter())
    losses = module.run(args, log=log)
    return losses, [1e3 * (b - a) for a, b in zip(marks, marks[1:])]


def ec_train(smi, cpu_losses):
    """examples/helloworld_expert_choice.py at helloworld's default width
    (16 x 512 tokens, 2048 x 2048, the example's 4 experts and cf 2.0,
    float32, 10 steps): finite, falling losses, ms a step, TFLOP/s by the
    helloworld formula with cf 2 for min(k, E), peak memory; then the
    example's defaults on the card against the CPU (cpu_losses)."""
    hec, args = ec_example_args("cuda", True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms = timed_run(hec, args)
    launches = read_launches("ec_train", set())
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"ec_train losses {losses}: not finite, or the "
                           "last is not below the first")
    median = statistics.median(step_ms[-5:])
    flops = (args.batch * args.num_tokens * args.model_dim
             * args.hidden_size * 4 * 3 * EC_CF)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, dargs = ec_example_args("cuda", False)
    card = hec.run(dargs, log=lambda *_: None)
    err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu_losses))
    if not err <= TRAIN_TOL:
        raise RuntimeError(f"the EC example on the card against the CPU: "
                           f"{err} > {TRAIN_TOL}")
    return {"phase": "ec_train", "config": {k: getattr(args, k) for k in (
        "batch", "num_tokens", "model_dim", "hidden_size",
        "num_local_experts", "capacity_factor", "num_steps")},
        "losses": losses, "step_ms": step_ms,
        "median_step_ms_last5": median, "tflops": flops / median / 1e9,
        "f32_peak_share": flops / median / 1e-3 / F32_PEAK,
        "peak_mem_gb": peak, "launches": launches,
        "defaults_vs_cpu_rel_err": err, "tol": TRAIN_TOL, "card": smi}


PIPE_ARGV = ["--device", "cuda", "--num_stages", "1", "--model_dim", "2048",
             "--hidden", "2048", "--num_experts", "4", "--batch", "4096",
             "--n_micro", "8", "--num_steps", "5"]
PIPE_TOL = 1e-5            # pipeline against microbatches in sequence


def sequential_losses(module, args):
    """The example's model and loss trained with its microbatches run in
    sequence, without the pipeline: the losses of args.num_steps SGD
    steps."""
    from tutel_tpu_torch.examples import helloworld_pipeline as hp
    _, _, layer, local, x = hp.setup(args)
    stage = hp.stage_fn(layer)
    target = torch.sin(torch.cumsum(x, dim=-1))
    nm = args.n_micro

    def loss_fn(p):
        p0 = tree_replace(p, [t[0] for t in tree_leaves(p)])
        ys, aux = [], 0.0
        for xm in x.reshape(nm, -1, x.shape[-1]):
            y, a = stage(p0, xm)
            ys.append(y)
            aux = aux + a
        if module is hp:
            y = torch.cat(ys)
            return torch.mean((y - target) ** 2) + 0.01 * aux / nm
        return sum((y.float() ** 2).sum() / args.batch for y in ys) / nm \
            + aux / nm
    losses = []
    for _ in range(args.num_steps):
        local, loss, _ = sgd_step(loss_fn, local, args.lr)
        losses.append(float(loss))
    return losses


def rel_close(a, b):
    return float((a - b).abs().max()) <= PIPE_TOL * max(
        float(b.abs().max()), 1e-30)


def pipeline_world1(smi, env):
    """helloworld_pipeline (GPipe) and helloworld_1f1b at one stage (the
    world-1 group; model_dim 2048, hidden 2048, 4 experts, batch 4096,
    n_micro 8, 5 steps, float32): each one's losses against the same model
    trained with the microbatches in sequence, ms a step and peak memory;
    1F1B's loss and gradients against GPipe's on the same loss; then a
    stage whose body is local_forward of a top-2 and of an EC layer:
    GPipe's outputs and 1F1B's loss against the sequential run."""
    from tutel_tpu_torch.examples import helloworld_1f1b as h1
    from tutel_tpu_torch.examples import helloworld_pipeline as hp
    from tutel_tpu_torch.parallel import (local_stage_params, pipeline,
                                          pipeline_1f1b, stack_stage_params)
    out = {"phase": "pipeline_world1", "world_size": env.global_size,
           "backend": env.backend, "argv": PIPE_ARGV, "tol": PIPE_TOL}
    for name, module in (("gpipe", hp), ("1f1b", h1)):
        args = module.build_args(PIPE_ARGV)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, step_ms = timed_run(module, args)
        read_launches(f"pipeline_world1 {name}", {ROUTE})
        peak = torch.cuda.max_memory_allocated() / 1e9
        seq = sequential_losses(module, args)
        err = max(abs(a - b) / abs(b) for a, b in zip(losses, seq))
        if not (all(np.isfinite(losses)) and err <= PIPE_TOL):
            raise RuntimeError(f"{name}: losses {losses} against the "
                               f"sequential {seq}: {err}")
        out[name] = {"losses": losses, "sequential_losses": seq,
                     "max_rel_err": err, "step_ms": step_ms,
                     "median_step_ms_last3": statistics.median(step_ms[-3:]),
                     "peak_mem_gb": peak}
        torch.cuda.empty_cache()
    # 1F1B's gradients against GPipe's on the 1F1B example's loss
    args = h1.build_args(PIPE_ARGV)
    _, mesh, layer, local, x = hp.setup(args)
    stage = hp.stage_fn(layer)

    def loss_fn(y):
        return (y.float() ** 2).sum() / args.batch
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(local)]
    y, aux = pipeline(stage, 1, mesh, n_micro=args.n_micro, has_aux=True)(
        tree_replace(local, leaves), x)
    gp = sum(loss_fn(ym) for ym in y.reshape(args.n_micro, -1, y.shape[-1])) \
        / args.n_micro + aux
    gp_grads = torch.autograd.grad(gp, leaves)
    loss, grads = pipeline_1f1b(stage, loss_fn, 1, mesh, n_micro=args.n_micro,
                                has_aux=True)(local, x)
    gp = gp.detach()
    if not (abs(float(loss) - float(gp)) <= PIPE_TOL * abs(float(gp))
            and all(rel_close(b, a) for a, b in zip(gp_grads,
                                                     tree_leaves(grads)))):
        raise RuntimeError("1F1B's loss or gradients differ from GPipe's")
    out["1f1b_vs_gpipe"] = {"loss": float(loss), "gpipe_loss": float(gp),
                            "grads_within_tol": True}
    # one training step of each schedule on that loss, profiled: device
    # busy share, time by kernel kind, the step's peak memory
    fwd = pipeline(stage, 1, mesh, n_micro=args.n_micro, has_aux=True)
    train = pipeline_1f1b(stage, loss_fn, 1, mesh, n_micro=args.n_micro,
                          has_aux=True)

    def gpipe_loss(p):
        y, aux = fwd(p, x)
        return sum(loss_fn(ym) for ym in y.reshape(
            args.n_micro, -1, y.shape[-1])) / args.n_micro + aux
    for name, step in (("gpipe", lambda: sgd_step(gpipe_loss, local,
                                                  args.lr)),
                       ("1f1b", lambda: train(local, x))):
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof = profiled(step)
        out[f"{name}_step_profile"] = {
            **prof, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "ms": median_ms(step, reps=5)}
    # a stage whose body is local_forward
    for gate in ({"type": "top", "k": 2, "capacity_factor": 1.0},
                 {"type": "expert_choice", "capacity_factor": EC_CF}):
        lay = moe.moe_layer(
            gate_type=gate, model_dim=args.model_dim, device="cuda",
            group=env, experts={"type": "ffn",
                                "num_experts_per_device": args.num_experts,
                                "hidden_size_per_expert": args.hidden})
        body = lay.local_forward()

        def lstage(p, h, body=body):
            o, a = body(p, h)
            return h + o, a
        p1 = local_stage_params(stack_stage_params([lay.init(
            torch.Generator(device="cuda").manual_seed(SEED + 70))]), mesh)
        with torch.no_grad():
            y, aux = pipeline(lstage, 1, mesh, n_micro=args.n_micro,
                              has_aux=True)(p1, x)
            p0 = tree_replace(p1, [t[0] for t in tree_leaves(p1)])
            seq, total = [], 0.0
            for xm in x.reshape(args.n_micro, -1, x.shape[-1]):
                ym, a = lstage(p0, xm)
                seq.append(ym)
                total = total + loss_fn(ym) + a
            seq = torch.cat(seq)
        loss, _ = pipeline_1f1b(lstage, loss_fn, 1, mesh,
                                n_micro=args.n_micro, has_aux=True)(p1, x)
        want = float(total) / args.n_micro
        if not (rel_close(y, seq) and abs(float(loss) - want)
                <= PIPE_TOL * abs(want)):
            raise RuntimeError(f"local_forward stage ({gate['type']}): the "
                               f"pipelines differ from the sequential run")
        out[f"local_forward_{gate['type']}"] = {
            "gpipe_vs_sequential": "within tol", "1f1b_loss": float(loss),
            "sequential_loss": want}
    return out


def slice6a_phases(smi, env, ec_cpu_losses):
    """Slice 6a's phases under the world-1 group, each printing its JSON
    line; returns the kernels' launches in their path runs (ec_layer's and
    ec_lm_serve's)."""
    total = {k: 0 for k in KERNELS}
    for phase in (lambda: ec_layer(smi), lambda: ec_lm_serve(smi),
                  lambda: (ec_engines_vs_cpu(), None),
                  lambda: (ec_train(smi, ec_cpu_losses), None),
                  lambda: (pipeline_world1(smi, env), None)):
        line, counts = phase()
        print(json.dumps(line), flush=True)
        for k, n in (counts or {}).items():
            total[k] += n
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Slices 6b and 6c (step 15): sequence parallelism, the vision model and
# the host library; no ported kernel but the location scan lies on
# these paths
# ---------------------------------------------------------------------------

SP_TOL = 2e-2           # the ring body's bf16 logits: per token, of max |logit|
# the ring's share of tokens allowed past SP_TOL: its float32 online softmax
# rounds apply's bf16 attention differently, which can flip a top-2 choice
# at a near-tie and move that token (and, through later blocks' attention,
# a little of the tokens after it); 1.7% on an H100. Such flips fall on
# tokens at random, so each position's median token over the batch must
# stay within SP_POS_TOL: on an H100 the ring's largest is 5.7e-3 of max
# |logit|. SP_FAULT_TAIL: a planted fault, one future key leaked into the
# last positions of the sequence, that the check must see (on an H100 it
# raises the largest median to 1.6e-2, and moves too few tokens past
# SP_TOL, 2.2%, to exceed the share)
SP_FLIP_SHARE, SP_POS_TOL, SP_FAULT_TAIL = 0.03, 1e-2, 16
SP_NLL_TOL = 1e-3       # the SP body's nll against loss's, bf16
# the gradients, per leaf, compared in float32 with every token at every
# expert (top_k = E), where no top-k choice can flip: the norm of the
# difference within SP_GRAD_TOL of the leaf's norm, and its largest entry
# within SP_GRAD_MAX_TOL of the leaf's max |ref|. A rounding difference
# still moves an expert's relu input across 0 for a few of the 268 million
# (token, hidden unit) pairs a layer; each such token's changed cotangent
# reaches every leaf before it (on an H100: 3e-5 to 1.2e-4 of a leaf's
# norm, 6.4e-4 for the experts' fc1, their largest entry 4.2e-3 of the
# max), while a fault in the attention's backward moves every leaf by far
# more
SP_GRAD_TOL, SP_GRAD_MAX_TOL = 2e-3, 2e-2
EXAMPLE_TOL = 1e-4      # an example's losses, card against the CPU
SP_MODES = ("ulysses", "ring")


def leaf_names(tree, prefix=""):
    """Dotted names of a tree's tensors, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def grads_of(loss_fn, params):
    """(loss, the gradients in tree_leaves order) of loss_fn(params)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_replace(params, leaves))
    return loss.detach(), torch.autograd.grad(loss, leaves)


def step_ms(fn, reps=5):
    """Median host ms of `reps` synchronized calls after one warm-up, and
    the peak memory of those calls in GB."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), torch.cuda.max_memory_allocated() / 1e9


def seqpar_world1(smi, env):
    """The LM-train model (bench_lm_train.py's, bf16, 32 x 512 tokens) under
    the world-1 group: apply_seqpar at one rank equals apply bit for bit;
    the per-rank SP body (`_seqpar_local`, `_loss_seqpar_local`) forced at
    P = 1 in both attention modes against apply / loss (Ulysses' logits
    bit for bit, the ring's bf16 logits per token and per position, and a
    planted tail fault that the ring's check must see; the nll; one
    backward per leaf in float32 with every token at every expert); ms a
    forward + backward step (median of 5) and peak memory of each mode
    beside loss's (bf16, top-2)."""
    cfg = TransformerMoEConfig(**LM_TRAIN_CONFIG, dtype=torch.bfloat16)
    model = TransformerMoE(cfg, group=env, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    b, t = LM_TRAIN_BATCH
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (b, t))).to("cuda")
    out = {"phase": "seqpar_world1", "world_size": env.global_size,
           "backend": env.backend,
           "config": {**LM_TRAIN_CONFIG, "batch": b, "seq": t,
                      "dtype": "bfloat16"},
           "tol": {"logits": SP_TOL, "flip_share": SP_FLIP_SHARE,
                   "position_median": SP_POS_TOL,
                   "nll": SP_NLL_TOL, "grads_float32_dense_norm":
                   SP_GRAD_TOL, "grads_float32_dense_max": SP_GRAD_MAX_TOL}}
    reset_launches()
    with torch.no_grad():
        ref, _ = model.apply(params, tokens)
        fallback, _ = model.apply_seqpar(params, tokens)
        if not torch.equal(fallback, ref):
            raise RuntimeError("apply_seqpar at one rank is not apply")
        del fallback
        scale = float(ref.float().abs().max())

        def logits_check(mode):
            got, _ = model._seqpar_local(params, tokens, attn_mode=mode)
            err = (got.float() - ref.float()).abs().amax(dim=-1) / scale
            past = int((err > SP_TOL).sum())
            pos = err.median(dim=0).values
            return {"bit_exact": torch.equal(got, ref),
                    "max_token_err": float(err.max()),
                    "tokens_past_tol": past,
                    "max_position_median_err": float(pos.max()),
                    "within": past <= SP_FLIP_SHARE * tokens.numel()
                    and float(pos.max()) <= SP_POS_TOL}

        _, (nll_ref, _) = model.loss(params, tokens)
        for mode in SP_MODES:
            out[mode] = logits_check(mode)
            _, (nll, _) = model._loss_seqpar_local(params, tokens,
                                                   attn_mode=mode)
            out[mode].update(nll=float(nll), nll_ref=float(nll_ref),
                             nll_err=abs(float(nll) - float(nll_ref)))
            if not out[mode]["bit_exact" if mode == "ulysses" else
                             "within"] or out[mode]["nll_err"] > SP_NLL_TOL:
                raise RuntimeError(f"seqpar_world1 {mode}: {out[mode]}")
        step = transformer.ring_attention_step
        tail = tokens.shape[1] - SP_FAULT_TAIL

        def leaky_step(q, k, v, q_pos, k_pos, *state):
            return step(q, k, v, q_pos + (q_pos >= tail).long(), k_pos,
                        *state)

        transformer.ring_attention_step = leaky_step
        try:
            out["ring_tail_fault"] = {"positions": SP_FAULT_TAIL,
                                      **logits_check("ring")}
        finally:
            transformer.ring_attention_step = step
        if out["ring_tail_fault"]["within"]:
            raise RuntimeError(f"seqpar_world1: the ring's check misses a "
                               f"planted tail fault: {out}")
    del ref
    torch.cuda.empty_cache()
    model32 = TransformerMoE(TransformerMoEConfig(**LM_TRAIN_CONFIG),
                             group=env, device="cuda")
    params32 = tree_replace(params, [p.float() for p in tree_leaves(params)])
    dense = {"top_k": cfg.num_local_experts}
    names = leaf_names(params32)
    _, ref_grads = grads_of(lambda p: model32.loss(
        p, tokens, moe_overrides=dense)[0], params32)
    for mode in SP_MODES:
        _, grads = grads_of(lambda p: model32._loss_seqpar_local(
            p, tokens, moe_overrides=dense, attn_mode=mode)[0], params32)
        fro = [float((g - r).norm() / r.norm().clamp_min(1e-30))
               for g, r in zip(grads, ref_grads)]
        top = [float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
               for g, r in zip(grads, ref_grads)]
        out[mode].update(max_leaf_grad_norm_err=max(fro),
                         max_leaf_grad_max_err=max(top),
                         worst_leaf=names[int(np.argmax(top))])
        if not (max(fro) <= SP_GRAD_TOL and max(top) <= SP_GRAD_MAX_TOL):
            raise RuntimeError(f"seqpar_world1 {mode}: gradient errors "
                               f"{dict(zip(names, zip(fro, top)))}")
        del grads
    del ref_grads, params32
    torch.cuda.empty_cache()
    for name, fn in (("loss", lambda p: model.loss(p, tokens)[0]),) + tuple(
            (mode, lambda p, mode=mode: model._loss_seqpar_local(
                p, tokens, attn_mode=mode)[0]) for mode in SP_MODES):
        ms, peak = step_ms(lambda: grads_of(fn, params))
        out.setdefault(name, {}).update(step_ms=ms, peak_mem_gb=peak)
        torch.cuda.empty_cache()
    out["launches"] = read_launches("seqpar_world1", {ROUTE})
    out["card"] = smi
    return out


def ring_blocks(q, k, v, p):
    """models.transformer.ring_attention_step over p blocks of one
    sequence: block i's queries take the K/V blocks in rank i's ring order
    (i, i - 1, ...), with no collective. q [B, T, NH, HD], k, v [B, T, KVH,
    HD] -> [B, T, NH, HD] in q's dtype."""
    from tutel_tpu_torch.models.transformer import ring_attention_step
    b, t, nh, hd = q.shape
    kvh = k.shape[2]
    mq, tl = nh // kvh, t // p
    pos = torch.arange(tl, device=q.device)
    qg = q.reshape(b, t, mq, kvh, hd)
    outs = []
    for i in range(p):
        m = torch.full((b, mq, kvh, tl), float("-inf"), device=q.device)
        den = torch.zeros((b, mq, kvh, tl), device=q.device)
        acc = torch.zeros((b, tl, mq, kvh, hd), device=q.device)
        for j in range(p):
            src = (i - j) % p
            m, den, acc = ring_attention_step(
                qg[:, i * tl:(i + 1) * tl], k[:, src * tl:(src + 1) * tl],
                v[:, src * tl:(src + 1) * tl], i * tl + pos, src * tl + pos,
                m, den, acc)
        outs.append(acc / den.permute(0, 3, 1, 2)[..., None])
    return torch.cat(outs, dim=1).reshape(b, t, nh, hd).to(q.dtype)


def full_causal_attention(q, k, v):
    """Causal attention over the whole sequence as the model's `_attn`
    computes it: float32 scores, probabilities in q's dtype."""
    b, t, nh, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, t, nh // kvh, kvh, hd)
    scores = torch.einsum("bqmgd,bkgd->bmgqk", qg.float(),
                          k.float()) * hd ** -0.5
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, torch.full_like(scores,
                                                       float("-inf")))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bmgqk,bkgd->bqmgd", probs, v)
    return out.reshape(b, t, nh, hd)


def ring_blocks_check(smi, blocks=4, t=512):
    """The ring's per-step function over `blocks` blocks of one sequence of
    t at the LM-train width (16 heads of 128; MHA and 4 KV heads) against
    full causal attention, forward and the gradients of q, k and v: float32
    within F32_TOL, bfloat16 within BF16_TOL, of max |ref|."""
    nh, hd = LM_TRAIN_CONFIG["num_heads"], (LM_TRAIN_CONFIG["model_dim"]
                                            // LM_TRAIN_CONFIG["num_heads"])
    out = {"phase": "ring_blocks", "blocks": blocks, "seq": t, "heads": nh,
           "head_dim": hd}
    g = torch.Generator(device="cuda").manual_seed(SEED + 80)
    reset_launches()
    for kvh in (nh, 4):
        base = [torch.randn(1, t, n, hd, generator=g, device="cuda")
                for n in (nh, kvh, kvh, nh)]
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            q, k, v = (a.to(dtype).requires_grad_(True) for a in base[:3])
            results = []
            for fn in (lambda: ring_blocks(q, k, v, blocks),
                       lambda: full_causal_attention(q, k, v)):
                y = fn()
                results.append((y.detach(), torch.autograd.grad(
                    y.float(), (q, k, v), base[3].to(dtype).float())))
            (y, gr), (yr, grr) = results
            errs = [rel_err(y.float(), yr.float())[1]] + [
                rel_err(a.float(), b.float())[1] for a, b in zip(gr, grr)]
            key = f"kvh{kvh}_{str(dtype).split('.')[1]}"
            out[key] = {"forward": errs[0], "grad_q": errs[1],
                        "grad_k": errs[2], "grad_v": errs[3], "tol": tol,
                        "finite": all(bool(torch.isfinite(a).all())
                                      for a in gr)}
            if not (max(errs) <= tol and out[key]["finite"]):
                raise RuntimeError(f"ring_blocks {key}: {out[key]}")
    out["launches"] = read_launches("ring_blocks", set())
    out["card"] = smi
    return out


SEQPAR_EXAMPLE_ARGV = (("ulysses", []),
                       ("ring_kv4", ["--attn", "ring", "--num_kv_heads",
                                     "4"]))
VISION_BATCH, VISION_STEPS, VISION_CPU_STEPS = 256, 20, 5
NATIVE_CPU_STEPS = 10


def vision_batch():
    rng = np.random.default_rng(SEED + 90)
    cfg = VisionMoEConfig()
    images = rng.standard_normal((VISION_BATCH, cfg.image_size,
                                  cfg.image_size, cfg.in_channels))
    labels = rng.integers(0, cfg.num_classes, VISION_BATCH)
    return (torch.from_numpy(images.astype(np.float32)),
            torch.from_numpy(labels))


def check_losses(name, got, ref):
    """max |card - CPU| over the CPU's steps; raises past EXAMPLE_TOL."""
    err = float(np.max(np.abs(np.array(got[:len(ref)]) - np.array(ref))))
    if not err <= EXAMPLE_TOL:
        raise RuntimeError(f"{name} on the card: losses {got[:len(ref)]} "
                           f"against the CPU's {list(ref)}")
    return err


# An Adam trainer's trajectory is not held to the CPU's step by step: its
# first step moves every parameter by about lr, whatever the size of its
# gradient, so an element whose gradient is rounding noise (the LM has one
# at 4.5e-9 of a largest 2.3e-2) moves by +-lr as its sign falls, and the
# losses part by 1e-4 within 10 steps between two CPU code paths alone.
# Its steps are held one by one instead: the card takes each step's loss
# and gradients from the CPU's parameters at that step. The gradients are
# held by their median step: from the same parameters a gate near-tie can
# still send one token to another expert on the card, which moves that
# step's expert gradients by the token's share and the loss by nothing
# visible, while a fault in the backward would move every step.
# tools/adam_replay.py shows both.
def cpu_train_states(loss_fn, start, make_opt, batches):
    """Trains on the CPU from `start`, one optimizer step a batch; for each
    step (the parameters it starts from, its loss, its gradients)."""
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(start)]
    params = tree_replace(start, leaves)
    opt = make_opt(leaves)
    states = []
    for batch in batches:
        before = [p.detach().clone() for p in leaves]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        states.append((before, float(loss), [p.grad.clone() for p in leaves]))
        opt.step()
    return states


def check_states(name, loss_fn, start, states, batches, device="cuda"):
    """From each of the CPU's states, the loss and gradients on `device`:
    every loss within EXAMPLE_TOL of the CPU's, and the median step's
    gradient error (|card - CPU| / |CPU| over all leaves as one vector)
    within F32_TOL. Returns (the losses, the largest loss difference, each
    step's gradient error)."""
    losses, loss_err, grad_errs = [], 0.0, []
    for (before, ref_loss, ref_grads), batch in zip(states, batches):
        leaves = [p.to(device).requires_grad_(True) for p in before]
        loss = loss_fn(tree_replace(start, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss))
        loss_err = max(loss_err, abs(losses[-1] - ref_loss))
        diff = sum(float((g.cpu() - r).square().sum())
                   for g, r in zip(grads, ref_grads))
        grad_errs.append(math.sqrt(diff / sum(float(r.square().sum())
                                              for r in ref_grads)))
    if not (loss_err <= EXAMPLE_TOL
            and statistics.median(grad_errs) <= F32_TOL):
        raise RuntimeError(f"{name} on the card from the CPU's states: "
                           f"losses {losses} against "
                           f"{[st[1] for st in states]}, gradient errors "
                           f"{grad_errs} (median > {F32_TOL})")
    return losses, loss_err, grad_errs


def vision_start():
    return VisionMoE(VisionMoEConfig(), device="cpu").init(
        torch.Generator().manual_seed(SEED))


def vision_run(device, steps, start=None):
    """VisionMoE at VisionMoEConfig's defaults on `device`, from one CPU
    start (default vision_start()): `steps` Adam(1e-2) steps on
    vision_batch(). (model, params, losses, synchronized ms a step)."""
    cfg = VisionMoEConfig()
    model = VisionMoE(cfg, device=device)
    start = vision_start() if start is None else start
    leaves = [p.detach().to(device).clone().requires_grad_(True)
              for p in tree_leaves(start)]
    params = tree_replace(start, leaves)
    images, labels = (a.to(device) for a in vision_batch())
    opt = torch.optim.Adam(leaves, lr=1e-2)
    losses, times = [], []
    for _ in range(steps):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss, _ = model.loss(params, images, labels)
        loss.backward()
        opt.step()
        losses.append(float(loss))
        times.append(1e3 * (time.perf_counter() - t0))
    return model, params, losses, times


def vision_loss(device):
    """VisionMoE's loss on vision_batch() on `device`, as vision_run
    takes it, for cpu_train_states / check_states."""
    model = VisionMoE(VisionMoEConfig(), device=device)
    images, labels = (a.to(device) for a in vision_batch())
    return lambda params, _: model.loss(params, images, labels)[0]


def native_lm_loss(args, device):
    """examples/moe_transformer_lm.run's loss on `device` (its model, its
    key seeded 7, its l_aux weight), for cpu_train_states /
    check_states."""
    from tutel_tpu_torch.examples import moe_transformer_lm as mtl
    model = mtl.build_model(args, device)
    key = torch.Generator(device=device).manual_seed(7)
    return lambda params, batch: model.loss(
        params, batch.to(device), key=key, l_aux_wt=args.l_aux_wt)[0]


def native_lm_args(device, steps):
    from tutel_tpu_torch.examples import moe_transformer_lm as mtl
    return mtl.build_args(["--device", device, "--steps", str(steps)])


def adam_cpu_states():
    """The CPU states of the Adam trainers (cpu_train_states): the vision
    trainer's first steps; moe_transformer_lm's over the example's start,
    batches, loss and AdamW, with that start."""
    from tutel_tpu_torch.examples import moe_transformer_lm as mtl
    vision = cpu_train_states(
        vision_loss("cpu"), vision_start(),
        lambda leaves: torch.optim.Adam(leaves, lr=1e-2),
        [None] * VISION_CPU_STEPS)
    args = native_lm_args("cpu", NATIVE_CPU_STEPS)
    start = mtl.build_model(args, "cpu").init(torch.Generator().manual_seed(0))
    states = cpu_train_states(
        native_lm_loss(args, "cpu"), start,
        lambda leaves: torch.optim.AdamW(leaves, lr=args.lr,
                                         betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=1e-4),
        mtl.make_batches(args))
    return {"vision": vision, "native_lm": (start, states)}


def slice6b_cpu_refs():
    """The CPU results step 15 holds the card's against, computed before
    the NCCL group exists: seqpar_lm's losses at its defaults in both
    runs; the Adam trainers' states (adam_cpu_states)."""
    from tutel_tpu_torch import csrc
    from tutel_tpu_torch.examples import seqpar_lm
    built = csrc.native.library_path().exists()
    t0 = time.perf_counter()
    csrc.lib()                          # g++, at its first use here
    build = {"seconds": time.perf_counter() - t0, "was_built": built}
    refs = {name: seqpar_lm.run(seqpar_lm.build_args(
        ["--device", "cpu"] + argv), log=lambda *_: None)
        for name, argv in SEQPAR_EXAMPLE_ARGV}
    refs.update(adam_cpu_states())
    refs["native_build"] = build
    return refs


def seqpar_example(smi, cpu_refs):
    """examples/seqpar_lm.py at its defaults on the card at one rank
    (Ulysses, and ring with 4 KV heads): its losses against the CPU's."""
    from tutel_tpu_torch.examples import seqpar_lm
    out = {"phase": "seqpar_example", "tol": EXAMPLE_TOL}
    reset_launches()
    for name, argv in SEQPAR_EXAMPLE_ARGV:
        args = seqpar_lm.build_args(["--device", "cuda"] + argv)
        losses, ms = timed_run(seqpar_lm, args)
        err = check_losses(f"seqpar_lm {name}", losses, cpu_refs[name])
        out[name] = {"argv": argv, "losses": losses, "max_abs_diff": err,
                     "median_step_ms": statistics.median(ms)}
    out["launches"] = read_launches("seqpar_example", {ROUTE})
    out["card"] = smi
    return out


def vision_train(smi, cpu_refs):
    """VisionMoE at VisionMoEConfig's defaults (32 x 32 x 3 images, patch 4,
    model_dim 64, 4 heads, 4 layers, MoE in 2 of them with 4 experts of
    128, top-2, cf 1.25, float32), 256 images, 20 Adam(1e-2) steps:
    finite, falling losses, ms a step, peak memory; from each of the CPU's
    first 5 states, the loss and gradients (check_states); then its MoE
    state through scatter_state(., 2) and gather_states back into the
    model, bit for bit."""
    from tutel_tpu_torch.checkpoint import reshard
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    model, params, losses, times = vision_run("cuda", VISION_STEPS)
    replay, err, grad_errs = check_states(
        "vision_train", vision_loss("cuda"), vision_start(),
        cpu_refs["vision"], [None] * VISION_CPU_STEPS)
    launches = read_launches("vision_train", {ROUTE})
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"vision_train: losses {losses}")
    state = model.moe_state_dict(params)
    merged = reshard.gather_states(reshard.scatter_state(state, 2))
    loaded = model.load_moe_state_dict(model.init(torch.Generator(
        device="cuda").manual_seed(SEED + 91)), merged)
    exact = all(np.array_equal(merged[k], state[k]) for k in state) and all(
        torch.equal(a, b.detach()) for i in model.moe_layers
        for a, b in zip(tree_leaves(loaded["blocks"][i]["moe"]),
                        tree_leaves(params["blocks"][i]["moe"])))
    if not exact:
        raise RuntimeError("vision_train: the MoE state's 1 -> 2 -> 1 "
                           "reshard is not bit-exact")
    return {"phase": "vision_train", "config": dataclasses.asdict(
        VisionMoEConfig()) | {"dtype": "float32"}, "batch": VISION_BATCH,
        "steps": VISION_STEPS, "losses": losses, "max_abs_diff_cpu": err,
        "tol": EXAMPLE_TOL, "losses_from_cpu_states": replay,
        "cpu_losses": [st[1] for st in cpu_refs["vision"]],
        "grad_rel_err_cpu": grad_errs, "grad_tol_median": F32_TOL,
        "step_ms": times, "median_step_ms": statistics.median(times[1:]),
        "peak_mem_gb": peak, "reshard_bit_exact": True,
        "launches": launches, "card": smi}


def native_lm(smi, cpu_refs):
    """The host library (built by g++ at its first use, timed in
    slice6b_cpu_refs) against ops/dispatch and
    ops/routing on the card (float32 within F32_TOL, locations exact),
    then examples/moe_transformer_lm.py at its defaults on the card:
    falling losses, tokens/s; from each of the CPU's first 10 states, the
    loss and gradients (check_states); of the ported kernels only the
    location scan launches in the phase (the card's extract_critical
    above and the example's routes)."""
    from tutel_tpu_torch import csrc
    from tutel_tpu_torch.examples import moe_transformer_lm as mtl
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(SEED + 95)
    reset_launches()
    s, e, m, k = 4096, 8, 256, 2
    scores = torch.softmax(torch.randn(s, e, generator=g, device="cuda"), 1)
    cap = routing.compute_static_capacity(s, e, k, 1.0)
    crit, _ = routing.extract_critical(scores, k, cap)
    x = torch.randn(s, m, generator=g, device="cuda")
    disp = torch.randn(e, cap, m, generator=g, device="cuda")
    host = [t.cpu() for t in (crit.gates, crit.indices, crit.locations)]
    xg = x.clone().requires_grad_(True)
    gates = crit.gates.clone().requires_grad_(True)
    dec = dispatch.fast_decode(disp, crit._replace(gates=gates), True)
    gate_grad, = torch.autograd.grad((dec * x).sum(), gates)
    errs = {
        "dispatch_forward": rel_err(csrc.dispatch_forward(
            *host, x.cpu(), cap, e), dispatch.fast_encode(x, crit, False)
            .cpu())[1],
        "dispatch_backward_data": rel_err(csrc.dispatch_backward_data(
            *host, disp.cpu(), s), dec.detach().cpu())[1],
        "dispatch_backward_gate": rel_err(csrc.dispatch_backward_gate(
            host[1], host[2], disp.cpu(), x.cpu()), gate_grad.cpu())[1]}
    del xg
    locs, counts = csrc.cumsum_locations(host[1], e)
    exact = torch.equal(locs.long(), crit.locations.cpu().long()) and \
        torch.equal(counts.long(), crit.dispatch_count.cpu().long())
    if not (max(errs.values()) <= F32_TOL and exact):
        raise RuntimeError(f"native_lm: the host library against the card's "
                           f"dispatch: {errs}, locations exact {exact}")
    args = mtl.build_args(["--device", "cuda"])
    lines = []
    torch.cuda.reset_peak_memory_stats()
    losses = mtl.run(args, log=lines.append)
    peak = torch.cuda.max_memory_allocated() / 1e9
    start, states = cpu_refs["native_lm"]
    replay, err, grad_errs = check_states(
        "moe_transformer_lm", native_lm_loss(args, "cuda"), start, states,
        mtl.make_batches(native_lm_args("cpu", len(states))))
    launches = read_launches("native_lm", {ROUTE})
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError(f"moe_transformer_lm: losses {losses}")
    summary = next(ln for ln in lines if ln.startswith("[Summary]"))
    return {"phase": "native_lm", "gxx": gxx,
            "build": cpu_refs["native_build"],
            "dispatch_rel_err": errs, "locations_exact": True,
            "shape": {"tokens": s, "experts": e, "model_dim": m, "top_k": k,
                      "capacity": cap},
            "losses_first10": losses[:10], "losses_last": losses[-1],
            "losses_from_cpu_states": replay, "max_abs_diff_cpu": err,
            "tol": EXAMPLE_TOL, "cpu_losses": [st[1] for st in states],
            "grad_rel_err_cpu": grad_errs, "grad_tol_median": F32_TOL,
            "tokens_per_s": float(re.search(r"~([0-9]+) tokens/s",
                                            summary).group(1)),
            "summary": summary, "peak_mem_gb": peak,
            "cpu": {"capability": torch.backends.cpu.get_cpu_capability(),
                    "threads": torch.get_num_threads()},
            "launches": launches, "card": smi}


def slice6b_phases(smi, env, cpu_refs):
    """Step 15's phases under the world-1 group, each printing its JSON
    line."""
    for phase in (lambda: seqpar_world1(smi, env),
                  lambda: ring_blocks_check(smi),
                  lambda: seqpar_example(smi, cpu_refs),
                  lambda: vision_train(smi, cpu_refs),
                  lambda: native_lm(smi, cpu_refs)):
        print(json.dumps(phase()), flush=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Slice 6c, second half (step 16): the remaining examples, autotune; the
# serving_decode LM runs K6, K7 and K8 at head_dim 16
# ---------------------------------------------------------------------------

# helloworld_amp computes in bfloat16, which the card's kernels and the
# CPU's could round at other points: its losses are held to the CPU's
# within AMP_TOL, relative. On an H100 the largest difference was 2.3e-7
# of the loss (PERF.md §6): the two devices rounded alike. 1e-5 keeps
# 40 times that reading, and a wrong cast (a bfloat16 ulp is 3.9e-3 of a
# value) would pass it by orders of magnitude
AMP_TOL = 1e-5
# the convnets' logged losses (epoch 0, steps 0 and 20), card against CPU
CONVNET_STEPS = ((0, 0), (0, 20))
SWITCH_CPU_STEPS = 5            # each of helloworld_switch's configs once


def example(name):
    import importlib
    return importlib.import_module(f"tutel_tpu_torch.examples.{name}")


def run_example(name, argv, **kw):
    mod = example(name)
    return mod.run(mod.build_args(argv), log=lambda *_: None, **kw)


# the single-rank trainers held step by step to the CPU: (example, argv)
TRAINERS = (("helloworld_from_scratch", []),
            ("helloworld_custom_gate_expert", []),
            ("helloworld_ddp", []),
            ("helloworld_ddp_tutel", []),
            ("helloworld_custom_expert_sharded", ["--num_local_experts", "1"]),
            ("helloworld_multiprocess", []),
            ("helloworld_amp", []))


def slice6c_cpu_refs():
    """The CPU results step 16 holds the card's against, computed before
    the NCCL group exists."""
    refs = {"serving_decode": run_example("serving_decode",
                                          ["--device", "cpu"])}
    for name in ("moe_mnist", "moe_cifar10"):       # epoch 0 is enough
        refs[name] = run_example(name, ["--device", "cpu", "--epochs", "1"])
    refs["helloworld_switch"] = run_example(
        "helloworld_switch", ["--device", "cpu", "--steps",
                              str(SWITCH_CPU_STEPS)])
    for name, argv in TRAINERS:
        refs[name] = run_example(name, ["--device", "cpu"] + argv)
    refs["all_to_all_v"] = run_example("all_to_all_v", ["--device", "cpu"])
    return refs


def serving_decode_phase(smi, refs):
    """examples/serving_decode.py at its defaults on the card: every
    request of both engines finishes, the MoE engine's final states within
    SMALL_TOL of the CPU's, the LM's tokens/s and ms a decode step; K6, K7
    and K8 launch (head_dim 16, float32), and the location scan, and no
    other kernel does."""
    reset_launches()
    moe_stats, lm_stats, finals, timing = run_example("serving_decode", [])
    torch.cuda.synchronize()
    counts = read_launches("serving_decode",
                           {"decode_attn", "prefill_attn", "kv_write",
                            ROUTE})
    cpu_stats, cpu_lm, cpu_finals, _ = refs["serving_decode"]
    if not (moe_stats["finished"] == 48 and lm_stats["finished"] == 12):
        raise RuntimeError(f"serving_decode: {moe_stats}, {lm_stats}")
    err = max(rel_err(finals[u].float().cpu(), v.float())[1]
              for u, v in cpu_finals.items())
    if not err <= SMALL_TOL:
        raise RuntimeError(f"serving_decode: MoE final states {err} from "
                           f"the CPU's (> {SMALL_TOL})")
    return {"phase": "serving_decode", "moe": moe_stats, "lm": lm_stats,
            "moe_max_rel_err_cpu": err, "tol": SMALL_TOL,
            "lm_tokens_per_s": timing["tokens_per_s"],
            "lm_ms_per_decode_step": timing["ms_per_step"],
            "lm_seconds": timing["seconds"], "head_dim": 16,
            "launches": counts, "card": smi}


def convnet_phase(smi, refs, name):
    """A convnet example at its defaults (2 epochs) on the card: its losses
    at epoch 0 steps 0 and 20 within EXAMPLE_TOL of the CPU's, the eval
    accuracies, ms a training step; of the ported kernels only the
    location scan launches."""
    reset_launches()
    accs, losses, step_s, _ = run_example(name, [])
    launches = read_launches(name, {ROUTE})
    cpu = refs[name][1]
    err = max(abs(losses[k] - cpu[k]) for k in CONVNET_STEPS)
    if not err <= EXAMPLE_TOL:
        raise RuntimeError(f"{name} on the card: losses {losses} against "
                           f"the CPU's {cpu}")
    return {"phase": name, "losses": {f"{e}:{i}": v for (e, i), v in
                                      losses.items()},
            "cpu_losses": {f"{e}:{i}": v for (e, i), v in cpu.items()},
            "max_abs_diff_cpu": err, "tol": EXAMPLE_TOL,
            "eval_accuracy": accs, "cpu_eval_accuracy_epoch0": refs[name][0],
            "ms_per_step": 1e3 * step_s, "launches": launches, "card": smi}


def switch_phase(smi, refs):
    """helloworld_switch at its defaults (4 x 512 tokens, 1024 x 1024, 2
    experts, 24 calls over its 5 configs) on the card: each config's
    output and l_aux within EXAMPLE_TOL of the CPU's (relative to max
    |output|), first-call and warm ms per config."""
    reset_launches()
    timings, outputs = run_example("helloworld_switch", [])
    launches = read_launches("helloworld_switch", {ROUTE})
    cpu = refs["helloworld_switch"][1]
    per = {}
    for name, (out, l_aux) in outputs.items():
        c_out, c_aux = cpu[name]
        per[name] = {"out_rel_err": rel_err(out, c_out)[1],
                     "l_aux": l_aux, "l_aux_abs_diff": abs(l_aux - c_aux),
                     "first_ms": 1e3 * timings[name][0],
                     "warm_ms": 1e3 * statistics.median(timings[name][1:])}
        if not (per[name]["out_rel_err"] <= EXAMPLE_TOL
                and per[name]["l_aux_abs_diff"] <= EXAMPLE_TOL):
            raise RuntimeError(f"helloworld_switch {name}: {per[name]}")
    return {"phase": "helloworld_switch", "configs": per,
            "tol": EXAMPLE_TOL, "launches": launches, "card": smi}


def trainers_phase(smi, refs):
    """The single-rank trainers at their defaults on the card under the
    world-1 group (helloworld_custom_expert_sharded with one expert a
    rank): every step's loss within EXAMPLE_TOL of the CPU's (amp's within
    AMP_TOL relative, and falling), ms a step; of the ported kernels
    only the location scan launches."""
    out = {"phase": "trainers", "tol": EXAMPLE_TOL, "amp_tol": AMP_TOL}
    for name, argv in TRAINERS:
        reset_launches()
        losses, ms = timed_run(example(name), example(name).build_args(
            argv))
        launches = read_launches(name, {ROUTE})
        cpu = refs[name]
        if name == "helloworld_amp":
            err = float(np.max(np.abs(np.array(losses) - np.array(cpu))
                               / np.abs(np.array(cpu))))
            if not (err <= AMP_TOL and losses[-1] < losses[0]):
                raise RuntimeError(f"helloworld_amp on the card: {losses} "
                                   f"against the CPU's {cpu}")
        else:
            err = check_losses(name, losses, cpu)
        out[name] = {"argv": argv, "losses": losses, "cpu_losses": cpu,
                     "max_diff": err, "median_step_ms":
                         statistics.median(ms), "launches": launches}
    out["card"] = smi
    return out


def multiprocess_launch(smi):
    """helloworld_multiprocess through `python -m tutel_tpu_torch.launcher
    .run` with OMPI_COMM_WORLD_SIZE=1 in a process of its own (NCCL at
    world 1): its printed losses equal the in-process run's under the
    world-1 group, as printed."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    reset_launches()
    lines = []
    mp = example("helloworld_multiprocess")
    mp.run(mp.build_args([]), log=lines.append)
    launches = read_launches("helloworld_multiprocess", {ROUTE})
    want = [ln for ln in lines if ln.startswith("STEP-")]
    t0 = time.perf_counter()
    printed = run_module(
        ["tutel_tpu_torch.launcher.run", "-m",
         "tutel_tpu_torch.examples.helloworld_multiprocess"],
        env={"OMPI_COMM_WORLD_SIZE": "1", "OMPI_COMM_WORLD_RANK": "0",
             "MASTER_ADDR": f"127.0.0.1:{port}"})
    seconds = time.perf_counter() - t0
    got = [ln for ln in printed.splitlines() if ln.startswith("STEP-")]
    if got != want or "[rank 0] world=1 ranks" not in printed:
        raise RuntimeError(f"the launched helloworld_multiprocess printed "
                           f"{printed!r}, the in-process run {want}")
    return {"phase": "helloworld_multiprocess", "launched": got,
            "in_process": want, "equal": True, "seconds": seconds,
            "launches": launches, "card": smi}


def collectives_phase(smi, refs):
    """all_to_all_v and bandwidth_test at their defaults over the world-1
    NCCL group: the received rows and counts equal the CPU's; the GB/s
    table (one rank: each op is a copy on the card, not a transfer)."""
    reset_launches()
    got = run_example("all_to_all_v", [])
    equal = all(torch.equal(a.cpu(), b) for a, b in
                zip(got, refs["all_to_all_v"]))
    if not equal:
        raise RuntimeError(f"all_to_all_v on the card: {got} against the "
                           f"CPU's {refs['all_to_all_v']}")
    rates, outputs = run_example("bandwidth_test", [])
    launches = read_launches("collectives", set())
    return {"phase": "collectives", "all_to_all_v_equal_cpu": True,
            "recv_counts": got[1].tolist(), "bandwidth_gb_s": rates,
            "bandwidth_size_mb": 64, "iters": 20, "ranks": 1,
            "launches": launches, "card": smi}


def autotune_phase(smi):
    """tune_moe on the helloworld layer at its defaults (16 x 512 tokens,
    2048 x 2048, 2 experts, top-2, float32): each candidate's ms a call
    and the winner; every candidate's output within F32_TOL of the
    default call's (relative to max |output|), since they are equal
    configs; of the ported kernels only the location scan launches."""
    from tutel_tpu_torch.autotune import moe_candidates, tune_moe
    args = helloworld.build_args(["--device", "cuda"])
    layer = moe.moe_layer(
        gate_type={"type": "top", "k": args.top, "capacity_factor": 1.0},
        experts={"type": "ffn", "num_experts_per_device":
                 args.num_local_experts,
                 "hidden_size_per_expert": args.hidden_size},
        model_dim=args.model_dim, seeds=(1, 1, 1), group=[0],
        device="cuda")
    params = layer.init(torch.Generator(device="cuda").manual_seed(SEED))
    x = torch.randn(args.batch_size * args.num_tokens, args.model_dim,
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 1), device="cuda")
    reset_launches()
    with torch.no_grad():
        ref, _ = layer(params, x)
        errs = {json.dumps(c, sort_keys=True): rel_err(
            layer(params, x, **c)[0], ref)[1] for c in moe_candidates(layer)}
    if not max(errs.values()) <= F32_TOL:
        raise RuntimeError(f"tune_moe candidates disagree: {errs}")
    result = tune_moe(layer, params, x, iters=5)
    launches = read_launches("autotune", {ROUTE})
    return {"phase": "autotune", "candidates_rel_err": errs,
            "tol": F32_TOL, "ms": {k: 1e3 * v for k, v in
                                   result["timings"].items()},
            "best": result["best"], "launches": launches, "card": smi}


def slice6c_phases(smi, env, refs):
    """Step 16's phases under the world-1 group, each printing its JSON
    line; returns serving_decode's launches."""
    torch.backends.cudnn.allow_tf32 = False    # float32 convolutions in full
    served = serving_decode_phase(smi, refs)
    print(json.dumps(served), flush=True)
    for phase in (lambda: convnet_phase(smi, refs, "moe_mnist"),
                  lambda: convnet_phase(smi, refs, "moe_cifar10"),
                  lambda: switch_phase(smi, refs),
                  lambda: trainers_phase(smi, refs),
                  lambda: multiprocess_launch(smi),
                  lambda: collectives_phase(smi, refs),
                  lambda: autotune_phase(smi)):
        print(json.dumps(phase()), flush=True)
        torch.cuda.empty_cache()
    return served["launches"]


# ---------------------------------------------------------------------------
# Slice 6c's last module (step 17): parted, plans lowered to net collectives
# ---------------------------------------------------------------------------

# tests/test_parted.py's MLP graph at helloworld's default width (16 x 512
# tokens, model_dim 2048, hidden 2048), float32; its activation node is K10
PARTED_SHAPE = {"n": 8192, "k": 2048, "h": 2048, "m": 2048}
PARTED_TOL = 1e-4          # max |program - plain chain| / max |plain chain|
# plan: (config, the collectives it lists, in order)
PARTED_PLANS = {
    "data_parallel": ({"x": 0, "w1": -1, "y1": 0, "act": 0, "w2": -1,
                       "y2": 0}, ["all-gather"]),
    # test_gspmd_inserts_allreduce_for_k_split's FAR plan
    "k_split_far": ({"x": 1, "w1": 0, "y1": -1, "act": -1, "w2": -1,
                     "y2": -1}, ["all-reduce"]),
    "zero": ({"x": 0, "w1": -2, "y1": 0, "act": 0, "w2": -2, "y2": 0},
             ["all-gather", "all-gather", "all-gather"]),
    # y1 split on N, act on H: an A2A; w2 split on H, y2 replicated: a FAR
    "a2a": ({"x": 0, "w1": -1, "y1": 0, "act": 1, "w2": 0, "y2": -1},
            ["all-to-all", "all-reduce"]),
    "rs": ({"x": 1, "w1": 0, "y1": 0, "act": 0, "w2": -1, "y2": 0},
           ["reduce-scatter", "all-gather"]),
}


def parted_graph(spmdx, s=PARTED_SHAPE):
    """The MLP graph at the shape `s` (n, k, h, m), K10 as its activation
    node."""
    x = spmdx.data((s["n"], s["k"]), name="x")
    w1 = spmdx.param((s["k"], s["h"]), name="w1")
    w2 = spmdx.param((s["h"], s["m"]), name="w2")
    y1 = spmdx.custom("NH = NK, KH+", [x, w1], name="y1")
    act = spmdx.custom("NH = NH", [y1], name="act", fn=SQUARED_RELU)
    return spmdx.custom("NM = NH, HM+", [act, w2], name="y2")


def chain_seconds(fn, steps=5, warmup=2):
    """Program.execute's loop around fn: seconds a step between two
    synchronizes."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps


def parted_phase(smi, env):
    """Step 17: the MLP graph through `parted` under the world-1 NCCL group
    (its default group). optimize() returns the default plan; five forced
    plans (data-parallel, the K-split FAR, ZERO, A2A + FAR, RS + AG) each
    list their collectives, run them through NCCL, hold the output within
    PARTED_TOL of the graph as one plain torch chain on the card, launch
    K10 once a call and nothing else, and time execute() beside the chain;
    then optimize(measure=True, top_k=3). Returns the phase's line."""
    from tutel_tpu_torch import parted
    from tutel_tpu_torch.parted import spmdx
    session = parted.init(device="cuda")
    y2 = parted_graph(spmdx)
    graph = spmdx.Graph([y2])
    (cost, default), = parted.optimize(y2)
    if (cost, default) != (0.0, spmdx.Config.default(graph)):
        raise RuntimeError(f"parted.optimize at world 1: {cost}, {default}")
    args = parted.compile_graph(y2, default).example_inputs(SEED)
    with torch.no_grad():
        ref = SQUARED_RELU.fn(args[0] @ args[1]) @ args[2]
        plain_ms = 1e3 * chain_seconds(
            lambda: SQUARED_RELU.fn(args[0] @ args[1]) @ args[2])
    plans, launches = {}, 0
    for name, (cfg, kinds) in {"default": (dict(default), []),
                               **PARTED_PLANS}.items():
        prog = parted.compile_graph(y2, spmdx.Config(cfg))
        listed = [c.kind for c in prog.collectives]
        reset_launches()
        with torch.no_grad():
            out = prog(*args)
        torch.cuda.synchronize()
        err = rel_err(out, ref)[1]
        del out
        seconds = prog.execute(steps=5, warmup=2, seed=SEED)
        counts = read_launches(f"parted {name}", {"pallas_kernel"})
        if not (listed == kinds and counts["pallas_kernel"] == 8
                and err <= PARTED_TOL):
            raise RuntimeError(f"parted plan {name}: collectives {listed} "
                               f"(expected {kinds}), K10 launches {counts} "
                               f"in 8 calls, error {err} > {PARTED_TOL}?")
        launches += counts["pallas_kernel"]
        plans[name] = {"config": cfg, "collectives": listed,
                       "max_rel_err": err, "ms_per_step": 1e3 * seconds,
                       "launches": counts["pallas_kernel"], "calls": 8}
    reset_launches()
    ranked = parted.optimize(y2, top_k=3, measure=True)
    counts = read_launches("parted optimize(measure=True)", {"pallas_kernel"})
    times = [t for t, _ in ranked]
    if not (times == sorted(times) and all(t > 0 for t in times)):
        raise RuntimeError(f"parted measured optimize: {ranked}")
    launches += counts["pallas_kernel"]
    return {"phase": "parted", "backend": env.backend,
            "world": session.world, "shape": PARTED_SHAPE,
            "dtype": "float32", "tol": PARTED_TOL, "plans": plans,
            "plain_chain_ms_per_step": plain_ms,
            "plain_chain_tflops": 2 * PARTED_SHAPE["n"] * PARTED_SHAPE["h"]
            * (PARTED_SHAPE["k"] + PARTED_SHAPE["m"]) / plain_ms / 1e9,
            "measured": [[1e3 * t, dict(c)] for t, c in ranked],
            "launches": {"pallas_kernel": launches}, "card": smi}


def ep_phases(smi, plain_losses, bandwidth):
    """Slice 5a's phases, then slice 5b's, 6a's, 6b / 6c's and parted's,
    in order, each printing its JSON line; the process group is destroyed
    at the end, so the script can exit. Returns the kernels' launches in
    slice 5b's, 6a's, 6c's and parted's phases."""
    print(json.dumps(megablocks_decode(smi)), flush=True)
    torch.cuda.empty_cache()
    cpu_ref = net_calls("cpu")
    # the CPU references, before the NCCL group exists
    zero_cpu = zero_run("cpu")
    hec, cpu_args = ec_example_args("cpu", False)
    ec_cpu = hec.run(cpu_args, log=lambda *_: None)
    sp_cpu = slice6b_cpu_refs()
    sd_cpu = slice6c_cpu_refs()
    env = init_world1()
    try:
        print(json.dumps(net_nccl(cpu_ref, env)), flush=True)
        print(json.dumps(ep_train_world1(smi, env, plain_losses)),
              flush=True)
        total = slice5b_phases(smi, env, plain_losses, bandwidth, zero_cpu)
        for k, n in slice6a_phases(smi, env, ec_cpu).items():
            total[k] += n
        slice6b_phases(smi, env, sp_cpu)
        for k, n in slice6c_phases(smi, env, sd_cpu).items():
            total[k] += n
        parted_line = parted_phase(smi, env)
        print(json.dumps(parted_line), flush=True)
        total["pallas_kernel"] += parted_line["launches"]["pallas_kernel"]
        return total
    finally:
        system.destroy()
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 twins in full
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    bandwidth = hbm_bytes_per_s(smi)

    # K9 at test_facade's [256, 128] (2 tiles of 128 rows) and at full
    # width (1024 tiles of 16 rows)
    injected = {(256, 128): inject_scale(256, 128, 128),
                (16384, 2048): inject_scale(16384, 2048, 16)}
    t0 = time.perf_counter()
    ptxas = start_ptxas()
    build.build_all(build.SOURCES, [f.source for f in injected.values()] + [
        k.cuda_source(d) for k in (SQUARED_RELU, GELU_TANH)
        for d in (torch.bfloat16, torch.float32)])
    for name in build.SOURCES:
        build.load(name)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}),
          flush=True)
    print(json.dumps({"phase": "prefill_attn_ptxas",
                      "kernels": ptxas_report(ptxas)}), flush=True)
    print(json.dumps({"phase": "prefill_attn_sass",
                      **sass_counts("prefill_attn")}), flush=True)
    print(json.dumps({"phase": "gemm_tc_sass", "grouped_gemm_quant": mma_sass(
        "grouped_gemm_quant", "gmm_quant_kernel_tc", "HMMA"),
        "fused_ffn_w8a8": mma_sass("fused_ffn_w8a8", "fused_w8a8_kernel",
                                   "IMMA"),
        "grouped_gemm_w8a8": mma_sass("grouped_gemm_w8a8", "gmm_w8a8_kernel",
                                      "IMMA")}), flush=True)

    # the decode server's shape: capacity 32 (the speculated buffer at 256
    # active tokens), row counts of 512 top-2 routings over 128 experts
    routed = np.random.default_rng(SEED).multinomial(512, [1 / 128] * 128)
    shapes = [("decode", 128, 32, 2048, 2048, 2048,
               np.minimum(routed, 32), False, "relu"),
              ("all_rows", 128, 32, 2048, 2048, 2048, [32] * 128, False,
               "relu"),
              ("k_lt_h", 64, 32, 1024, 4096, 1024,
               np.random.default_rng(SEED + 1).integers(0, 33, 64), True,
               "gelu"),
              # the LM server's MoE blocks: 32 experts, 1024 x 2048 x 1024,
              # a decode step (64 tokens at the speculated capacity 16) and
              # a prefill chunk (64 x 128 tokens at capacity 8192)
              ("lm_decode", 32, 16, 1024, 2048, 1024, np.minimum(
                  np.random.default_rng(SEED + 2).multinomial(
                      128, [1 / 32] * 32), 16), True, "relu"),
              ("lm_prefill", 32, 8192, 1024, 2048, 1024,
               np.random.default_rng(SEED + 3).multinomial(
                   16384, [1 / 32] * 32), True, "relu")]
    checks = {}
    for shape in shapes:
        for r in check_kernels(shape, bandwidth):
            print(json.dumps(r), flush=True)
            checks[(r["name"], r["shape"])] = r
        torch.cuda.empty_cache()
    # K5 and K3 at the W4A8 decode shape (INT4 and INT8), all rows live,
    # and K < H in INT8 with bias and gelu
    w8a8_shapes = [("decode", 128, 32, 2048, 2048, 2048,
                    np.minimum(routed, 32), False, "relu", 4),
                   ("decode_int8", 128, 32, 2048, 2048, 2048,
                    np.minimum(routed, 32), False, "relu", 8),
                   ("all_rows", 128, 32, 2048, 2048, 2048, [32] * 128, False,
                    "relu", 4),
                   ("k_lt_h", 64, 32, 1024, 4096, 1024,
                    np.random.default_rng(SEED + 1).integers(0, 33, 64), True,
                    "gelu", 8)]
    for shape in w8a8_shapes:
        for r in check_w8a8_kernels(shape, bandwidth):
            print(json.dumps(r), flush=True)
            checks[(r["name"], r["shape"])] = r
        torch.cuda.empty_cache()
    # K4 at the SwiGLU LM's expert shapes, as for K1/K2 above
    for shape in (("lm_decode", 32, 16, 1024, 2048, 1024, shapes[3][6], 4),
                  ("lm_prefill", 32, 8192, 1024, 2048, 1024, shapes[4][6], 4)):
        r = check_swiglu_kernel(shape, bandwidth)
        print(json.dumps(r), flush=True)
        checks[(r["name"], r["shape"])] = r
        torch.cuda.empty_cache()
    # K9 and K10 at their shapes, each beside one PyTorch call
    for (rows, cols), f in injected.items():
        r = check_inject_kernel(f, rows, cols, bandwidth)
        print(json.dumps(r), flush=True)
        checks[(r["name"], r["shape"])] = r
    for shape, dtype in (((128, 32, 2048), torch.bfloat16),
                         ((32, 8192, 2048), torch.bfloat16),
                         ((128, 32, 2048), torch.float32)):
        for label, kernel, library in (("squared_relu", SQUARED_RELU, None),
                                       ("gelu_tanh", GELU_TANH,
                                        activations.gelu)):
            r = check_pallas_kernel(label, kernel, shape, dtype, bandwidth,
                                    library)
            print(json.dumps(r), flush=True)
            checks[(r["name"], r["shape"])] = r
        torch.cuda.empty_cache()
    print(json.dumps(jit_graph(injected[(16384, 2048)], SQUARED_RELU)),
          flush=True)
    torch.cuda.empty_cache()
    # K9's path: a user's injected kernel called on four inputs
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    s = torch.full((1, 1), -0.5, device="cuda")
    reset_launches()
    for _ in range(4):
        x = torch.randn(16384, 2048, generator=g, device="cuda")
        if rel_err(injected[(16384, 2048)](x, s),
                   scale_plus_one(x, s))[1] > F32_TOL:
            raise RuntimeError("the injected kernel's output is wrong")
    counts = read_launches("inject", {"inject_kernel"})
    print(json.dumps({"phase": "inject", "calls": 4, "launches": counts}),
          flush=True)
    launches = {"inject_kernel": counts["inject_kernel"], ROUTE: 0}
    del x
    torch.cuda.empty_cache()

    layer, layer_w4a8 = decode_layer(0), decode_layer(8)
    params = decode_params(layer)
    torch.cuda.empty_cache()
    for lay in (layer, layer_w4a8):                            # warm-up
        serve(lay, params, 16, (2, 2), True, SEED + 7)
        serve(lay, params, 16, (2, 2), False, SEED + 7)

    for path, lay, auto_fuse, n_req, runs in (
            ("fused", layer, True, 512, "fused_ffn_quant"),
            ("two_call", layer, False, 128, "grouped_gemm_quant"),
            ("w4a8_fused", layer_w4a8, True, 512, "fused_ffn_w8a8"),
            ("w4a8_two_call", layer_w4a8, False, 128, "grouped_gemm_w8a8")):
        reset_launches()
        eng, seconds = serve(lay, params, n_req, (8, 32), auto_fuse, SEED)
        counts = read_launches(path, {runs, ROUTE})
        print(json.dumps({
            "phase": "serve", "path": path, "requests": n_req,
            "tokens": eng.stats["tokens"], "decode_steps": eng.stats["steps"],
            "spec_retries": eng.stats["spec_retries"], "seconds": seconds,
            "tokens_per_s": eng.stats["tokens"] / seconds,
            "launches": counts, "card": smi}), flush=True)
        launches[runs] = counts[runs]
        launches[ROUTE] += counts[ROUTE]

    # the device time of a step on the paths of K1 (two-call) and K3 (W4A8
    # fused)
    moe_profiles(layer, layer_w4a8, params, smi)

    # the two-call path with squared ReLU lifted by jit.pallas_kernel: each
    # step K1, K10, K1 (the fused kernels take activation codes only)
    layer_jit = decode_layer(0, SQUARED_RELU)
    serve(layer_jit, params, 16, (2, 2), False, SEED + 7)       # warm-up
    reset_launches()
    eng, seconds = serve(layer_jit, params, 128, (8, 32), False, SEED)
    counts = read_launches("jit_serve", {"grouped_gemm_quant",
                                         "pallas_kernel", ROUTE})
    if counts["grouped_gemm_quant"] != 2 * counts["pallas_kernel"]:
        raise RuntimeError(f"jit_serve launched {counts}: expected two K1 "
                           f"launches per K10 launch")
    print(json.dumps({
        "phase": "jit_serve", "path": "two_call", "activation": "squared_relu",
        "requests": 128, "tokens": eng.stats["tokens"],
        "decode_steps": eng.stats["steps"],
        "spec_retries": eng.stats["spec_retries"], "seconds": seconds,
        "tokens_per_s": eng.stats["tokens"] / seconds,
        "ms_per_decode_step": 1e3 * seconds / eng.stats["steps"],
        "launches": counts, "card": smi}), flush=True)
    launches["pallas_kernel"] = counts["pallas_kernel"]
    launches[ROUTE] += counts[ROUTE]

    print(json.dumps({"phase": "small_engine_vs_cpu",
                      "max_rel_err": small_engine_check(), "tol": SMALL_TOL}),
          flush=True)
    print(json.dumps({"phase": "small_lifted_engine_vs_cpu",
                      "activation": "squared_relu", "path": "two_call",
                      "max_rel_err": small_engine_check(
                          activation_fn=SQUARED_RELU), "tol": SMALL_TOL}),
          flush=True)
    print(json.dumps({"phase": "small_w4a8_engine_vs_cpu",
                      "max_rel_err": small_engine_check(8, W8A8_TOL),
                      "tol": W8A8_TOL}), flush=True)
    del layer, layer_w4a8, layer_jit, params, eng
    torch.cuda.empty_cache()

    for mode in ("int8", "bfloat16", "int4"):
        for fn in (check_decode_attn, check_prefill_attn):
            r = fn(mode, bandwidth)
            print(json.dumps(r), flush=True)
            checks[(r["name"], mode)] = r
        torch.cuda.empty_cache()
    # K6 at 8 rows: 16 (group, row) pairs, the window split the most
    print(json.dumps(check_decode_attn("int8", bandwidth, b=8)), flush=True)
    # K7's float32 kernel (CUDA cores) over the INT8 cache
    print(json.dumps(check_prefill_attn("int8", bandwidth,
                                        dtype=torch.float32)), flush=True)
    small_head_dim_checks(bandwidth)
    r = check_kv_write(bandwidth)
    print(json.dumps(r), flush=True)
    checks[("kv_write", "int8")] = r
    for r in check_route_locations(bandwidth):
        print(json.dumps(r), flush=True)
        checks[(r["name"], r["shape"])] = r
    for name in ("decode_attn", "prefill_attn"):   # the bf16 cache's SDPA
        checks[(name, "int8")]["library_ms"] = \
            checks[(name, "bfloat16")]["library_ms"]
    torch.cuda.empty_cache()

    attn = {"decode_attn", "prefill_attn", "kv_write"}
    for label, expert_type, ffn_kernel in (
            ("lm", "ffn", "fused_ffn_quant"),
            ("swiglu_lm", "llama_ffn", "fused_swiglu_quant")):
        lm = TransformerMoE(TransformerMoEConfig(
            **LM_CONFIG, expert_type=expert_type, dtype=torch.bfloat16),
            device="cuda")
        lm_p = lm_params(lm, torch.Generator(device="cuda").manual_seed(SEED))
        warm = lm_serve(lm, lm_p, 64, 1664, 16, SEED + 1)      # warm-up
        print(json.dumps({"phase": f"{label}_warmup", **warm}), flush=True)
        reset_launches()
        lm_run = lm_serve(lm, lm_p, 64, 1664, 320, SEED)
        counts = read_launches(f"{label} serve",
                               attn | {ffn_kernel, ROUTE})
        print(json.dumps({"phase": f"{label}_serve", **lm_run,
                          "launches": counts, "card": smi}), flush=True)
        if label == "lm":
            launches.update({k: counts[k] for k in attn})
        else:
            launches[ffn_kernel] = counts[ffn_kernel]
        launches[ROUTE] += counts[ROUTE]
        print(json.dumps({"phase": f"{label}_profile",
                          **lm_profile(lm, lm_p, SEED + 2)}), flush=True)
        print(json.dumps({"phase": f"{label}_prefill_profile",
                          **lm_prefill_profile(lm, lm_p, SEED + 3,
                                               ffn_kernel),
                          "card": smi}), flush=True)
        del lm, lm_p
        torch.cuda.empty_cache()

    print(json.dumps({"phase": "small_lm_engine_vs_cpu",
                      "max_rel_err": small_lm_check(), "tol": SMALL_TOL,
                      "greedy_tokens": "identical"}), flush=True)
    print(json.dumps({"phase": "small_swiglu_lm_engine_vs_cpu",
                      "max_rel_err": small_lm_check("llama_ffn", (8,)),
                      "tol": SMALL_TOL, "greedy_tokens": "identical"}),
          flush=True)
    torch.cuda.empty_cache()

    plain_losses = training_phases(smi)
    for k, n in ep_phases(smi, plain_losses, bandwidth).items():
        launches[k] = launches.get(k, 0) + n

    sources = {
        "grouped_gemm_quant": ("tutel_tpu_torch/csrc/grouped_gemm_quant.cu",
                               "tutel_tpu/ops/grouped_gemm_pallas.py:94",
                               "decode"),
        "fused_ffn_quant": ("tutel_tpu_torch/csrc/fused_ffn_quant.cu",
                            "tutel_tpu/ops/fused_ffn_pallas.py:209",
                            "decode"),
        "fused_ffn_w8a8": ("tutel_tpu_torch/csrc/fused_ffn_w8a8.cu",
                           "tutel_tpu/ops/fused_ffn_pallas.py:354", "decode"),
        "fused_swiglu_quant": ("tutel_tpu_torch/csrc/fused_swiglu_quant.cu",
                               "tutel_tpu/ops/fused_ffn_pallas.py:556",
                               "lm_decode"),
        "grouped_gemm_w8a8": ("tutel_tpu_torch/csrc/grouped_gemm_w8a8.cu",
                              "tutel_tpu/ops/w8a8_pallas.py:81", "decode"),
        "decode_attn": ("tutel_tpu_torch/csrc/decode_attn.cu",
                        "tutel_tpu/ops/decode_attn_pallas.py:171", "int8"),
        "prefill_attn": ("tutel_tpu_torch/csrc/prefill_attn.cu",
                         "tutel_tpu/ops/decode_attn_pallas.py:493", "int8"),
        "kv_write": ("tutel_tpu_torch/csrc/kv_write.cu",
                     "tutel_tpu/ops/kv_write_pallas.py:146", "int8"),
        # K9: the trampoline, build and launch of a user's source
        "inject_kernel": ("tutel_tpu_torch/jit.py", "tutel_tpu/jit.py:29",
                          "16384x2048"),
        "pallas_kernel": ("tutel_tpu_torch/csrc/elementwise.cu",
                          "tutel_tpu/jit.py:74",
                          "squared_relu_bfloat16_128x32x2048"),
        # no TPU kernel: the JAX package's jnp.cumsum over the one-hot
        "compute_locations": ("tutel_tpu_torch/csrc/route_locations.cu",
                              "tutel_tpu/ops/routing.py:55", "train")}
    kernels = []
    for name, (source, replaces, shape) in sources.items():
        r = checks[(name, shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "device_ms": r.get("device_ms"),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
