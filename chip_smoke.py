#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card; without one (or outside a checkout of the repository)
it exits non-zero and prints no result.  Phases, each of which fails the
run on error:

  1. build the port's CUDA kernels (``src/repro_torch/csrc/*.cu``);
  2. hold every kernel against its plain PyTorch version on the card, at
     the main path's shapes (llama3-8b-262k: H=32, Hkv=8, D=128, bs=128,
     N=8192, B=2), in bfloat16 and float32, on layer 0's real q/k/v and
     SharePrefill masks plus synthetic edge rows, the block-sparse kernel
     also at head dim 96 (phi3-mini) and as a 16-block chunk launch at q
     block 48 (chunked prefill's shape: bitwise the full launch's rows);
     time kernel, plain version and a PyTorch library call (and, for the
     decode kernel, its device time per call from the profiler and its
     split count); the
     strip also at N = 2048, 512 and 8320 and at its other instances'
     head widths, with sample 0 alone bitwise equal to the batch's slice,
     and its device time at B = 2 and at B = 1; the block-sparse kernel
     also under each baseline's masks (MInference vertical-slash and
     FlexPrefill, built on the card) with a stats gate of zeros (Ã all
     −inf), with the mask blocks the card's masks and the CPU's differ by
     on the same float32 q/k;
  3. serve a small ragged batch through the kernels and through the plain
     versions on the CPU, and compare greedy tokens (near-tie aware), for
     SharePrefill and both baselines; count the baselines' mask blocks
     that differ between the card and the CPU in a traced prefill;
  4. serve two full-width llama3-8b-262k requests (prompts of 8192 and 7937
     tokens, 16 greedy tokens each) through ``ServingEngine`` with
     SharePrefill prefill and plan-driven sparse decode, with every kernel's
     launch count reset just before and read just after; then serve them
     once more under ``torch.profiler`` to see where the device time goes;
  5. hold the paged sparse-decode kernel against its plain version at the
     paged serve's shapes (4 slots, a 65-page table of 128-token pages, a
     shuffled pool with slack pages), in bfloat16 and float32, on layer 0's
     plan rows from two real prefills (8192 and 2048 buckets), an empty
     slot, a row padded from the 2048 bucket and partly false keep bits
     with a right-pad range; and against the contiguous decode kernel on
     the gathered pages, bitwise;
  6. serve six full-width requests of two buckets through the continuous-
     batching scheduler on a 148-page pool (``EngineConfig(paged=True)``),
     launch counts reset just before and read just after, so that a request
     waits for pages and finished slots are refilled during the serve; then
     serve them through the contiguous scheduler (one per bucket) and
     compare greedy tokens (near-tie aware);
  7. hold the kernel API slice's four kernels against their plain versions
     in bfloat16 and float32 at the main path's shapes: the single-sample
     block-sparse kernel on sample 0's real layer-0 tables (W = 64) and on
     edge rows, the paged block-sparse kernel on a 16-block chunk at q
     block 48 over a shuffled pool (also against the batched kernel on the
     gathered pages: bitwise where both run one body, within ``TOL`` in
     bf16, where the batched one is the Hopper body), and both
     single-sample decodes on a
     real plan's token mask over an 8320-token cache with one all-false
     head; time them; then call each public function that no serve
     reaches once, launch counts reset just before and read just after;
     then hold the four decode kernels against their plain versions at
     mistral-large's GQA group (G = 12: H = 96, Hkv = 8, D = 128);
  8. serve phase 4's requests through the per-sample path
     (``attn_impl="kernel"``) under phase 4's masks and pattern decisions
     (B.6's Ã rounds otherwise than the Hopper body's, and the decisions
     are thresholds on it), launch counts reset just before and read
     just after; hold its first-step logits, greedy tokens and own
     decisions to a twin of phase 4 under the same masks whose B.2 runs
     B.6 sample by sample (rounding as the per-sample path does); then
     profile it;
  9. serve phase 6's requests, pool and buckets through chunked admission
     (``prefill_chunk=1024``: 8 chunks at the 8192 bucket, 2 at 2048),
     launch counts reset just before and read just after: greedy tokens
     equal to phase 6's and first-step logits bitwise equal; then with
     ``prefill_pack=2`` (the 2048-bucket requests packed in pairs), tokens
     near-tie aware; print prefill, TTFT and prefill stall per request
     beside phase 6's, and profile the chunked serve;
 10. serve the configs the head-dim-96 and GQA-group-12 kernels exist for
     at full width: phi3-mini-3.8b (all 32 layers) and mistral-large-123b
     (2 of its 88 layers: 123B parameters do not fit one card), two
     requests each through the batch server, launch counts reset just
     before and read just after, against the same serve with the decode's
     plain versions;
 11. the paper's baselines on llama3-8b-262k at full width, launch counts
     reset just before and read just after each run: phase 4's requests
     through ``EngineConfig(method=m)`` for ``vertical_slash`` and ``flex``
     (the strip 32 / 0 times, the block-sparse kernel 32 times, no decode
     kernel) beside phase 4's ``share`` serve and a ``dense`` one; the
     ``vertical_slash`` serve through the per-sample path (64 single-
     sample launches, first-step logits against the batch serve's); two of
     phase 6's requests through chunked admission with ``flex``
     (first-step logits bitwise the unchunked serve's); the traced prefill
     (``core/profile.py``) of one 8192-token prompt for the four methods
     and its block attention maps; ``Model.prefill`` of one 32768-token
     prompt for the four methods (the second of two runs each, the
     only run for ``dense``); one
     layer's dense attention at 8192 through the plain chunked path and
     through ``scaled_dot_product_attention``;
 12. decode-pattern refresh, the request lifecycle and the width policies
     on llama3-8b-262k at full width, launch counts reset just before and
     read just after each serve: two requests (8192 and 2048 prompt
     tokens, 300 greedy tokens) through the paged scheduler with
     ``refresh_every=128`` and with frozen plans — the strip (B.1) and
     paged decode (B.4) launches exactly as predicted from the refresh
     positions, each request's logits bitwise the frozen serve's until its
     first refresh, and the first refreshed row rebuilt by the plain path
     on the CPU from the same window and pages (keep blocks differing in at
     most 0.1 %); phase 6's requests under ``NaNLogits``, ``PrefillError``,
     ``CancelAt``, a deadline and preemption, one-shot on phase 6's pool
     and chunked on a pool of one request per bucket (a cancel aborts a
     run between quanta): every fault ends only its request, the resumed
     and untouched requests' tokens bitwise those of phase 6's serve, no
     page leaked; two successive batch serves of phase 4's requests under
     ``width_policy="count"`` and ``"auto"`` (uncapped, then at the frozen
     cap, whose layer-0 B.2 tables are ``cap_block_mask`` of the uncapped
     masks);
 13. prefix sharing with copy-on-write on llama3-8b-262k at full width
     (the model of phase 12 still loaded): three requests of one
     8192-token prompt (16, 16 and 12 new tokens, the third sampled) and
     one of its own 2048-token prompt (8 new) through phase 6's paged
     scheduler, buckets and pool, with ``prefix_sharing`` off and on, one-
     shot and with ``prefill_chunk=1024``: every stream bitwise equal off
     and on, the two later copies hits, the index's hits, misses, pages
     saved and copies as predicted from the code, the strip and block-
     sparse kernels launched for the two cold prefills only, no page
     leaked and each pool fully free after the index's ``clear``;
 14. Mixtral 8x22B (MoE, 8 experts top 2, sliding window 4096) at full
     width, 4 of its 56 layers, after llama3 is freed: B.1, B.2, B.6, B.3
     and B.4 against their plain versions at its G = 6 (H = 48 over
     Hkv = 8) in bfloat16 and float32 on layer 0's real q/k/v and window
     masks (a row listing a block above the diagonal; decode validity
     banded by the window, with kept blocks it hides wholly), timed
     beside their bounds; a batch serve of phase 4's prompt lengths (8
     new tokens) with exact launches against the same serve with the
     plain decode (greedy, near-tie aware), its block density and the
     window's share of the skipped blocks; three requests (two of one
     prompt) through the paged scheduler with prefix sharing off and on,
     bitwise;
 15. Qwen2-VL 72B's backbone (M-RoPE) at full width, 8 of its 80 layers,
     after Mixtral is freed: two 8192-token rows laid out as image
     prompts (text, a 32 × 32 grid of random patch embeddings, text) with
     3-D positions; B.1, B.2 and B.3 against their plain versions in
     bfloat16 and float32 on layer 0's post-M-RoPE q/k/v, real masks and a
     real plan, timed beside their bounds at H = 64;
     ``Model.prefill(positions=, embeds=)`` then 7 decode steps with
     ``(3, B, 1)`` rope positions through the plan (launches exactly B.1 8,
     B.2 8, B.3 56) against the plain decode; phase 6's first four
     requests text-only through the paged scheduler, one-shot and with
     ``prefill_chunk=1024``, first-step logits bitwise;
 16. DeepSeek-V2 236B (MLA, MoE) at full width, 3 of its 60 layers (the
     dense prefix layer and two MoE layers): B.1 at D = 192 and B.2 and
     B.6 at Dqk = 192, Dv = 128 against their plain versions in bfloat16
     and float32 on layer 0's decompressed q/k/v and real masks, the
     bodies each ran, their times beside their bounds and fused SDPA on
     sample 0's masked problem per backend; a batch serve of 2 × 8192
     prompts (8 new) with launches exactly B.1 3, B.2 3 and no decode
     kernel against the same serve on the plain B.1/B.2, the same serve
     with ``scheduler=True`` (the batch path), and the per-sample path
     (B.6 6); the MoE FFN's share of a synchronised prefill;
 17. offline head clustering on llama3-8b-262k at full width (after
     phase 13, the model still loaded): the block attention maps of
     prompt 0 (``core/profile.py``), ``cluster_heads`` on the card at the
     reference's bench settings (200 epochs, the adaptive threshold,
     clusters of 2 or more), the JSON artifact written under ``build/``
     and read back equal, a cluster spanning head indices asserted; phase
     4's serve under ``SharePrefill.from_clustering`` with launches
     exactly B.1 32, B.2 32, B.3 480, beside the trivial clustering's serve
     (shared/dense/VS heads per layer, prefill_s) and against a serve on
     the plain B.1/B.2 under the same artifact (greedy, near-tie aware);
     B.2 against its plain version under the clustered masks of layer 0
     and of the layer with the most shared heads, timed beside its bound
     and phase 2's row;
 18. Mamba-2 370M (the attention-free SSM family) at full width, all 48
     layers: a batch serve of phase 4's prompt lengths with every kernel's
     launches exactly 0, ``scheduler=True`` on the batch path with the
     same tokens, the float32 recurrence (prefill of 2048 tokens and one
     decode step against the prefill of 2049) and the bf16 serve's tokens
     against a float32 serve's (near-tie aware);
 19. RecurrentGemma 9B (the RG-LRU hybrid: 12 super-blocks of two
     recurrent layers and one local-attention layer, then 2 recurrent
     layers) at full width, all 38 layers: the registers and spills of
     the D = 256 instances; B.1 at D = 256, G = 16 and B.2 and B.6 at
     D = 256 against their plain versions in bfloat16 and float32 on layer
     2's q/k/v under its window ∧ SharePrefill masks, the bodies each ran,
     their times beside their bounds and SDPA per fused backend under the
     tables' token mask; a batch serve of phase 4's prompt lengths (16
     new) with launches exactly B.1 12, B.2 12 and no decode kernel,
     ``scheduler=True`` on the batch path, the per-sample path (B.1 24,
     B.6 24) and a float32 serve (the weights widened) against the bf16
     serve's tokens (near-tie aware);
 20. Whisper base (the encoder-decoder) at full width (6 + 6 layers, 1500
     stub frames drawn from the seed): B.1 and B.2 at D = 64, G = 1 on
     decoder layer 0's tables as phase 19's; a batch serve of 448 and 385
     prompt tokens in a 448-token bucket with launches exactly B.1 6, B.2
     6 and no decode kernel; the card's float32 serve against the port's
     float32 serve on the CPU, same weights and frames;
 21. training (``repro_torch.training``): (a) every registry config at
     its smoke size, one float32 ``make_train_step`` step on the card
     against the same step on the CPU from the same weights and batch
     (loss, grad norm, every gradient and updated leaf), and llama3 at 2
     microbatches against 1; (b) llama3-8b-262k at full width, 8 of its
     32 layers (≈ 2.80 B float32 parameters), ``remat_policy="full"``, 6
     steps of ``train`` at sequence 4096, batch 2 in 2 microbatches: the
     loss finite and falling, forward+backward and optimizer ms, tokens/s,
     peak memory and the float32 FLOP/s share per step; ``save_step`` and
     ``restore_step`` bitwise; the restored weights in bf16 serving phase
     4's requests with launches exactly B.1 8, B.2 8, B.3 120; (c) the
     reference's bench model (internlm2-1.8b cut to 3 layers) trained for
     600 steps on the four synthetic tasks in turn and saved under
     ``build/`` in the reference's format; a 2048-token retrieval prefill
     under SharePrefill with the initial and the trained weights (block
     density and shared/dense/VS heads per layer; launches exactly B.1 3,
     B.2 3); (d) the trained weights' prefill on the plain B.1/B.2: masks,
     tables and decisions equal, greedy tokens near-tie aware;
 22. the heads-sharded serve (A.12): two ranks share the card over gloo
     (``run_ranks``, ``make_serving_mesh(2)``), each with llama3-8b-262k
     at full width, 8 of its 32 layers, in bf16 from seed 0 (the weights'
     checksum all-reduced equal); (a) phase 4's requests served under
     ``ShardingRules`` against the same serve on one rank without them:
     launches exactly B.1 8, B.2 8, B.3 120 per rank, each B.2 on 16 of
     the 32 heads and each B.3 on 4 of the 8 kv heads, every logit row and
     token bitwise, the plan each rank builds equal to the single-device
     plan and on both ranks, the masks and decisions equal on both ranks
     (digests, all-reduced);
     (b) phase 6's requests through the paged scheduler (148 pages) the
     same way, B.4 per kv-head shard, no page leaked; (c) B.2 (output and
     Ã), B.3 and B.4 through their sharded functions bitwise their
     single-device launches on layer 0's inputs, and each rank's shard
     launch (B.3/B.4 reading the rank's kv heads of the whole cache or
     pool in place) timed beside the whole launch while the other rank
     waits, with the head-slice copy that the in-place read avoids;
     the all-gathers' calls, bytes and seconds per serve; (d) the serving
     launcher with and without ``--model-parallel 2`` (smoke config)
     printing the same request lines but for their times.  The two ranks share one card: the times
     are not those of tensor parallelism over several cards;
 23. the launch layer (A.13) at llama3-8b-262k's published widths, bf16
     from seed-0 random weights, on a gloo world of one rank (the card):
     (a) ``build_step(..., "prefill_32k", mesh)`` at full depth, batch
     cut from 32 to 1 (32768 tokens), its ``fn`` on real tensors with
     launches exactly B.1 32 and B.2 32 and its last logits and cache
     bitwise ``model.prefill`` called outside the bundle (the ``shard()``
     sites move nothing); prefill_s and the peak; (b) one step of the
     ``decode_32k`` bundle (batch cut from 128 to 8) and of the
     ``long_500k`` one (24 of 32 layers, window 8192), each against the
     dry-run's accounting of the same cut bundle on a fake world of one
     rank: argument bytes and FLOPs (``FlopCounterMode``) exactly, the
     predicted peak within 15 % of the rise of ``max_memory_allocated``,
     the step time beside the roofline's ``memory_s``; (c) the four
     examples (``python -m repro_torch.examples.<name>``) as subprocesses,
     each exiting 0, ``serve_longcontext``'s request lines printed;
 24. B.2's Hopper body (``bsa_wgmma_kernel``: BATCHED, bf16, bs = 128,
     D = 128) at Qwen2.5-7B's layer shape (H = 28, Hkv = 4, N = 16384)
     against its plain version, with edge rows, half the heads ungated,
     rows listed out of order and a chunk launch at a q_block_offset > 0;
     its times at 16k, 32k and 64k beside the bound, the plain version and
     SDPA (``phase24``).

Every phase that times a kernel also reads its device time from
``torch.profiler``; a port kernel that ran with no device time traced
fails the run.  ``python3 chip_smoke.py --phase 12`` (13 to 24) builds
the kernels and runs that phase alone, printing no result line.
``python3 chip_smoke.py --bitwise TREE`` holds the equal-width
block-sparse and strip instances bitwise to another checkout's
(``bitwise_instances``); ``--profiler-probe`` checks whether the
profiler keeps tracing the card after sessions of many launches.

Then it prints one JSON line with every kernel's numbers, the card's name
and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Weights are random, from a fixed seed (phase 21 trains its own).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "llama3-8b-262k"
SEQ = 8192
PROMPT_LENS = (8192, 7937)
NEW_TOKENS = 16
SEED = 0

# published H100 SXM peaks (dense): HBM bytes/s, and FLOP/s per input type
# (bf16 on the tensor cores, float32 outside them)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# max |kernel − plain| allowed, per output and input dtype.  Both sides
# accumulate in float32 from the same inputs, so the gap is summation order
# (float32) plus one rounding of the output to bfloat16 (bf16 ulp at |x|<2
# is 2^-7; the plain decode also rounds p to bf16 before PV, as the
# reference's einsum does).  Strips and Ã are float32 in both dtypes.
TOL = {
    ("strip", "float32"): 1e-5, ("strip", "bfloat16"): 1e-5,
    ("out", "float32"): 1e-4, ("out", "bfloat16"): 2e-2,
    ("a_tilde", "float32"): 1e-4, ("a_tilde", "bfloat16"): 1e-3,
}
# near-tie tolerance of the small CUDA-vs-CPU serve comparison (float32)
TIE_TOL = 1e-3
# bf16 outputs at the MLA widths (phase 16) are also held row by row: each
# row's max |kernel − plain| within this many bf16 ulps of that row's
# max |plain|.  Rows that average thousands of keys have |out| of the order
# of the absolute ``TOL`` itself; this bound scales with each row.
ROW_ULPS = 4

KERNELS = {
    "strip": ("src/repro_torch/csrc/strip.cu",
              "src/repro/kernels/strip.py:111"),
    "block_sparse_attn": ("src/repro_torch/csrc/block_sparse_attn.cu",
                          "src/repro/kernels/block_sparse_attn.py:312"),
    "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                    "src/repro/kernels/decode_attn.py:340"),
    "decode_attn_paged": ("src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn.py:579"),
    "block_sparse_attn_single": ("src/repro_torch/csrc/block_sparse_attn.cu",
                                 "src/repro/kernels/block_sparse_attn.py:122"),
    "block_sparse_attn_paged": ("src/repro_torch/csrc/block_sparse_attn.cu",
                                "src/repro/kernels/block_sparse_attn.py:428"),
    "decode_attn_dense": ("src/repro_torch/csrc/decode_attn.cu",
                          "src/repro/kernels/decode_attn.py:143"),
    "decode_attn_sparse": ("src/repro_torch/csrc/decode_attn.cu",
                           "src/repro/kernels/decode_attn.py:226"),
}

# phase 6: (prompt tokens, max_new_tokens); buckets 8192 / 2048 take 65 / 17
# pages of the 147 usable, so r0-r2 fill the pool and r3 waits for r1's
SHORT = 2048
PAGED_REQUESTS = ((8192, 16), (7937, 4), (2048, 24), (1990, 8), (8192, 12),
                  (2000, 6))
NUM_PAGES = 148

# the paper's baselines (core/baselines.py) and the four prefill methods
BASELINES = ("vertical_slash", "flex")
METHODS = ("share", "dense") + BASELINES


# the instances of the templated kernel bodies, by their MODE argument
# (csrc/block_sparse_attn.cu: the bf16 tensor-core body bsa_tc_kernel, its
# Hopper body bsa_wgmma_kernel and the float32 body bsa_f32_kernel;
# csrc/decode_attn.cu: decode_kernel and its split combine
# decode_combine_kernel)
INSTANCES = {("bsa", "0"): "block_sparse_attn",
             ("bsa", "1"): "block_sparse_attn_paged",
             ("bsa", "2"): "block_sparse_attn_single",
             ("decode", "0"): "decode_attn",
             ("decode", "1"): "decode_attn_paged",
             ("decode", "2"): "decode_attn_dense",
             ("decode", "3"): "decode_attn_sparse"}
# bsa_*_kernel<BQ, DQK, DV, MODE> (<BQ, D, MODE> before the V width had
# its own argument, and for the Hopper body bsa_wgmma_kernel<BQ, D, MODE>),
# decode_kernel<T, MODE, GP, CH>,
# decode_combine_kernel<T, MODE>
_INSTANCE = re.compile(r"\b(?:(bsa)_(?:tc|f32|wgmma)_kernel<\d+,\s*\d+,\s*"
                       r"(?:\d+,\s*)?(\d+)>"
                       r"|(decode)_(?:combine_)?kernel<[^,<>]+,\s*(\d+)[,>])")
_PORT_KERNEL = re.compile(r"\b(?:bsa|decode|strip)_\w*kernel\b")
# csrc/strip.cu: strip_tc_kernel<D, PASS> (bf16, tensor cores) and
# strip_f32_kernel<T, PASS>, two device kernels per call
_STRIP = re.compile(r"\bstrip_\w*kernel\b")


def kernel_group(name: str) -> str:
    """The profile group of a device function: a port kernel's instance
    (``KERNELS`` key), "gemm" for cuBLAS, else "other".  Raises on a port
    kernel that maps to no instance."""
    low = name.lower()
    if _STRIP.search(low):
        return "strip"
    mode = _INSTANCE.search(low)
    if mode:
        return INSTANCES[tuple(x for x in mode.groups() if x is not None)]
    if _PORT_KERNEL.search(low):
        raise AssertionError(f"port kernel {name!r} maps to no instance")
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "matmul")):
        return "gemm"
    return "other"


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


# device kernels one call of each wrapper launches: the strip's partial-
# stats pass and its normalised write, a decode's split kernel and its
# combine, one block-sparse kernel
DEVICE_KERNELS = {name: 2 if name == "strip" or name.startswith("decode")
                  else 1 for name in KERNELS}


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` summed over the port's kernels it
    launches, read from ``torch.profiler``.  Fails where the profiler
    traced no port kernel, or another number of device kernels than the
    wrapper launches per call (``DEVICE_KERNELS``: a strip call is two).
    ``cuda_ms`` of back-to-back calls also counts the host's enqueue when
    that is the longer."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        g = kernel_group(e.key)
        if g in KERNELS and _device_us(e) > 0:
            us_n = groups.setdefault(g, [0.0, 0])
            us_n[0] += _device_us(e)
            us_n[1] += e.count
    if not groups:
        raise AssertionError("the profiler traced no device time for a "
                             "port kernel that ran")
    for g, (_, n) in groups.items():
        if n != reps * DEVICE_KERNELS[g]:
            raise AssertionError(
                f"{g}: the profiler traced {n} device kernels in {reps} "
                f"calls, expected {reps * DEVICE_KERNELS[g]}")
    return sum(us for us, _ in groups.values()) / 1e3 / reps


# what each traced session waits for before its body: CUPTI, torn down
# after each session (TEARDOWN_CUPTI=1), comes back up; and the pause
# after it, before another session may start
TRACE_PAD_S = 0.3
TRACE_GAP_S = 0.2


@contextlib.contextmanager
def traced(activities):
    """A ``torch.profiler`` session over the ``with`` body.  In a process
    that has run a while, the tracer drops the first kernels of each
    session, more of them the older the process (``--profiler-probe``).
    ``main`` therefore sets ``TEARDOWN_CUPTI=1``, so that CUPTI starts
    afresh in each session; each session waits ``TRACE_PAD_S`` before its
    body, and ``TRACE_GAP_S`` after it."""
    import torch
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
    time.sleep(TRACE_GAP_S)


PROBE_OPS = ("add", "mul", "sqrt", "div", "exp", "log", "sin", "cos", "tanh",
             "sigmoid")


def probe_session(helper: bool) -> list:
    """One traced session of ten distinct elementwise ops (~0.1 ms each),
    through :func:`traced` or a bare ``torch.profiler`` session: the ops
    whose kernel the profiler kept, in launch order."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.rand(1 << 25, device="cuda") + 0.5
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with (traced(acts) if helper else profile(activities=acts)) as prof:
        for op in PROBE_OPS:
            fn = getattr(torch, op)
            fn(x, x) if op in ("add", "mul", "div") else fn(x)
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.name in {f"aten::{o}" for o in PROBE_OPS}]
    return [e.name[6:] for e in sorted(ops, key=lambda e: e.time_range.start)
            if e.kernels]


def profiler_probe_run(variant: str) -> None:
    """One process of ``--profiler-probe``: a bare session fresh, then, once
    the process has aged under two sessions of 400k launches and 30 s, a
    bare session and 60 :func:`traced` sessions in a row (their pad and
    gap as the variant says)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    global TRACE_PAD_S, TRACE_GAP_S
    show = lambda kept: f"{len(kept)} of {len(PROBE_OPS)} {kept}"
    print(f"  [{variant}] fresh, bare: {show(probe_session(False))}",
          flush=True)
    x = torch.zeros(1, device="cuda")
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in range(400_000):
                x.add_(1)
            torch.cuda.synchronize()
    time.sleep(30)
    print(f"  [{variant}] aged, bare: {show(probe_session(False))}",
          flush=True)
    if "pad 0" in variant:
        TRACE_PAD_S = TRACE_GAP_S = 0.0
    t = time.time()
    kept = [len(probe_session(True)) for _ in range(60)]
    print(f"  [{variant}] aged, 60 traced() sessions in a row: kept "
          f"{min(kept)}-{max(kept)} of {len(PROBE_OPS)}, "
          f"{sum(k == len(PROBE_OPS) for k in kept)} whole; "
          f"{(time.time() - t) / 60:.3f} s a session", flush=True)


def profiler_probe() -> int:
    """``--profiler-probe``: :func:`profiler_probe_run` in a process of its
    own per variant of the tracer's settings, each cut at 150 s."""
    for variant, env in (
            ("TEARDOWN_CUPTI unset", {}),
            ("TEARDOWN_CUPTI=1", {"TEARDOWN_CUPTI": "1"}),
            ("TEARDOWN_CUPTI=1, pad 0", {"TEARDOWN_CUPTI": "1"})):
        base = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        try:
            p = subprocess.run(
                [sys.executable, __file__, "--profiler-probe-run", variant],
                capture_output=True, text=True, env={**base, **env},
                timeout=150)
        except subprocess.TimeoutExpired as exc:
            out = exc.stdout or b""
            print((out.decode() if isinstance(out, bytes) else out)
                  + f"  [{variant}] cut at 150 s", flush=True)
            continue
        print(p.stdout, end="", flush=True)
        if p.returncode:
            print(p.stderr[-3000:], flush=True)
    return 0


def library_ms(fn, reps: int):
    """``cuda_ms`` of a PyTorch library call used only as a yardstick;
    None (and the reason printed) when the call cannot run here."""
    import torch
    try:
        return cuda_ms(fn, reps)
    except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
        print(f"  library call not timed: {exc}".splitlines()[0], flush=True)
        torch.cuda.empty_cache()
        return None


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms, what bounds it) for moving ``nbytes`` and doing
    ``flops`` products in ``dtype`` at the card's published peaks."""
    name = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    print(f"  {name}: max_abs_err {err:.3e} (tol {tol:.0e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: error {err} above {tol}")


def row_ulp_err(a, b) -> float:
    """Largest per-row max |a − b| over the last axis, in bf16 ulps of the
    row's max |b| (ulp 2^(floor(log2 x) − 7))."""
    import torch
    a, b = a.float(), b.float()
    top = b.abs().amax(-1).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return float(((a - b).abs().amax(-1) / ulp).max())


def check_rows(name: str, a, b) -> float:
    u = row_ulp_err(a, b)
    ok = u <= ROW_ULPS
    print(f"  {name}: worst row {u:.2f} bf16 ulps of its max |out| "
          f"(bound {ROW_ULPS}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: a row {u} ulps off, above {ROW_ULPS}")
    return u


def a_tilde_err(a, b) -> float:
    """Max |Δ| over finite entries; −inf must sit at the same places."""
    import torch
    if not bool((torch.isinf(a) == torch.isinf(b)).all()):
        return float("inf")
    fin = torch.isfinite(a)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


# ---------------------------------------------------------------- phase 2

def layer0_qkv(model, params, tokens, positions=None, embeds=None):
    """Layer 0's post-RoPE q (B,H,N,D) and k/v (B,Hkv,N,D), as prefill
    computes them (a VLM's from ``embeds`` under 3-D ``positions``)."""
    import torch
    from repro_torch.models import attention, common
    cfg = model.cfg
    x = params["embed"][tokens] if embeds is None else embeds
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    layer = params["layers"][0]
    h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    q, k, v = common.gqa_qkv(layer["attn"], h)
    q, k = attention.rope_qk(q, k, positions, cfg)
    return q.contiguous(), k.contiguous(), v.contiguous()


def real_masks(model, q, k, v, extra=None):
    """Layer 0's SharePrefill masks and decisions for q (B,H,N,D) and k/v
    (B,Hkv,N,D) from the dictionary that layer 0 builds on the same input
    (so some heads share), as in a serve's second pass over a cluster;
    ``extra`` (NB, NB) is ANDed in (a sliding window's block mask)."""
    from repro_torch.core.share_attention import (
        build_share_masks, update_share_state)
    from repro_torch.kernels import (block_sparse_attention_cuda,
                                     compact_block_mask)

    spc = model.cfg.share_prefill
    b, h, n, _ = q.shape
    nb = n // spc.block_size
    sp = model.default_share_prefill()
    state = sp.init_state(b, n, device=q.device)
    ids = sp.layer_cluster_ids(device=q.device)[0]
    masks, decision = build_share_masks(q, k, state, ids, spc, extra)
    idx, cnt = compact_block_mask(masks)
    _, a0 = block_sparse_attention_cuda(
        q, k, v, idx.contiguous(), cnt.contiguous(),
        block_size=spc.block_size, stats_gate=decision.use_dense)
    state = update_share_state(a0, state, ids, decision, spc)
    shared, decision = build_share_masks(q, k, state, ids, spc, extra)
    for label, m in (("layer 0", masks), ("with its dictionary", shared)):
        print(f"real masks, {label}: density "
              f"{float(m.float().sum() / (b * h * nb * (nb + 1) / 2)):.4f}",
              flush=True)
    print(f"with its dictionary: shared heads "
          f"{int(decision.use_shared.sum())}, dense "
          f"{int(decision.use_dense.sum())}, vs {int(decision.use_vs.sum())}",
          flush=True)
    return shared, decision


def bsa_work(vis, group: int, bs: int, off: int) -> tuple:
    """What block-sparse tables make the kernel do: the causally valid
    (query, key) entries over the visited blocks (query block i sits at
    block ``off + i``) and the distinct (batch, kv head, block) K/V tiles
    read; ``vis`` (B, H, NBq, NBkv) bool."""
    import torch
    b, h, nbq, nbkv = vis.shape
    i = torch.arange(nbq, device=vis.device)[:, None] + off
    j = torch.arange(nbkv, device=vis.device)[None, :]
    per_block = torch.where(j < i, float(bs * bs),
                            torch.where(j == i, bs * (bs + 1) / 2.0, 0.0))
    entries = float((vis.float() * per_block).sum())
    tiles = float(vis.reshape(b, h // group, group, nbq, nbkv)
                  .any(2).any(2).sum())
    return entries, tiles


def strip_cases(q, k, bs: int, gen):
    """(label, q, k, bs) of the strip checks: q (B, H, N, D) and k of layer
    0 at the phase-2 shape; its first 2048 and 512 positions (the
    scheduler's short bucket; 64-key chunks, so the last chunk holds no
    visible key for strip rows < 64); an 8320-token cache (the decode
    cache: a shorter last chunk) extended by random rows at the scale of
    q's and k's; then the body's other instances on random inputs: the
    tensor-core body at D = 64 (bs = 16: N % 64 != 0, and row tiles only
    partly filled) and D = 96, the CUDA-core body (bf16 at D = 80)."""
    import torch
    b, h, n, d = q.shape
    hkv, dev, dtype = k.shape[1], q.device, q.dtype

    def rand(shape, like):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * like.float().std()).to(dtype)

    extra = lambda x: torch.cat(
        [x, rand(x.shape[:2] + (bs, d), x)], dim=2).contiguous()
    cases = [(q, k, bs),
             (q[:, :, :2048].contiguous(), k[:, :, :2048].contiguous(), bs),
             (q[:, :, :512].contiguous(), k[:, :, :512].contiguous(), bs),
             (extra(q), extra(k), bs)]
    for bb, hh, hk, nn, dd, bsz in ((2, 4, 2, 1040, 64, 16),
                                    (2, 6, 2, 768, 96, 128),
                                    (1, 4, 1, 512, 80, 64)):
        cases.append((rand((bb, hh, nn, dd), q), rand((bb, hk, nn, dd), k),
                      bsz))
    return [(f"B={qs.shape[0]} H={qs.shape[1]} Hkv={ks.shape[1]} "
             f"N={ks.shape[2]} D={ks.shape[3]} bs={bsz}", qs, ks, bsz)
            for qs, ks, bsz in cases]


def check_baseline_masks(q, k, v, bs: int, gamma: float, out: dict
                         ) -> dict:
    """Phase 2, the baselines: each baseline's masks built on the card from
    q (B,H,N,D) and k (B,Hkv,N,D), the block-sparse kernel on them with a
    stats gate of zeros against its plain version (out within ``TOL``, Ã
    all −inf on both sides); in float32 also the mask blocks that differ
    from the same masks built on the CPU, counted and not bounded; in
    bfloat16 the kernel's time.  Updates and returns ``out`` (per method:
    error, density, flips, ms)."""
    import torch
    from repro_torch.core.baselines import baseline_block_masks
    from repro_torch.core.patterns import block_mask_density
    from repro_torch.kernels import (block_sparse_attention_cuda,
                                     block_sparse_attention_plain,
                                     compact_block_mask)
    dn = str(q.dtype).replace("torch.", "")
    b, h, n, _ = q.shape
    nb = n // bs
    gate = torch.zeros((b, h), dtype=torch.int32, device=q.device)
    causal = torch.ones(nb, nb, dtype=torch.bool, device=q.device).tril()
    for method in BASELINES:
        r = out.setdefault(method, {"max_abs_err": 0.0})
        masks = baseline_block_masks(method, q, k, gamma=gamma,
                                     block_size=bs) & causal
        idx, cnt = (x.contiguous() for x in compact_block_mask(masks))
        kw = dict(block_size=bs, stats_gate=gate)
        o1, a1 = block_sparse_attention_cuda(q, k, v, idx, cnt, **kw)
        o2, a2 = block_sparse_attention_plain(q, k, v, idx, cnt, **kw)
        neg_inf = bool(torch.isneginf(a1).all() and torch.isneginf(a2).all())
        r["density"] = float(block_mask_density(masks).mean())
        extra = ""
        if q.dtype == torch.float32:
            cpu = baseline_block_masks(method, q.cpu(), k.cpu(), gamma=gamma,
                                       block_size=bs) & causal.cpu()
            r["flips"] = int((cpu != masks.cpu()).sum())
            extra = (f", mask blocks differing from the CPU's "
                     f"{r['flips']} of {masks.numel()}")
        print(f"  block_sparse_attn [{method} masks, gate 0]: density "
              f"{r['density']:.4f}, W={idx.shape[-1]}, a_tilde all -inf "
              f"{neg_inf}{extra}", flush=True)
        if not neg_inf:
            raise AssertionError(f"{method}: a stats gate of zeros left "
                                 "finite a_tilde entries")
        e = max_err(o1, o2)
        check("  out", e, TOL[("out", dn)])
        r["max_abs_err"] = max(r["max_abs_err"], e)
        if q.dtype == torch.bfloat16:
            call = lambda: block_sparse_attention_cuda(q, k, v, idx, cnt,
                                                       **kw)
            r["ms"], r["device_ms"] = cuda_ms(call, 10), device_ms(call, 10)
            print(f"  block_sparse_attn bf16 [{method} masks]: "
                  f"{r['ms']:.3f} ms (device {r['device_ms']:.4f} ms)",
                  flush=True)
    return out


def check_kernels(model, params, tokens, prompt_lens) -> dict:
    """Phase 2: each kernel against its plain version; returns the kernels'
    numbers for the JSON line (errors over every case, times at bf16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (
        block_sparse_attention_cuda, block_sparse_attention_plain,
        compact_block_mask, decode_plan_einsum_sliced, expand_kv,
        flash_decode_sparse_cuda, strip_scores, strip_scores_cuda,
        table_block_mask)
    from repro_torch.kernels.decode_attn import (
        DecodePlan, decode_splits, sm_count)
    from repro_torch.models.transformer import decode_valid_mask

    cfg = model.cfg
    spc = cfg.share_prefill
    bs = spc.block_size
    dev = tokens.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q16, k16, v16 = layer0_qkv(model, params, tokens)
    b, h, n, d = q16.shape
    hkv = k16.shape[1]
    g = h // hkv
    nb = n // bs
    print(f"shapes: B={b} H={h} Hkv={hkv} N={n} D={d} bs={bs}", flush=True)
    masks, decision = real_masks(model, q16, k16, v16)
    # synthetic rows: an empty row (counts == 0), a sparse random row, and
    # a stats-gate mix (real gate xor every third head)
    syn = masks.clone()
    syn[0, 1, nb // 2] = False
    syn[1, 2, nb - 1] &= torch.rand(nb, generator=gen, device=dev) < 0.3
    syn[1, 2, nb - 1, nb - 1] = True
    gate = decision.use_dense ^ (torch.arange(h, device=dev) % 3 == 0)
    width_cap = nb // 4
    ridx, rcnt = (x.contiguous() for x in compact_block_mask(masks))
    # C.1: head dim 96 (phi3-mini) on layer 0's tables, random q/k/v at the
    # scale of the model's
    d96 = [torch.randn(x.shape[:3] + (96,), generator=gen, device=dev)
           * x.float().std() for x in (q16, k16, v16)]
    # the chunk launch: q blocks [OFFSET, OFFSET + 16) of the 64
    off = API_OFFSET
    cidx, ccnt = (x.contiguous() for x in
                  compact_block_mask(masks[:, :, off:off + 16]))
    rows = slice(off * bs, (off + 16) * bs)

    res = {name: {"max_abs_err": 0.0}
           for name in ("strip", "block_sparse_attn", "decode_attn")}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q, k, v = (x.to(dtype) for x in (q16, k16, v16))
        print(f"[{dn}]", flush=True)

        # strip: the phase-2 shape and others of the main path, and the
        # body's other instances; sample 0 alone bitwise the batch's slice
        for label, qs, ks, sbs in strip_cases(q, k, bs, gen):
            o = strip_scores_cuda(qs, ks, sbs)
            e = max_err(o, strip_scores(qs, ks, sbs))
            check(f"strip [{label}]", e, TOL[("strip", dn)])
            res["strip"]["max_abs_err"] = max(res["strip"]["max_abs_err"], e)
            # the key split depends on N alone: sample 0 alone is bitwise
            # the batch's first strip
            if not torch.equal(strip_scores_cuda(qs[:1], ks[:1], sbs), o[:1]):
                raise AssertionError(f"strip [{label}]: sample 0 alone "
                                     "differs from the batch's slice")
        if dtype == torch.float32:
            res["strip"]["f32_ms"] = cuda_ms(
                lambda: strip_scores_cuda(q, k, bs), 10)

        # block-sparse prefill attention: real tables, synthetic rows, cap
        cases = [("real masks, real gate", masks, None, decision.use_dense),
                 ("synthetic rows, gate mix", syn, None, gate),
                 (f"synthetic rows, W cap {width_cap}", syn, width_cap, gate)]
        for label, m, width, gt in cases:
            idx, cnt = compact_block_mask(m, width=width)
            idx, cnt = idx.contiguous(), cnt.contiguous()
            o1, a1 = block_sparse_attention_cuda(q, k, v, idx, cnt,
                                                 block_size=bs, stats_gate=gt)
            o2, a2 = block_sparse_attention_plain(q, k, v, idx, cnt,
                                                  block_size=bs,
                                                  stats_gate=gt)
            zero_row = bool((o1[0, 1, (nb // 2) * bs:(nb // 2 + 1) * bs]
                             == 0).all()) if m is syn else True
            padded = int((cnt < idx.shape[-1]).sum())
            print(f"  block_sparse_attn [{label}]: W={idx.shape[-1]}, "
                  f"padded rows {padded}, counts==0 rows "
                  f"{int((cnt == 0).sum())}, zero row exact {zero_row}",
                  flush=True)
            if not zero_row:
                raise AssertionError("counts == 0 row is not exact zeros")
            e = max_err(o1, o2)
            check("  out", e, TOL[("out", dn)])
            ea = a_tilde_err(a1, a2)
            check("  a_tilde", ea, TOL[("a_tilde", dn)])
            res["block_sparse_attn"]["max_abs_err"] = max(
                res["block_sparse_attn"]["max_abs_err"], e)

        # the baselines' masks, built on the card (MInference's strip is
        # the strip kernel), under a stats gate of zeros
        res["baselines"] = check_baseline_masks(q, k, v, bs, spc.gamma,
                                                res.get("baselines", {}))
        res["block_sparse_attn"]["max_abs_err"] = max(
            res["block_sparse_attn"]["max_abs_err"],
            *(r["max_abs_err"] for r in res["baselines"].values()))

        # C.1: the same tables at head dim 96
        q96, k96, v96 = (x.to(dtype) for x in d96)
        kw96 = dict(block_size=bs, stats_gate=decision.use_dense)
        o1, a1 = block_sparse_attention_cuda(q96, k96, v96, ridx, rcnt,
                                             **kw96)
        o2, a2 = block_sparse_attention_plain(q96, k96, v96, ridx, rcnt,
                                              **kw96)
        print("  block_sparse_attn [real masks, D=96]", flush=True)
        e = max_err(o1, o2)
        check("  out", e, TOL[("out", dn)])
        check("  a_tilde", a_tilde_err(a1, a2), TOL[("a_tilde", dn)])
        res["block_sparse_attn"]["max_abs_err"] = max(
            res["block_sparse_attn"]["max_abs_err"], e)

        # the chunk launch at q block OFFSET (chunked prefill's shape):
        # against its plain version, and bitwise the full launch's rows
        kwc = dict(block_size=bs, stats_gate=decision.use_dense)
        qc = q[:, :, rows].contiguous()
        oc, ac = block_sparse_attention_cuda(qc, k, v, cidx, ccnt,
                                             q_block_offset=off, **kwc)
        op, ap = block_sparse_attention_plain(qc, k, v, cidx, ccnt,
                                              q_block_offset=off, **kwc)
        of, af = block_sparse_attention_cuda(q, k, v, ridx, rcnt, **kwc)
        torch.cuda.synchronize()
        same = (torch.equal(oc, of[:, :, rows])
                and torch.equal(ac, af[:, :, off:off + 16]))
        print(f"  block_sparse_attn [16-block chunk at q block {off}]: "
              f"bitwise the full launch's rows (out and a_tilde) {same}",
              flush=True)
        if not same:
            raise AssertionError("the chunk launch differs from the full "
                                 "launch's rows")
        e = max_err(oc, op)
        check("  out", e, TOL[("out", dn)])
        check("  a_tilde", a_tilde_err(ac, ap), TOL[("a_tilde", dn)])
        res["block_sparse_attn"]["max_abs_err"] = max(
            res["block_sparse_attn"]["max_abs_err"], e)

        # sparse decode over the grown cache: partly false keep bits, an
        # empty (counts == 0) slot, ragged valid (the shorter prompt's pad)
        extra = bs
        s = n + extra
        ck = torch.zeros((b, hkv, s, d), dtype=dtype, device=dev)
        cv = torch.zeros_like(ck)
        ck[:, :, :n], cv[:, :, :n] = k, v
        pos = n + 5
        ck[:, :, n:pos + 1] = torch.randn((b, hkv, pos + 1 - n, d),
                                          generator=gen, device=dev).to(dtype)
        cv[:, :, n:pos + 1] = torch.randn((b, hkv, pos + 1 - n, d),
                                          generator=gen, device=dev).to(dtype)
        qd = q[:, :, -1].contiguous()
        nbs = s // bs
        keep = torch.rand((b, hkv, nbs, g), generator=gen, device=dev) < 0.7
        keep[..., -1, :] = True
        union = keep.any(-1)
        union[1, 3] = False
        keep &= union[..., None]
        idx, cnt = compact_block_mask(union)
        idx, cnt, keep = idx.contiguous(), cnt.contiguous(), keep.contiguous()
        valid = decode_valid_mask(s, pos, prompt_lens, n).contiguous()
        od = flash_decode_sparse_cuda(qd, ck, cv, idx, cnt, keep, valid)
        ref = decode_plan_einsum_sliced(qd, ck, cv,
                                        DecodePlan(idx, cnt, keep), valid)
        zeros = bool((od[1, 3 * g:4 * g] == 0).all())
        print(f"  decode_attn: S={s}, counts==0 slot exact zeros {zeros}",
              flush=True)
        if not zeros:
            raise AssertionError("counts == 0 decode slot is not zeros")
        e = max_err(od, ref)
        check("  out", e, TOL[("out", dn)])
        res["decode_attn"]["max_abs_err"] = max(
            res["decode_attn"]["max_abs_err"], e)

        if dtype != torch.bfloat16:
            continue
        # ---- times at the main path's dtype, with bounds and library calls
        elt = q.element_size()
        # strip: q's last bs rows and k in, the f32 strip out; products over
        # the causally valid (row, key) pairs
        pairs = bs * (n - bs) + bs * (bs + 1) // 2
        sb = bound(b * h * bs * d * elt + b * hkv * n * d * elt
                   + b * h * bs * n * 4, 2.0 * d * b * h * pairs, dtype)
        q1, k1 = q[:1], k[:1]
        res["strip"].update(
            ms=cuda_ms(lambda: strip_scores_cuda(q, k, bs), 20),
            device_ms=device_ms(lambda: strip_scores_cuda(q, k, bs), 10),
            b1_ms=cuda_ms(lambda: strip_scores_cuda(q1, k1, bs), 20),
            b1_device_ms=device_ms(lambda: strip_scores_cuda(q1, k1, bs),
                                   10),
            plain_ms=cuda_ms(lambda: strip_scores(q, k, bs), 3),
            bound_ms=sb[0], bound_by=sb[1], library_ms=None)

        # block-sparse: the real layer-0 tables; QK and PV products over
        # the causally valid entries of every visited block; q, out, the
        # visited K/V blocks, tables and Ã moved once
        bidx, bcnt = compact_block_mask(masks)
        bidx, bcnt = bidx.contiguous(), bcnt.contiguous()
        dg = decision.use_dense
        vis = table_block_mask(bidx, bcnt, nb)     # causal rows: all visited
        entries, kv_blocks = bsa_work(vis, g, bs, 0)
        bb = bound(2 * b * h * n * d * elt + 2 * kv_blocks * bs * d * elt
                   + bidx.numel() * 4 + bcnt.numel() * 4 + b * h * nb * nb * 4,
                   4.0 * d * entries, dtype)
        # yardstick: SDPA on K/V expanded to H heads under the token mask
        # the tables expand to (the output only; no Ã)
        kx, vx = expand_kv(k, v, h)
        tok_mask = (vis.repeat_interleave(bs, 2).repeat_interleave(bs, 3)
                    & torch.ones(n, n, dtype=torch.bool, device=dev).tril())
        lib = library_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=tok_mask), 5)
        del tok_mask, kx, vx
        res["block_sparse_attn"].update(
            ms=cuda_ms(lambda: block_sparse_attention_cuda(
                q, k, v, bidx, bcnt, block_size=bs, stats_gate=dg), 10),
            device_ms=device_ms(lambda: block_sparse_attention_cuda(
                q, k, v, bidx, bcnt, block_size=bs, stats_gate=dg), 10),
            plain_ms=cuda_ms(lambda: block_sparse_attention_plain(
                q, k, v, bidx, bcnt, block_size=bs, stats_gate=dg), 2),
            bound_ms=bb[0], bound_by=bb[1], library_ms=lib)
        # the same work at D = 96, and the chunk launch at its offset
        b96 = bound(2 * b * h * n * 96 * elt + 2 * kv_blocks * bs * 96 * elt
                    + bidx.numel() * 4 + bcnt.numel() * 4
                    + b * h * nb * nb * 4, 4.0 * 96 * entries, dtype)
        cvis = table_block_mask(cidx, ccnt, nb)
        centries, ctiles = bsa_work(cvis, g, bs, off)
        bc = bound(2 * qc.numel() * elt + 2 * ctiles * bs * d * elt
                   + cidx.numel() * 4 + ccnt.numel() * 4 + cvis.numel() * 4,
                   4.0 * d * centries, dtype)
        run96 = lambda: block_sparse_attention_cuda(
            q96, k96, v96, bidx, bcnt, block_size=bs, stats_gate=dg)
        run_chunk = lambda: block_sparse_attention_cuda(
            qc, k, v, cidx, ccnt, q_block_offset=off, **kwc)
        res["block_sparse_attn"].update(
            d96_ms=cuda_ms(run96, 10), d96_device_ms=device_ms(run96, 10),
            d96_bound_ms=b96[0], chunk_ms=cuda_ms(run_chunk, 10),
            chunk_device_ms=device_ms(run_chunk, 10), chunk_bound_ms=bc[0])

        # decode: the table's blocks of K and V, q, out and the tables
        # moved once; QK and PV products over the kept, valid keys
        ntok = valid.reshape(b, 1, nbs, bs).sum(-1)          # (B, 1, NB)
        listed = table_block_mask(idx, cnt, nbs)             # (B, Hkv, NB)
        kept_tok = float(((keep & listed[..., None]).float()
                          * ntok[..., None]).sum())
        db = bound(2 * b * h * d * elt + 2 * float(cnt.sum()) * bs * d * elt
                   + idx.numel() * 4 + cnt.numel() * 4 + keep.numel()
                   + valid.numel(), 4.0 * d * kept_tok, dtype)
        # yardstick: SDPA on the cache expanded to H heads under the
        # token mask of keep bits and slot validity
        ckx, cvx = expand_kv(ck, cv, h)
        dmask = (keep.movedim(-1, 2).repeat_interleave(bs, -1)
                 .reshape(b, h, 1, s) & valid[:, None, None, :])
        lib = library_ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], ckx, cvx, attn_mask=dmask), 50)
        res["decode_attn"].update(
            ms=cuda_ms(lambda: flash_decode_sparse_cuda(
                qd, ck, cv, idx, cnt, keep, valid), 50),
            plain_ms=cuda_ms(lambda: decode_plan_einsum_sliced(
                qd, ck, cv, DecodePlan(idx, cnt, keep), valid), 10),
            bound_ms=db[0], bound_by=db[1], library_ms=lib,
            device_ms=device_ms(lambda: flash_decode_sparse_cuda(
                qd, ck, cv, idx, cnt, keep, valid), 20),
            splits=decode_splits(b, hkv, keep.shape[2], sm_count(dev)))
        for name in ("strip", "block_sparse_attn", "decode_attn"):
            r = res[name]
            split = (f", {r['splits']} splits x {b * hkv} rows, device "
                     f"{r['device_ms']} ms a call"
                     if "splits" in r else "")
            if name == "strip":
                split = (f", device {r['device_ms']} ms a call; B=1 "
                         f"{r['b1_ms']:.4f} ms, device {r['b1_device_ms']}"
                         f" ms; float32 {r['f32_ms']:.4f} ms")
            if name == "block_sparse_attn":
                split = (f", device {r['device_ms']:.4f} ms a call; D=96 "
                         f"{r['d96_ms']:.3f} ms (device "
                         f"{r['d96_device_ms']:.4f}), bound "
                         f"{r['d96_bound_ms']:.4f}, bound_frac "
                         f"{r['d96_bound_ms'] / r['d96_ms']:.4f}; 16-block "
                         f"chunk at q block {off} {r['chunk_ms']:.3f} ms "
                         f"(device {r['chunk_device_ms']:.4f}), bound "
                         f"{r['chunk_bound_ms']:.4f}, bound_frac "
                         f"{r['chunk_bound_ms'] / r['chunk_ms']:.4f}")
            print(f"  {name} bf16: {r['ms']:.3f} ms (plain "
                  f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, bound_frac "
                  f"{r['bound_ms'] / r['ms']:.4f}, library "
                  f"{r['library_ms']}{split})", flush=True)
    return res


# ---------------------------------------------------------------- phases 3-4

class LogitProbe:
    """The model, as the engine calls it, recording every logit it returns
    (finiteness and the top-2 margin of each row) on the device."""

    def __init__(self, model):
        self.model, self.cfg, self.device = model, model.cfg, model.device
        self.logits = []

    def _record(self, logits):
        self.logits.append(logits.detach().float())

    def prefill(self, *args, **kwargs):
        result = self.model.prefill(*args, **kwargs)
        self._record(result.last_logits)
        return result

    def decode(self, *args, **kwargs):
        out = self.model.decode(*args, **kwargs)
        self._record(out[0])            # (logits, cache[, queries])
        return out

    def __getattr__(self, name):        # the rest of the model's API
        return getattr(self.model, name)


def greedy_agree(ref_tokens, ref_logits, tokens, tol: float) -> str:
    """Greedy streams agree up to their first flip, and a flip is allowed
    only where the reference's top-2 margin at that step is below ``tol``
    (after it, the streams condition on different tokens)."""
    for t, (a, c) in enumerate(zip(ref_tokens, tokens)):
        if a == c:
            continue
        top2 = np.sort(ref_logits[t])[-2:]
        margin = float(top2[1] - top2[0])
        if margin >= tol:
            raise AssertionError(f"token {t}: {c} != {a} at margin "
                                 f"{margin:.3e} >= {tol}")
        return f"near-tie flip at token {t} (margin {margin:.2e})"
    if len(ref_tokens) != len(tokens):
        raise AssertionError("stream lengths differ")
    return "identical"


def small_serve_agreement() -> None:
    """Phase 3: a small ragged batch served through the kernels (float32 on
    the card) and through the plain versions (the CPU) from the same
    weights, for SharePrefill and both baselines; greedy tokens must agree,
    near-tie aware.  For each baseline, the traced prefill of prompt 0 on
    both devices counts the mask blocks that differ (reported, not held:
    the card's strip accumulates in another order)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.profile import run_prefill_traced
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    cfg = dataclasses.replace(get_smoke_config(ARCH), num_heads=8,
                              num_kv_heads=2)
    cpu = build_model(cfg, device="cpu")
    params_cpu = cpu.init(torch.Generator().manual_seed(SEED))
    params_gpu = _to(params_cpu, "cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (512, 450)]
    for method in ("share",) + BASELINES:
        runs = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, device=dev)
            params = params_cpu if dev == "cpu" else params_gpu
            probe = LogitProbe(model)
            eng = ServingEngine(probe, params, model.default_share_prefill(),
                                EngineConfig(method=method, max_batch=2,
                                             seq_buckets=(512,),
                                             decode_sparse=True))
            reqs = eng.serve([Request(uid=i, prompt=p, max_new_tokens=8)
                              for i, p in enumerate(prompts)])
            runs[dev] = ([r.output_tokens for r in reqs],
                         torch.stack(probe.logits, 1).cpu().numpy(),
                         reqs[0].pattern_stats)
        (tok_c, log_c, st_c), (tok_p, log_p, st_p) = runs["cuda"], runs["cpu"]
        err = float(np.abs(log_c[:, 0] - log_p[:, 0]).max())
        flips = ""
        if method != "share":
            masks = [run_prefill_traced(
                params, cfg, torch.as_tensor(prompts[0][None], device=dev),
                cpu.default_share_prefill(), method=method,
                want_masks=True).masks
                for params, dev in ((params_gpu, "cuda"), (params_cpu, "cpu"))]
            diff = sum(int((a != c).sum()) for a, c in zip(*masks))
            flips = (f"; traced prefill of request 0: mask blocks differing "
                     f"cuda/cpu {diff} of {sum(m.size for m in masks[1])}")
        print(f"small serve [{method}]: prefill logits max_abs_err "
              f"{err:.3e}; block density cuda {st_c['block_density']:.4f} "
              f"cpu {st_p['block_density']:.4f}{flips}", flush=True)
        for i in range(len(prompts)):
            verdict = greedy_agree(tok_p[i], log_p[i], tok_c[i], TIE_TOL)
            print(f"  request {i}: cuda {tok_c[i].tolist()} cpu "
                  f"{tok_p[i].tolist()} -> {verdict}", flush=True)


def _to(params, dev):
    if isinstance(params, dict):
        return {k: _to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, dev) for v in params]
    return params.to(dev)


def serve_full(model, params, prompts, need: dict,
               attn_impl: str = "auto", method: str = "share",
               sp=None) -> dict:
    """Phases 4, 8, 11 and 17: the main path at full width (under ``sp``,
    by default the model's trivial clustering), launch counts reset just
    before it and read just after; fails unless each kernel in ``need``
    launched at least that often."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    probe = LogitProbe(model)
    eng = ServingEngine(probe, params, sp or model.default_share_prefill(),
                        EngineConfig(method=method, attn_impl=attn_impl,
                                     decode_sparse=True, max_batch=2,
                                     seq_buckets=(SEQ,)))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    print(f"serve (method={method}, attn_impl={attn_impl}): {len(reqs)} "
          f"requests in "
          f"{wall:.3f} s; launches {counts}", flush=True)
    for r in reqs:
        m = r.metrics()
        print(f"  request {r.uid}: prompt {len(r.prompt)} tokens "
              f"{r.output_tokens.tolist()} prefill_s {m['prefill_s']:.4f} "
              f"ttft_s {m['ttft_s']:.4f} decode_tokens_per_s "
              f"{m['decode_tokens_per_s']:.3f}", flush=True)
    st = reqs[0].pattern_stats
    print("  pattern stats: " + json.dumps(
        {k: st[k] for k in ("num_shared", "num_dense", "num_vs",
                            "block_density", "max_row_pop",
                            "decode_traffic_fraction",
                            "decode_blocks_computed", "decode_blocks_total")
         if k in st}), flush=True)

    vocab = model.cfg.vocab_size
    for r in reqs:
        toks = r.output_tokens
        if len(toks) != NEW_TOKENS or toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"request {r.uid}: tokens {toks} outside "
                                 f"[0, {vocab}) or not {NEW_TOKENS} of them")
    shapes_ok = all(x.shape == (len(reqs), vocab) for x in probe.logits)
    finite = all(bool(torch.isfinite(x).all()) for x in probe.logits)
    print(f"  logits: {len(probe.logits)} steps, shapes ok {shapes_ok}, "
          f"all finite {finite}", flush=True)
    if not (shapes_ok and finite):
        raise AssertionError("non-finite or misshapen logits")
    for name, n in need.items():
        if counts[name] < n:
            raise AssertionError(f"{name}: {counts[name]} launches on the "
                                 f"serve, expected >= {n}")
    return dict(counts=counts, reqs=reqs, logits=probe.logits)


class Spans(LogitProbe):
    """:class:`LogitProbe` marking prefill and decode steps as profiler
    spans."""

    def prefill(self, *args, **kwargs):
        from torch.profiler import record_function
        with record_function("serve.prefill"):
            return super().prefill(*args, **kwargs)

    def decode(self, *args, **kwargs):
        from torch.profiler import record_function
        with record_function("serve.decode_step"):
            return super().decode(*args, **kwargs)


def profile_serve(label: str, serve) -> None:
    """Where a serve's device time goes: ``serve(model_wrapper)`` under
    ``torch.profiler``, device time summed by kernel, with prefill and
    decode steps marked as spans.  A measurement only: the launch counts
    were read before it.  Fails where the profiler traced no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        serve(Spans)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = prof.key_averages()
    on_device = lambda e: str(e.device_type).endswith("CUDA")
    # the spans appear on the device timeline too, as ranges around their
    # kernels: they are not kernels and are reported apart
    is_span = lambda e: e.key.startswith("serve.")
    spans = [e for e in events if is_span(e)]
    kernels = [e for e in events
               if on_device(e) and _device_us(e) > 0 and not is_span(e)]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    if busy_ms == 0:
        raise AssertionError(f"profile {label}: no device time traced")
    groups = {g: [0.0, 0] for g in (*KERNELS, "gemm", "other")}
    for e in kernels:
        g = kernel_group(e.key)
        groups[g][0] += _device_us(e) / 1e3
        groups[g][1] += e.count
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f} %)", flush=True)
    print("  device ms and launches by group: " + json.dumps(
        {k: [round(v[0], 3), v[1]] for k, v in groups.items() if v[1]}),
        flush=True)
    # per span: the host time to enqueue it, the device range from its
    # first kernel's start to its last kernel's end, and the device time of
    # the torch ops inside it (the port's own kernels, launched through
    # ctypes, are attributed to no torch op: add them by name)
    for e in spans:
        if on_device(e):
            print(f"  span {e.key}: {e.count} calls, device range "
                  f"{_device_us(e) / 1e3:.1f} ms", flush=True)
        else:
            inner = getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0))
            print(f"  span {e.key}: {e.count} calls, host "
                  f"{e.cpu_time_total / 1e3:.1f} ms, torch-op kernels "
                  f"{inner / 1e3:.1f} ms", flush=True)
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        print(f"  kernel {_device_us(e) / 1e3:9.3f} ms x{e.count:5d} "
              f"{e.key[:90]}", flush=True)


# ---------------------------------------------------------------- phase 5

def check_paged_decode(model, params, prompts) -> dict:
    """Phase 5: the paged decode kernel against its plain version and
    against the contiguous kernel on the gathered pages; returns its numbers
    for the JSON line (errors over every case, times at bf16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (
        compact_block_mask, expand_kv, flash_decode_sparse_cuda,
        table_block_mask)
    from repro_torch.kernels.decode_attn import (
        DecodePlan, decode_plan_einsum_sliced_paged, decode_splits,
        flash_decode_sparse_paged_cuda, gather_pages, sm_count)
    from repro_torch.models.transformer import decode_valid_mask
    from repro_torch.serving import decode_plan as dplan

    cfg = model.cfg
    sp = model.default_share_prefill()
    ps = sp.cfg.block_size
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    short_len = PAGED_REQUESTS[5][0]           # a ragged short prompt
    nb = (SEQ + ps) // ps                       # the 8192 bucket + one tail
    hkv, h, d = cfg.num_kv_heads, cfg.num_heads, cfg.resolved_head_dim
    g = h // hkv

    # layer 0's K/V and plan rows from two real prefills, each row built at
    # its own allocation (bucket + tail) and padded to the table width
    real = []
    for prompt, bucket in ((prompts[0], SEQ),
                           (prompts[1][:short_len], SHORT)):
        toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        toks[0, :len(prompt)] = torch.as_tensor(prompt, device=dev)
        res = model.prefill(params, toks, sp, method="share",
                            prompt_lens=torch.tensor([len(prompt)],
                                                     device=dev))
        plan = dplan.pad_plan_row(dplan.build_decode_plan(
            sp, res.sp_state, cfg, prefill_len=bucket,
            cache_len=bucket + ps), nb)
        real.append((res.cache[0][0, 0].clone(), res.cache[1][0, 0].clone(),
                     [x[0, 0] for x in plan]))
        del res, plan
    torch.cuda.empty_cache()
    (ka, va, row_a), (kb, vb, row_b) = real

    # slots: 0 the 8192 row; 1 empty; 2 the row padded from the 2048 bucket
    # (17 live blocks, then null pages); 3 the 8192 row with partly false
    # keep bits and the right-pad range [7937, 8192) invalid
    keep3 = row_a[2] & (torch.rand(row_a[2].shape, generator=gen,
                                   device=dev) < 0.7)
    keep3[:, SEQ // ps] = True                  # the decode tail block
    union3 = keep3.any(-1)
    idx3, cnt3 = compact_block_mask(union3)
    keep3 &= union3[..., None]
    empty = (torch.zeros_like(row_a[0]), torch.zeros_like(row_a[1]),
             torch.zeros_like(row_a[2]))
    rows = [row_a, empty, row_b, (idx3, cnt3, keep3)]
    idx, cnt, keep = (torch.stack([r[i] for r in rows]).contiguous()
                      for i in range(3))
    pos = torch.tensor([SEQ + 5, SEQ, SHORT + 7, SEQ + 5], device=dev)
    plens = torch.tensor([SEQ, SEQ, short_len, PROMPT_LENS[1]], device=dev)
    pflens = torch.tensor([SEQ, SEQ, SHORT, SEQ], device=dev)
    valid = decode_valid_mask(nb * ps, pos, plens, pflens).contiguous()

    # a shuffled pool with slack pages; unheld table entries are the null
    # page 0, which (like the slack pages) holds values that must never be
    # read
    held = [nb, 0, SHORT // ps + 1, nb]
    num_pages = 1 + sum(held) + 4
    perm = (1 + torch.randperm(num_pages - 1, generator=gen, device=dev)
            ).to(torch.int32)
    table = torch.zeros((4, nb), dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(held):
        table[b, :n] = perm[at: at + n]
        at += n
    print(f"paged decode shapes: B=4 H={h} Hkv={hkv} D={d} ps={ps} NB={nb} "
          f"P={num_pages}, table rows hold {held} pages", flush=True)

    res = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        # garbage everywhere, then the prompts' pages; the decode tail
        # pages keep their garbage as the appended tokens' K/V, at the
        # scale of the model's own (|out| < 2, where the bf16 tolerance is
        # one ulp)
        pool_k = (torch.randn((num_pages, hkv, ps, d), generator=gen,
                              device=dev) * 0.5).to(dtype)
        pool_v = (torch.randn((num_pages, hkv, ps, d), generator=gen,
                              device=dev) * 0.5).to(dtype)
        for b, (k, v) in ((0, (ka, va)), (2, (kb, vb)), (3, (ka, va))):
            n = k.shape[1] // ps                # prompt pages; the tail
            pages = table[b, :n].long()         # page keeps its garbage
            for pool, x in ((pool_k, k), (pool_v, v)):
                pool[pages] = x.reshape(hkv, n, ps, d).transpose(0, 1).to(
                    dtype)
        q = torch.randn((4, h, d), generator=gen, device=dev).to(dtype)
        print(f"[{dn}]", flush=True)
        out = flash_decode_sparse_paged_cuda(q, pool_k, pool_v, table, idx,
                                             cnt, keep, valid)
        ref = decode_plan_einsum_sliced_paged(
            q, pool_k, pool_v, table, DecodePlan(idx, cnt, keep), valid)
        gk, gv = gather_pages(pool_k, table), gather_pages(pool_v, table)
        contiguous = flash_decode_sparse_cuda(q, gk, gv, idx, cnt, keep,
                                              valid)
        torch.cuda.synchronize()
        zeros = bool((out[1] == 0).all())
        bitwise = max_err(out, contiguous)
        print(f"  decode_attn_paged: empty slot exact zeros {zeros}; "
              f"max |paged - contiguous kernel on gathered pages| "
              f"{bitwise:.3e}; live blocks per slot "
              f"{cnt.float().mean(1).tolist()}", flush=True)
        if not zeros:
            raise AssertionError("empty paged decode slot is not zeros")
        if bitwise != 0.0:
            raise AssertionError("paged kernel differs from the contiguous "
                                 "kernel on the gathered pages")
        e = max_err(out, ref)
        check("  out", e, TOL[("out", dn)])
        res["max_abs_err"] = max(res["max_abs_err"], e)
        if dtype != torch.bfloat16:
            continue
        elt = q.element_size()
        # bytes: q, out, the listed pages' K and V, the tables, keep bits,
        # validity and the page table; products over the kept, valid keys
        ntok = valid.reshape(4, 1, nb, ps).sum(-1)
        listed = table_block_mask(idx, cnt, nb)
        kept_tok = float(((keep & listed[..., None]).float()
                          * ntok[..., None]).sum())
        pb = bound(2 * 4 * h * d * elt + 2 * float(cnt.sum()) * ps * d * elt
                   + (idx.numel() + cnt.numel() + table.numel()) * 4
                   + keep.numel() + valid.numel(), 4.0 * d * kept_tok, dtype)
        # yardstick: SDPA on the gathered cache expanded to 32 heads under
        # the keep ∧ valid token mask
        gkx, gvx = expand_kv(gk, gv, h)
        dmask = (keep.movedim(-1, 2).repeat_interleave(ps, -1)
                 .reshape(4, h, 1, nb * ps) & valid[:, None, None, :])
        lib = library_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], gkx, gvx, attn_mask=dmask), 50)
        res.update(
            ms=cuda_ms(lambda: flash_decode_sparse_paged_cuda(
                q, pool_k, pool_v, table, idx, cnt, keep, valid), 50),
            plain_ms=cuda_ms(lambda: decode_plan_einsum_sliced_paged(
                q, pool_k, pool_v, table, DecodePlan(idx, cnt, keep),
                valid), 10),
            contiguous_ms=cuda_ms(lambda: flash_decode_sparse_cuda(
                q, gk, gv, idx, cnt, keep, valid), 50),
            bound_ms=pb[0], bound_by=pb[1], library_ms=lib,
            device_ms=device_ms(lambda: flash_decode_sparse_paged_cuda(
                q, pool_k, pool_v, table, idx, cnt, keep, valid), 20),
            splits=decode_splits(4, hkv, keep.shape[2], sm_count(dev)))
        print(f"  decode_attn_paged bf16: {res['ms']:.4f} ms (contiguous "
              f"kernel on the gathered pages {res['contiguous_ms']:.4f}, "
              f"plain {res['plain_ms']:.4f}, bound {res['bound_ms']:.5f} "
              f"by {res['bound_by']}, bound_frac "
              f"{res['bound_ms'] / res['ms']:.4f}, library "
              f"{res['library_ms']}, {res['splits']} splits x {4 * hkv} "
              f"rows, device {res['device_ms']} ms a call)", flush=True)
    return res


# ---------------------------------------------------------------- phase 6

class PrefillProbe(LogitProbe):
    """:class:`LogitProbe` that also keeps each request's first-token
    logits, keyed by (prompt length, first token)."""

    def __init__(self, model):
        super().__init__(model)
        self.first = {}
        self.segments = {}      # key → prompts in its chunked run
        self.packed = []        # (seq, prompts, logits) of each packed run

    def prefill(self, params, tokens, sp, **kwargs):
        result = super().prefill(params, tokens, sp, **kwargs)
        key = (int(kwargs["prompt_lens"][0]), int(tokens[0, 0]))
        self.first[key] = result.last_logits[0].float()
        return result


def scheduler_serve(model, params, prompts, news, faults=None,
                    fields=None, **ecfg) -> dict:
    """One serve of the phase-6 requests through the slot scheduler,
    launch counts reset just before and read just after; every paged
    serve's allocator is kept for its audit.  ``faults`` is the serve's
    fault injector, ``fields`` sets request fields ``{index: {name:
    value}}``."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                     SlotScheduler)

    probe = PrefillProbe(model)
    base = dict(max_batch=4, method="share", decode_sparse=True,
                seq_buckets=(SHORT, SEQ))
    eng = ServingEngine(probe, params, model.default_share_prefill(),
                        EngineConfig(**{**base, **ecfg}))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, news))]
    for i, f in (fields or {}).items():
        for name, value in f.items():
            setattr(reqs[i], name, value)
    allocs = []
    summary = SlotScheduler._pool_summary
    complete = SlotScheduler._complete_run

    def audited(self):
        summary(self)
        if self.paged:
            allocs.append(self.alloc)

    def completed(self, run):
        # a chunked run's first-token logits, keyed as the probe keys a
        # one-shot prefill's
        for j, plen in enumerate(run.plens):
            key = (int(plen), int(run.tokens[0, j * run.seq]))
            probe.first[key] = run.logits[j].float()
            probe.segments[key] = run.P
        if run.P > 1:
            probe.packed.append((run.seq, [r.prompt for r in run.requests],
                                 run.logits.float()))
        complete(self, run)

    SlotScheduler._pool_summary = audited
    SlotScheduler._complete_run = completed
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.time()
        eng.serve(reqs, faults=faults)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
    finally:
        SlotScheduler._pool_summary = summary
        SlotScheduler._complete_run = complete
    return dict(eng=eng, reqs=reqs, probe=probe, counts=counts, wall=wall,
                allocs=allocs)


def report_scheduler_serve(label: str, run: dict) -> int:
    """Print a scheduler serve's per-request metrics, phase clocks and
    pool; returns its decode steps."""
    eng, reqs = run["eng"], run["reqs"]
    steps = eng.slot_steps // eng.ecfg.max_batch
    print(f"{label}: {len(reqs)} requests in {run['wall']:.3f} s, "
          f"{steps} decode steps; launches {run['counts']}", flush=True)
    for r in reqs:
        m = r.metrics()
        bucket = eng._bucket(len(r.prompt))
        print(f"  request {r.uid}: prompt {len(r.prompt)} bucket {bucket} "
              f"{r.finish_reason} {len(r.output_tokens)} tokens queue_s "
              f"{m['queue_s']:.4f} ttft_s {m['ttft_s']:.4f} prefill_s "
              f"{m['prefill_s']:.4f} prefill_stall_s "
              f"{m['prefill_stall_s']:.4f} decode_tokens_per_s "
              f"{m['decode_tokens_per_s']:.3f} plan_traffic_fraction "
              f"{m['plan_traffic_fraction']:.4f} waiting_deferred_steps "
              f"{m['waiting_deferred_steps']}", flush=True)
    print(f"  slot_occupancy {eng.slot_occupancy():.4f}; phase_s "
          + json.dumps({k: round(v, 4) for k, v in eng.phase_s.items()})
          + f"; decode step {1e3 * eng.phase_s['decode'] / max(steps, 1):.2f}"
          f" ms (mean over 4 slots); pages_exhausted_steps "
          f"{eng.pages_exhausted_steps}; pool "
          f"{json.dumps(eng.page_pool_stats)}", flush=True)
    return steps


def check_paged_run(run: dict, what: str) -> None:
    """Every request finished whole, logits finite, no page leaked and
    each allocator consistent."""
    import torch
    for r in run["reqs"]:
        if r.finish_reason not in ("length", "stop") or (
                r.finish_reason == "length"
                and len(r.output_tokens) != r.max_new_tokens):
            raise AssertionError(f"{what}: request {r.uid}: "
                                 f"{r.finish_reason} with "
                                 f"{len(r.output_tokens)} tokens")
    finite = all(bool(torch.isfinite(x).all()) for x in run["probe"].logits)
    finite &= all(bool(torch.isfinite(x).all())
                  for x in run["probe"].first.values())
    print(f"  logits: {len(run['probe'].logits)} calls, all finite {finite}",
          flush=True)
    if not finite:
        raise AssertionError(f"non-finite logits in the {what}")
    pool = run["eng"].page_pool_stats
    if pool["pages_in_use_at_end"] != 0:
        raise AssertionError(f"{what}: pages leaked: {pool}")
    for alloc in run["allocs"]:
        alloc.check_consistency()


def serve_paged(model, params, prompts, layers: int) -> dict:
    """Phase 6: the continuous-batching serve on the paged pool, checked,
    then the same requests through the contiguous scheduler.  Returns the
    paged serve."""
    import torch

    news = [m for _, m in PAGED_REQUESTS]
    run = scheduler_serve(model, params, prompts, news, paged=True,
                          num_pages=NUM_PAGES)
    eng, reqs, counts = run["eng"], run["reqs"], run["counts"]
    steps = report_scheduler_serve("paged serve", run)
    check_paged_run(run, "paged serve")
    if eng.pages_exhausted_steps < 1:
        raise AssertionError("no admission waited on pool headroom")
    need = {"strip": layers * len(reqs),
            "block_sparse_attn": layers * len(reqs),
            "decode_attn_paged": layers * steps}
    for name, n in need.items():
        if counts[name] < n:
            raise AssertionError(f"{name}: {counts[name]} launches on the "
                                 f"paged serve, expected >= {n}")
    if counts["decode_attn"]:
        raise AssertionError("the paged serve launched the contiguous "
                             "decode kernel")

    contig = scheduler_serve(model, params, prompts, news, scheduler=True)
    print(f"contiguous scheduler serve: {contig['wall']:.3f} s; launches "
          f"{contig['counts']}", flush=True)
    if contig["counts"]["decode_attn"] < layers or \
            contig["counts"]["decode_attn_paged"]:
        raise AssertionError("the contiguous serve did not run the "
                             "contiguous decode kernel alone")
    first = run["probe"].first
    err = max(max_err(first[k], contig["probe"].first[k]) for k in first)
    print(f"  first-step logits max_abs_err paged vs contiguous {err:.3e}",
          flush=True)
    for a, b in zip(reqs, contig["reqs"]):
        ref, got = a.output_tokens, b.output_tokens
        verdict = "identical"
        if ref.tolist() != got.tolist():
            # margins of the paged stream: the request served alone
            solo = scheduler_serve(model, params, [a.prompt],
                                   [a.max_new_tokens], paged=True,
                                   num_pages=NUM_PAGES)
            logits = torch.stack([x[0] for x in solo["probe"].logits])
            verdict = greedy_agree(ref, logits.cpu().numpy(), got, TIE_TOL)
        print(f"  request {a.uid}: {verdict}", flush=True)
    return run


# ---------------------------------------------------------------- phase 7

API_OFFSET = 48          # phase 7's paged chunk: q blocks [48, 64) of 65


def check_kernel_api(model, params, tokens, prompt) -> dict:
    """Phase 7: the kernel API slice's four kernels against their plain
    versions in bfloat16 and float32 at the main path's shapes, timed
    beside their bounds and library calls; then one call of each public
    function that no serving path reaches (the paged block-sparse kernel
    and both single-sample decodes), launch counts reset just before and
    read just after.  Returns the four kernels' numbers for the JSON line
    and that run's launch counts."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.kernels.decode_attn import gather_pages
    from repro_torch.models.transformer import decode_valid_mask
    from repro_torch.serving import decode_plan as dplan

    cfg = model.cfg
    sp = model.default_share_prefill()
    bs = cfg.share_prefill.block_size
    dev = tokens.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    q16, k16, v16 = layer0_qkv(model, params, tokens)
    masks, decision = real_masks(model, q16, k16, v16)
    b, h, n, d = q16.shape
    hkv = k16.shape[1]
    g, nb = h // hkv, n // bs

    # B.6: sample 0's tables at full width, and edge rows: counts == 0, a
    # row listing a block above the diagonal first, and a W cap
    sidx, scnt = (x.contiguous() for x in K.compact_block_mask(masks[0]))
    eidx, ecnt = sidx.clone(), scnt.clone()
    ecnt[1, nb // 2] = 0
    eidx[0, 1, :3] = torch.tensor([2, 0, 1], device=dev)
    eidx[0, 1, 3:] = 1
    ecnt[0, 1] = 3
    cidx, ccnt = (x.contiguous()
                  for x in K.compact_block_mask(masks[0], width=nb // 4))
    single_cases = [("real masks", sidx, scnt), ("edge rows", eidx, ecnt),
                    (f"W cap {nb // 4}", cidx, ccnt)]

    # B.5: a 16-block chunk at q block 48 of a 65-block logical cache (the
    # last block a decode tail that no row may list) over a shuffled pool;
    # the tail's table entry is the null page 0, which, like the slack
    # pages, holds random values that must never be read
    nbq, nbkv = nb - API_OFFSET, nb + 1
    chunk = masks[:, :, API_OFFSET:, :]
    chunk = torch.cat([chunk, torch.zeros_like(chunk[..., :1])], dim=-1)
    chunk[0, 3, 2] = False                          # a counts == 0 row
    pidx, pcnt = (x.contiguous() for x in K.compact_block_mask(chunk))
    pgate = decision.use_dense ^ (torch.arange(h, device=dev) % 3 == 0)
    num_pages = 1 + b * nb + 4
    perm = (1 + torch.randperm(num_pages - 1, generator=gen, device=dev)
            ).to(torch.int32)
    table = torch.zeros((b, nbkv), dtype=torch.int32, device=dev)
    table[:, :nb] = perm[:b * nb].reshape(b, nb)

    # B.7 / B.8: a real plan's keep bits ∧ validity of sample 0 as a token
    # mask over an 8320-token cache (the prompt plus a 128-token decode
    # tail, 6 tokens of it written), and one all-false head
    res = model.prefill(params, tokens[:1], sp, method="share",
                        prompt_lens=torch.tensor([len(prompt)], device=dev))
    plan = dplan.build_decode_plan(sp, res.sp_state, cfg, prefill_len=n,
                                   cache_len=n + bs).layer(0)
    s = n + bs
    pos = n + 5
    valid = decode_valid_mask(s, pos, torch.tensor([len(prompt)],
                                                   device=dev), n)[0]
    keep = plan.keep_heads[0].permute(0, 2, 1).reshape(h, nbkv)
    tok_mask = keep.repeat_interleave(bs, dim=1) & valid[None]
    dead = 5
    tok_mask[dead] = False
    tok_mask = tok_mask.contiguous()
    ck0, cv0 = res.cache[0][0, 0].clone(), res.cache[1][0, 0].clone()
    del res
    tail = [torch.randn((hkv, bs, d), generator=gen, device=dev) * 0.5
            for _ in range(2)]
    print(f"kernel API shapes: single H={h} Hkv={hkv} N={n} D={d} bs={bs} "
          f"W={nb}; paged B={b} NBq={nbq} at q block {API_OFFSET}, "
          f"NBkv={nbkv}, P={num_pages}; decode S={s}, kept tokens per head "
          f"{float(tok_mask.float().sum(1).mean()):.1f} of {s}, union "
          f"blocks per kv head "
          f"{K.decode_block_table(tok_mask, hkv, bs)[1].tolist()}",
          flush=True)

    names = ("block_sparse_attn_single", "block_sparse_attn_paged",
             "decode_attn_dense", "decode_attn_sparse")
    out = {name: {"max_abs_err": 0.0} for name in names}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q, k, v = (x.to(dtype) for x in (q16, k16, v16))
        print(f"[{dn}]", flush=True)

        # ---- B.6
        for label, idx, cnt in single_cases:
            o1, s1 = K.block_sparse_attention_single_cuda(
                q[0], k[0], v[0], idx, cnt, block_size=bs)
            o2, s2 = K.block_sparse_attention_single_plain(
                q[0], k[0], v[0], idx, cnt, block_size=bs)
            edge = ""
            if idx is eidx:
                zero = bool((o1[1, (nb // 2) * bs:(nb // 2 + 1) * bs] == 0)
                            .all())
                above = bool(torch.isneginf(s1[0, 1, 0]))
                edge = (f", counts==0 row exact zeros {zero}, block above "
                        f"the diagonal -inf {above}")
                if not (zero and above):
                    raise AssertionError("single-sample edge rows wrong")
            print(f"  block_sparse_attn_single [{label}]: W="
                  f"{idx.shape[-1]}{edge}", flush=True)
            e = max_err(o1, o2)
            check("  out", e, TOL[("out", dn)])
            check("  stats", a_tilde_err(s1, s2), TOL[("a_tilde", dn)])
            r = out["block_sparse_attn_single"]
            r["max_abs_err"] = max(r["max_abs_err"], e)

        # ---- B.5
        qc = q[:, :, API_OFFSET * bs:].contiguous()
        pool_k = (torch.randn((num_pages, hkv, bs, d), generator=gen,
                              device=dev) * 0.5).to(dtype)
        pool_v = (torch.randn((num_pages, hkv, bs, d), generator=gen,
                              device=dev) * 0.5).to(dtype)
        for pool, x in ((pool_k, k), (pool_v, v)):
            pool[table[:, :nb].reshape(-1).long()] = x.reshape(
                b, hkv, nb, bs, d).transpose(1, 2).reshape(-1, hkv, bs, d)
        kw = dict(block_size=bs, stats_gate=pgate, q_block_offset=API_OFFSET)
        o1, a1 = K.block_sparse_attention_paged_cuda(
            qc, pool_k, pool_v, table, pidx, pcnt, **kw)
        o2, a2 = K.block_sparse_attention_paged_plain(
            qc, pool_k, pool_v, table, pidx, pcnt, **kw)
        gk, gv = gather_pages(pool_k, table), gather_pages(pool_v, table)
        o3, a3 = K.block_sparse_attention_cuda(qc, gk, gv, pidx, pcnt, **kw)
        torch.cuda.synchronize()
        bitwise = max(max_err(o1, o3), a_tilde_err(a1, a3))
        zero = bool((o1[0, 3, 2 * bs:3 * bs] == 0).all())
        # the batched launch at bs = 128, D = 128 in bf16 is the Hopper
        # body, which rounds otherwise than the paged instance's body
        hopper = (str(dtype), bs, d, d) == HOPPER_CASE
        print(f"  block_sparse_attn_paged: counts==0 row exact zeros {zero};"
              f" max |paged - kernel 2 on gathered pages| {bitwise:.3e}"
              f"{' (the Hopper body)' if hopper else ''}", flush=True)
        if not zero:
            raise AssertionError("paged counts == 0 row is not zeros")
        if hopper:
            check("  out against the Hopper body", max_err(o1, o3),
                  TOL[("out", dn)])
            check("  a_tilde against the Hopper body", a_tilde_err(a1, a3),
                  TOL[("a_tilde", dn)])
        elif bitwise != 0.0:
            raise AssertionError("paged block-sparse kernel differs from "
                                 "the contiguous kernel on gathered pages")
        e = max_err(o1, o2)
        check("  out", e, TOL[("out", dn)])
        check("  a_tilde", a_tilde_err(a1, a2), TOL[("a_tilde", dn)])
        r = out["block_sparse_attn_paged"]
        r["max_abs_err"] = max(r["max_abs_err"], e)

        # ---- B.7 / B.8
        ck = torch.cat([ck0.to(dtype), tail[0].to(dtype)], dim=1)
        cv = torch.cat([cv0.to(dtype), tail[1].to(dtype)], dim=1)
        qd = (torch.randn((h, d), generator=gen, device=dev)).to(dtype)
        for name, cuda_fn, plain_fn in (
                ("decode_attn_dense", K.flash_decode_cuda,
                 K.flash_decode_plain),
                ("decode_attn_sparse", K.flash_decode_sparse_single_cuda,
                 K.flash_decode_sparse_plain)):
            o1 = cuda_fn(qd, ck, cv, tok_mask, block_kv=bs)
            o2 = plain_fn(qd, ck, cv, tok_mask, block_kv=bs)
            zero = bool((o1[dead] == 0).all())
            print(f"  {name}: all-false head exact zeros {zero}", flush=True)
            if not zero:
                raise AssertionError(f"{name}: all-false head not zeros")
            e = max_err(o1, o2)
            check("  out", e, TOL[("out", dn)])
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)

        if dtype != torch.bfloat16:
            continue
        # ---- times at the main path's dtype, with bounds and library calls
        elt = q.element_size()
        # B.6: q, out, the visited K/V tiles, tables and stats moved once;
        # QK and PV products over the causally valid entries visited
        vis = K.table_block_mask(sidx, scnt, nb)[None]
        entries, tiles = bsa_work(vis, g, bs, 0)
        sb = bound(2 * h * n * d * elt + 2 * tiles * bs * d * elt
                   + sidx.numel() * 4 + scnt.numel() * 4      # tables
                   + sidx.numel() * 4, 4.0 * d * entries,     # stats
                   dtype)
        kx, vx = K.expand_kv(k[:1], v[:1], h)
        tmask = (vis.repeat_interleave(bs, 2).repeat_interleave(bs, 3)
                 & torch.ones(n, n, dtype=torch.bool, device=dev).tril())
        lib = library_ms(lambda: F.scaled_dot_product_attention(
            q[:1], kx, vx, attn_mask=tmask), 5)
        del kx, vx, tmask
        out["block_sparse_attn_single"].update(
            ms=cuda_ms(lambda: K.block_sparse_attention_single_cuda(
                q[0], k[0], v[0], sidx, scnt, block_size=bs), 10),
            device_ms=device_ms(lambda: K.block_sparse_attention_single_cuda(
                q[0], k[0], v[0], sidx, scnt, block_size=bs), 10),
            plain_ms=cuda_ms(lambda: K.block_sparse_attention_single_plain(
                q[0], k[0], v[0], sidx, scnt, block_size=bs), 2),
            bound_ms=sb[0], bound_by=sb[1], library_ms=lib)

        # B.5: the same count at the chunk's offset, plus the page table
        # and Ã
        vis = K.table_block_mask(pidx, pcnt, nbkv)
        entries, tiles = bsa_work(vis, g, bs, API_OFFSET)
        pb = bound(2 * qc.numel() * elt + 2 * tiles * bs * d * elt
                   + pidx.numel() * 4 + pcnt.numel() * 4 + table.numel() * 4
                   + vis.numel() * 4, 4.0 * d * entries, dtype)
        gkx, gvx = K.expand_kv(gk, gv, h)
        qpos = API_OFFSET * bs + torch.arange(nbq * bs, device=dev)
        tmask = (vis.repeat_interleave(bs, 2).repeat_interleave(bs, 3)
                 & (torch.arange(nbkv * bs, device=dev)[None, :]
                    <= qpos[:, None]))
        lib = library_ms(lambda: F.scaled_dot_product_attention(
            qc, gkx, gvx, attn_mask=tmask), 5)
        del gkx, gvx, tmask
        out["block_sparse_attn_paged"].update(
            ms=cuda_ms(lambda: K.block_sparse_attention_paged_cuda(
                qc, pool_k, pool_v, table, pidx, pcnt, **kw), 10),
            device_ms=device_ms(lambda: K.block_sparse_attention_paged_cuda(
                qc, pool_k, pool_v, table, pidx, pcnt, **kw), 10),
            plain_ms=cuda_ms(lambda: K.block_sparse_attention_paged_plain(
                qc, pool_k, pool_v, table, pidx, pcnt, **kw), 2),
            contiguous_ms=cuda_ms(lambda: K.block_sparse_attention_cuda(
                qc, gk, gv, pidx, pcnt, **kw), 10),
            bound_ms=pb[0], bound_by=pb[1], library_ms=lib)

        # B.7 / B.8 compute one function: q, out, the mask, and the K/V rows
        # of tokens that some head of the group keeps, moved once; QK and
        # PV products over the kept tokens
        rows = float(tok_mask.reshape(hkv, g, s).any(1).sum())
        db = bound(2 * h * d * elt + 2 * rows * d * elt + tok_mask.numel(),
                   4.0 * d * float(tok_mask.sum()), dtype)
        ckx, cvx = K.expand_kv(ck, cv, h)
        lib = library_ms(lambda: F.scaled_dot_product_attention(
            qd[:, None], ckx, cvx, attn_mask=tok_mask[:, None]), 50)
        # the sparse wrapper's time includes staging its union table
        out["decode_attn_sparse"]["staging_ms"] = cuda_ms(
            lambda: K.decode_block_table(tok_mask, hkv, bs), 50)
        for name, cuda_fn, plain_fn in (
                ("decode_attn_dense", K.flash_decode_cuda,
                 K.flash_decode_plain),
                ("decode_attn_sparse", K.flash_decode_sparse_single_cuda,
                 K.flash_decode_sparse_plain)):
            out[name].update(
                ms=cuda_ms(lambda: cuda_fn(qd, ck, cv, tok_mask,
                                           block_kv=bs), 50),
                device_ms=device_ms(lambda: cuda_fn(qd, ck, cv, tok_mask,
                                                    block_kv=bs), 20),
                plain_ms=cuda_ms(lambda: plain_fn(qd, ck, cv, tok_mask,
                                                  block_kv=bs), 10),
                bound_ms=db[0], bound_by=db[1], library_ms=lib)
        for name, r in out.items():
            extra = (f", contiguous kernel on the gathered pages "
                     f"{r['contiguous_ms']:.4f}" if "contiguous_ms" in r
                     else f", of which table staging {r['staging_ms']:.4f}"
                     if "staging_ms" in r else "")
            if "device_ms" in r:
                extra += f", device {r['device_ms']} ms a call"
            print(f"  {name} bf16: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} by "
                  f"{r['bound_by']}, bound_frac "
                  f"{r['bound_ms'] / r['ms']:.4f}, library "
                  f"{r['library_ms']}{extra})", flush=True)

        # ---- the public functions no serving path reaches, once each
        torch.cuda.synchronize()
        K.reset_launch_counts()
        api = {
            "block_sparse_attn_paged": K.block_sparse_attention_batched_paged(
                qc, pool_k, pool_v, table, pidx, pcnt, **kw)[0],
            "decode_attn_dense": K.flash_decode(qd, ck, cv, tok_mask,
                                                block_kv=bs),
            "decode_attn_sparse": K.flash_decode_sparse(qd, ck, cv, tok_mask,
                                                        block_kv=bs),
        }
        torch.cuda.synchronize()
        counts = K.launch_counts()
        print(f"kernel API calls: launches {counts}", flush=True)
        want = {name: int(name in api) for name in counts}
        if counts != want:
            raise AssertionError(f"kernel API calls launched {counts}, "
                                 f"expected {want}")
        same = (torch.equal(api["block_sparse_attn_paged"],
                            K.block_sparse_attention_paged_cuda(
                                qc, pool_k, pool_v, table, pidx, pcnt,
                                **kw)[0])
                and torch.equal(api["decode_attn_dense"],
                                K.flash_decode_cuda(qd, ck, cv, tok_mask,
                                                    block_kv=bs))
                and torch.equal(api["decode_attn_sparse"],
                                K.flash_decode_sparse_single_cuda(
                                    qd, ck, cv, tok_mask, block_kv=bs)))
        if not same:
            raise AssertionError("a public function's result differs from "
                                 "its checked kernel's on the same inputs")
    return out, counts


def check_group12(dev) -> dict:
    """Phase 7, C.2: the four decode kernels at mistral-large's G = 12
    (H = 96 over Hkv = 8, D = 128) against their plain versions in
    bfloat16 and float32, on random inputs at a 65-block cache of
    128-token blocks: B.3 over 2 slots (an empty one, partly false keep
    bits, a right-pad range), B.4 on the same plan through a shuffled
    pool (also bitwise B.3 on the gathered pages), B.7 and B.8 on a token
    mask with an all-false head; then B.3's device time at G = 12 against
    G = 8 on the same K/V and tables (G = 8 keeps the first 8 heads of
    each group).  Returns each kernel's largest error."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.decode_attn import (
        DecodePlan, decode_plan_einsum_sliced_paged, gather_pages)

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, hkv, g, d, bs, nb = 2, 8, 12, 128, 128, 65
    h, s = hkv * g, nb * bs
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    keep = torch.rand((b, hkv, nb, g), generator=gen, device=dev) < 0.6
    keep[..., -1, :] = True
    union = keep.any(-1)
    union[1, 5] = False                         # an empty (b, kv head) row
    keep &= union[..., None]
    idx, cnt = (x.contiguous() for x in K.compact_block_mask(union))
    keep = keep.contiguous()
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    valid[1, 7937:8192] = False                 # right-pad
    valid[:, 8192 + 6:] = False                 # past the decode position
    plan = DecodePlan(idx, cnt, keep)
    num_pages = 1 + b * nb + 4
    perm = (1 + torch.randperm(num_pages - 1, generator=gen, device=dev)
            ).to(torch.int32)
    table = perm[:b * nb].reshape(b, nb).contiguous()
    tok_mask = (keep[0].movedim(-1, 1).reshape(h, nb)
                .repeat_interleave(bs, 1) & valid[0]).contiguous()
    tok_mask[7] = False                         # an all-false head
    print(f"G=12 decode shapes: B={b} H={h} Hkv={hkv} D={d} bs={bs} "
          f"NB={nb}, live blocks per row {cnt.float().mean():.1f}",
          flush=True)
    out = {name: 0.0 for name in ("decode_attn", "decode_attn_paged",
                                  "decode_attn_dense", "decode_attn_sparse")}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q = (rnd(b, h, d)).to(dtype)
        ck, cv = ((rnd(b, hkv, s, d) * 0.5).to(dtype) for _ in range(2))
        pool_k, pool_v = ((rnd(num_pages, hkv, bs, d) * 0.5).to(dtype)
                          for _ in range(2))
        for pool, x in ((pool_k, ck), (pool_v, cv)):
            pool[table.reshape(-1).long()] = x.reshape(
                b, hkv, nb, bs, d).transpose(1, 2).reshape(-1, hkv, bs, d)
        print(f"[{dn}]", flush=True)
        o3 = K.flash_decode_sparse_cuda(q, ck, cv, idx, cnt, keep, valid)
        p3 = K.decode_plan_einsum_sliced(q, ck, cv, plan, valid)
        o4 = K.flash_decode_sparse_paged_cuda(q, pool_k, pool_v, table, idx,
                                              cnt, keep, valid)
        p4 = decode_plan_einsum_sliced_paged(q, pool_k, pool_v, table, plan,
                                             valid)
        og = K.flash_decode_sparse_cuda(q, gather_pages(pool_k, table),
                                        gather_pages(pool_v, table), idx,
                                        cnt, keep, valid)
        torch.cuda.synchronize()
        zeros = bool((o3[1, 5 * g:6 * g] == 0).all())
        bitwise = max_err(o4, og)
        print(f"  decode_attn / decode_attn_paged: empty row exact zeros "
              f"{zeros}; max |paged - contiguous kernel on gathered pages| "
              f"{bitwise:.3e}", flush=True)
        if not zeros or bitwise != 0.0:
            raise AssertionError("G=12 decode: empty row not zeros, or the "
                                 "paged kernel differs from the contiguous "
                                 "one on gathered pages")
        for name, got, ref in (("decode_attn", o3, p3),
                               ("decode_attn_paged", o4, p4)):
            e = max_err(got, ref)
            check(f"  {name} out", e, TOL[("out", dn)])
            out[name] = max(out[name], e)
        for name, cuda_fn, plain_fn in (
                ("decode_attn_dense", K.flash_decode_cuda,
                 K.flash_decode_plain),
                ("decode_attn_sparse", K.flash_decode_sparse_single_cuda,
                 K.flash_decode_sparse_plain)):
            o1 = cuda_fn(q[0], ck[0], cv[0], tok_mask, block_kv=bs)
            o2 = plain_fn(q[0], ck[0], cv[0], tok_mask, block_kv=bs)
            if not bool((o1[7] == 0).all()):
                raise AssertionError(f"{name}: all-false head not zeros")
            e = max_err(o1, o2)
            check(f"  {name} out", e, TOL[("out", dn)])
            out[name] = max(out[name], e)
        if dtype != torch.bfloat16:
            continue
        # device time at G = 12 against G = 8: the same K/V bytes and
        # tables, 2/3 of the query heads
        q8 = q.reshape(b, hkv, g, d)[:, :, :8].reshape(b, hkv * 8, d)
        q8 = q8.contiguous()
        keep8 = keep[..., :8].contiguous()
        t12 = device_ms(lambda: K.flash_decode_sparse_cuda(
            q, ck, cv, idx, cnt, keep, valid), 20)
        t8 = device_ms(lambda: K.flash_decode_sparse_cuda(
            q8, ck, cv, idx, cnt, keep8, valid), 20)
        ratio = t12 / t8 if t12 and t8 else None
        print(f"  decode_attn bf16 device ms a call: G=12 {t12}, G=8 {t8}, "
              f"ratio {ratio}", flush=True)
        out["g12_device_ms"], out["g8_device_ms"] = t12, t8
    return out


# ---------------------------------------------------------------- phase 8

# first-step logits of the per-sample serve against its batched twin's,
# both under phase 4's masks and pattern decisions and both attending
# through B.6: at most this share of the largest |logit| (2.5 bf16 ulps;
# both round alike per (head, row)), which is also the near-tie margin of
# the greedy comparison
PER_SAMPLE_RTOL = 1e-2


@contextlib.contextmanager
def record_share_masks():
    """Within it, each call of ``build_share_masks`` (one a layer on the
    batched path) appends its ``(masks, decision)`` to the list it
    yields."""
    from repro_torch.core import share_attention as sa
    calls, build = [], sa.build_share_masks

    def recording(*args, **kwargs):
        masks, decision = build(*args, **kwargs)
        calls.append((masks.clone(),
                      type(decision)(*(x.clone() for x in decision))))
        return masks, decision

    sa.build_share_masks = recording
    try:
        yield calls
    finally:
        sa.build_share_masks = build


@contextlib.contextmanager
def replay_share_masks(calls: list):
    """Within it, ``build_share_masks`` runs as always (its strip launch
    counts) and returns the recorded ``(masks, decision)`` of ``calls``
    (:func:`record_share_masks`) in its place, layer by layer: a call of b
    samples takes the next b of the layer's.  Yields a ``(layers,
    samples)`` count of the heads whose own decision differs from the
    recorded one."""
    import torch
    from repro_torch.core import share_attention as sa
    build = sa.build_share_masks
    flips = torch.zeros((len(calls), calls[0][0].shape[0]), dtype=torch.int64)
    cursor = [0, 0]                 # layer, first sample of the next call

    def replaying(*args, **kwargs):
        masks, mine = build(*args, **kwargs)
        layer, s0 = cursor
        rec_masks, rec = calls[layer]
        part = slice(s0, s0 + masks.shape[0])
        if rec_masks[part].shape != masks.shape:
            raise AssertionError(f"layer {layer}: masks {tuple(masks.shape)}"
                                 f" against recorded {tuple(rec_masks.shape)}")
        other = ((mine.use_shared != rec.use_shared[part])
                 | (mine.use_dense != rec.use_dense[part])
                 | (mine.use_vs != rec.use_vs[part]))
        flips[layer, part] += other.sum(-1).cpu()
        cursor[:] = ((layer + 1, 0) if part.stop == rec_masks.shape[0]
                     else (layer, part.stop))
        return rec_masks[part], type(rec)(*(x[part] for x in rec))

    sa.build_share_masks = replaying
    try:
        yield flips
    finally:
        sa.build_share_masks = build
    if cursor != [len(calls), 0]:
        raise AssertionError(f"replayed up to {cursor} of {len(calls)} "
                             "layers")


@contextlib.contextmanager
def batched_through_single():
    """Within it, B.2's dispatcher on CUDA tensors runs B.6 sample by sample
    and scatters its compact Ã into B.2's layout (−inf off the visited
    blocks and the gated heads): a batch serve that rounds as the
    per-sample path does, head by head and row by row."""
    import torch
    from repro_torch.kernels import block_sparse_attn as bsa
    saved = bsa.block_sparse_attention_cuda

    def through_single(q, k, v, indices, counts, *, block_size: int,
                       causal: bool = True, stats_gate=None,
                       q_block_offset=None):
        b, h, n, _ = q.shape
        nb = n // block_size
        if k.shape[2] != n or q_block_offset not in (None, 0):
            raise ValueError("B.6 takes square one-shot launches only")
        outs = []
        a_tilde = torch.full((b, h, nb, nb), float("-inf"),
                             dtype=torch.float32, device=q.device)
        for i in range(b):
            out, st = bsa.block_sparse_attention_kernel(
                q[i], k[i], v[i], indices[i].contiguous(),
                counts[i].contiguous(), block_size=block_size,
                causal=causal)
            outs.append(out)
            # slots past a row's count read −inf, so amax keeps each
            # visited block's Ã
            a_tilde[i].scatter_reduce_(-1, indices[i].long(), st, "amax")
        if stats_gate is not None:
            a_tilde[stats_gate == 0] = float("-inf")
        return torch.stack(outs), a_tilde

    bsa.block_sparse_attention_cuda = through_single
    try:
        yield
    finally:
        bsa.block_sparse_attention_cuda = saved


def first_logit_errs(run: dict, ref: dict) -> list:
    """Max |difference| of two serves' first-step logits, per request."""
    return (run["logits"][0].float() - ref["logits"][0].float()
            ).abs().amax(-1).tolist()


def serve_per_sample(model, params, prompts, layers: int, batch: dict
                     ) -> dict:
    """Phase 8: phase 4's requests served through the per-sample path
    (``attn_impl="kernel"``): the single-sample kernel and the strip once
    per sample and layer, the batched block-sparse kernel never, decode as
    in phase 4.  At bs = 128, D = 128 in bf16 phase 4's B.2 is the Hopper
    body, whose output and Ã round otherwise than B.6's, and SharePrefill's
    decisions (pivotal patterns, d_sim < τ) are thresholds on Ã, so on its
    own masks the per-sample serve may take a near tie the other way and
    change every later layer's masks.  So it replays phase 4's masks and
    pattern decisions (``batch["share_masks"]``), and so does its batched
    twin: phase 4's batch path with B.2 run by B.6
    (:func:`batched_through_single`), which rounds as the per-sample path
    does.  Held against the twin: first-step logits within
    ``PER_SAMPLE_RTOL``, greedy tokens near-tie aware, and the decisions
    each serve would take on its own Ã, layer by layer and request by
    request; phase 4 itself is compared in print only (its body is held
    to the plain version in phases 2 and 24)."""
    import torch
    with replay_share_masks(batch["share_masks"]) as flips:
        run = serve_full(model, params, prompts,
                         {"block_sparse_attn_single": 2 * layers},
                         attn_impl="kernel")
    counts, ref_counts = run["counts"], batch["counts"]
    want = dict(ref_counts, block_sparse_attn=0,
                block_sparse_attn_single=len(prompts) * layers,
                strip=len(prompts) * layers)
    if counts != want:
        raise AssertionError(f"per-sample serve launched {counts}, "
                             f"expected {want}")
    with batched_through_single(), \
            replay_share_masks(batch["share_masks"]) as twin_flips:
        twin = serve_full(model, params, prompts, {})
    print(f"  own decisions the other way from phase 4's, per request: "
          f"per-sample {flips.sum(0).tolist()}, twin "
          f"{twin_flips.sum(0).tolist()}", flush=True)
    if not torch.equal(flips, twin_flips):
        raise AssertionError("the per-sample serve and its twin decide "
                             "otherwise on their own Ã")
    print("  first-step logits, max_abs_err per request: per-sample against"
          f" phase 4 {first_logit_errs(run, batch)} (not held)", flush=True)
    errs = first_logit_errs(run, twin)
    tol = PER_SAMPLE_RTOL * float(twin["logits"][0].abs().max())
    print(f"  first-step logits, max_abs_err per request: per-sample "
          f"against its twin {errs} (tol {tol:.3e})", flush=True)
    if max(errs) > tol:
        raise AssertionError(f"per-sample: first-step logits differ from "
                             f"the twin's by {max(errs)} > {tol}")
    for i, (a, c) in enumerate(zip(twin["reqs"], run["reqs"])):
        logits = torch.stack([x[i] for x in twin["logits"]]).cpu().numpy()
        verdict = greedy_agree(a.output_tokens, logits, c.output_tokens, tol)
        print(f"  request {a.uid}: {verdict}", flush=True)
    return counts


# ---------------------------------------------------------------- phase 9

CHUNK = 1024        # phase 9's prefill chunk: 8 chunks at 8192, 2 at 2048


def serve_chunked(model, params, prompts, layers: int, oneshot: dict
                  ) -> dict:
    """Phase 9: phase 6's requests, pool and buckets through chunked
    admission (``prefill_chunk=CHUNK``): greedy tokens equal to phase 6's
    one-shot paged serve and first-step logits bitwise equal (every gemm
    runs at the one-shot shapes, and a chunk launch's rows are the full
    launch's); then packed (``prefill_pack=2``): a request that ran alone
    is held to phase 6 the same way, each packed run of the serve bitwise
    to a one-shot prefill of the same packed row, a packed run bitwise to
    itself unchunked (:func:`check_packed_run`), and its segments'
    agreement with phase 6 (solo prefills) is reported.  Prints each serve's metrics beside phase 6's;
    returns the chunked serve's launch counts."""
    import torch
    from repro_torch.serving.chunked_prefill import ChunkedPrefillRun

    news = [m for _, m in PAGED_REQUESTS]
    eng6 = oneshot["eng"]
    chunks = [eng6._bucket(len(p)) // CHUNK for p in prompts]
    runs = {}
    quanta = []                 # (kind, host seconds) of every quantum
    step = ChunkedPrefillRun.step

    def timed(self):
        kind, t = self._phase, time.time()
        ev = step(self)         # ends in a device synchronisation
        quanta.append((kind, time.time() - t))
        return ev

    for label, extra in (("chunked", {}), ("chunked+packed",
                                           {"prefill_pack": 2})):
        quanta.clear()
        ChunkedPrefillRun.step = timed
        try:
            run = scheduler_serve(model, params, prompts, news, paged=True,
                                  num_pages=NUM_PAGES, prefill_chunk=CHUNK,
                                  **extra)
        finally:
            ChunkedPrefillRun.step = step
        report_scheduler_serve(f"{label} paged serve (chunk {CHUNK})", run)
        kinds = {}
        for kind, dt in quanta:
            kinds.setdefault(kind, []).append(dt * 1e3)
        print(f"  {label}: {len(quanta)} quanta; ms by kind (count, mean, "
              f"max): " + json.dumps(
                  {k: [len(v), round(sum(v) / len(v), 3), round(max(v), 3)]
                   for k, v in kinds.items()}), flush=True)
        check_paged_run(run, f"{label} serve")
        counts = run["counts"]
        admissions = counts["strip"] // layers
        print(f"  {label}: {admissions} admissions, block_sparse_attn "
              f"launches {counts['block_sparse_attn']} (one-shot: "
              f"{oneshot['counts']['block_sparse_attn']})", flush=True)
        if counts["decode_attn"] or counts["decode_attn_paged"] < layers:
            raise AssertionError(f"{label}: the serve did not decode "
                                 "through the paged kernel alone")
        runs[label] = run

    # chunked: one admission per request, one B.2 launch per chunk and
    # layer; tokens and first-step logits bitwise phase 6's
    counts = runs["chunked"]["counts"]
    want = {"strip": layers * len(prompts),
            "block_sparse_attn": layers * sum(chunks)}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"chunked serve launched {counts}, expected "
                             f"{want}")
    first, ref_first = runs["chunked"]["probe"].first, oneshot["probe"].first
    if set(first) != set(ref_first):
        raise AssertionError("chunked serve: first-step logits of other "
                             "requests than phase 6's")
    delta = max(max_err(first[k], ref_first[k]) for k in first)
    bitwise = all(torch.equal(first[k], ref_first[k]) for k in first)
    print(f"  chunked: first-step logits bitwise phase 6's {bitwise} "
          f"(max |delta| {delta:.3e})", flush=True)
    for a, c in zip(oneshot["reqs"], runs["chunked"]["reqs"]):
        if a.output_tokens.tolist() != c.output_tokens.tolist():
            raise AssertionError(f"chunked serve: request {a.uid} tokens "
                                 f"{c.output_tokens.tolist()} != phase 6's "
                                 f"{a.output_tokens.tolist()}")
    if not bitwise:
        raise AssertionError("chunked first-step logits differ from the "
                             "one-shot serve's")
    print("  chunked: greedy tokens identical to phase 6's", flush=True)

    # packed: a request that ran alone is held to phase 6 as above.  A
    # packed run shares one strip estimate and one dictionary across its
    # segments (the reference's packing does the same), so its segments'
    # masks, and so their tokens, may differ from a solo prefill's: their
    # agreement with phase 6 is reported, and each packed run is held
    # bitwise to a one-shot prefill of its own packed row
    packed = runs["chunked+packed"]
    seg = packed["probe"].segments
    if max(seg.values()) < 2:
        raise AssertionError("the packed serve packed no run")
    for a, c in zip(oneshot["reqs"], packed["reqs"]):
        key = (len(a.prompt), int(a.prompt[0]))
        same = a.output_tokens.tolist() == c.output_tokens.tolist()
        if seg[key] == 1:
            if not (same and torch.equal(packed["probe"].first[key],
                                         ref_first[key])):
                raise AssertionError(f"packed serve: request {a.uid} ran "
                                     "alone but differs from phase 6")
            print(f"  packed serve, request {a.uid} (alone): identical, "
                  "first-step logits bitwise", flush=True)
            continue
        verdict = "identical"
        if not same:
            t = next(i for i, (x, y) in enumerate(
                zip(a.output_tokens, c.output_tokens)) if x != y)
            solo = scheduler_serve(model, params, [a.prompt],
                                   [a.max_new_tokens], paged=True,
                                   num_pages=NUM_PAGES)
            top2 = np.sort(solo["probe"].logits[t][0].cpu().numpy())[-2:]
            verdict = (f"differs from token {t} on (phase 6's top-2 margin "
                       f"there {float(top2[1] - top2[0]):.3e})")
        delta = max_err(packed["probe"].first[key], ref_first[key])
        print(f"  packed serve, request {a.uid} (packed in a run of "
              f"{seg[key]}): {verdict}; first-step logits max |delta| "
              f"against phase 6 {delta:.3e} (reported, not held)",
              flush=True)
    check_packed_oneshot(packed["eng"], packed["probe"].packed)
    check_packed_run(packed["eng"], [oneshot["reqs"][i].prompt
                                     for i in (0, 1)])

    print("  per request (prefill_s / ttft_s / prefill_stall_s): one-shot "
          "| chunked | packed", flush=True)
    for i, r in enumerate(oneshot["reqs"]):
        cells = [f"{x.prefill_s:.4f} / {x.ttft_s:.4f} / "
                 f"{x.prefill_stall_s:.4f}"
                 for x in (r, runs["chunked"]["reqs"][i],
                           packed["reqs"][i])]
        print(f"  request {r.uid} ({len(r.prompt)} tokens, "
              f"{chunks[i]} chunks): " + " | ".join(cells), flush=True)
    for label, run in (("one-shot", oneshot), *runs.items()):
        e = run["eng"]
        steps = e.slot_steps // e.ecfg.max_batch
        stall = sum(r.prefill_stall_s for r in run["reqs"])
        print(f"  {label}: makespan {run['wall']:.3f} s, {steps} decode "
              f"steps of {1e3 * e.phase_s['decode'] / max(steps, 1):.2f} ms,"
              f" prefill {e.phase_s['prefill']:.3f} s, total "
              f"prefill_stall_s {stall:.4f}, block_sparse_attn launches "
              f"{run['counts']['block_sparse_attn']}", flush=True)
    return counts


def check_packed_oneshot(eng, runs) -> None:
    """Phase 9: the first-step logits of each packed run of the packed
    serve (chunk CHUNK, decode steps between its quanta) bitwise equal to a
    one-shot prefill of the same packed row, its own positions and segment
    mask: the same quanta with one chunk a layer, which is the one-shot
    layer's code (begin, every query block's rows, end)."""
    import torch
    from repro_torch.serving import Request
    from repro_torch.serving.chunked_prefill import ChunkedPrefillRun

    for seq, prompts, logits in runs:
        reqs = [Request(uid=i, prompt=p, max_new_tokens=1)
                for i, p in enumerate(prompts)]
        run = ChunkedPrefillRun(eng, reqs, list(range(len(reqs))), seq,
                                len(reqs) * seq, None)
        while not run.done:
            run.step()
        same = torch.equal(run.logits.float(), logits)
        print(f"  packed run of {len(reqs)} x {seq} tokens (prompts "
              f"{[len(p) for p in prompts]}): serve's first-step logits "
              f"bitwise a one-shot prefill of the packed row {same} (max "
              f"|delta| {max_err(run.logits.float(), logits):.3e})",
              flush=True)
        if not same:
            raise AssertionError("a packed run of the serve differs from a "
                                 "one-shot prefill of its packed row")


def check_packed_run(eng, prompts) -> None:
    """Phase 9: one packed admission (two 8192-bucket prompts in a
    16384-token row) driven to its end at CHUNK and as one chunk a layer:
    logits and every layer's K/V bitwise equal, and one B.2 launch per
    chunk and layer."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Request
    from repro_torch.serving.chunked_prefill import ChunkedPrefillRun

    out = {}
    for chunk in (CHUNK, 2 * SEQ):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=1)
                for i, p in enumerate(prompts)]
        run = ChunkedPrefillRun(eng, reqs, [0, 1], SEQ, chunk, None)
        reset_launch_counts()
        kv = []
        while not run.done:
            if run.step() == "kv":
                kv.append(run.kv)
        n = launch_counts()["block_sparse_attn"]
        if n != eng.model.cfg.num_layers * len(run.chunks):
            raise AssertionError(f"packed run at chunk {chunk}: {n} "
                                 "block-sparse launches")
        out[chunk] = (run.logits, kv, len(run.chunks))
    (la, kva, ca), (lb, kvb, cb) = out[CHUNK], out[2 * SEQ]
    same = torch.equal(la, lb) and all(
        torch.equal(x, y) for a, b in zip(kva, kvb) for x, y in zip(a, b))
    print(f"  packed run of 2 x {SEQ} tokens: {ca} chunks a layer bitwise "
          f"{cb} chunk (logits and every layer's K/V) {same}", flush=True)
    if not same:
        raise AssertionError("a packed run's result depends on its chunks")


# ---------------------------------------------------------------- phase 10

# the repaired configs at full width: (arch, layers kept or None for all,
# prompt lengths, new tokens)
REPAIRED = (("phi3-mini-3.8b", None, (8192, 7937), 8),
            ("mistral-large-123b", 2, (8192, 8192), 8))


def load_model(arch: str, depth):
    """``arch``'s config at full width, cut to ``depth`` layers (None: all),
    in bf16 from seed-0 random weights on the card; prints its size and
    init time."""
    import torch
    from repro_torch.checkpoint import num_params
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    model = build_model(cfg, dtype=torch.bfloat16)
    t = time.time()
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(SEED))
    torch.cuda.synchronize()
    cut = ("" if depth is None else f" (depth cut: {depth} of "
           f"{get_config(arch).num_layers} layers)")
    m = cfg.mla
    dims = (f"MLA Dqk {m.qk_nope_head_dim + m.qk_rope_head_dim}, Dv "
            f"{m.v_head_dim}" if m.enabled
            else f"head dim {cfg.resolved_head_dim}")
    print(f"{arch}: {cfg.num_layers} layers{cut}, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads (G = "
          f"{cfg.num_heads // cfg.num_kv_heads}), {dims}, "
          f"{num_params(params) / 1e9:.3f} B params in bf16, init "
          f"{time.time() - t:.2f} s", flush=True)
    return model, params


def serve_repaired(arch: str, depth, prompt_lens, new_tokens: int) -> dict:
    """Phase 10: a batch serve of one repaired config at full width (D = 96
    for phi3-mini, G = 12 for mistral-large) against the same serve with
    the decode's plain versions (:func:`serve_against_plain_decode`)."""
    import torch
    model, params = load_model(arch, depth)
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, model.cfg.vocab_size, n)
               for n in prompt_lens]
    runs = serve_against_plain_decode(model, params, prompts, new_tokens,
                                      arch)
    del model, params, runs
    torch.cuda.empty_cache()


def serve_against_plain_decode(model, params, prompts, new_tokens: int,
                               label: str) -> dict:
    """A batch serve, launch counts reset just before and read just after,
    then the same serve with the decode's plain versions
    (``decode_impl="einsum"``): logits finite, first-step logits equal (the
    same prefill), greedy tokens near-tie aware, launches exactly one strip
    and one block-sparse launch a layer and one decode launch a layer and
    step (none with the plain decode).  Returns both runs (requests,
    logits, counts) by decode_impl."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    cfg = model.cfg
    runs = {}
    for impl in ("auto", "einsum"):
        probe = LogitProbe(model)
        eng = ServingEngine(probe, params, model.default_share_prefill(),
                            EngineConfig(method="share", decode_sparse=True,
                                         decode_impl=impl, max_batch=2,
                                         seq_buckets=(SEQ,)))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        st = reqs[0].pattern_stats
        print(f"  decode_impl={impl}: {wall:.3f} s, prefill_s "
              f"{reqs[0].prefill_s:.4f}, decode_tokens_per_s "
              f"{reqs[0].decode_tokens_per_s:.3f}, block density "
              f"{st['block_density']:.4f}, shared/dense/vs "
              f"{st['num_shared']:.1f}/{st['num_dense']:.1f}/"
              f"{st['num_vs']:.1f}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {counts}", flush=True)
        logits = torch.stack(probe.logits, 1)       # (B, steps, V)
        if not bool(torch.isfinite(logits).all()) or logits.shape != (
                len(prompts), new_tokens, cfg.vocab_size):
            raise AssertionError(f"{label}: non-finite or misshapen logits")
        runs[impl] = (reqs, logits, counts)
    layers = cfg.num_layers
    want = {"strip": layers, "block_sparse_attn": layers}
    _expect_counts(f"{label} (kernel decode)", runs["auto"][2],
                   dict(want, decode_attn=layers * (new_tokens - 1)))
    _expect_counts(f"{label} (plain decode)", runs["einsum"][2], want)
    (kr, kl, _), (pr, pl, _) = runs["auto"], runs["einsum"]
    if not torch.equal(kl[:, 0], pl[:, 0]):
        raise AssertionError(f"{label}: the two serves' prefills differ")
    tol = PER_SAMPLE_RTOL * float(pl[:, 0].abs().max())
    for i, (a, c) in enumerate(zip(pr, kr)):
        verdict = greedy_agree(a.output_tokens, pl[i].cpu().numpy(),
                               c.output_tokens, tol)
        print(f"  request {a.uid}: kernel {c.output_tokens.tolist()} plain "
              f"{a.output_tokens.tolist()} -> {verdict}; max |logit "
              f"kernel - plain| {max_err(kl[i], pl[i]):.3e}", flush=True)
    return runs


# ---------------------------------------------------------------- phase 11

LONG = 32768        # phase 11's long prompt (NB = 256 blocks of 128)


def _expect_counts(what: str, counts: dict, want: dict) -> None:
    """Every kernel's launches are exactly ``want``'s (0 where absent)."""
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, expected {full}")


def serve_baselines(model, params, prompts, paged_prompts, layers: int,
                    batch: dict) -> dict:
    """Phase 11: the paper's baselines at full width (module docstring).
    Returns the launches of the phase's serves by kernel and run."""
    import torch
    from repro_torch.core.profile import (capture_block_attention_maps,
                                          run_prefill_traced)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    smi = nvidia_smi()
    cfg = model.cfg
    sp = model.default_share_prefill()
    launches = {}

    # phase 4's requests through each baseline, beside share and dense
    runs = {"share": batch}
    for method in BASELINES + ("dense",):
        run = serve_full(model, params, prompts, {}, method=method)
        want = {} if method == "dense" else {"block_sparse_attn": layers}
        if method == "vertical_slash":
            want["strip"] = layers
        _expect_counts(f"{method} serve", run["counts"], want)
        launches[f"serve {method}"] = run["counts"]
        runs[method] = run
    print(f"batch serves, 2 x {SEQ} tokens ({smi}):", flush=True)
    for method, run in runs.items():
        r, st = run["reqs"][0], run["reqs"][0].pattern_stats
        print(f"  {method}: prefill_s {r.prefill_s:.4f} block density "
              f"{st['block_density']:.4f} max_row_pop "
              f"{st['max_row_pop']:.0f} decode_tokens_per_s "
              f"{r.decode_tokens_per_s:.3f} tokens "
              f"{[x.output_tokens.tolist()[:4] for x in run['reqs']]}",
              flush=True)

    # vertical_slash through the per-sample path: the strip once per layer
    # for the batch, the single-sample kernel once per sample and layer
    per = serve_full(model, params, prompts, {}, method="vertical_slash",
                     attn_impl="kernel")
    _expect_counts("vertical_slash per-sample serve", per["counts"],
                   {"strip": layers,
                    "block_sparse_attn_single": len(prompts) * layers})
    launches["serve vertical_slash, attn_impl=kernel"] = per["counts"]
    first, ref_first = per["logits"][0], runs["vertical_slash"]["logits"][0]
    err = max_err(first, ref_first)
    tol = PER_SAMPLE_RTOL * float(ref_first.abs().max())
    print(f"  vertical_slash per-sample: prefill_s "
          f"{per['reqs'][0].prefill_s:.4f}; first-step logits max_abs_err "
          f"against the batch serve {err:.3e} (tol {tol:.3e})", flush=True)
    if err > tol:
        raise AssertionError(f"per-sample logits differ by {err} > {tol}")
    ref = runs["vertical_slash"]
    for i, (a, c) in enumerate(zip(ref["reqs"], per["reqs"])):
        logits = torch.stack([x[i] for x in ref["logits"]]).cpu().numpy()
        print(f"  request {a.uid}: "
              f"{greedy_agree(a.output_tokens, logits, c.output_tokens, tol)}",
              flush=True)
    del runs, per, ref
    torch.cuda.empty_cache()

    # flex through chunked admission: two of phase 6's requests, bitwise
    sel = (1, 2)
    ps = [paged_prompts[i] for i in sel]
    news = [PAGED_REQUESTS[i][1] for i in sel]
    sched = {}
    for label, extra in (("one-shot", {}), ("chunked",
                                           {"prefill_chunk": CHUNK})):
        run = scheduler_serve(model, params, ps, news, paged=True,
                              num_pages=NUM_PAGES, method="flex", **extra)
        report_scheduler_serve(f"flex {label} paged serve", run)
        check_paged_run(run, f"flex {label} serve")
        sched[label] = run
        launches[f"flex {label} paged serve"] = run["counts"]
    chunks = sum(sched["one-shot"]["eng"]._bucket(len(p)) // CHUNK
                 for p in ps)
    _expect_counts("flex one-shot paged serve", sched["one-shot"]["counts"],
                   {"block_sparse_attn": layers * len(ps)})
    _expect_counts("flex chunked paged serve", sched["chunked"]["counts"],
                   {"block_sparse_attn": layers * chunks})
    a, c = sched["one-shot"]["probe"].first, sched["chunked"]["probe"].first
    bitwise = a.keys() == c.keys() and all(torch.equal(a[k], c[k])
                                           for k in a)
    same = all(x.output_tokens.tolist() == y.output_tokens.tolist()
               for x, y in zip(sched["one-shot"]["reqs"],
                               sched["chunked"]["reqs"]))
    print(f"  flex chunked: first-step logits bitwise the one-shot serve's "
          f"{bitwise}, tokens identical {same}", flush=True)
    if not (bitwise and same):
        raise AssertionError("flex: the chunked serve differs from the "
                             "one-shot serve")
    del sched
    torch.cuda.empty_cache()

    # the profiling pass on one 8192-token prompt
    tok1 = torch.as_tensor(prompts[0][None], device=model.device)
    traces = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    for method in METHODS:
        t0 = time.time()
        traces[method] = run_prefill_traced(params, cfg, tok1, sp,
                                            method=method)
        torch.cuda.synchronize()
        dens = np.mean([r["block_density"] for r in traces[method].per_layer])
        print(f"  traced prefill [{method}]: {time.time() - t0:.2f} s, mean "
              f"density {dens:.4f}", flush=True)
    counts = launch_counts()
    _expect_counts("traced prefills", counts, {"strip": 2 * layers})
    launches["traced prefills"] = counts
    dense = traces["dense"].last_logits
    for method in ("share",) + BASELINES:
        last = traces[method].last_logits
        if not np.isfinite(last).all():
            raise AssertionError(f"traced {method}: non-finite logits")
        print(f"  traced {method}: last-logits max |gap| to dense "
              f"{float(np.abs(last - dense).max()):.4f} (random weights: "
              "reported, not held)", flush=True)
    t0 = time.time()
    maps = capture_block_attention_maps(params, cfg, tok1, block_size=64)
    rows = maps.sum(-1)
    print(f"  block attention maps: shape {maps.shape} in "
          f"{time.time() - t0:.2f} s, row sums within "
          f"{float(np.abs(rows - 1).max()):.2e} of 1", flush=True)
    if maps.shape != (layers, cfg.num_heads, SEQ // 64, SEQ // 64) or \
            not np.isfinite(maps).all() or np.abs(rows - 1).max() > 1e-3:
        raise AssertionError("block attention maps: bad shape or rows")
    del traces, maps
    torch.cuda.empty_cache()

    # Model.prefill of one 32768-token prompt, the second of two runs (one
    # run for ``dense``: the plain float32 chunked path needs no warm-up
    # and takes tens of seconds a run)
    long = np.random.default_rng(SEED + 11).integers(0, cfg.vocab_size,
                                                     (1, LONG))
    long = torch.as_tensor(long, device=model.device)
    print(f"Model.prefill of one {LONG}-token prompt ({smi}):", flush=True)
    for method in METHODS:
        for _ in range(1 if method == "dense" else 2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            res = model.prefill(params, long, sp, method=method)
            torch.cuda.synchronize()
            wall = time.time() - t0
            finite = bool(torch.isfinite(res.last_logits).all())
            st = res.stats
            del res
        print(f"  {method}: prefill_s {wall:.4f} block density "
              f"{float(st.block_density):.4f} max_row_pop "
              f"{float(st.max_row_pop):.0f} peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if not finite:
            raise AssertionError(f"{method} at {LONG}: non-finite logits")
        torch.cuda.empty_cache()

    # one layer's dense attention at 8192: the dense method's plain chunked
    # path against one PyTorch library call on the same q/k/v
    import torch.nn.functional as F
    from repro_torch.kernels import expand_kv
    from repro_torch.kernels.chunked import chunked_attention
    q, k, v = layer0_qkv(model, params, tok1.expand(2, -1).contiguous())
    kx, vx = expand_kv(k, v, q.shape[1])
    plain = lambda: chunked_attention(q, kx, vx, block_size=128, causal=True)
    lib = lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True)
    err = max_err(plain(), lib())
    print(f"  one layer's dense attention (B=2, H={q.shape[1]}, N={SEQ}, "
          f"D={q.shape[3]}, {str(q.dtype).replace('torch.', '')}): plain "
          f"chunked {cuda_ms(plain, 3):.3f} ms, scaled_dot_product_attention "
          f"{cuda_ms(lib, 10):.3f} ms, max |difference| {err:.3e} ({smi})",
          flush=True)
    return launches


# ---------------------------------------------------------------- phase 12

# the refresh serve: two prompts of the two buckets, REFRESH_NEW greedy
# tokens each, a refresh every block (both slots reach block boundaries
# together: 128 and 256 steps after admission, two refreshes each)
REFRESH_PROMPTS = (8192, 2048)
REFRESH_NEW = 300
REFRESH_EVERY = 128
REFRESH_MASS = 0.95
# keep blocks the card's first refreshed row may differ in from the CPU's
REFRESH_ROW_TOL = 1e-3
# the chunked lifecycle serve's pool: one 8192-bucket and one 2048-bucket
# admission (65 + 17 pages) and the null page, so admissions starve
LIFECYCLE_CHUNKED_PAGES = 83
# the lifecycle serves' deadline for r5: it passes while r5 waits behind
# the first admissions (three one-shot prefills take about 1 s)
LIFECYCLE_DEADLINE_S = 0.5
# the width-policy serves: a safety factor below 1, so that the resolved
# cap truncates rows (random weights keep most blocks: at 1.25 both
# policies resolve to NB, uncapped)
WIDTH_SAFETY = 0.5


class StepProbe(LogitProbe):
    """:class:`LogitProbe` keeping the decode steps' logits apart."""

    def __init__(self, model):
        super().__init__(model)
        self.steps = []

    def decode(self, *args, **kwargs):
        out = super().decode(*args, **kwargs)
        self.steps.append(self.logits[-1])
        return out


def refresh_serve(model, params, prompts, every: int) -> dict:
    """One serve of the refresh requests, ``refresh_every=every`` (0:
    frozen plans), launch counts reset just before and read just after.
    Records each request's decode steps before its first refresh, and the
    inputs and result of the first refreshed row built."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                     SlotScheduler)
    from repro_torch.serving import decode_plan as dplan

    probe = StepProbe(model)
    eng = ServingEngine(probe, params, model.default_share_prefill(),
                        EngineConfig(method="share", decode_sparse=True,
                                     paged=True, max_batch=2,
                                     seq_buckets=(SHORT, SEQ),
                                     refresh_every=every,
                                     refresh_mass=REFRESH_MASS))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=REFRESH_NEW)
            for i, p in enumerate(prompts)]
    first, row = {}, {}
    refresh_slot = SlotScheduler._refresh_slot
    build = dplan.build_refresh_plan_row
    allocs = []
    summary = SlotScheduler._pool_summary

    def refreshed(self, slot, s, st, pos):
        first.setdefault(s.req.uid, (slot, len(probe.steps)))
        refresh_slot(self, slot, s, st, pos)

    def built(q_hat, pool_k, table, cfg, **kw):
        out = build(q_hat, pool_k, table, cfg, **kw)
        if not row:
            pages = table[: kw["num_blocks"]].long()
            row.update(window=q_hat.cpu(), pages=pool_k[:, pages].cpu(),
                       kw=kw, row=[x.cpu() for x in out])
        return out

    def audited(self):
        summary(self)
        allocs.append(self.alloc)

    SlotScheduler._refresh_slot = refreshed
    SlotScheduler._pool_summary = audited
    dplan.build_refresh_plan_row = built
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.time()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
    finally:
        SlotScheduler._refresh_slot = refresh_slot
        SlotScheduler._pool_summary = summary
        dplan.build_refresh_plan_row = build
    steps = eng.slot_steps // eng.ecfg.max_batch
    label = f"refresh_every={every}" if every else "frozen plans"
    print(f"refresh serve ({label}): {len(reqs)} requests in {wall:.3f} s, "
          f"{steps} decode steps, decode step "
          f"{1e3 * eng.phase_s['decode'] / max(steps, 1):.2f} ms (mean), "
          f"phase_s " + json.dumps({k: round(v, 4)
                                    for k, v in eng.phase_s.items()})
          + f"; refresh_stats {json.dumps(eng.refresh_stats)}; launches "
          f"{counts}", flush=True)
    for r in reqs:
        print(f"  request {r.uid}: prompt {len(r.prompt)} "
              f"{r.finish_reason} {len(r.output_tokens)} tokens refreshes "
              f"{r.refreshes} tail_fraction {r.tail_fraction:.4f} "
              f"plan_traffic_fraction {r.plan_traffic_fraction:.4f} "
              f"decode_tokens_per_s {r.decode_tokens_per_s:.3f}", flush=True)
        if r.finish_reason != "length" or \
                len(r.output_tokens) != REFRESH_NEW:
            raise AssertionError(f"refresh serve: request {r.uid} "
                                 f"{r.finish_reason}")
    if eng.page_pool_stats["pages_in_use_at_end"] != 0:
        raise AssertionError(f"refresh serve: pages leaked "
                             f"{eng.page_pool_stats}")
    for alloc in allocs:
        alloc.check_consistency()
    if not all(bool(torch.isfinite(x).all()) for x in probe.logits):
        raise AssertionError("refresh serve: non-finite logits")
    return dict(eng=eng, reqs=reqs, counts=counts, steps=probe.steps,
                first=first, row=row, wall=wall, nsteps=steps)


def check_refresh(model, params, layers: int) -> dict:
    """Phase 12, part 1: the refresh serve beside the frozen serve."""
    import torch
    from repro_torch.kernels.decode_attn import DecodePlan
    from repro_torch.serving import decode_plan as dplan

    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(0, model.cfg.vocab_size, n)
               for n in REFRESH_PROMPTS]
    # predicted from the refresh positions: a slot admitted at a block
    # boundary refreshes once its window is full and its cadence is due,
    # at 128, 256, ... decode steps, while it still decodes (its last
    # step, the 299th, vacates it first)
    refreshes = len(prompts) * ((REFRESH_NEW - 2) // REFRESH_EVERY)
    steps = REFRESH_NEW - 1
    want_off = {"strip": layers * len(prompts),
                "block_sparse_attn": layers * len(prompts),
                "decode_attn_paged": layers * steps}
    want_on = dict(want_off, strip=layers * (len(prompts) + refreshes))
    print(f"  predicted launches: frozen {want_off}; refresh {want_on} "
          f"({refreshes} refreshes of {layers} strip launches)",
          flush=True)
    # frozen, refresh, frozen again: the first frozen serve warms the
    # card up and is the bitwise reference, the second is the one the
    # refresh serve's step time is compared with (taken in turns), and
    # the two frozen serves must be bitwise equal (run-to-run determinism)
    off = refresh_serve(model, params, prompts, 0)
    on = refresh_serve(model, params, prompts, REFRESH_EVERY)
    off2 = refresh_serve(model, params, prompts, 0)
    _expect_counts("frozen serve", off["counts"], want_off)
    _expect_counts("refresh serve", on["counts"], want_on)
    _expect_counts("second frozen serve", off2["counts"], want_off)
    again = (all(torch.equal(a, b) for a, b in zip(off["steps"],
                                                    off2["steps"]))
             and all(a.output_tokens.tolist() == b.output_tokens.tolist()
                     for a, b in zip(off["reqs"], off2["reqs"])))
    print(f"  the two frozen serves bitwise equal (every step's logits and "
          f"every token): {again}", flush=True)
    if not again:
        raise AssertionError("two frozen serves of the same requests "
                             "differ")
    got = sum(r.refreshes for r in on["reqs"])
    if got != refreshes or on["eng"].refresh_stats["refreshes"] != got:
        raise AssertionError(f"refreshes {got}, predicted {refreshes}")

    # bitwise the frozen serve until each slot's first refresh
    for r_on, r_off in zip(on["reqs"], off["reqs"]):
        slot, k = on["first"][r_on.uid]
        same = all(torch.equal(a[slot], b[slot])
                   for a, b in zip(on["steps"][:k], off["steps"][:k]))
        toks = (r_on.output_tokens[:k + 1].tolist()
                == r_off.output_tokens[:k + 1].tolist())
        later = next((t for t, (x, y) in enumerate(zip(
            r_on.output_tokens.tolist(), r_off.output_tokens.tolist()))
            if x != y), None)
        print(f"  request {r_on.uid}: first refresh after {k} decode "
              f"steps; logits of those steps bitwise the frozen serve's "
              f"{same}, tokens {toks}; streams first differ at token "
              f"{later}", flush=True)
        if not (same and toks):
            raise AssertionError(f"request {r_on.uid}: the refresh serve "
                                 "left the frozen serve before its first "
                                 "refresh")

    # the first refreshed row, built again by the plain path on the CPU
    # from the same window and pages
    cap = on["row"]
    t0 = time.time()
    kw = dict(cap["kw"])
    nblk = kw["num_blocks"]
    cpu = dplan.build_refresh_plan_row(
        cap["window"], cap["pages"], torch.arange(nblk, dtype=torch.int32),
        model.cfg, **kw)
    card = DecodePlan(*cap["row"])
    flips = int((cpu.keep_heads != card.keep_heads).sum())
    kept = int(card.keep_heads.sum())
    frac = flips / max(kept, 1)
    print(f"  first refreshed row (nblk {nblk}, horizon "
          f"{kw['horizon_blocks']}): {kept} keep blocks on the card, "
          f"{int(cpu.keep_heads.sum())} on the CPU, {flips} differ "
          f"({frac:.2e}, tol {REFRESH_ROW_TOL:.0e}); table counts equal "
          f"{torch.equal(cpu.counts, card.counts)}; CPU rebuild "
          f"{time.time() - t0:.1f} s", flush=True)
    if frac > REFRESH_ROW_TOL:
        raise AssertionError(f"refreshed row: {flips} of {kept} keep "
                             "blocks differ between the card and the CPU")
    step = lambda run: 1e3 * run["eng"].phase_s["decode"] / run["nsteps"]
    print(f"  mean decode step: refresh serve {step(on):.2f} ms (its "
          f"{refreshes} refreshes {1e3 * on['eng'].phase_s['refresh']:.1f} "
          f"ms apart), "
          f"frozen serves {step(off):.2f} then {step(off2):.2f} ms "
          f"({nvidia_smi()})", flush=True)
    return dict(on=on["counts"], off=off["counts"],
                refresh_s=on["eng"].phase_s["refresh"],
                step_ms=(step(on), step(off), step(off2)))


def check_lifecycle(model, params, prompts, layers: int) -> dict:
    """Phase 12, part 2: phase 6's requests under faults, a deadline and
    preemption, one-shot (phase 6's pool) and chunked (a pool of one
    request per bucket), each against phase 6's serve without them."""
    import torch
    from repro_torch.serving import (CancelAt, FaultInjector, NaNLogits,
                                     PrefillError)
    from repro_torch.serving.chunked_prefill import ChunkedPrefillRun

    news = [m for _, m in PAGED_REQUESTS]
    base = scheduler_serve(model, params, prompts, news, paged=True,
                           num_pages=NUM_PAGES)
    check_paged_run(base, "unpreempted serve")
    ref = [r.output_tokens.tolist() for r in base["reqs"]]
    del base
    # chunked: r0's run takes steps 1..q, r0 is preempted at q + 1 (r1
    # starves with r0 decoding) and r1's run takes steps q + 2 .. 2q + 1
    q = 2 + layers * (2 + SEQ // CHUNK)
    cancel_step = q + 2 + q // 4
    cases = {
        # r2 is the preemption victim (lowest priority): r0-r2 fill the
        # pool, r3 starves; r5's deadline passes while it waits
        "one-shot": (dict(num_pages=NUM_PAGES, preempt_after_steps=2),
                     [NaNLogits(uid=0, at_token=5), PrefillError(uid=4),
                      CancelAt(uid=3, step=8)],
                     {2: dict(priority=-1),
                      5: dict(deadline_s=LIFECYCLE_DEADLINE_S)},
                     {0: "failed", 3: "cancelled", 4: "failed",
                      5: "timeout"}),
        # r1 is cancelled while its chunked run is in flight (q quanta
        # an 8192 admission): the run aborts between quanta
        "chunked": (dict(num_pages=LIFECYCLE_CHUNKED_PAGES,
                         prefill_chunk=CHUNK, preempt_after_steps=2),
                    [CancelAt(uid=1, step=cancel_step),
                     NaNLogits(uid=3, at_token=3), PrefillError(uid=4)],
                    {5: dict(deadline_s=LIFECYCLE_DEADLINE_S)},
                    {1: "cancelled", 3: "failed", 4: "failed",
                     5: "timeout"}),
    }
    out = {}
    abort = ChunkedPrefillRun.abort
    for label, (ecfg, faults, fields, expect) in cases.items():
        aborts = []

        def counted(self):
            aborts.append(self.quanta_done)
            abort(self)

        ChunkedPrefillRun.abort = counted
        try:
            run = scheduler_serve(model, params, prompts, news, paged=True,
                                  faults=FaultInjector(*faults),
                                  fields=fields, **ecfg)
        finally:
            ChunkedPrefillRun.abort = abort
        eng = run["eng"]
        print(f"lifecycle serve ({label}): {run['wall']:.3f} s, "
              f"preemptions {eng.preemptions}, pages_exhausted_steps "
              f"{eng.pages_exhausted_steps}, run aborts after quanta "
              f"{aborts}; launches {run['counts']}", flush=True)
        for r in run["reqs"]:
            got = r.output_tokens.tolist()
            want = expect.get(r.uid, "length")
            if want == "length":
                ok = got == ref[r.uid]
            elif r.error is not None and r.error.kind == "prefill":
                ok = got == []
            else:
                ok = got == ref[r.uid][: len(got)] and (
                    want != "timeout" or got == [])
            print(f"  request {r.uid}: {r.finish_reason} ({r.state}) "
                  f"{len(got)} tokens, preempted {r.preempted_count}, "
                  f"deferred {r.waiting_deferred_steps} steps; tokens "
                  f"{'bitwise' if want == 'length' else 'a prefix of'} "
                  f"phase 6's {ok}", flush=True)
            if r.finish_reason != want or not ok:
                raise AssertionError(f"lifecycle {label}: request {r.uid} "
                                     f"{r.finish_reason}, tokens ok {ok}")
        resumed = [r.uid for r in run["reqs"]
                   if r.preempted_count and r.finish_reason == "length"]
        if eng.preemptions < 1 or not resumed:
            raise AssertionError(f"lifecycle {label}: no preempted request "
                                 "resumed to its end")
        if label == "chunked" and not aborts:
            raise AssertionError("chunked lifecycle: no run aborted")
        if eng.page_pool_stats["pages_in_use_at_end"] != 0:
            raise AssertionError(f"lifecycle {label}: pages leaked "
                                 f"{eng.page_pool_stats}")
        for alloc in run["allocs"]:
            alloc.check_consistency()
        if not all(bool(torch.isfinite(x).all())
                   for x in run["probe"].logits):
            raise AssertionError(f"lifecycle {label}: non-finite logits "
                                 "outside the injected fault")
        out[label] = dict(wall=run["wall"], preemptions=eng.preemptions,
                          resumed=resumed, counts=run["counts"])
    return out


def check_width_policies(model, params, prompts, layers: int) -> dict:
    """Phase 12, part 3: two successive batch serves of phase 4's requests
    under each width policy; the first prefill runs uncapped, the second
    under the frozen cap, whose layer-0 B.2 tables must be the uncapped
    layer-0 masks capped (``cap_block_mask``)."""
    import torch
    from repro_torch.kernels import (cap_block_mask, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    smi = nvidia_smi()
    stage = ops.compact_block_mask
    out = {}
    for policy in ("count", "auto"):
        eng = ServingEngine(model, params, model.default_share_prefill(),
                            EngineConfig(method="share", decode_sparse=True,
                                         max_batch=2, seq_buckets=(SEQ,),
                                         width_policy=policy,
                                         width_safety=WIDTH_SAFETY))
        runs = []
        for rnd in range(2):
            staged = []

            def staging(mask, width=None):
                tables = stage(mask, width=width)
                if not staged:          # layer 0 of the serve's prefill
                    staged.append((mask.clone(), width, tables))
                return tables

            reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(prompts)]
            ops.compact_block_mask = staging
            try:
                torch.cuda.synchronize()
                reset_launch_counts()
                eng.serve(reqs)
                torch.cuda.synchronize()
                counts = launch_counts()
            finally:
                ops.compact_block_mask = stage
            _expect_counts(f"{policy} serve {rnd + 1}", counts, {
                "strip": layers, "block_sparse_attn": layers,
                "decode_attn": layers * (NEW_TOKENS - 1)})
            runs.append(dict(reqs=reqs, staged=staged[0], counts=counts))
        w = eng._width_frozen.get(SEQ)
        (m0, w0, _), (m1, w1, (i1, c1)) = runs[0]["staged"], \
            runs[1]["staged"]
        if w0 is not None or w is None or w1 != w:
            raise AssertionError(f"{policy}: widths {w0} then {w1}, "
                                 f"frozen {w}")
        same_mask = torch.equal(m0, m1)
        ci, cc = ops.compact_block_mask(cap_block_mask(m0, w), width=w)
        tables = torch.equal(i1, ci) and torch.equal(c1, cc)
        p0, p1 = (r["reqs"][0].prefill_s for r in runs)
        caps = [r["reqs"][0].pattern_stats["prefill_width_cap"]
                for r in runs]
        print(f"width_policy={policy} (width_safety {WIDTH_SAFETY}): "
              f"resolved W {w} of {SEQ // eng.sp.cfg.block_size}; "
              f"prefill_s uncapped "
              f"{p0:.4f}, capped {p1:.4f}; prefill_width_cap {caps}; B.2 "
              f"launches {[r['counts']['block_sparse_attn'] for r in runs]}"
              f"; layer-0 masks of the two prefills equal {same_mask}; "
              f"capped layer-0 B.2 tables equal cap_block_mask of the "
              f"uncapped masks {tables} ({smi})", flush=True)
        if not (same_mask and tables):
            raise AssertionError(f"{policy}: capped tables differ")
        out[policy] = dict(width=w, prefill_s=(p0, p1))
    return out


def phase12(model, params, prompts, paged_prompts, layers: int) -> None:
    """Phase 12: decode-pattern refresh, the request lifecycle and the
    width policies at full width."""
    import torch
    print("== phase 12: pattern refresh, lifecycle, width policies",
          flush=True)
    t = time.time()
    refresh = check_refresh(model, params, layers)
    torch.cuda.empty_cache()
    life = check_lifecycle(model, params, paged_prompts, layers)
    torch.cuda.empty_cache()
    widths = check_width_policies(model, params, prompts, layers)
    torch.cuda.empty_cache()
    print(f"phase 12: {time.time() - t:.1f} s ({nvidia_smi()}); " + json.dumps(
        {"refresh": refresh, "lifecycle": life, "width": widths}),
        flush=True)


# ---------------------------------------------------------------- phase 13

# three requests share one prompt of the 8192 bucket, one has its own of
# the 2048 bucket: (prompt index, max_new_tokens); the third is sampled
PREFIX_PROMPTS = (8192, 2048)
PREFIX_REQUESTS = ((0, 16), (0, 16), (0, 12), (1, 8))
PREFIX_SAMPLED = 2
# predicted from the code: the two later copies of prompt 0 hit, each
# mapping its 65-page run; every slot copies the one tail page its decode
# appends into (the run is published, so shared) and no other
PREFIX_EXPECT = {"prefix_hits": 2.0, "prefix_misses": 2.0,
                 "prefix_pages_saved": 130.0, "prefix_cow_copies": 4.0,
                 "prefix_evictions": 0.0}


def check_prefix_runs(label: str, off: dict, on: dict, hits: list,
                      expect: dict, want_on: dict, want_off: dict) -> dict:
    """Sharing on against off: every stream and finish reason bitwise, the
    hits where predicted, the index counters and the launches as
    predicted, the hits' prefill skipped; then each pool is fully free
    after the index's ``clear`` (``check_paged_run``)."""
    for run, what in ((off, "off"), (on, "on")):
        check_paged_run(run, f"{label}, sharing {what}")
        for alloc in run["allocs"]:
            if alloc.free_pages != alloc.num_pages - 1:
                raise AssertionError(f"{label}: pool not free at the end")
    for a, c in zip(off["reqs"], on["reqs"]):
        if (a.output_tokens.tolist() != c.output_tokens.tolist()
                or a.finish_reason != c.finish_reason):
            raise AssertionError(
                f"{label}: request {a.uid} differs with sharing: "
                f"{a.output_tokens.tolist()} / {c.output_tokens.tolist()}")
    got = [r.prefix_hit for r in on["reqs"]]
    ps = on["eng"].prefix_stats
    print(f"  {label}: streams bitwise equal with and without sharing; "
          f"hits {got}; prefix_stats {json.dumps(ps)}; hits' prefill_s "
          + ", ".join(f"{r.prefill_s:.6f}" for r in on["reqs"]
                      if r.prefix_hit)
          + "; ttft_s off / on " + ", ".join(
              f"{a.ttft_s:.4f}/{c.ttft_s:.4f}"
              for a, c in zip(off["reqs"], on["reqs"])), flush=True)
    if got != hits or any(ps[k] != v for k, v in expect.items()):
        raise AssertionError(f"{label}: hits {got} / stats {ps}, predicted "
                             f"{hits} / {expect}")
    _expect_counts(f"{label}, sharing on", on["counts"], want_on)
    _expect_counts(f"{label}, sharing off", off["counts"], want_off)
    return dict(ps, hits_prefill_s=[r.prefill_s for r in on["reqs"]
                                    if r.prefix_hit],
                ttft_s_on=[r.ttft_s for r in on["reqs"]],
                ttft_s_off=[r.ttft_s for r in off["reqs"]],
                wall_on=on["wall"], wall_off=off["wall"],
                launches_on=on["counts"], launches_off=off["counts"])


def _decode_steps(run: dict) -> int:
    return run["eng"].slot_steps // run["eng"].ecfg.max_batch


def phase13(model, params, layers: int) -> None:
    """Phase 13: prefix sharing with copy-on-write on llama3-8b-262k at full
    width, through phase 6's paged scheduler, buckets and pool, one-shot and
    with ``prefill_chunk=1024``: sharing on against off."""
    from repro_torch.serving import SamplingConfig
    print("== phase 13: prefix sharing with copy-on-write", flush=True)
    t = time.time()
    rng = np.random.default_rng(SEED + 13)
    base = [rng.integers(0, model.cfg.vocab_size, n) for n in PREFIX_PROMPTS]
    prompts = [base[i] for i, _ in PREFIX_REQUESTS]
    news = [m for _, m in PREFIX_REQUESTS]
    fields = {PREFIX_SAMPLED: {"sampling": SamplingConfig(temperature=0.8)}}
    out = {}
    for chunk in (0, CHUNK):
        label = "chunked" if chunk else "one-shot"
        runs = {}
        for sharing in (False, True):
            run = scheduler_serve(model, params, prompts, news,
                                  fields=fields, paged=True,
                                  num_pages=NUM_PAGES, prefill_chunk=chunk,
                                  prefix_sharing=sharing)
            report_scheduler_serve(f"{label} serve, prefix sharing "
                                   f"{'on' if sharing else 'off'}", run)
            runs[sharing] = run
        # B.1 once a layer for each cold prefill; B.2 once a layer (one-shot)
        # or once a layer and chunk; B.4 once a layer and decode step
        per = [n // CHUNK for n in PREFIX_PROMPTS] if chunk else [1, 1]
        want_on = {"strip": 2 * layers,
                   "block_sparse_attn": layers * sum(per),
                   "decode_attn_paged": layers * _decode_steps(runs[True])}
        want_off = {"strip": 4 * layers,
                    "block_sparse_attn": layers * (3 * per[0] + per[1]),
                    "decode_attn_paged": layers * _decode_steps(runs[False])}
        out[label] = check_prefix_runs(
            f"{label} serve", runs[False], runs[True],
            [False, True, True, False], PREFIX_EXPECT, want_on, want_off)
    print(f"phase 13: {time.time() - t:.1f} s ({nvidia_smi()}); "
          + json.dumps(out), flush=True)


# ---------------------------------------------------------------- phase 14

MIXTRAL = "mixtral-8x22b"
MIXTRAL_LAYERS = 4          # of 56: 10.4 B parameters, 20.8 GB in bf16
MIXTRAL_NEW = 8
# the paged serve's three requests, the first two of one prompt: the second
# hits and maps the 65-page run; each of the three copies its tail page
MIXTRAL_PREFIX_EXPECT = {"prefix_hits": 1.0, "prefix_misses": 2.0,
                         "prefix_pages_saved": 65.0,
                         "prefix_cow_copies": 3.0, "prefix_evictions": 0.0}


def window_skip_share(cfg, nb: int, bs: int, density: float) -> tuple:
    """The window block mask's density (of the causal blocks) and its share
    of the blocks a prefill of block density ``density`` skips."""
    from repro_torch.core.patterns import block_mask_density
    from repro_torch.models.attention import extra_block_mask
    wd = float(block_mask_density(extra_block_mask(cfg, nb, bs)))
    return wd, (1.0 - wd) / max(1.0 - density, 1e-12)


def check_mixtral_kernels(model, params, tokens, prompt_lens) -> dict:
    """Phase 14: B.1, B.2, B.6, B.3 and B.4 against their plain versions at
    Mixtral's G = 6 (H = 48 over Hkv = 8, D = 128, N = 8192, B = 2) in
    bfloat16 and float32, on layer 0's real q/k/v and its SharePrefill
    masks with the window's block mask ANDed in (one row also listing a
    block above the diagonal, wholly masked); decode on layer 0's real
    DecodePlan tables over a grown cache under the window's banded
    validity (kept blocks it hides wholly), contiguous and through a
    shuffled pool; then their bf16 times beside their bounds.  Returns each kernel's largest error and its times."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.decode_attn import (
        decode_plan_einsum_sliced_paged)
    from repro_torch.models.attention import extra_block_mask
    from repro_torch.models.transformer import (decode_valid_mask,
                                                window_valid_mask)

    cfg = model.cfg
    bs = cfg.share_prefill.block_size
    dev = tokens.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    q16, k16, v16 = layer0_qkv(model, params, tokens)
    b, h, n, d = q16.shape
    hkv = k16.shape[1]
    g, nb = h // hkv, n // bs
    extra = extra_block_mask(cfg, nb, bs, device=dev)
    masks, decision = real_masks(model, q16, k16, v16, extra)
    causal = torch.ones(nb, nb, dtype=torch.bool, device=dev).tril()
    skipped = float((causal & ~masks).sum())
    by_window = float((causal & ~extra).sum()) * b * h
    print(f"Mixtral layer 0: B={b} H={h} Hkv={hkv} (G = {g}) N={n} D={d} "
          f"bs={bs}, window {cfg.sliding_window} tokens = "
          f"{cfg.sliding_window // bs} blocks; masks keep "
          f"{float(masks.sum()) / (b * h * float(causal.sum())):.4f} of the "
          f"causal blocks; the window's share of the skipped ones "
          f"{by_window / max(skipped, 1):.4f}", flush=True)
    # a row that also lists the block above its diagonal: visited, wholly
    # masked, weighs nothing (out unchanged, Ã −inf there)
    syn = masks.clone()
    syn[0, 1, nb - 2, nb - 1] = True
    sidx, scnt = (x.contiguous() for x in K.compact_block_mask(masks))
    yidx, ycnt = (x.contiguous() for x in K.compact_block_mask(syn))
    s0idx, s0cnt = (x.contiguous() for x in K.compact_block_mask(masks[0]))

    # decode: layer 0's tables of the two prompts' real DecodePlan over the
    # prompt plus a 128-token tail, 6 tokens of it written; validity the
    # prompts', banded by the window: the plan ignores the window, so the
    # sink block and the others before pos − 4096 are kept and wholly
    # hidden
    from repro_torch.serving import decode_plan as dplan
    sp = model.default_share_prefill()
    s = n + bs
    pos = n + 5
    nbs = s // bs
    pre = model.prefill(params, tokens, sp, method="share",
                        prompt_lens=prompt_lens)
    plan = dplan.build_decode_plan(sp, pre.sp_state, cfg, prefill_len=n,
                                   cache_len=s).layer(0)
    del pre
    didx, dcnt, keep = (x.contiguous() for x in plan)
    union = K.table_block_mask(didx, dcnt, nbs)                # (B, Hkv, NB)
    valid = window_valid_mask(
        decode_valid_mask(s, pos, prompt_lens, n), s, pos,
        cfg.sliding_window, b, dev).contiguous()
    vis_blocks = valid.reshape(b, nbs, bs).any(-1)              # (B, NB)
    hidden = int((union & ~vis_blocks[:, None]).sum())
    num_pages = 1 + b * nbs + 4
    perm = (1 + torch.randperm(num_pages - 1, generator=gen, device=dev)
            ).to(torch.int32)
    table = perm[:b * nbs].reshape(b, nbs).contiguous()
    print(f"  decode: S={s} pos={pos}, window band keeps "
          f"{int(valid[0].sum())} of {pos + 1} written slots; kept blocks "
          f"the band hides wholly {hidden} of {int(union.sum())}", flush=True)
    if hidden == 0:
        raise AssertionError("no kept decode block is wholly hidden")

    names = ("strip", "block_sparse_attn", "block_sparse_attn_single",
             "decode_attn", "decode_attn_paged")
    out = {name: {"max_abs_err": 0.0} for name in names}

    def fold(name, e):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q, k, v = (x.to(dtype) for x in (q16, k16, v16))
        print(f"[{dn}]", flush=True)
        e = max_err(K.strip_scores_cuda(q, k, bs), K.strip_scores(q, k, bs))
        check("strip [G=6]", e, TOL[("strip", dn)])
        fold("strip", e)
        for label, idx, cnt in (("window masks", sidx, scnt),
                                ("a block above the diagonal", yidx, ycnt)):
            kw = dict(block_size=bs, stats_gate=decision.use_dense)
            o1, a1 = K.block_sparse_attention_cuda(q, k, v, idx, cnt, **kw)
            o2, a2 = K.block_sparse_attention_plain(q, k, v, idx, cnt, **kw)
            print(f"  block_sparse_attn [{label}]: W={idx.shape[-1]}",
                  flush=True)
            check("  out", max_err(o1, o2), TOL[("out", dn)])
            check("  a_tilde", a_tilde_err(a1, a2), TOL[("a_tilde", dn)])
            fold("block_sparse_attn", max_err(o1, o2))
            if idx is yidx:
                o0, _ = K.block_sparse_attention_cuda(q, k, v, sidx, scnt,
                                                      **kw)
                same = bool(torch.equal(o1, o0))
                above = bool(torch.isneginf(a1[0, 1, nb - 2, nb - 1]))
                print(f"  the masked entry: out bitwise unchanged {same}, "
                      f"a_tilde -inf {above}", flush=True)
                if not (same and above):
                    raise AssertionError("a wholly masked table entry "
                                         "changed the output")
        o1, s1 = K.block_sparse_attention_single_cuda(
            q[0], k[0], v[0], s0idx, s0cnt, block_size=bs)
        o2, s2 = K.block_sparse_attention_single_plain(
            q[0], k[0], v[0], s0idx, s0cnt, block_size=bs)
        check("block_sparse_attn_single [window masks] out", max_err(o1, o2),
              TOL[("out", dn)])
        check("  stats", a_tilde_err(s1, s2), TOL[("a_tilde", dn)])
        fold("block_sparse_attn_single", max_err(o1, o2))

        ck = torch.zeros((b, hkv, s, d), dtype=dtype, device=dev)
        cv = torch.zeros_like(ck)
        ck[:, :, :n], cv[:, :, :n] = k, v
        for c in (ck, cv):
            c[:, :, n:pos + 1] = torch.randn(
                (b, hkv, pos + 1 - n, d), generator=gen, device=dev).to(dtype)
        qd = q[:, :, -1].contiguous()
        pool_k, pool_v = ((torch.randn((num_pages, hkv, bs, d), generator=gen,
                                       device=dev) * 0.5).to(dtype)
                          for _ in range(2))
        for pool, x in ((pool_k, ck), (pool_v, cv)):
            pool[table.reshape(-1).long()] = x.reshape(
                b, hkv, nbs, bs, d).transpose(1, 2).reshape(-1, hkv, bs, d)
        o3 = K.flash_decode_sparse_cuda(qd, ck, cv, didx, dcnt, keep, valid)
        p3 = K.decode_plan_einsum_sliced(qd, ck, cv, plan, valid)
        o4 = K.flash_decode_sparse_paged_cuda(qd, pool_k, pool_v, table,
                                              didx, dcnt, keep, valid)
        p4 = decode_plan_einsum_sliced_paged(qd, pool_k, pool_v, table,
                                             plan, valid)
        finite = bool(torch.isfinite(o3).all() and torch.isfinite(o4).all())
        print(f"  decode under the window band: outputs finite {finite}",
              flush=True)
        if not finite:
            raise AssertionError("hidden kept blocks gave non-finite output")
        for name, got, ref in (("decode_attn", o3, p3),
                               ("decode_attn_paged", o4, p4)):
            check(f"  {name} out", max_err(got, ref), TOL[("out", dn)])
            fold(name, max_err(got, ref))
        if dtype != torch.bfloat16:
            continue

        # times at bf16 beside bounds (the formulas of phases 2, 5 and 7)
        elt = q.element_size()
        pairs = bs * (n - bs) + bs * (bs + 1) // 2
        sb = bound(b * h * bs * d * elt + b * hkv * n * d * elt
                   + b * h * bs * n * 4, 2.0 * d * b * h * pairs, dtype)
        vis = K.table_block_mask(sidx, scnt, nb)
        entries, tiles = bsa_work(vis, g, bs, 0)
        bb = bound(2 * b * h * n * d * elt + 2 * tiles * bs * d * elt
                   + sidx.numel() * 4 + scnt.numel() * 4 + b * h * nb * nb * 4,
                   4.0 * d * entries, dtype)
        e0, t0_ = bsa_work(vis[:1], g, bs, 0)
        b6 = bound(2 * h * n * d * elt + 2 * t0_ * bs * d * elt
                   + s0idx.numel() * 4 + s0cnt.numel() * 4 + h * nb * nb * 4,
                   4.0 * d * e0, dtype)
        ntok = valid.reshape(b, 1, nbs, bs).sum(-1)
        listed = K.table_block_mask(didx, dcnt, nbs)
        kept_tok = float(((keep & listed[..., None]).float()
                          * ntok[..., None]).sum())
        db = bound(2 * b * h * d * elt + 2 * float(dcnt.sum()) * bs * d * elt
                   + didx.numel() * 4 + dcnt.numel() * 4 + keep.numel()
                   + valid.numel(), 4.0 * d * kept_tok, dtype)
        kwg = dict(block_size=bs, stats_gate=decision.use_dense)
        times = {
            "strip": (lambda: K.strip_scores_cuda(q, k, bs), sb, 20),
            "block_sparse_attn": (lambda: K.block_sparse_attention_cuda(
                q, k, v, sidx, scnt, **kwg), bb, 10),
            "block_sparse_attn_single": (
                lambda: K.block_sparse_attention_single_cuda(
                    q[0], k[0], v[0], s0idx, s0cnt, block_size=bs), b6, 10),
            "decode_attn": (lambda: K.flash_decode_sparse_cuda(
                qd, ck, cv, didx, dcnt, keep, valid), db, 50),
            "decode_attn_paged": (lambda: K.flash_decode_sparse_paged_cuda(
                qd, pool_k, pool_v, table, didx, dcnt, keep, valid), db, 50),
        }
        for name, (fn, bnd, reps) in times.items():
            ms = cuda_ms(fn, reps)
            dms = device_ms(fn, 10)
            out[name].update(ms=ms, device_ms=dms, bound_ms=bnd[0],
                             bound_by=bnd[1])
            print(f"  {name} bf16 [G=6, window]: {ms:.4f} ms (device "
                  f"{dms} ms), bound {bnd[0]:.4f} by {bnd[1]}, bound_frac "
                  f"{bnd[0] / ms:.4f}", flush=True)
    return out


def phase14() -> dict:
    """Phase 14: Mixtral 8x22B at full width, 4 of its 56 layers: the
    kernels at G = 6 under window masks, a batch serve against its plain
    decode twin, and a paged serve with prefix sharing against the same
    serve without.  Returns the kernels' largest errors."""
    import torch
    print("== phase 14: Mixtral 8x22B (MoE, sliding window) at full width",
          flush=True)
    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    model, params = load_model(MIXTRAL, MIXTRAL_LAYERS)
    cfg = model.cfg
    layers = cfg.num_layers
    rng = np.random.default_rng(SEED + 14)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    toks = np.zeros((len(prompts), SEQ), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    res = check_mixtral_kernels(model, params,
                                torch.as_tensor(toks, device=model.device),
                                torch.tensor(PROMPT_LENS, device=model.device))
    torch.cuda.empty_cache()

    print(f"Mixtral batch serve: prompts {PROMPT_LENS}, {MIXTRAL_NEW} new "
          "tokens", flush=True)
    runs = serve_against_plain_decode(model, params, prompts, MIXTRAL_NEW,
                                      MIXTRAL)
    st = runs["auto"][0][0].pattern_stats
    wd, share = window_skip_share(cfg, SEQ // cfg.share_prefill.block_size,
                                  cfg.share_prefill.block_size,
                                  st["block_density"])
    print(f"  block density {st['block_density']:.4f} (the window's mask "
          f"alone {wd:.4f}); the window's share of the skipped blocks "
          f"{share:.4f}; decode traffic fraction "
          f"{st.get('decode_traffic_fraction', float('nan')):.4f}",
          flush=True)
    res["serve"] = {"block_density": st["block_density"],
                    "window_density": wd, "window_skip_share": share,
                    "launches": runs["auto"][2]}
    del runs
    torch.cuda.empty_cache()

    # three requests, two of one prompt, through the paged scheduler
    shared, own = prompts
    offon = {}
    for sharing in (False, True):
        run = scheduler_serve(model, params, [shared, shared, own],
                              [MIXTRAL_NEW] * 3, paged=True,
                              prefix_sharing=sharing)
        report_scheduler_serve(f"Mixtral paged serve, prefix sharing "
                               f"{'on' if sharing else 'off'}", run)
        offon[sharing] = run
    res["prefix"] = check_prefix_runs(
        "Mixtral paged serve", offon[False], offon[True],
        [False, True, False], MIXTRAL_PREFIX_EXPECT,
        {"strip": 2 * layers, "block_sparse_attn": 2 * layers,
         "decode_attn_paged": layers * _decode_steps(offon[True])},
        {"strip": 3 * layers, "block_sparse_attn": 3 * layers,
         "decode_attn_paged": layers * _decode_steps(offon[False])})
    del offon, run
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, params
    torch.cuda.empty_cache()
    print(f"phase 14: {time.time() - t:.1f} s, peak device memory "
          f"{peak:.2f} GiB ({nvidia_smi()}); " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- phase 15

QWEN_VL = "qwen2-vl-72b"
QWEN_VL_LAYERS = 8          # of 80: 9.5 B parameters, 19.0 GB in bf16
VL_NEW = 8
VL_OFFSETS = (2048, 4096)   # each row's image offset o
VL_SERVE = 4                # phase 6's first four requests


def image_layout(cfg, seq: int, offsets, device):
    """Qwen2-VL's positions of image prompts (arXiv:2409.12191 §2.1), one
    row per offset ``o``: text at ``t = h = w = i``, then the config's
    ``num_visual_tokens`` positions as a square grid (``t = o``, ``h = o +
    r``, ``w = o + c``), then text from ``o + side``.  Returns positions
    ``(3, B, S)`` int64 and the visual rows ``(B, S)`` bool."""
    import torch
    side = int(round(cfg.vlm.num_visual_tokens ** 0.5))
    nv = side * side
    pos = torch.zeros((3, len(offsets), seq), dtype=torch.int64)
    vis = torch.zeros((len(offsets), seq), dtype=torch.bool)
    r, c = torch.arange(nv) // side, torch.arange(nv) % side
    for b, o in enumerate(offsets):
        pos[:, b, :o] = torch.arange(o)
        pos[0, b, o:o + nv] = o
        pos[1, b, o:o + nv] = o + r
        pos[2, b, o:o + nv] = o + c
        pos[:, b, o + nv:] = o + side + torch.arange(seq - o - nv)
        vis[b, o:o + nv] = True
    return pos.to(device), vis.to(device)


def _times(name: str, fn, bnd, reps: int, plain=None, lib=None) -> dict:
    """A kernel's bf16 time (CUDA events and profiler device time), its
    bound and fraction, printed; with the plain version's time."""
    ms = cuda_ms(fn, reps)
    r = dict(ms=ms, device_ms=device_ms(fn, 5), bound_ms=bnd[0],
             bound_by=bnd[1], library_ms=lib,
             plain_ms=None if plain is None else cuda_ms(plain, 1))
    print(f"  {name} bf16: {ms:.4f} ms (device {r['device_ms']} ms), bound "
          f"{bnd[0]:.4f} by {bnd[1]}, bound_frac {bnd[0] / ms:.4f}, plain "
          f"{r['plain_ms']} ms, library {lib} ms", flush=True)
    return r


def check_vlm_kernels(model, params, embeds, positions, prompt_lens) -> dict:
    """Phase 15 (a): B.1, B.2 and B.3 against their plain versions at
    Qwen2-VL's shapes (H = 64 over Hkv = 8, D = 128, N = 8192, B = 2) in
    float32 and bfloat16, on layer 0's post-M-RoPE q/k/v of the image
    prompts, its SharePrefill masks, and layer 0's DecodePlan tables of a
    real prefill over the grown cache; then their bf16 times beside their
    bounds (the formulas of phases 2 and 5)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.models.transformer import decode_valid_mask
    from repro_torch.serving import decode_plan as dplan

    cfg = model.cfg
    bs = cfg.share_prefill.block_size
    dev = embeds.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    q16, k16, v16 = layer0_qkv(model, params, None, positions, embeds)
    b, h, n, d = q16.shape
    hkv = k16.shape[1]
    g, nb = h // hkv, n // bs
    masks, decision = real_masks(model, q16, k16, v16)
    sidx, scnt = (x.contiguous() for x in K.compact_block_mask(masks))
    sp = model.default_share_prefill()
    s, pos = n + bs, n + 5
    nbs = s // bs
    pre = model.prefill(params, None, sp, method="share",
                        prompt_lens=prompt_lens, positions=positions,
                        embeds=embeds)
    plan = dplan.build_decode_plan(sp, pre.sp_state, cfg, prefill_len=n,
                                   cache_len=s).layer(0)
    del pre
    didx, dcnt, keep = (x.contiguous() for x in plan)
    valid = decode_valid_mask(s, pos, prompt_lens, n).contiguous()
    print(f"Qwen2-VL layer 0 under M-RoPE: B={b} H={h} Hkv={hkv} (G = {g}) "
          f"N={n} D={d} bs={bs}; decode S={s} pos={pos}, plan W="
          f"{didx.shape[-1]}", flush=True)
    out = {name: {"max_abs_err": 0.0}
           for name in ("strip", "block_sparse_attn", "decode_attn")}

    def fold(name, e):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q, k, v = (x.to(dtype) for x in (q16, k16, v16))
        print(f"[{dn}]", flush=True)
        e = max_err(K.strip_scores_cuda(q, k, bs), K.strip_scores(q, k, bs))
        check("strip [M-RoPE]", e, TOL[("strip", dn)])
        fold("strip", e)
        kw = dict(block_size=bs, stats_gate=decision.use_dense)
        o1, a1 = K.block_sparse_attention_cuda(q, k, v, sidx, scnt, **kw)
        o2, a2 = K.block_sparse_attention_plain(q, k, v, sidx, scnt, **kw)
        check("block_sparse_attn [M-RoPE masks] out", max_err(o1, o2),
              TOL[("out", dn)])
        check("  a_tilde", a_tilde_err(a1, a2), TOL[("a_tilde", dn)])
        fold("block_sparse_attn", max_err(o1, o2))
        ck = torch.zeros((b, hkv, s, d), dtype=dtype, device=dev)
        cv = torch.zeros_like(ck)
        ck[:, :, :n], cv[:, :, :n] = k, v
        for c in (ck, cv):
            c[:, :, n:pos + 1] = torch.randn(
                (b, hkv, pos + 1 - n, d), generator=gen, device=dev).to(dtype)
        qd = q[:, :, -1].contiguous()
        o3 = K.flash_decode_sparse_cuda(qd, ck, cv, didx, dcnt, keep, valid)
        p3 = K.decode_plan_einsum_sliced(qd, ck, cv, plan, valid)
        check("decode_attn [real plan] out", max_err(o3, p3),
              TOL[("out", dn)])
        fold("decode_attn", max_err(o3, p3))
        if dtype != torch.bfloat16:
            continue
        elt = q.element_size()
        pairs = bs * (n - bs) + bs * (bs + 1) // 2
        sb = bound(b * h * bs * d * elt + b * hkv * n * d * elt
                   + b * h * bs * n * 4, 2.0 * d * b * h * pairs, dtype)
        vis = K.table_block_mask(sidx, scnt, nb)
        entries, tiles = bsa_work(vis, g, bs, 0)
        bb = bound(2 * b * h * n * d * elt + 2 * tiles * bs * d * elt
                   + sidx.numel() * 4 + scnt.numel() * 4 + b * h * nb * nb * 4,
                   4.0 * d * entries, dtype)
        ntok = valid.reshape(b, 1, nbs, bs).sum(-1)
        listed = K.table_block_mask(didx, dcnt, nbs)
        kept_tok = float(((keep & listed[..., None]).float()
                          * ntok[..., None]).sum())
        db = bound(2 * b * h * d * elt + 2 * float(dcnt.sum()) * bs * d * elt
                   + didx.numel() * 4 + dcnt.numel() * 4 + keep.numel()
                   + valid.numel(), 4.0 * d * kept_tok, dtype)
        out["strip"].update(_times(
            "strip [H=64]", lambda: K.strip_scores_cuda(q, k, bs), sb, 20,
            lambda: K.strip_scores(q, k, bs)))
        out["block_sparse_attn"].update(_times(
            "block_sparse_attn [H=64]", lambda: K.block_sparse_attention_cuda(
                q, k, v, sidx, scnt, **kw), bb, 10))
        out["decode_attn"].update(_times(
            "decode_attn [H=64]", lambda: K.flash_decode_sparse_cuda(
                qd, ck, cv, didx, dcnt, keep, valid), db, 50))
    return out


def vlm_batch_decode(model, params, embeds, positions, prompt_lens) -> dict:
    """Phase 15 (b): ``Model.prefill(positions=, embeds=)`` of the image
    prompts, then ``VL_NEW`` greedy tokens (the first from the prefill,
    then decode steps with ``(3, B, 1)`` rope positions continuing each
    row's text ids, apart from the cache slots) through the prefill's
    DecodePlan, launch counts reset just before the prefill and read after
    the kernel decode; then the same decode with the plain version (no
    kernel launch): tokens near-tie aware; and one step roped by the cache
    slot instead, whose logits must move."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServingEngine
    from repro_torch.serving import decode_plan as dplan

    cfg = model.cfg
    n = embeds.shape[1]
    extra = cfg.share_prefill.block_size
    sp = model.default_share_prefill()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    pre = model.prefill(params, None, sp, method="share",
                        prompt_lens=prompt_lens, positions=positions,
                        embeds=embeds)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    density = float(pre.stats.block_density)
    cache0 = ServingEngine.grow_cache(pre.cache, n, extra)
    plan = dplan.build_decode_plan(sp, pre.sp_state, cfg, prefill_len=n,
                                   cache_len=n + extra)
    last = positions[:, :, -1:]
    kw = dict(plan=plan, prompt_lens=prompt_lens, prefill_len=n)
    runs = {}
    for impl in ("auto", "einsum"):
        if impl == "einsum":
            reset_launch_counts()
        cache = tuple(c.clone() for c in cache0)
        logits, steps, toks = pre.last_logits, [pre.last_logits], []
        t1 = time.time()
        for t in range(VL_NEW - 1):
            toks.append(logits.argmax(-1))
            logits, cache = model.decode(params, toks[-1][:, None], cache,
                                         n + t, positions=last + 1 + t,
                                         decode_impl=impl, **kw)
            steps.append(logits)
        toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        runs[impl] = (torch.stack(toks, 1).cpu().numpy(),
                      torch.stack(steps, 1).float(), launch_counts(),
                      time.time() - t1)
    layers = cfg.num_layers
    _expect_counts("Qwen2-VL prefill and kernel decode", runs["auto"][2],
                   {"strip": layers, "block_sparse_attn": layers,
                    "decode_attn": layers * (VL_NEW - 1)})
    _expect_counts("Qwen2-VL plain decode", runs["einsum"][2], {})
    (kt, kl, kc, ks), (pt, pl, _, ps) = runs["auto"], runs["einsum"]
    if not bool(torch.isfinite(kl).all()) or kl.shape != (
            len(pt), VL_NEW, cfg.vocab_size):
        raise AssertionError("Qwen2-VL: non-finite or misshapen logits")
    print(f"  prefill_s {prefill_s:.4f} (B={len(pt)}, N={n}), block density "
          f"{density:.4f}; {VL_NEW - 1} decode steps: kernel {ks:.3f} s, "
          f"plain {ps:.3f} s; launches {kc}", flush=True)
    tol = PER_SAMPLE_RTOL * float(pl[:, 0].abs().max())
    for i in range(len(pt)):
        verdict = greedy_agree(pt[i], pl[i].cpu().numpy(), kt[i], tol)
        print(f"  row {i}: kernel {kt[i].tolist()} plain {pt[i].tolist()} "
              f"-> {verdict}; max |logit kernel - plain| "
              f"{max_err(kl[i], pl[i]):.3e}", flush=True)
    tok = torch.as_tensor(kt[:, :1], device=embeds.device)
    by_rope, by_slot = (
        model.decode(params, tok, tuple(c.clone() for c in cache0), n,
                     positions=p, **kw)[0]
        for p in (last + 1, None))
    moved = max_err(by_rope, by_slot)
    print(f"  rope ids end at {int(last.max())} < slot {n}: a step roped by "
          f"the cache slot moves the logits by {moved:.3e}", flush=True)
    if not moved > 0:
        raise AssertionError("M-RoPE decode positions had no effect")
    return dict(prefill_s=prefill_s, block_density=density, counts=kc)


def phase15() -> dict:
    """Phase 15: Qwen2-VL 72B's backbone at full width, 8 of its 80
    layers, on image prompts under M-RoPE: the kernels against their plain
    versions, the batch path with ``embeds`` and 3-D positions against its
    plain decode, and a text-only paged scheduler serve bitwise its chunked
    twin at the first step's logits.  Returns the kernels' numbers."""
    import torch
    print("== phase 15: Qwen2-VL 72B (M-RoPE) at full width", flush=True)
    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    model, params = load_model(QWEN_VL, QWEN_VL_LAYERS)
    cfg, dev = model.cfg, model.device
    layers = cfg.num_layers
    rng = np.random.default_rng(SEED + 15)
    toks = np.zeros((len(PROMPT_LENS), SEQ), np.int64)
    for i, n in enumerate(PROMPT_LENS):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    tokens = torch.as_tensor(toks, device=dev)
    plens = torch.tensor(PROMPT_LENS, device=dev)
    positions, visual = image_layout(cfg, SEQ, VL_OFFSETS, dev)
    emb = params["embed"][tokens]
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    patches = torch.randn(emb.shape, generator=gen, device=dev) \
        * params["embed"].float().std()
    embeds = torch.where(visual[..., None], patches.to(emb.dtype), emb)
    del emb, patches
    differ = int((positions[0] != positions[1]).sum()
                 + (positions[1] != positions[2]).sum())
    print(f"image prompts: offsets {VL_OFFSETS}, {cfg.vlm.num_visual_tokens}"
          f" visual positions each, rope ids up to "
          f"{int(positions.max())} of {SEQ} slots; (t, h, w) differ at "
          f"{differ} entries", flush=True)
    res = check_vlm_kernels(model, params, embeds, positions, plens)
    torch.cuda.empty_cache()
    print(f"Qwen2-VL batch path with embeds: prompts {PROMPT_LENS}, "
          f"{VL_NEW} new tokens", flush=True)
    res["serve"] = vlm_batch_decode(model, params, embeds, positions, plens)
    del embeds
    torch.cuda.empty_cache()

    # text-only: phase 6's first four requests, one-shot and chunked
    rng = np.random.default_rng(SEED + 2)
    reqs = PAGED_REQUESTS[:VL_SERVE]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n, _ in reqs]
    news = [m for _, m in reqs]
    runs = {}
    for label, extra in (("one-shot", {}), ("chunked",
                                            {"prefill_chunk": CHUNK})):
        run = scheduler_serve(model, params, prompts, news, paged=True,
                              num_pages=NUM_PAGES, **extra)
        report_scheduler_serve(f"Qwen2-VL text-only paged serve ({label})",
                               run)
        check_paged_run(run, f"Qwen2-VL {label} serve")
        runs[label] = run
    one, chunked = runs["one-shot"], runs["chunked"]
    eng = one["eng"]
    _expect_counts("Qwen2-VL one-shot serve", one["counts"], {
        "strip": layers * VL_SERVE, "block_sparse_attn": layers * VL_SERVE,
        "decode_attn_paged": layers * _decode_steps(one)})
    chunks = sum(eng._bucket(len(p)) // CHUNK for p in prompts)
    _expect_counts("Qwen2-VL chunked serve", chunked["counts"], {
        "strip": layers * VL_SERVE, "block_sparse_attn": layers * chunks,
        "decode_attn_paged": layers * _decode_steps(chunked)})
    first, ref_first = chunked["probe"].first, one["probe"].first
    bitwise = set(first) == set(ref_first) and all(
        torch.equal(first[k], ref_first[k]) for k in first)
    print(f"  chunked: first-step logits bitwise the one-shot serve's "
          f"{bitwise}", flush=True)
    if not bitwise:
        raise AssertionError("Qwen2-VL: chunked first-step logits differ "
                             "from the one-shot serve's")
    for a, c in zip(one["reqs"], chunked["reqs"]):
        if a.output_tokens.tolist() != c.output_tokens.tolist():
            raise AssertionError(f"Qwen2-VL chunked serve: request {a.uid} "
                                 "tokens differ from the one-shot serve's")
    print("  chunked: greedy tokens identical to the one-shot serve's",
          flush=True)
    del runs, one, chunked
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, params
    torch.cuda.empty_cache()
    print(f"phase 15: {time.time() - t:.1f} s, peak device memory "
          f"{peak:.2f} GiB ({nvidia_smi()}); " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- phase 16

DEEPSEEK = "deepseek-v2-236b"
DEEPSEEK_LAYERS = 3     # of 60: the dense prefix layer and 2 MoE layers,
                        # 9.3 B parameters, 18.7 GB in bf16
DEEPSEEK_NEW = 8
# the body the dispatch picks at the MLA widths (csrc/strip.cu::repro_strip,
# csrc/block_sparse_attn.cu::by_dim) by dtype, bfloat16 then float32,
# printed beside what the profiler sees (in some long processes, nothing)
MLA_BODY = {"strip": ("strip_tc_kernel<192, pass> (tensor cores)",
                      "strip_f32_kernel<float, pass> (CUDA cores)"),
            "bsa": ("bsa_tc_kernel<bs, 192, 128, mode> (tensor cores)",
                    "bsa_f32_kernel<bs, 192, 128, mode> (CUDA cores)")}


def mla_layer0_qkv(model, params, tokens):
    """Layer 0's decompressed q and k (B, H, N, qk_nope + qk_rope) and v
    (B, H, N, v_head_dim), as MLA prefill computes them."""
    import torch
    from repro_torch.models import common, mla
    cfg = model.cfg
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    layer = params["layers"][0]
    h = common.rmsnorm(layer["ln1"], params["embed"][tokens],
                       cfg.rms_norm_eps)
    q, k, v, _, _ = mla.mla_qkv(layer["attn"], h, cfg, positions)
    return q.contiguous(), k.contiguous(), v.contiguous()


def bodies(fn, reps: int = 5) -> dict:
    """The port's device functions one call of ``fn`` runs (the profiler's
    names, shortened to the template) and each one's device ms per call.
    A strip call must run both its passes (the partial-stats kernel
    ``<·, 1>`` and the normalised write ``<·, 2>``), once each a call."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with traced([ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, counts = {}, {}
    for e in prof.key_averages():
        if kernel_group(e.key) in KERNELS and _device_us(e) > 0:
            m = re.search(r"\w+_kernel<[^>]*>", e.key)
            name = m.group(0) if m else e.key[:60]
            out[name] = out.get(name, 0.0) + _device_us(e) / 1e3 / reps
            counts[name] = counts.get(name, 0) + e.count
    strips = sorted(n for n in out if _STRIP.search(n))
    if strips and ([n[-2] for n in strips] != ["1", "2"]
                   or any(counts[n] != reps for n in strips)):
        raise AssertionError(f"a strip call ran {counts}, expected both "
                             f"passes once each in {reps} calls")
    return dict(sorted(out.items()))


def sdpa_by_backend(q, k, v, mask, reps: int) -> dict:
    """``scaled_dot_product_attention`` under each fused backend: its time,
    or why it refused (the first warning it gave, else its error)."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "FLASH_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            out[name] = "absent in this torch"
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                with sdpa_kernel(backend):
                    out[name] = cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask), reps)
            except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
                why = [str(w.message).split("(Triggered")[0].strip()
                       for w in caught] + [str(exc).splitlines()[0]]
                out[name] = "refused: " + " | ".join(
                    dict.fromkeys(w for w in why if w))[:400]
                torch.cuda.empty_cache()
    return out


def check_mla_kernels(model, params, tokens) -> dict:
    """Phase 16 (a): B.1 at D = 192, B.2 and B.6 at Dqk = 192, Dv = 128
    against their plain versions in float32 and bfloat16, on layer 0's
    decompressed q/k/v of the two prompts (H = Hkv = 128, N = 8192, B = 2)
    and its SharePrefill masks (B.6 on sample 0), bf16 outputs also row by
    row within ``ROW_ULPS`` (a plain output at the wrong scale must fail
    that bound); the bodies each ran;
    then their bf16 times beside their bounds (QK^T's products at Dqk,
    PV's at Dv) and fused SDPA on sample 0's masked problem where a
    backend takes Dqk != Dv, beside B.2 at B = 1."""
    import torch
    from repro_torch import kernels as K

    cfg = model.cfg
    bs = cfg.share_prefill.block_size
    dev = tokens.device
    q16, k16, v16 = mla_layer0_qkv(model, params, tokens)
    b, h, n, dqk = q16.shape
    dv = v16.shape[-1]
    nb = n // bs
    print(f"DeepSeek-V2 layer 0 (MLA, decompressed): B={b} H=Hkv={h} N={n} "
          f"Dqk={dqk} Dv={dv} bs={bs}", flush=True)
    masks, decision = real_masks(model, q16, k16, v16)
    sidx, scnt = (x.contiguous() for x in K.compact_block_mask(masks))
    s0idx, s0cnt = (x.contiguous() for x in K.compact_block_mask(masks[0]))
    names = ("strip", "block_sparse_attn", "block_sparse_attn_single")
    out = {name: {"max_abs_err": 0.0} for name in names}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q, k, v = (x.to(dtype) for x in (q16, k16, v16))
        print(f"[{dn}]", flush=True)
        kw = dict(block_size=bs, stats_gate=decision.use_dense)
        calls = {
            "strip": lambda: K.strip_scores_cuda(q, k, bs),
            "block_sparse_attn": lambda: K.block_sparse_attention_cuda(
                q, k, v, sidx, scnt, **kw),
            "block_sparse_attn_single":
                lambda: K.block_sparse_attention_single_cuda(
                    q[0], k[0], v[0], s0idx, s0cnt, block_size=bs)}
        for name, fn in calls.items():
            body = MLA_BODY["strip" if name == "strip" else "bsa"][
                dtype == torch.float32]
            seen = bodies(fn)
            print(f"  {name} [{dn}]: {body} by the dispatch rule; the "
                  "profiler saw " + ", ".join(
                      f"{n} {ms:.4f} ms" for n, ms in seen.items()),
                  flush=True)
            if not seen:
                raise AssertionError(f"{name}: no device kernel traced")
        e = max_err(calls["strip"](), K.strip_scores(q, k, bs))
        check(f"strip [D={dqk}]", e, TOL[("strip", dn)])
        out["strip"]["max_abs_err"] = max(out["strip"]["max_abs_err"], e)
        o1, a1 = calls["block_sparse_attn"]()
        o2, a2 = K.block_sparse_attention_plain(q, k, v, sidx, scnt, **kw)
        if o1.shape != (b, h, n, dv):
            raise AssertionError(f"B.2 output {tuple(o1.shape)}")
        e2 = max_err(o1, o2)
        check(f"block_sparse_attn [{dqk}/{dv}] out", e2, TOL[("out", dn)])
        check("  a_tilde", a_tilde_err(a1, a2), TOL[("a_tilde", dn)])
        if dtype == torch.bfloat16:
            out["block_sparse_attn"]["row_ulps"] = check_rows(
                "  rows", o1, o2)
            top = o2.float().abs().amax(-1)
            print(f"  |out| (plain): mean {float(o2.float().abs().mean()):.4f}"
                  f", row max median {float(top.median()):.4f}, min "
                  f"{float(top.min()):.4f}, max {float(top.max()):.4f}",
                  flush=True)
            del top
        o1, s1 = calls["block_sparse_attn_single"]()
        o2, s2 = K.block_sparse_attention_single_plain(
            q[0], k[0], v[0], s0idx, s0cnt, block_size=bs)
        e6 = max_err(o1, o2)
        check(f"block_sparse_attn_single [{dqk}/{dv}] out", e6,
              TOL[("out", dn)])
        check("  stats", a_tilde_err(s1, s2), TOL[("a_tilde", dn)])
        if dtype == torch.bfloat16:
            out["block_sparse_attn_single"]["row_ulps"] = check_rows(
                "  rows", o1, o2)
            # the row bound must reject a body scaled by 1/sqrt(Dv): the
            # plain version on q scaled by sqrt(Dqk / Dv)
            wrong, _ = K.block_sparse_attention_single_plain(
                (q[0].float() * (dqk / dv) ** 0.5).to(dtype), k[0], v[0],
                s0idx, s0cnt, block_size=bs)
            u = row_ulp_err(wrong, o2)
            print(f"  rows at the scale 1/sqrt(Dv) (a control): worst "
                  f"{u:.2f} ulps, {'rejected' if u > ROW_ULPS else 'PASSED'}"
                  f" by the bound", flush=True)
            if u <= ROW_ULPS:
                raise AssertionError("the row bound passes a wrong scale")
            del wrong
        for name, e in (("block_sparse_attn", e2),
                        ("block_sparse_attn_single", e6)):
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)
        del o1, o2, a1, a2, s1, s2
        if dtype != torch.bfloat16:
            continue
        elt = q.element_size()
        pairs = bs * (n - bs) + bs * (bs + 1) // 2
        sb = bound(b * h * bs * dqk * elt + b * h * n * dqk * elt
                   + b * h * bs * n * 4, 2.0 * dqk * b * h * pairs, dtype)
        vis = K.table_block_mask(sidx, scnt, nb)

        def bsa_bound(vis, idx, cnt):
            bb_, hh = vis.shape[:2]
            entries, tiles = bsa_work(vis, 1, bs, 0)
            return bound(bb_ * hh * n * (dqk + dv) * elt
                         + tiles * bs * (dqk + dv) * elt + idx.numel() * 4
                         + cnt.numel() * 4 + bb_ * hh * nb * nb * 4,
                         2.0 * (dqk + dv) * entries, dtype)
        out["strip"].update(_times(
            f"strip [D={dqk}, H={h}]", calls["strip"], sb, 20,
            lambda: K.strip_scores(q, k, bs)))
        out["block_sparse_attn"].update(_times(
            f"block_sparse_attn [{dqk}/{dv}, H={h}]", calls["block_sparse_attn"],
            bsa_bound(vis, sidx, scnt), 10,
            lambda: K.block_sparse_attention_plain(q, k, v, sidx, scnt,
                                                   **kw)))
        b6 = bsa_bound(vis[:1], s0idx, s0cnt)
        out["block_sparse_attn_single"].update(_times(
            f"block_sparse_attn_single [{dqk}/{dv}, sample 0]",
            calls["block_sparse_attn_single"], b6, 10,
            lambda: K.block_sparse_attention_single_plain(
                q[0], k[0], v[0], s0idx, s0cnt, block_size=bs)))
        b1 = cuda_ms(lambda: K.block_sparse_attention_cuda(
            q[:1], k[:1], v[:1], sidx[:1].contiguous(),
            scnt[:1].contiguous(), block_size=bs,
            stats_gate=decision.use_dense[:1]), 10)
        torch.cuda.empty_cache()
        tok_mask = (vis[:1].repeat_interleave(bs, 2)
                    .repeat_interleave(bs, 3)
                    & torch.ones(n, n, dtype=torch.bool, device=dev).tril())
        sdpa = sdpa_by_backend(q[:1], k[:1], v[:1], tok_mask, 5)
        del tok_mask
        torch.cuda.empty_cache()
        timed = [ms for ms in sdpa.values() if isinstance(ms, float)]
        out["block_sparse_attn_single"]["library_ms"] = (
            min(timed) if timed else None)
        out["sdpa_sample0"] = sdpa
        out["block_sparse_attn"]["b1_ms"] = b1
        print(f"  SDPA on sample 0's masked problem (Dqk={dqk}, Dv={dv}): "
              + json.dumps(sdpa) + f"; B.2 at B = 1 {b1:.4f} ms, B.6 "
              f"{out['block_sparse_attn_single']['ms']:.4f} ms", flush=True)
    return out


@contextlib.contextmanager
def plain_prefill_kernels():
    """Within it, the dispatchers of B.1 and B.2 run the plain versions on
    CUDA tensors (a serve's plain twin); the kernels' launch counters stay
    untouched."""
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.kernels import strip
    saved = strip.strip_scores_cuda, bsa.block_sparse_attention_cuda
    strip.strip_scores_cuda = strip.strip_scores
    bsa.block_sparse_attention_cuda = bsa.block_sparse_attention_plain
    try:
        yield
    finally:
        strip.strip_scores_cuda, bsa.block_sparse_attention_cuda = saved


def plain_serve(model, params, prompts, new: int, seq: int,
                frames=None, **ecfg) -> dict:
    """A batch-path serve of ``prompts`` (``new`` greedy tokens each),
    launch counts reset just before and read just after (phases 16, 18,
    19, 20: MLA and the plain families serve through the batch path);
    ``frames`` (Whisper's stub frontend output) go to prefill as
    ``embeds``.  Returns the requests, the logits ``(B, steps, V)``, the
    counts, the wall time and the peak device memory."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    class Frames(LogitProbe):
        def prefill(self, *args, **kwargs):
            if frames is not None:
                kwargs["embeds"] = frames
            return super().prefill(*args, **kwargs)

    probe = Frames(model)
    eng = ServingEngine(probe, params, model.default_share_prefill(),
                        EngineConfig(**{**dict(method="share", max_batch=2,
                                               decode_sparse=True,
                                               seq_buckets=(seq,)), **ecfg}))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    eng.serve(reqs)
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    logits = torch.stack(probe.logits, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    st = reqs[0].pattern_stats
    print(f"  {json.dumps(ecfg) if ecfg else 'batch path'} "
          f"[{str(model.dtype)[6:]}, {model.device.type}]: {wall:.3f} s, "
          f"prefill_s {reqs[0].prefill_s:.4f}, decode_tokens_per_s "
          f"{reqs[0].decode_tokens_per_s:.3f}, block density "
          f"{st['block_density']:.4f}, shared/dense/vs "
          f"{st['num_shared']:.1f}/{st['num_dense']:.1f}/"
          f"{st['num_vs']:.1f}, peak {peak} GiB; launches {counts}",
          flush=True)
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            len(prompts), new, model.cfg.vocab_size):
        raise AssertionError(f"{model.cfg.name}: non-finite or misshapen "
                             "logits")
    return dict(reqs=reqs, logits=logits, counts=counts, wall=wall,
                peak=peak)


def moe_share_of_prefill(model, params, tokens, prompt_lens) -> tuple:
    """One ``Model.prefill`` with every MoE FFN call timed between device
    synchronisations: (prefill s, MoE FFN s)."""
    import torch
    from repro_torch.models import moe
    spent = [0.0]
    apply = moe.moe_apply

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.time()
        out = apply(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.time() - t
        return out

    moe.moe_apply = timed
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        model.prefill(params, tokens, model.default_share_prefill(),
                      prompt_lens=prompt_lens)
        torch.cuda.synchronize()
    finally:
        moe.moe_apply = apply
    return time.time() - t0, spent[0]


def phase16() -> dict:
    """Phase 16: DeepSeek-V2 236B at full width, 3 of its 60 layers (the
    dense prefix layer and 2 MoE layers): B.1, B.2 and B.6 at the MLA
    widths against their plain versions, the engine's batch serve against
    its plain-prefill twin with exact launches, ``scheduler=True`` on the
    batch path, and the per-sample path.  Returns the kernels' numbers."""
    import torch
    from repro_torch.serving import SlotScheduler
    print("== phase 16: DeepSeek-V2 236B (MLA, MoE) at full width",
          flush=True)
    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    model, params = load_model(DEEPSEEK, DEEPSEEK_LAYERS)
    cfg, dev = model.cfg, model.device
    layers = cfg.num_layers
    m = cfg.mla
    print(f"  MLA: kv_lora {m.kv_lora_rank}, q_lora {m.q_lora_rank}, "
          f"qk_nope {m.qk_nope_head_dim} + qk_rope {m.qk_rope_head_dim}, v "
          f"{m.v_head_dim}; MoE {cfg.moe.num_experts} experts top "
          f"{cfg.moe.top_k} of width {cfg.moe.expert_d_ff} + "
          f"{cfg.moe.num_shared_experts} shared; prefix FFN {cfg.d_ff}",
          flush=True)
    rng = np.random.default_rng(SEED + 16)
    prompts = [rng.integers(0, cfg.vocab_size, SEQ) for _ in range(2)]
    tokens = torch.as_tensor(np.stack(prompts), device=dev)
    res = check_mla_kernels(model, params, tokens)
    torch.cuda.empty_cache()

    print(f"DeepSeek-V2 batch serve: 2 x {SEQ} prompts, {DEEPSEEK_NEW} new "
          "tokens", flush=True)
    serve = lambda **kw: (lambda r: (r["reqs"], r["logits"], r["counts"]))(
        plain_serve(model, params, prompts, DEEPSEEK_NEW, SEQ, **kw))
    kr, kl, kc = serve()
    _expect_counts("DeepSeek-V2 batch serve", kc,
                   {"strip": layers, "block_sparse_attn": layers})
    with plain_prefill_kernels():
        pr, pl, pc = serve()
    _expect_counts("DeepSeek-V2 plain serve", pc, {})
    tol = PER_SAMPLE_RTOL * float(pl[:, 0].abs().max())
    for i, (a, c) in enumerate(zip(pr, kr)):
        verdict = greedy_agree(a.output_tokens, pl[i].cpu().numpy(),
                               c.output_tokens, tol)
        print(f"  request {a.uid}: kernel {c.output_tokens.tolist()} plain "
              f"{a.output_tokens.tolist()} -> {verdict}; max |logit "
              f"kernel - plain| {max_err(kl[i], pl[i]):.3e}", flush=True)
    del pl
    run = SlotScheduler.run

    def refuse(self):
        raise AssertionError("DeepSeek-V2 reached the slot scheduler")
    SlotScheduler.run = refuse
    try:
        sr, sl, sc = serve(scheduler=True)
    finally:
        SlotScheduler.run = run
    _expect_counts("DeepSeek-V2 scheduler=True serve", sc, kc)
    same = all(a.output_tokens.tolist() == c.output_tokens.tolist()
               for a, c in zip(kr, sr))
    print(f"  scheduler=True: the batch path, tokens identical {same}, "
          f"logits bitwise {bool(torch.equal(kl, sl))}", flush=True)
    if not same:
        raise AssertionError("DeepSeek-V2: scheduler=True changed tokens")
    del sl

    print("DeepSeek-V2 per-sample path (attn_impl=kernel)", flush=True)
    cr, cl, cc = serve(attn_impl="kernel")
    _expect_counts("DeepSeek-V2 per-sample serve", cc,
                   {"strip": layers * 2,
                    "block_sparse_attn_single": layers * 2})
    tol = PER_SAMPLE_RTOL * float(kl[:, 0].abs().max())
    for i, (a, c) in enumerate(zip(kr, cr)):
        verdict = greedy_agree(a.output_tokens, kl[i].cpu().numpy(),
                               c.output_tokens, tol)
        print(f"  request {a.uid}: per-sample {c.output_tokens.tolist()} "
              f"batched {a.output_tokens.tolist()} -> {verdict}; "
              f"first-step max |logit delta| {max_err(cl[i, 0], kl[i, 0]):.3e}",
              flush=True)
    del cl, kl
    pre_s, moe_s = moe_share_of_prefill(
        model, params, tokens, torch.tensor([SEQ, SEQ], device=dev))
    st = kr[0].pattern_stats
    res["serve"] = {"prefill_s": kr[0].prefill_s,
                    "block_density": st["block_density"],
                    "launches": kc, "per_sample_launches": cc,
                    "moe_share_of_prefill": moe_s / pre_s}
    print(f"  prefill_s {kr[0].prefill_s:.4f}, block density "
          f"{st['block_density']:.4f}; MoE FFN {moe_s:.3f} s of a "
          f"synchronised {pre_s:.3f} s prefill ({moe_s / pre_s:.3f})",
          flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, params
    torch.cuda.empty_cache()
    print(f"phase 16: {time.time() - t:.1f} s, peak device memory "
          f"{peak:.2f} GiB ({nvidia_smi()}); " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- phase 17

CLUSTER_BLOCK = 64          # the reference's bench capture block
CLUSTER_EPOCHS = 200        # and its cluster_heads settings
CLUSTER_MIN_SIZE = 2


def layer_decisions(model, params, tokens, sp, keep=()) -> tuple:
    """Layer by layer through the batch prefill of ``tokens`` under ``sp``:
    each layer's shared, dense and VS head counts (over the batch), and for
    the layers in ``keep`` the q/k/v, masks and decision its attention
    ran on (the masks ``layer_prefill`` builds from the same state)."""
    import torch
    from repro_torch.core.share_attention import build_share_masks
    from repro_torch.models import attention, common, transformer
    cfg = model.cfg
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = params["embed"][tokens]
    state = sp.init_state(b, s, device=tokens.device)
    ids = sp.layer_cluster_ids(device=tokens.device)
    counts, kept = [], {}
    for li, layer in enumerate(params["layers"]):
        h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
        q, k, v = common.gqa_qkv(layer["attn"], h)
        q, k = attention.rope_qk(q, k, positions, cfg)
        masks, dec = build_share_masks(q, k, state, ids[li],
                                       cfg.share_prefill)
        counts.append([int(dec.use_shared.sum()), int(dec.use_dense.sum()),
                       int(dec.use_vs.sum())])
        if li in keep:
            kept[li] = (q.contiguous(), k.contiguous(), v.contiguous(),
                        masks, dec)
        x, _, state, _ = transformer.layer_prefill(
            layer, x, cfg, positions, sp, state, ids[li], method="share",
            attn_impl="auto")
    return counts, kept


def check_clustered_b2(label: str, q16, k16, v16, masks, dec, bs: int,
                       phase2) -> dict:
    """B.2 against its plain version under one layer's clustered masks in
    float32 and bfloat16 (``TOL``), then its bf16 time beside its bound and
    phase 2's row."""
    import torch
    from repro_torch import kernels as K
    idx, cnt = (x.contiguous() for x in K.compact_block_mask(masks))
    b, h, n, d = q16.shape
    g, nb = h // k16.shape[1], n // bs
    out = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q, k, v = (x.to(dtype) for x in (q16, k16, v16))
        kw = dict(block_size=bs, stats_gate=dec.use_dense)
        o1, a1 = K.block_sparse_attention_cuda(q, k, v, idx, cnt, **kw)
        o2, a2 = K.block_sparse_attention_plain(q, k, v, idx, cnt, **kw)
        check(f"block_sparse_attn [{label}, {dn}] out", max_err(o1, o2),
              TOL[("out", dn)])
        check("  a_tilde", a_tilde_err(a1, a2), TOL[("a_tilde", dn)])
        out["max_abs_err"] = max(out["max_abs_err"], max_err(o1, o2))
    elt = q.element_size()
    vis = K.table_block_mask(idx, cnt, nb)
    entries, tiles = bsa_work(vis, g, bs, 0)
    bb = bound(2 * b * h * n * d * elt + 2 * tiles * bs * d * elt
               + idx.numel() * 4 + cnt.numel() * 4 + b * h * nb * nb * 4,
               4.0 * d * entries, q.dtype)
    density = float(vis.float().sum() / (b * h * nb * (nb + 1) / 2))
    out.update(_times(f"block_sparse_attn [{label}, density {density:.4f}]",
                      lambda: K.block_sparse_attention_cuda(
                          q, k, v, idx, cnt, **kw), bb, 10))
    out["density"] = density
    if phase2:
        print(f"    beside phase 2's row 3 (trivial clustering, layer 0): "
              f"{phase2['ms']:.4f} ms (device {phase2['device_ms']:.4f} "
              f"ms), bound {phase2['bound_ms']:.4f}, frac "
              f"{phase2['bound_ms'] / phase2['ms']:.4f}", flush=True)
    return out


def phase17(model, params, prompts, tokens, phase2=None) -> dict:
    """Phase 17: offline head clustering (``core/clustering.py``) on
    llama3-8b-262k at full width, driving SharePrefill across heads: the
    block attention maps of prompt 0, ``cluster_heads`` on the card at the
    reference's bench settings, the JSON artifact written and read back,
    then phase 4's serve under ``SharePrefill.from_clustering`` with exact
    launches beside the trivial clustering's serve and a plain-B.1/B.2
    serve under the same artifact, and B.2 under the clustered masks of
    layer 0 and of the layer with the most shared heads."""
    import torch
    from repro_torch.core.api import SharePrefill
    from repro_torch.core.clustering import cluster_heads
    from repro_torch.core.profile import capture_block_attention_maps
    print("== phase 17: offline head clustering, SharePrefill across heads",
          flush=True)
    t = time.time()
    cfg = model.cfg
    layers, bs = cfg.num_layers, cfg.share_prefill.block_size
    torch.cuda.synchronize()
    t0 = time.time()
    maps = capture_block_attention_maps(params, cfg, tokens[:1],
                                        block_size=CLUSTER_BLOCK)
    capture_s = time.time() - t0
    res = cluster_heads(torch.as_tensor(maps, device=tokens.device),
                        distance_threshold=None,
                        min_cluster_size=CLUSTER_MIN_SIZE,
                        ae_epochs=CLUSTER_EPOCHS)
    ids = res.cluster_ids
    sizes = sorted((int((ids == c).sum()) for c in range(res.num_clusters)),
                   reverse=True)
    print(f"  maps {maps.shape} {maps.dtype} of prompt 0; autoencoder "
          f"{res.epochs} epochs, final loss {res.final_loss:.6g}; threshold "
          f"{res.distance_threshold:.6g}; {res.num_clusters} clusters, noise "
          f"heads {int((ids < 0).sum())} of {ids.size}, sizes {sizes}; "
          f"seconds: capture {capture_s:.2f}, autoencoder "
          f"{res.seconds['autoencoder']:.2f}, agglomerative "
          f"{res.seconds['agglomerative']:.2f}", flush=True)
    del maps
    path = os.path.join(ROOT, "build", "phase17_clusters.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"cluster_ids": ids.tolist(),
                   "num_clusters": int(res.num_clusters)}, f)
    with open(path) as f:
        art = json.load(f)
    back = np.asarray(art["cluster_ids"], np.int32)
    if not (np.array_equal(back, ids)
            and art["num_clusters"] == res.num_clusters):
        raise AssertionError("the clustering artifact did not round-trip")
    spans = [c for c in range(res.num_clusters)
             if len(set(np.nonzero(ids == c)[1])) > 1]
    print(f"  artifact {os.path.relpath(path, ROOT)} round-trips; clusters "
          f"spanning two or more head indices: {len(spans)} of "
          f"{res.num_clusters}", flush=True)
    if not spans:
        raise AssertionError("no cluster holds two head indices")
    sp = SharePrefill.from_clustering(cfg.share_prefill, back,
                                      art["num_clusters"])
    trivial = model.default_share_prefill()

    want = {"strip": layers, "block_sparse_attn": layers,
            "decode_attn": layers * (NEW_TOKENS - 1)}
    # each clustering's decisions layer by layer first (these prefills
    # also warm the card up for the serves, run alone or late)
    per_layer = {label: layer_decisions(model, params, tokens, s)[0]
                 for label, s in (("trivial", trivial), ("clustered", sp))}
    runs = {}
    for label, s in (("clustered", sp), ("trivial", trivial)):
        run = serve_full(model, params, prompts, want, sp=s)
        _expect_counts(f"phase 17 {label} serve", run["counts"], want)
        counts = run["per_layer"] = per_layer[label]
        st = run["reqs"][0].pattern_stats
        print(f"  {label}: prefill_s {run['reqs'][0].prefill_s:.4f}, "
              f"density {st['block_density']:.4f}; shared/dense/vs heads "
              f"summed over layers and both rows "
              f"{[sum(c[i] for c in counts) for i in range(3)]}; per layer "
              + json.dumps(counts), flush=True)
        runs[label] = run
    with plain_prefill_kernels():
        plain = serve_full(model, params, prompts, {}, sp=sp)
    _expect_counts("phase 17 plain serve", plain["counts"],
                   {"decode_attn": layers * (NEW_TOKENS - 1)})
    kl = torch.stack(runs["clustered"]["logits"], 1)
    pl = torch.stack(plain["logits"], 1)
    tol = PER_SAMPLE_RTOL * float(pl[:, 0].abs().max())
    for i, (a, c) in enumerate(zip(plain["reqs"], runs["clustered"]["reqs"])):
        verdict = greedy_agree(a.output_tokens, pl[i].cpu().numpy(),
                               c.output_tokens, tol)
        print(f"  request {a.uid}: kernels {c.output_tokens.tolist()} plain "
              f"B.1/B.2 {a.output_tokens.tolist()} -> {verdict}; max |logit "
              f"kernel - plain| {max_err(kl[i], pl[i]):.3e}", flush=True)
    del kl, pl, plain

    counts = runs["clustered"]["per_layer"]
    top = max(range(layers), key=lambda li: counts[li][0])
    _, kept = layer_decisions(model, params, tokens, sp, keep=(0, top))
    out = {}
    for li in sorted(kept):
        q, k, v, masks, dec = kept[li]
        print(f"  layer {li}: shared/dense/vs {counts[li]}", flush=True)
        out[li] = check_clustered_b2(f"clustered layer {li}", q, k, v, masks,
                                     dec, bs, phase2)
    del kept
    torch.cuda.empty_cache()
    result = {"num_clusters": res.num_clusters,
              "noise": int((ids < 0).sum()), "sizes": sizes,
              "threshold": res.distance_threshold, "epochs": res.epochs,
              "final_loss": res.final_loss, "capture_s": capture_s,
              "seconds": res.seconds,
              "prefill_s": {k: r["reqs"][0].prefill_s
                            for k, r in runs.items()},
              "heads": {k: [sum(c[i] for c in r["per_layer"])
                            for i in range(3)] for k, r in runs.items()},
              "launches": runs["clustered"]["counts"],
              "block_sparse_attn": {f"layer {li}": r
                                    for li, r in out.items()}}
    print(f"phase 17: {time.time() - t:.1f} s ({nvidia_smi()}); "
          + json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------- phase 18

MAMBA = "mamba2-370m"
MAMBA_CHECK_SEQ = 2048      # the float32 recurrence check: S, then S + 1
# max |Δ| between prefill(S) + one decode and prefill(S + 1), float32 logits
# over 48 layers: the decode state is one cumsum, the prefill a chunk scan
MAMBA_STEP_TOL = 2e-3


def phase18() -> dict:
    """Phase 18: mamba2-370m (the attention-free SSM family) at full width,
    all 48 layers: the engine's batch serve of phase 4's prompt lengths
    with no kernel launched, ``scheduler=True`` on the batch path, the
    float32 recurrence (prefill then one decode against a longer prefill),
    and bf16 tokens against a float32 serve."""
    import torch
    from repro_torch.checkpoint import num_params
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import SlotScheduler
    print("== phase 18: Mamba-2 370M (SSM) at full width", flush=True)
    t = time.time()
    cfg = get_config(MAMBA)
    model = build_model(cfg, dtype=torch.bfloat16)
    t0 = time.time()
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(SEED))
    torch.cuda.synchronize()
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    print(f"{MAMBA}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"d_inner {d_inner}, {d_inner // s.head_dim} SSD heads of "
          f"{s.head_dim}, state {s.state_dim}, "
          f"chunk {s.chunk_size}, conv {s.conv_width}, vocab "
          f"{cfg.vocab_size}; {num_params(params) / 1e6:.1f} M params in "
          f"bf16, init {time.time() - t0:.2f} s; SharePrefill "
          f"{model.default_share_prefill().cfg.enabled}", flush=True)
    rng = np.random.default_rng(SEED + 18)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    with torch.no_grad():               # a warm-up prefill, untimed
        model.prefill(params, torch.as_tensor(
            np.stack([prompts[0]] * 2), device=model.device),
            model.default_share_prefill())
    bf = plain_serve(model, params, prompts, NEW_TOKENS, SEQ)
    _expect_counts("mamba2 serve", bf["counts"], {})
    run = SlotScheduler.run

    def refuse(self):
        raise AssertionError("mamba2 reached the slot scheduler")
    SlotScheduler.run = refuse
    try:
        sched = plain_serve(model, params, prompts, NEW_TOKENS, SEQ,
                            scheduler=True)
        _expect_counts("mamba2 serve", sched["counts"], {})
    finally:
        SlotScheduler.run = run
    same = all(a.output_tokens.tolist() == c.output_tokens.tolist()
               for a, c in zip(bf["reqs"], sched["reqs"]))
    print(f"  scheduler=True: the batch path, tokens identical {same}",
          flush=True)
    if not same:
        raise AssertionError("mamba2: scheduler=True changed tokens")
    del sched

    m32 = build_model(cfg, dtype=torch.float32)
    p32 = _to(params, torch.float32)        # the same weights, widened
    toks = torch.as_tensor(np.stack([p[:MAMBA_CHECK_SEQ + 1]
                                     for p in prompts]), device=m32.device)
    sp = m32.default_share_prefill()
    with torch.no_grad():
        head = m32.prefill(p32, toks[:, :MAMBA_CHECK_SEQ], sp)
        step, _ = m32.decode(p32, toks[:, MAMBA_CHECK_SEQ:], head.cache,
                             MAMBA_CHECK_SEQ)
        whole = m32.prefill(p32, toks, sp)
    err = max_err(step, whole.last_logits)
    check(f"float32 prefill({MAMBA_CHECK_SEQ}) + decode against prefill("
          f"{MAMBA_CHECK_SEQ + 1}) last logits (max |logit| "
          f"{float(whole.last_logits.abs().max()):.3f})", err,
          MAMBA_STEP_TOL)
    del head, step, whole
    torch.cuda.empty_cache()
    f32 = plain_serve(m32, p32, prompts, NEW_TOKENS, SEQ)
    _expect_counts("mamba2 serve", f32["counts"], {})
    # bf16 rounding over 48 layers: a flip is allowed where float32's top-2
    # margin is below twice the bf16 serve's first-step logit error
    first = max_err(bf["logits"][:, 0], f32["logits"][:, 0])
    for i, (a, c) in enumerate(zip(f32["reqs"], bf["reqs"])):
        verdict = greedy_agree(a.output_tokens,
                               f32["logits"][i].cpu().numpy(),
                               c.output_tokens, 2 * first)
        print(f"  request {a.uid}: bf16 {c.output_tokens.tolist()} float32 "
              f"{a.output_tokens.tolist()} -> {verdict}; first-step max "
              f"|logit bf16 - float32| {first:.3e}", flush=True)
    result = {"prefill_s": bf["reqs"][0].prefill_s,
              "decode_tokens_per_s": bf["reqs"][0].decode_tokens_per_s,
              "peak_gib": bf["peak"], "f32_prefill_s": f32["reqs"][0]
              .prefill_s, "step_err": err, "bf16_f32_first_err": first,
              "launches": bf["counts"]}
    del model, params, m32, p32, bf, f32
    torch.cuda.empty_cache()
    print(f"phase 18: {time.time() - t:.1f} s ({nvidia_smi()}); "
          + json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------- phase 19

HYBRID = "recurrentgemma-9b"


def ptxas_lines(stem: str, pattern: str) -> list:
    """Each kernel instance of ``csrc/<stem>.cu`` whose mangled name and
    template arguments match ``pattern``: (name<args>, registers, spill
    bytes), from the ptxas report the build wrote beside the library."""
    from repro_torch.kernels import _build
    lines = (_build._build_dir() / f"{stem}.ptxas.txt").read_text(
        ).splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?\d+"
                      r"((?:bsa|strip)_\w+?_kernel)I(\w+?)EEv", line)
        if not m or not re.search(pattern, m.group(1) + m.group(2)):
            continue
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        args = re.sub(r"Li(\d+)E", r" \1", re.sub(r"^\d+", "",
                                                     m.group(2))).strip()
        out.append((f"{m.group(1)}<{args}>", int(regs.group(1)),
                    int(spill.group(1))))
    return out


def hybrid_attn_qkv(model, params, tokens):
    """The first attention sublayer's (layer 2's) post-RoPE q (B, H, N, D)
    and k/v (B, Hkv, N, D), as the hybrid's prefill computes them."""
    import torch
    from repro_torch.models import attention, common, hybrid
    cfg = model.cfg
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    block = params["stack"][0]
    x = params["embed"][tokens]
    x, _ = hybrid._sub_forward(block["rec1"], x, cfg)
    x, _ = hybrid._sub_forward(block["rec2"], x, cfg)
    h = common.rmsnorm(block["attn"]["ln1"], x, cfg.rms_norm_eps)
    q, k, v = common.gqa_qkv(block["attn"]["mixer"], h)
    q, k = attention.rope_qk(q, k, positions, hybrid._attn_cfg(cfg))
    return q.contiguous(), k.contiguous(), v.contiguous()


def check_wide_kernels(label: str, model, q16, k16, v16, extra) -> dict:
    """Phases 19 and 20: B.1, B.2 and B.6 against their plain versions in
    float32 and bfloat16 on one layer's q/k/v and its SharePrefill masks
    (``extra`` ANDed in: the hybrid's window), bf16 outputs also row by row
    within ``ROW_ULPS``; the bodies each ran; then their bf16 times beside
    their bounds, and ``scaled_dot_product_attention`` under the tables'
    token mask per fused backend (K/V expanded over the group), at B = 2
    for B.2 and on sample 0 for B.6.  Returns each kernel's largest error
    and its numbers."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.ops import expand_kv

    cfg = model.cfg
    bs = cfg.share_prefill.block_size
    dev = q16.device
    b, h, n, d = q16.shape
    hkv = k16.shape[1]
    g, nb = h // hkv, n // bs
    masks, decision = real_masks(model, q16, k16, v16, extra)
    causal = torch.ones(nb, nb, dtype=torch.bool, device=dev).tril()
    print(f"{label}: B={b} H={h} Hkv={hkv} (G = {g}) N={n} D={d} bs={bs}; "
          f"masks keep {float(masks.sum()) / (b * h * float(causal.sum())):.4f}"
          " of the causal blocks", flush=True)
    sidx, scnt = (x.contiguous() for x in K.compact_block_mask(masks))
    s0idx, s0cnt = (x.contiguous() for x in K.compact_block_mask(masks[0]))
    names = ("strip", "block_sparse_attn", "block_sparse_attn_single")
    out = {name: {"max_abs_err": 0.0} for name in names}
    kw = dict(block_size=bs, stats_gate=decision.use_dense)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        q, k, v = (x.to(dtype) for x in (q16, k16, v16))
        print(f"[{dn}]", flush=True)
        calls = {
            "strip": lambda: K.strip_scores_cuda(q, k, bs),
            "block_sparse_attn": lambda: K.block_sparse_attention_cuda(
                q, k, v, sidx, scnt, **kw),
            "block_sparse_attn_single":
                lambda: K.block_sparse_attention_single_cuda(
                    q[0], k[0], v[0], s0idx, s0cnt, block_size=bs)}
        # the strip's body by dtype (csrc/strip.cu::repro_strip): tensor
        # cores in bf16 at D = 64 ... 256, CUDA cores in float32
        body = ("strip_tc_kernel<" if dtype == torch.bfloat16
                else "strip_f32_kernel<")
        for name, fn in calls.items():
            seen = bodies(fn)
            print(f"  {name} [{dn}]: the profiler saw " + ", ".join(
                f"{nm} {ms:.4f} ms" for nm, ms in seen.items()), flush=True)
            if not seen:
                raise AssertionError(f"{name}: no device kernel traced")
            if name == "strip" and not all(nm.startswith(body)
                                           for nm in seen):
                raise AssertionError(f"strip [{dn}] ran {sorted(seen)}, "
                                     f"expected {body}·>")
        so = calls["strip"]()
        e = max_err(so, K.strip_scores(q, k, bs))
        check(f"strip [D={d}, G={g}]", e, TOL[("strip", dn)])
        out["strip"]["max_abs_err"] = max(out["strip"]["max_abs_err"], e)
        # the key split depends on N alone: sample 0 alone is bitwise the
        # batch's first strip
        if not torch.equal(K.strip_scores_cuda(q[:1].contiguous(),
                                               k[:1].contiguous(), bs),
                           so[:1]):
            raise AssertionError(f"strip [D={d}, G={g}, {dn}]: sample 0 "
                                 "alone differs from the batch's")
        print(f"  strip [D={d}, G={g}, {dn}]: sample 0 alone bitwise the "
              "batch's", flush=True)
        del so
        o1, a1 = calls["block_sparse_attn"]()
        o2, a2 = K.block_sparse_attention_plain(q, k, v, sidx, scnt, **kw)
        e2 = max_err(o1, o2)
        check(f"block_sparse_attn [D={d}] out", e2, TOL[("out", dn)])
        check("  a_tilde", a_tilde_err(a1, a2), TOL[("a_tilde", dn)])
        if dtype == torch.bfloat16:
            out["block_sparse_attn"]["row_ulps"] = check_rows("  rows", o1,
                                                              o2)
        o1, s1 = calls["block_sparse_attn_single"]()
        o2, s2 = K.block_sparse_attention_single_plain(
            q[0], k[0], v[0], s0idx, s0cnt, block_size=bs)
        e6 = max_err(o1, o2)
        check(f"block_sparse_attn_single [D={d}] out", e6, TOL[("out", dn)])
        check("  stats", a_tilde_err(s1, s2), TOL[("a_tilde", dn)])
        if dtype == torch.bfloat16:
            out["block_sparse_attn_single"]["row_ulps"] = check_rows(
                "  rows", o1, o2)
        for name, e in (("block_sparse_attn", e2),
                        ("block_sparse_attn_single", e6)):
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)
        del o1, o2, a1, a2, s1, s2
        if dtype != torch.bfloat16:
            continue
        elt = q.element_size()
        pairs = bs * (n - bs) + bs * (bs + 1) // 2
        sb = bound(b * h * bs * d * elt + b * hkv * n * d * elt
                   + b * h * bs * n * 4, 2.0 * d * b * h * pairs, dtype)
        vis = K.table_block_mask(sidx, scnt, nb)

        def bsa_bound(vis, idx, cnt):
            bb_, hh = vis.shape[:2]
            entries, tiles = bsa_work(vis, g, bs, 0)
            return bound(2 * bb_ * hh * n * d * elt + 2 * tiles * bs * d * elt
                         + idx.numel() * 4 + cnt.numel() * 4
                         + bb_ * hh * nb * nb * 4, 4.0 * d * entries, dtype)
        kx, vx = expand_kv(k, v, h)
        libs = {}
        for key, sl in (("b2", slice(None)), ("b6", slice(0, 1))):
            tok_mask = (vis[sl].repeat_interleave(bs, 2)
                        .repeat_interleave(bs, 3)
                        & torch.ones(n, n, dtype=torch.bool,
                                     device=dev).tril())
            libs[key] = sdpa_by_backend(q[sl], kx[sl], vx[sl], tok_mask, 5)
            del tok_mask
            torch.cuda.empty_cache()
        del kx, vx
        lib = {key: min((ms for ms in r.values() if isinstance(ms, float)),
                        default=None) for key, r in libs.items()}
        out["strip"].update(_times(
            f"strip [D={d}, G={g}]", calls["strip"], sb, 20,
            lambda: K.strip_scores(q, k, bs)))
        out["block_sparse_attn"].update(_times(
            f"block_sparse_attn [D={d}, G={g}]", calls["block_sparse_attn"],
            bsa_bound(vis, sidx, scnt), 10,
            lambda: K.block_sparse_attention_plain(q, k, v, sidx, scnt,
                                                   **kw), lib["b2"]))
        out["block_sparse_attn_single"].update(_times(
            f"block_sparse_attn_single [D={d}, sample 0]",
            calls["block_sparse_attn_single"],
            bsa_bound(vis[:1], s0idx, s0cnt), 10,
            lambda: K.block_sparse_attention_single_plain(
                q[0], k[0], v[0], s0idx, s0cnt, block_size=bs), lib["b6"]))
        out["sdpa"] = libs
        print(f"  SDPA under the tables' token mask (B = 2 / sample 0): "
              + json.dumps(libs), flush=True)
    return out


def agree_streams(label: str, ref: dict, got: dict, tol: float) -> None:
    for i, (a, c) in enumerate(zip(ref["reqs"], got["reqs"])):
        verdict = greedy_agree(a.output_tokens, ref["logits"][i].cpu()
                               .numpy(), c.output_tokens, tol)
        print(f"  request {a.uid}: {label} {c.output_tokens.tolist()} "
              f"against {a.output_tokens.tolist()} -> {verdict}",
              flush=True)


def phase19() -> dict:
    """Phase 19: RecurrentGemma 9B (the RG-LRU hybrid) at full width, all
    38 layers: B.1 at D = 256, G = 16 and B.2 and B.6 at D = 256 against
    their plain versions on layer 2's q/k/v under window ∧ share masks;
    the engine's batch serve of phase 4's prompt lengths with exact
    launches (B.1 12, B.2 12, no decode kernel), ``scheduler=True`` on the
    batch path, the per-sample path (B.1 24, B.6 24), and a float32 serve
    against the bf16 one.  Returns the kernels' numbers."""
    import torch
    from repro_torch.models import build_model, hybrid
    from repro_torch.models.attention import extra_block_mask
    from repro_torch.serving import SlotScheduler
    print("== phase 19: RecurrentGemma 9B (RG-LRU hybrid) at full width",
          flush=True)
    t = time.time()
    strip_regs = ptxas_lines("strip", r"strip_tc_kernelLi256E")
    wide = ptxas_lines("block_sparse_attn", r"Li256ELi256E") + strip_regs
    for name, regs, spill in wide:
        print(f"  ptxas: {name}: {regs} registers, {spill} bytes spilled",
              flush=True)
    if len(strip_regs) != 2 or any(spill for _, _, spill in wide):
        raise AssertionError(f"the D = 256 instances: expected both strip "
                             f"passes and no spill, ptxas gave {wide}")
    torch.cuda.reset_peak_memory_stats()
    model, params = load_model(HYBRID, None)
    cfg, dev = model.cfg, model.device
    n_super, n_trail = hybrid._counts(cfg)
    r = cfg.rglru
    print(f"  {n_super} super-blocks (rec, rec, attn) + {n_trail} trailing "
          f"recurrent layers; lru width {r.lru_width}, conv {r.conv_width}, "
          f"window {r.local_attn_window}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}", flush=True)
    rng = np.random.default_rng(SEED + 19)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    toks = np.zeros((2, SEQ), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tokens = torch.as_tensor(toks, device=dev)
    bs = cfg.share_prefill.block_size
    with torch.no_grad():
        q, k, v = hybrid_attn_qkv(model, params, tokens)
        extra = extra_block_mask(hybrid._attn_cfg(cfg), SEQ // bs, bs,
                                 device=dev)
        res = check_wide_kernels("RecurrentGemma layer 2 (window "
                                 f"{r.local_attn_window})", model, q, k, v,
                                 extra)
        del q, k, v
        st = res["strip"]
        st["registers"] = {name: regs for name, regs, _ in strip_regs}
        regs = ", ".join(f"{n} {r} registers"
                         for n, r in st["registers"].items())
        print(f"  B.1 bf16 at D = {cfg.resolved_head_dim}, G = "
              f"{cfg.num_heads // cfg.num_kv_heads} on its tensor-core body "
              f"({regs}): "
              f"{st['ms']:.4f} ms (device {st['device_ms']:.4f} ms), bound "
              f"{st['bound_ms']:.4f} ms by {st['bound_by']}, frac "
              f"{st['bound_ms'] / st['ms']:.4f}, plain {st['plain_ms']:.4f} ms"
              f" ({nvidia_smi()})", flush=True)
        if not st["ms"] < st["plain_ms"]:
            raise AssertionError("B.1 at D = 256: the kernel is not faster "
                                 "than its plain version")
        torch.cuda.empty_cache()
        model.prefill(params, tokens, model.default_share_prefill())
    print(f"RecurrentGemma batch serve: {PROMPT_LENS} prompt tokens, "
          f"{NEW_TOKENS} new", flush=True)
    bf = plain_serve(model, params, prompts, NEW_TOKENS, SEQ)
    _expect_counts("RecurrentGemma batch serve", bf["counts"],
                   {"strip": n_super, "block_sparse_attn": n_super})
    run = SlotScheduler.run

    def refuse(self):
        raise AssertionError("RecurrentGemma reached the slot scheduler")
    SlotScheduler.run = refuse
    try:
        sched = plain_serve(model, params, prompts, NEW_TOKENS, SEQ,
                            scheduler=True)
    finally:
        SlotScheduler.run = run
    _expect_counts("RecurrentGemma scheduler=True serve", sched["counts"],
                   bf["counts"])
    same = all(a.output_tokens.tolist() == c.output_tokens.tolist()
               for a, c in zip(bf["reqs"], sched["reqs"]))
    print(f"  scheduler=True: the batch path, tokens identical {same}",
          flush=True)
    if not same:
        raise AssertionError("RecurrentGemma: scheduler=True changed tokens")
    del sched
    print("RecurrentGemma per-sample path (attn_impl=kernel)", flush=True)
    ps = plain_serve(model, params, prompts, NEW_TOKENS, SEQ,
                     attn_impl="kernel")
    _expect_counts("RecurrentGemma per-sample serve", ps["counts"],
                   {"strip": 2 * n_super,
                    "block_sparse_attn_single": 2 * n_super})
    tol = PER_SAMPLE_RTOL * float(bf["logits"][:, 0].abs().max())
    agree_streams("per-sample", bf, ps, tol)
    print(f"  first-step max |logit per-sample - batched| "
          f"{max_err(ps['logits'][:, 0], bf['logits'][:, 0]):.3e}",
          flush=True)
    del ps
    torch.cuda.empty_cache()
    print("RecurrentGemma float32 serve (the same weights, widened)",
          flush=True)
    m32 = build_model(cfg, dtype=torch.float32)
    p32 = _to(params, torch.float32)
    del params
    torch.cuda.empty_cache()
    f32 = plain_serve(m32, p32, prompts, NEW_TOKENS, SEQ)
    _expect_counts("RecurrentGemma float32 serve", f32["counts"],
                   bf["counts"])
    # bf16 rounding over 38 layers: a flip is allowed where float32's top-2
    # margin is below twice the first-step bf16 logit error, as in phase 18
    first = max_err(bf["logits"][:, 0], f32["logits"][:, 0])
    agree_streams("bf16", f32, bf, 2 * first)
    print(f"  first-step max |logit bf16 - float32| {first:.3e}", flush=True)
    st = bf["reqs"][0].pattern_stats
    res["serve"] = {"prefill_s": bf["reqs"][0].prefill_s,
                    "decode_tokens_per_s": bf["reqs"][0].decode_tokens_per_s,
                    "peak_gib": bf["peak"],
                    "block_density": st["block_density"],
                    "f32_prefill_s": f32["reqs"][0].prefill_s,
                    "f32_peak_gib": f32["peak"],
                    "bf16_f32_first_err": first, "launches": bf["counts"]}
    del m32, p32, bf, f32
    torch.cuda.empty_cache()
    print(f"phase 19: {time.time() - t:.1f} s ({nvidia_smi()}); "
          + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- phase 20

WHISPER = "whisper-base"
WHISPER_PROMPTS = (448, 385)    # Whisper's published text context: 7 blocks
WHISPER_SEQ = 448
# max |logit card − CPU| of whisper's float32 first step: both float32 (no
# TF32), the kernels' float32 bodies against their plain versions, sums in
# another order over 6 + 6 layers
WHISPER_F32_TOL = 1e-3

def whisper_layer0_qkv(model, params, tokens):
    """Decoder layer 0's self-attention q and k/v (B, H, N, 64): token
    embeddings plus the sinusoid, RoPE the identity."""
    from repro_torch.models import common, whisper
    cfg = model.cfg
    layer = params["dec_stack"][0]
    x = whisper._add_positions(params["embed"][tokens], cfg)
    h = common.rmsnorm(layer["ln1"], x, cfg.rms_norm_eps)
    q, k, v = common.gqa_qkv(layer["self_attn"], h)
    return q.contiguous(), k.contiguous(), v.contiguous()


def phase20() -> dict:
    """Phase 20: Whisper base (encoder-decoder) at full width: B.1 and B.2
    at D = 64, G = 1 against their plain versions on decoder layer 0's
    tables; a batch serve of two prompts in a 448-token bucket under 1500
    stub frames drawn from the seed, launches exactly B.1 6, B.2 6, no
    decode kernel; the card's float32 serve against the port's float32
    serve on the CPU with the same weights and frames.  Returns the
    kernels' numbers."""
    import torch
    from repro_torch.checkpoint import num_params
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    print("== phase 20: Whisper base (encoder-decoder) at full width",
          flush=True)
    t = time.time()
    cfg = get_config(WHISPER)
    model = build_model(cfg, dtype=torch.bfloat16)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(SEED))
    dev = model.device
    print(f"{WHISPER}: {cfg.encdec.num_encoder_layers} + {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.encdec.encoder_seq_len} frames, "
          f"vocab {cfg.vocab_size}; {num_params(params) / 1e6:.1f} M params "
          f"in bf16", flush=True)
    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in WHISPER_PROMPTS]
    frames32 = torch.as_tensor(rng.standard_normal(
        (2, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32))
    toks = np.zeros((2, WHISPER_SEQ), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tokens = torch.as_tensor(toks, device=dev)
    with torch.no_grad():
        q, k, v = whisper_layer0_qkv(model, params, tokens)
        res = check_wide_kernels("Whisper decoder layer 0", model, q, k, v,
                                 None)
        del q, k, v
    frames = frames32.to(dev, torch.bfloat16)
    with torch.no_grad():               # a warm-up prefill, untimed
        model.prefill(params, tokens, model.default_share_prefill(),
                      embeds=frames)
    print(f"Whisper batch serve: {WHISPER_PROMPTS} prompt tokens in a "
          f"{WHISPER_SEQ}-token bucket, {NEW_TOKENS} new", flush=True)
    bf = plain_serve(model, params, prompts, NEW_TOKENS, WHISPER_SEQ,
                     frames=frames)
    _expect_counts("Whisper batch serve", bf["counts"],
                   {"strip": cfg.num_layers,
                    "block_sparse_attn": cfg.num_layers})
    p32 = _to(params, torch.float32)
    m32 = build_model(cfg, dtype=torch.float32)
    f32 = plain_serve(m32, p32, prompts, NEW_TOKENS, WHISPER_SEQ,
                      frames=frames32.to(dev))
    cpu = build_model(cfg, dtype=torch.float32, device="cpu")
    c32 = plain_serve(cpu, _to(p32, "cpu"), prompts, NEW_TOKENS,
                      WHISPER_SEQ, frames=frames32)
    first = max_err(f32["logits"][:, 0].cpu(), c32["logits"][:, 0])
    check("float32 first-step logits, card against CPU", first,
          WHISPER_F32_TOL)
    agree_streams("card float32", c32, f32, WHISPER_F32_TOL)
    bf_first = max_err(bf["logits"][:, 0], f32["logits"][:, 0])
    agree_streams("card bf16", f32, bf, 2 * bf_first)
    print(f"  first-step max |logit bf16 - float32| {bf_first:.3e}",
          flush=True)
    st = bf["reqs"][0].pattern_stats
    res["serve"] = {"prefill_s": bf["reqs"][0].prefill_s,
                    "decode_tokens_per_s": bf["reqs"][0].decode_tokens_per_s,
                    "peak_gib": bf["peak"],
                    "block_density": st["block_density"],
                    "f32_card_cpu_first_err": first,
                    "cpu_f32_wall_s": c32["wall"],
                    "launches": bf["counts"]}
    del model, params, m32, p32, cpu, bf, f32, c32
    torch.cuda.empty_cache()
    print(f"phase 20: {time.time() - t:.1f} s ({nvidia_smi()}); "
          + json.dumps(res), flush=True)
    return res


# phase 21: training
TRAIN_SMOKE_SEQ = 128       # 21a: each smoke config's one step, 2 rows
TRAIN_LAYERS = 8            # 21b: of llama3-8b-262k's 32 (≈ 2.80 B params)
TRAIN_SEQ = 4096            # the registry's train_4k length
TRAIN_BATCH = 2             # in TRAIN_MICRO microbatches of one row
TRAIN_MICRO = 2
TRAIN_STEPS = 6
# 21a: card against CPU in float32 (TF32 off).  Loss and grad norm
# relative; each gradient leaf within GRAD_RTOL of its max |g| plus
# GRAD_ATOL (summation order on two devices; the floor holds a leaf whose
# gradient is itself small, as Mamba-2's a_log at ≈ 2.5e-4, the CPU
# tests' rule); each updated leaf within UPDATE_TOL, except where
# AdamW's first step divides a gradient near zero by itself
# (g / (|g| + eps)): elements whose |g| is below SMALL_GRAD of the leaf's
# max may move up to one full step (2 · lr · lr_scale) apart, counted
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-7
UPDATE_TOL = 1e-5
SMALL_GRAD = 1e-4
# 21c: the reference's bench model (benchmarks/common.py), trained here
BENCH_ARCH = "internlm2-1.8b"
BENCH_STEPS = 600
BENCH_SEQ = 256
BENCH_BATCH = 8
BENCH_PREFILL = 2048
BENCH_NEW = 8
BENCH_DIR = os.path.join(ROOT, "build", "phase21_bench")
TRAIN_CKPT_DIR = os.path.join(ROOT, "build", "phase21_ckpt")


def bench_config():
    """The reference's ``benchmarks/common.py::bench_config``, copied:
    internlm2-1.8b's smoke config at 3 layers and 4 heads over 2, with
    SharePrefill at block 64, δ 0.75, τ 0.4, γ 0.55."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import SharePrefillConfig
    return dataclasses.replace(
        get_smoke_config(BENCH_ARCH), num_layers=3, num_heads=4,
        num_kv_heads=2,
        share_prefill=SharePrefillConfig(block_size=64, min_seq_blocks=2,
                                         delta=0.75, tau=0.4, gamma=0.55))


@contextlib.contextmanager
def watch_updates(keep_grads: bool = False):
    """Within it, every train step's AdamW update is recorded: the host
    times just before and after it, the device synchronised at both, and
    with ``keep_grads`` the gradients it was given."""
    import torch
    from repro_torch import tree as tu
    from repro_torch.training import train_loop
    real = train_loop.adamw_update
    seen = []

    def watched(cfg, params, grads, state, lr_scale=1.0, **kw):
        if tu.leaves(grads)[0].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(cfg, params, grads, state, lr_scale, **kw)
        if out[2].is_cuda:
            torch.cuda.synchronize()
        seen.append({"grads": grads if keep_grads else None, "t0": t0,
                     "t1": time.perf_counter()})
        return out
    train_loop.adamw_update = watched
    try:
        yield seen
    finally:
        train_loop.adamw_update = real


def one_train_step(model, tree, batch, extra, mb: int) -> dict:
    """One ``make_train_step`` step (functional) from ``tree``: the new
    tree, the metrics as floats and the gradients the update got."""
    from repro_torch.optim import init_adamw
    from repro_torch.training import TrainConfig, make_train_step
    tcfg = TrainConfig(num_steps=10, warmup_steps=2, microbatches=mb)
    step = make_train_step(model, tcfg, extra)
    with watch_updates(keep_grads=True) as seen:
        new, state, metrics = step(tree, init_adamw(tree), batch)
    return dict(tree=new, metrics={k: float(v) for k, v in metrics.items()},
                grads=seen[0]["grads"], step=int(state.step))


def compare_steps(label: str, ref: dict, got: dict, lr: float) -> dict:
    """``got``'s loss, grad norm, gradients and updated leaves against
    ``ref``'s (21a's tolerances); returns the worst errors."""
    import torch
    from repro_torch import tree as tu
    worst = {"loss": 0.0, "grad_norm": 0.0, "grad": 0.0, "update": 0.0,
             "sensitive": 0}
    for k in ("total_loss", "grad_norm"):
        a, b = ref["metrics"][k], got["metrics"][k]
        err = abs(a - b) / max(abs(a), 1e-30)
        worst["loss" if k == "total_loss" else "grad_norm"] = err
        check(f"{label} {k} (relative)", err, LOSS_RTOL)
    step_max = 2 * lr * ref["metrics"]["lr_scale"] * 1.01
    cpu = lambda tree: {k: t.float().cpu()
                        for k, t in tu.flatten_with_path(tree)}
    grads, new_ref = cpu(ref["grads"]), cpu(ref["tree"])
    for key, g in tu.flatten_with_path(got["grads"]):
        gr = grads[key]
        scale = float(gr.abs().max())
        err = max_err(g.float().cpu(), gr)
        worst["grad"] = max(worst["grad"], err / max(scale, 1e-30))
        if err > GRAD_RTOL * scale + GRAD_ATOL:
            raise AssertionError(f"{label} gradient {key}: error {err:.3e} "
                                 f"at max |g| {scale:.3e}")
    for key, p in tu.flatten_with_path(got["tree"]):
        diff = (p.float().cpu() - new_ref[key]).abs()
        small = grads[key].abs() < SMALL_GRAD * max(
            float(grads[key].abs().max()), 1e-30)
        worst["update"] = max(worst["update"],
                              float(diff[~small].max()) if (~small).any()
                              else 0.0)
        worst["sensitive"] += int((diff[small] > UPDATE_TOL).sum())
        if bool((diff[~small] > UPDATE_TOL).any()) or bool(
                (diff[small] > step_max).any()):
            raise AssertionError(f"{label} updated leaf {key}: max |Δ| "
                                 f"{float(diff.max()):.3e}")
    return worst


def phase21a() -> dict:
    """21a: every registry config at its smoke size: one float32 train step
    on the card against the same step on the CPU, from the same numpy
    weights and batch; one config also at 2 microbatches against 1."""
    import torch
    from repro_torch import checkpoint
    from repro_torch import tree as tu
    from repro_torch.configs import REGISTRY, get_smoke_config
    from repro_torch.data import DataConfig, batches
    from repro_torch.launch.train import extra_kwargs_fn
    from repro_torch.models import build_model
    from repro_torch.training import TrainConfig
    lr = TrainConfig().optimizer.learning_rate
    out = {}
    for arch in sorted(REGISTRY):
        cfg = get_smoke_config(arch)
        cpu = build_model(cfg, device="cpu")
        card = build_model(cfg)
        tree = checkpoint.params_to_tree(
            cpu.init(torch.Generator().manual_seed(SEED)), cfg)
        batch = next(batches(DataConfig(cfg.vocab_size, TRAIN_SMOKE_SEQ, 2,
                                        task="lm", seed=SEED)))
        on = lambda dev: (tu.tree_map(lambda t: t.to(dev), tree),
                          {k: torch.as_tensor(v, device=dev)
                           for k, v in batch.items()})
        ref, got = (one_train_step(m, *on(m.device), extra_kwargs_fn(cfg), 1)
                    for m in (cpu, card))
        out[arch] = compare_steps(f"21a {arch}", ref, got, lr)
        print(f"  {arch} ({cfg.family}): loss "
              f"{got['metrics']['total_loss']:.6f} (CPU "
              f"{ref['metrics']['total_loss']:.6f}), errors "
              + json.dumps(out[arch]), flush=True)
        if arch == ARCH:
            two = one_train_step(card, *on(card.device), None, 2)
            out["microbatches"] = compare_steps(
                f"21a {arch} microbatches 2 against 1", got, two, lr)
            print(f"  {arch} at 2 microbatches against 1: errors "
                  + json.dumps(out["microbatches"]), flush=True)
    return out


def phase21b() -> dict:
    """21b: llama3-8b-262k at its published widths, 8 of 32 layers, float32
    weights, ``remat_policy="full"``: ``TRAIN_STEPS`` steps of ``train`` at
    sequence 4096, batch 2 in 2 microbatches, the launcher's AdamW; then
    ``save_step``/``restore_step`` bitwise, and the restored weights in
    bf16 served through phase 4's requests with exact launches."""
    import shutil
    import torch
    from repro_torch import checkpoint
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batches
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, train
    full = get_config(ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS,
                              remat_policy="full")
    model = build_model(cfg)
    tcfg = TrainConfig(num_steps=TRAIN_STEPS, microbatches=TRAIN_MICRO,
                       warmup_steps=max(TRAIN_STEPS // 10, 1), log_every=1,
                       optimizer=AdamWConfig())
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    marks = []

    def data():
        it = batches(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                task="lm", seed=SEED))
        while True:
            batch = next(it)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks.append(time.perf_counter())
            yield batch

    rows, n_params = [], []

    def init():
        port = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        tree = checkpoint.params_to_tree(port, cfg)
        n_params.append(sum(t.numel() for t in tu.leaves(tree)))
        return tree

    def log(step, m):
        upd = seen[step]
        fb = upd["t0"] - marks[step]
        opt = upd["t1"] - upd["t0"]
        flops = 8 * n_params[0] * tokens_per_step   # 6PT + recomputed 2PT
        row = {"step": step, "loss": m["total_loss"],
               "grad_norm": m["grad_norm"], "fwd_bwd_ms": 1e3 * fb,
               "optimizer_ms": 1e3 * opt,
               "tokens_per_s": tokens_per_step / (fb + opt),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "f32_flops_share": flops / (fb + opt) / PEAK_FLOPS["float32"]}
        rows.append(row)
        print("  " + json.dumps(row), flush=True)

    print(f"21b: {ARCH} at full width, {TRAIN_LAYERS} of {full.num_layers} "
          f"layers (depth cut), float32, remat full, sequence {TRAIN_SEQ}, "
          f"batch {TRAIN_BATCH} in {TRAIN_MICRO} microbatches, "
          f"{TRAIN_STEPS} steps", flush=True)
    t = time.time()
    with watch_updates() as seen:
        params, opt_state, _ = train(model, tcfg, data(), params=init(),
                                     log_fn=log)
    print(f"  {n_params[0] / 1e9:.3f} B params; train {time.time() - t:.1f} "
          f"s", flush=True)
    del seen[:], opt_state
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in rows]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"21b: losses {losses} not finite or not falling")
    os.makedirs(TRAIN_CKPT_DIR, exist_ok=True)
    free = shutil.disk_usage(TRAIN_CKPT_DIR).free
    print(f"  disk free {free / 2**30:.1f} GiB", flush=True)
    t = time.time()
    checkpoint.save_step(TRAIN_CKPT_DIR, TRAIN_STEPS, params)
    save_s = time.time() - t
    t = time.time()
    if checkpoint.latest_step(TRAIN_CKPT_DIR) != TRAIN_STEPS:
        raise AssertionError("21b: latest_step does not find the checkpoint")
    back = checkpoint.restore_step(TRAIN_CKPT_DIR, TRAIN_STEPS, params)
    restore_s = time.time() - t
    same = all(torch.equal(a, b) for a, b in
               zip(tu.leaves(params), tu.leaves(back)))
    shutil.rmtree(TRAIN_CKPT_DIR)
    print(f"  save_step {save_s:.1f} s, restore_step {restore_s:.1f} s, "
          f"bitwise {same}", flush=True)
    if not same:
        raise AssertionError("21b: restored weights differ")
    del params
    serve_model = build_model(cfg, dtype=torch.bfloat16)
    served = checkpoint.params_from_tree(
        tu.tree_map(lambda t: t.to(torch.bfloat16), back), cfg)
    del back
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    run = serve_full(serve_model, served, prompts, {})
    want = {"strip": TRAIN_LAYERS, "block_sparse_attn": TRAIN_LAYERS,
            "decode_attn": TRAIN_LAYERS * (NEW_TOKENS - 1)}
    _expect_counts("21b serve of the trained weights", run["counts"], want)
    del served, serve_model, run
    torch.cuda.empty_cache()
    return {"steps": rows, "save_s": save_s, "restore_s": restore_s,
            "params": n_params[0]}


def bench_prefill(model, params, tokens, label: str) -> dict:
    """One share prefill of ``tokens`` (launches counted), and each layer's
    shared/dense/VS heads, masks and decision (:func:`layer_decisions`)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    sp = model.default_share_prefill()
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad():
        res = model.prefill(params, tokens, sp, method="share")
    torch.cuda.synchronize()
    counts = launch_counts()
    with torch.no_grad():
        heads, kept = layer_decisions(model, params, tokens, sp,
                                      keep=range(model.cfg.num_layers))
    density = float(res.stats.block_density)
    print(f"  {label}: block density {density:.4f}, shared/dense/VS heads "
          f"per layer {heads}, launches {counts}", flush=True)
    return dict(counts=counts, heads=heads, kept=kept, density=density,
                logits=res.last_logits)


def phase21c() -> dict:
    """21c and 21d: the reference's bench model trained on the card (600
    steps, the four tasks in turn), saved in the reference's format; one
    2048-token retrieval prefill under SharePrefill with the initial and
    the trained weights (launches exactly B.1 3, B.2 3); then the trained
    weights' prefill and a short serve on the plain B.1/B.2: masks,
    tables and decisions equal, greedy tokens near-tie aware."""
    import torch
    from repro_torch import checkpoint
    from repro_torch import tree as tu
    from repro_torch.data import TASKS, DataConfig, batches, sample
    from repro_torch.kernels.indices import build_block_tables
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, train
    cfg = bench_config()
    model = build_model(cfg)
    layers = cfg.num_layers
    init = checkpoint.params_to_tree(
        model.init(torch.Generator(device="cuda").manual_seed(SEED)), cfg)
    tcfg = TrainConfig(num_steps=BENCH_STEPS, warmup_steps=20, log_every=50,
                       remat=False, optimizer=AdamWConfig(learning_rate=1e-3))

    def mixed():            # benchmarks/common.py: the tasks in turn
        its = [batches(DataConfig(cfg.vocab_size, BENCH_SEQ, BENCH_BATCH,
                                  task=t)) for t in TASKS]
        i = 0
        while True:
            yield next(its[i % len(its)])
            i += 1

    def log(step, m):
        print(f"  step {step:4d} loss {m['total_loss']:.4f} accuracy "
              f"{m['accuracy']:.3f} grad_norm {m['grad_norm']:.3f} wall "
              f"{m['wall_s']:.1f} s", flush=True)

    print(f"21c: the bench model ({BENCH_ARCH} smoke, {layers} layers, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_model "
          f"{cfg.d_model}), {BENCH_STEPS} steps at sequence {BENCH_SEQ}, "
          f"batch {BENCH_BATCH}, lr 1e-3, warmup 20; PYTHONHASHSEED "
          f"{os.environ.get('PYTHONHASHSEED', 'unset')}", flush=True)
    t = time.time()
    trained, _, history = train(model, tcfg, mixed(), params=init,
                                log_fn=log)
    train_s = time.time() - t
    losses = history["total_loss"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"21c: losses {losses} not finite or falling")
    path = os.path.join(BENCH_DIR, "params.npz")
    checkpoint.save(path, trained, step=BENCH_STEPS,
                    extra_meta={"loss": losses[-1]})
    back = checkpoint.restore_like(path, trained)
    if not all(torch.equal(a, b) for a, b in
               zip(tu.leaves(trained), tu.leaves(back))):
        raise AssertionError("21c: the saved bench weights do not read back")
    print(f"  trained in {train_s:.1f} s ({1e3 * train_s / BENCH_STEPS:.1f} "
          f"ms a step); saved {path}", flush=True)
    toks = sample(DataConfig(cfg.vocab_size, BENCH_PREFILL, 1,
                             task="retrieval", seed=SEED), 0)["tokens"]
    tokens = torch.as_tensor(toks[None].astype(np.int64), device=model.device)
    want = {"strip": layers, "block_sparse_attn": layers}
    runs = {}
    for label, tree in (("initial", init), ("trained", trained)):
        runs[label] = bench_prefill(
            model, checkpoint.params_from_tree(tree, cfg), tokens,
            f"{label} weights")
        _expect_counts(f"21c prefill, {label} weights",
                       runs[label]["counts"], want)
    # 21d: the trained weights on the plain B.1/B.2
    params = checkpoint.params_from_tree(trained, cfg)
    with plain_prefill_kernels():
        plain = bench_prefill(model, params, tokens,
                              "trained weights, plain B.1/B.2")
    _expect_counts("21d plain prefill", plain["counts"], {})
    got = runs["trained"]
    for li in range(layers):
        masks, dec = got["kept"][li][3:]
        pm, pdec = plain["kept"][li][3], plain["kept"][li][4]
        same = (torch.equal(masks, pm)
                and all(torch.equal(getattr(dec, f), getattr(pdec, f))
                        for f in ("use_shared", "use_dense", "use_vs"))
                and all(torch.equal(a, b) for a, b in
                        zip(build_block_tables(masks), build_block_tables(pm))))
        if not same:
            raise AssertionError(f"21d layer {li}: masks, tables or "
                                 "decisions differ from the plain path's")
        for f in ("a_hat_blocks", "d_sparse", "d_sim"):
            check(f"21d layer {li} {f}", max_err(getattr(dec, f),
                                                 getattr(pdec, f)),
                  TOL[("strip", "float32")])
    first = max_err(got["logits"], plain["logits"])
    check("21d last logits, kernels against plain", first, TOL[("out",
                                                              "float32")])
    prompts = [toks]
    kern = plain_serve(model, params, prompts, BENCH_NEW, BENCH_PREFILL)
    with plain_prefill_kernels():
        ref = plain_serve(model, params, prompts, BENCH_NEW, BENCH_PREFILL)
    agree_streams("21d kernels against plain B.1/B.2", ref, kern, TIE_TOL)
    print("  21d: masks, tables and decisions of all layers equal",
          flush=True)
    return {"losses": losses, "train_s": train_s,
            "density": {k: r["density"] for k, r in runs.items()},
            "heads": {k: r["heads"] for k, r in runs.items()},
            "last_logits_err": first}


def phase21() -> dict:
    """Phase 21: training on the card (21a–21d)."""
    import torch
    print("== phase 21: training (A.11's rest)", flush=True)
    print(f"PYTHONHASHSEED {os.environ.get('PYTHONHASHSEED', 'unset')}",
          flush=True)
    t = time.time()
    res = {"21a": phase21a()}
    print(f"phase 21a: {time.time() - t:.1f} s", flush=True)
    res["21b"] = phase21b()
    print(f"phase 21b: {time.time() - t:.1f} s", flush=True)
    res["21c"] = phase21c()
    torch.cuda.empty_cache()
    print(f"phase 21: {time.time() - t:.1f} s ({nvidia_smi()}); "
          + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------- phase 22

MESH_RANKS = 2              # two ranks on one card, over gloo
MESH_LAYERS = 8             # of llama3-8b-262k's 32, as phase 21b
MESH_TIMEOUT_S = 300        # the ranks' collectives and their join
MESH_DECODE_STEP = 8        # the kernel check's decode position past SEQ
MESH_OUT = os.path.join(ROOT, "build", "phase22")


def _all_agree(value: float) -> bool:
    """Whether every rank holds the same ``value``: its max and min over
    the world, all-reduced (CPU tensors over gloo), are equal."""
    import torch
    import torch.distributed as dist
    hi = torch.tensor([value], dtype=torch.float64)
    lo = hi.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(hi == lo)


def tensors_digest(tensors) -> float:
    """The first 52 bits of a SHA-256 of ``tensors``' bytes, exact in a
    float64 (for :func:`_all_agree`)."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return float(int(h.hexdigest()[:13], 16))


class MaskDigest:
    """A running SHA-256 of every layer's SharePrefill masks and decision
    that ``build_share_masks`` returns while installed."""

    def __init__(self):
        import hashlib
        self.h = hashlib.sha256()
        self.calls = 0

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.core import share_attention as sa
        orig = sa.build_share_masks

        def digest(*args, **kwargs):
            masks, decision = orig(*args, **kwargs)
            for t in (masks, *decision):
                self.h.update(t.detach().contiguous().cpu().numpy().tobytes())
            self.calls += 1
            return masks, decision

        sa.build_share_masks = digest
        try:
            yield self
        finally:
            sa.build_share_masks = orig

    def value(self) -> float:
        """The digest's first 52 bits, exact in a float64."""
        return float(int(self.h.hexdigest()[:13], 16))


@contextlib.contextmanager
def captured_plans(out: list):
    """Every plan the engine and scheduler build through
    ``build_decode_plan`` while the body runs."""
    from repro_torch.serving import decode_plan as dplan
    orig = dplan.build_decode_plan

    def capture(*args, **kwargs):
        plan = orig(*args, **kwargs)
        out.append(plan)
        return plan

    dplan.build_decode_plan = capture
    try:
        yield out
    finally:
        dplan.build_decode_plan = orig


def _same(a, b) -> bool:
    """Tensors pairwise bitwise equal (dtype and shape included)."""
    import torch
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def mesh_serve(label: str, serve, rules):
    """One serve (``serve()`` returns its result dict) under ``rules`` (or
    none), with its plans captured, its masks and decisions digested, and
    the shard calls and all-gathers counted from zero."""
    import torch
    from repro_torch.distributed import sharding as dsh
    plans, digest = [], MaskDigest()
    dsh.reset_shard_calls()
    dsh.reset_gather_stats()
    with captured_plans(plans), digest.installed(), dsh.use_rules(rules):
        run = serve()
    torch.cuda.synchronize()
    run.update(plans=plans, digest=digest, shard_calls=dict(dsh.SHARD_CALLS),
               gather=dict(dsh.GATHER_STATS))
    print(f"  {label}: shard calls "
          + json.dumps({"/".join(map(str, k)): v
                        for k, v in run["shard_calls"].items()})
          + f"; all-gathers {run['gather']['calls']} calls, "
          f"{run['gather']['bytes']} bytes, {run['gather']['seconds']:.4f} "
          f"s", flush=True)
    return run


def _check_streams(what: str, plain: dict, sharded: dict, logits) -> None:
    """Greedy tokens and every logit row (``logits(run)``) of the sharded
    serve bitwise the single-device serve's."""
    toks = [r.output_tokens.tolist() for r in plain["reqs"]]
    got = [r.output_tokens.tolist() for r in sharded["reqs"]]
    same_logits = _same(logits(plain), logits(sharded))
    print(f"  {what}: tokens equal {toks == got}, {len(logits(plain))} "
          f"logit rows bitwise {same_logits}", flush=True)
    if toks != got or not same_logits:
        raise AssertionError(f"{what}: the sharded serve is not bitwise the "
                             f"single-device serve ({toks} vs {got})")


def mesh_kernels(model, params, tokens, plan, mesh, rank: int) -> dict:
    """Phase 22c: B.2 (output and Ã), B.3 and B.4 through their sharded
    functions against the single-device launch on the same inputs (layer
    0's q/k/v and masks, the batch serve's layer-0 plan), bitwise; then
    each rank in turn times its own head shard's launch beside the whole
    model's (CUDA events and the profiler's device time)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as dsh
    from repro_torch.kernels import (block_sparse_attention_cuda,
                                     compact_block_mask)
    from repro_torch.kernels.decode_attn import (
        flash_decode_plan, flash_decode_plan_paged, flash_decode_sparse_cuda,
        flash_decode_sparse_paged_cuda)
    from repro_torch.kernels.ops import batched_block_sparse_attention

    bs = model.cfg.share_prefill.block_size
    q, k, v = layer0_qkv(model, params, tokens)
    masks, dec = real_masks(model, q, k, v)
    gate = dec.use_dense
    out, a_tilde = batched_block_sparse_attention(q, k, v, masks,
                                                  block_size=bs,
                                                  stats_gate=gate)
    s_out, s_a = dsh.sharded_batched_block_sparse_attention(
        q, k, v, masks, mesh=mesh, block_size=bs, stats_gate=gate)
    p0 = plan.layer(0)
    b, hkv, nb, _ = p0.keep_heads.shape
    s = nb * bs
    dev = q.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    ck = torch.zeros((b, hkv, s, k.shape[-1]), dtype=k.dtype, device=dev)
    cv = torch.zeros_like(ck)
    ck[:, :, :SEQ], cv[:, :, :SEQ] = k, v
    tail = slice(SEQ, SEQ + MESH_DECODE_STEP)
    ck[:, :, tail] = torch.randn(ck[:, :, tail].shape, generator=gen,
                                 device=dev).to(ck.dtype)
    cv[:, :, tail] = torch.randn(cv[:, :, tail].shape, generator=gen,
                                 device=dev).to(cv.dtype)
    pos = torch.arange(s, device=dev)[None]
    plens = torch.tensor(PROMPT_LENS, device=dev)[:, None]
    valid = ((pos < plens) | ((pos >= SEQ) & (pos < SEQ + MESH_DECODE_STEP))
             ).contiguous()
    dq = torch.randn((b, q.shape[1], q.shape[-1]), generator=gen,
                     device=dev).to(q.dtype)
    dec_full = flash_decode_plan(dq, ck, cv, p0, valid, impl="kernel")
    dec_shard = dsh.sharded_flash_decode(dq, ck, cv, p0, valid, mesh=mesh,
                                         impl="kernel")
    perm = torch.randperm(b * nb, generator=gen, device=dev) + 1
    table = perm.reshape(b, nb).to(torch.int32).contiguous()
    pool_k = torch.zeros((b * nb + 1, hkv, bs, k.shape[-1]), dtype=k.dtype,
                         device=dev)
    pool_v = torch.zeros_like(pool_k)
    pool_k[table.long()] = ck.reshape(b, hkv, nb, bs, -1).transpose(1, 2)
    pool_v[table.long()] = cv.reshape(b, hkv, nb, bs, -1).transpose(1, 2)
    pg_full = flash_decode_plan_paged(dq, pool_k, pool_v, table, p0, valid,
                                      impl="kernel")
    pg_shard = dsh.sharded_flash_decode_paged(dq, pool_k, pool_v, table, p0,
                                              valid, mesh=mesh,
                                              impl="kernel")
    torch.cuda.synchronize()
    same = {"block_sparse_attn": bool(torch.equal(out, s_out)
                                      and torch.equal(a_tilde, s_a)),
            "decode_attn": bool(torch.equal(dec_full, dec_shard)),
            "decode_attn_paged": bool(torch.equal(pg_full, pg_shard)
                                      and torch.equal(pg_full, dec_full))}
    print(f"  22c rank {rank}: sharded against the single-device launch, "
          f"bitwise: {json.dumps(same)}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"phase 22c: {same}")

    # the shard's operands as the sharded functions hand them over: q, the
    # gate, the tables and the prefill K/V copied out once (the times are
    # the launches'); the decode cache and pool are head-slice views, read
    # in place
    hs, ks = dsh.shard_range(mesh, "model", q.shape[1], hkv)
    idx, cnt = (t.contiguous() for t in compact_block_mask(masks))
    idx_l, cnt_l = (t.contiguous() for t in compact_block_mask(masks[:, hs]))
    q_l, g_l, dq_l = (t[:, hs].contiguous() for t in (q, gate, dq))
    k_l, v_l, *p_l = (t[:, ks].contiguous() for t in (k, v, *p0))
    ck_l, cv_l, pk_l, pv_l = (t[:, ks] for t in (ck, cv, pool_k, pool_v))
    calls = {
        "block_sparse_attn": (
            lambda: block_sparse_attention_cuda(
                q, k, v, idx, cnt, block_size=bs, stats_gate=gate),
            lambda: block_sparse_attention_cuda(
                q_l, k_l, v_l, idx_l, cnt_l, block_size=bs, stats_gate=g_l),
            5),
        "decode_attn": (
            lambda: flash_decode_sparse_cuda(dq, ck, cv, *p0, valid),
            lambda: flash_decode_sparse_cuda(dq_l, ck_l, cv_l, *p_l, valid,
                                             num_kv_heads=hkv), 20),
        "decode_attn_paged": (
            lambda: flash_decode_sparse_paged_cuda(
                dq, pool_k, pool_v, table, *p0, valid),
            lambda: flash_decode_sparse_paged_cuda(
                dq_l, pk_l, pv_l, table, *p_l, valid, num_kv_heads=hkv),
            20)}
    # what a copy of the shard's kv heads would add to each launch (the
    # sharded decode read contiguous copies before it read in place)
    copies = {"decode_attn": lambda: (ck_l.contiguous(), cv_l.contiguous()),
              "decode_attn_paged": lambda: (pk_l.contiguous(),
                                            pv_l.contiguous())}
    times = {}
    for turn in range(MESH_RANKS):        # one rank times while the other
        dist.barrier()                    # waits: the card is shared
        if turn != rank:
            continue
        for name, (full, local, reps) in calls.items():
            times[name] = {
                "full_ms": cuda_ms(full, reps),
                "full_device_ms": device_ms(full, reps),
                "shard_ms": cuda_ms(local, reps),
                "shard_device_ms": device_ms(local, reps)}
            if name in copies:
                times[name]["copy_ms"] = cuda_ms(copies[name], reps)
        print(f"  22c rank {rank} (two ranks on one card, the other idle): "
              f"{json.dumps(times)}", file=sys.__stdout__, flush=True)
    dist.barrier()
    return {"bitwise": same, "times": times}


def phase22_rank(rank: int, device, out_dir: str) -> None:
    """One rank of phase 22 (``run_ranks``); rank 0 prints, rank 1 writes
    only its errors.  Writes ``rank{r}.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as dsh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import build_model

    if rank:
        sys.stdout = open(os.devnull, "w")
    # a young process: its profiler sessions keep CUPTI up (C.4 concerns
    # aged processes), and one that tore CUPTI down hangs at its exit
    os.environ.pop("TEARDOWN_CUPTI", None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_serving_mesh(MESH_RANKS)
    rules = dsh.ShardingRules(mesh)
    print(f"22: mesh {mesh.shape} on {device}, backend "
          f"{dist.get_backend()}: all_gather takes the CUDA "
          f"tensors directly (no collective staged by the port)", flush=True)
    cfg = dataclasses.replace(get_config(ARCH), num_layers=MESH_LAYERS)
    model = build_model(cfg, dtype=torch.bfloat16)
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    checksum = float(sum(float(p.double().sum()) for p in tu.leaves(params)))
    if not _all_agree(checksum):
        raise AssertionError("phase 22: the ranks' weights differ")
    print(f"22: {cfg.name} at full width, {MESH_LAYERS} of 32 layers, bf16, "
          f"weights checksum {checksum!r} equal on both ranks", flush=True)
    res = {"rank": rank, "device": str(device)}
    t = time.time()

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    print("22a: phase 4's requests, single device then sharded", flush=True)
    plain = mesh_serve("single device",
                       lambda: serve_full(model, params, prompts, {}), None)
    sharded = mesh_serve("sharded", lambda: serve_full(model, params, prompts,
                                                       {}), rules)
    _check_streams("22a", plain, sharded, lambda run: run["logits"])
    want = {"strip": MESH_LAYERS, "block_sparse_attn": MESH_LAYERS,
            "decode_attn": MESH_LAYERS * (NEW_TOKENS - 1)}
    _expect_counts("22a sharded serve", sharded["counts"], want)
    hkv, h = cfg.num_kv_heads, cfg.num_heads
    n = MESH_RANKS
    want_calls = {("prefill", h // n, h): MESH_LAYERS,
                  ("decode", hkv // n, hkv): MESH_LAYERS * (NEW_TOKENS - 1)}
    if sharded["shard_calls"] != want_calls or plain["shard_calls"]:
        raise AssertionError(f"22a shard calls {sharded['shard_calls']}, "
                             f"expected {want_calls}")
    if not (len(plain["plans"]) == len(sharded["plans"]) == 1
            and _same(plain["plans"][0], sharded["plans"][0])
            and _all_agree(tensors_digest(sharded["plans"][0]))):
        raise AssertionError("22a: the sharded serve's plan is not the "
                             "single-device plan on both ranks")
    agree = (_all_agree(sharded["digest"].value())
             and sharded["digest"].value() == plain["digest"].value())
    print(f"  22a: plan equal to the single-device plan on both ranks; masks "
          f"and decisions of {sharded['digest'].calls} layer calls equal "
          f"across ranks and to the single-device serve: {agree}",
          flush=True)
    if not agree:
        raise AssertionError("22a: masks or decisions differ")
    res["22a"] = {"launches": sharded["counts"],
                  "shard_calls": {"/".join(map(str, k)): v for k, v in
                                  sharded["shard_calls"].items()},
                  "all_gather": sharded["gather"]}
    tokens = torch.as_tensor(np.stack([np.pad(p, (0, SEQ - len(p)))
                                       for p in prompts]), device=model.device)
    plan = sharded["plans"][0]
    del plain, sharded
    torch.cuda.empty_cache()
    print(f"22a: {time.time() - t:.1f} s", flush=True)

    print("22b: phase 6's requests, paged scheduler, 148 pages", flush=True)
    rng = np.random.default_rng(SEED + 2)
    paged_prompts = [rng.integers(0, cfg.vocab_size, ln)
                     for ln, _ in PAGED_REQUESTS]
    news = [m for _, m in PAGED_REQUESTS]
    runs = [mesh_serve(label, lambda: scheduler_serve(
        model, params, paged_prompts, news, paged=True,
        num_pages=NUM_PAGES), r) for label, r in (("single device", None),
                                                 ("sharded", rules))]
    for run, what in zip(runs, ("single-device", "sharded")):
        check_paged_run(run, f"22b {what} paged serve")
    _check_streams("22b", *runs, lambda run: run["probe"].logits)
    first = runs[0]["probe"].first
    if not all(torch.equal(first[key], runs[1]["probe"].first[key])
               for key in first):
        raise AssertionError("22b: first-step logits differ")
    calls = runs[1]["shard_calls"]
    steps = runs[1]["eng"].slot_steps // runs[1]["eng"].ecfg.max_batch
    if calls.get(("decode_paged", hkv // n, hkv), 0) < MESH_LAYERS * steps \
            or any(k[0] == "decode" for k in calls) \
            or runs[1]["counts"]["decode_attn_paged"] \
            != calls[("decode_paged", hkv // n, hkv)]:
        raise AssertionError(f"22b shard calls {calls}, launches "
                             f"{runs[1]['counts']}")
    res["22b"] = {"launches": runs[1]["counts"], "decode_steps": steps,
                  "shard_calls": {"/".join(map(str, k)): v for k, v in
                                  calls.items()},
                  "all_gather": runs[1]["gather"],
                  "pool": runs[1]["eng"].page_pool_stats}
    del runs
    torch.cuda.empty_cache()
    print(f"22b: {time.time() - t:.1f} s", flush=True)

    print("22c: the sharded kernels against their single-device launches",
          flush=True)
    res["22c"] = mesh_kernels(model, params, tokens, plan, mesh, rank)
    print(f"22c: {time.time() - t:.1f} s", flush=True)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def launcher_runs() -> dict:
    """Phase 22d: ``python -m repro_torch.launch.serve --arch
    llama3-8b-262k --smoke --decode-sparse`` with and without
    ``--model-parallel 2``, at once, under one ``PYTHONHASHSEED``; the
    request lines must be equal but for their times (tokens, finish
    reasons, plan shares, pattern stats).  The smoke config's random
    weights mostly repeat one token: 22a and 22b hold the logits."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONHASHSEED="0")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
           "--smoke", "--decode-sparse"]
    t = time.time()
    procs = [subprocess.Popen(cmd + extra, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT)
             for extra in ([], ["--model-parallel", str(MESH_RANKS)])]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=MESH_TIMEOUT_S)
        finally:
            p.kill()
        if p.returncode:
            raise AssertionError(f"22d: the launcher failed:\n{err[-3000:]}")
        outs.append([_untimed(line) for line in out.splitlines()
                     if line.startswith("req ")])
        print("  " + "\n  ".join(out.strip().splitlines()[-6:]), flush=True)
    print(f"  22d: {len(outs[0])} request lines equal but for their times "
          f"without and with --model-parallel {MESH_RANKS}: "
          f"{bool(outs[0]) and outs[0] == outs[1]} ({time.time() - t:.1f} "
          f"s)", flush=True)
    if not outs[0] or outs[0] != outs[1]:
        raise AssertionError(f"22d: the launcher's sharded requests differ:"
                             f"\n{outs[0]}\n{outs[1]}")
    return {"tokens": [re.search(r"out=(\[[^\]]*\])", line).group(1)
                       for line in outs[0]]}


def _untimed(line: str) -> str:
    """A launcher request line without its times and rates."""
    line = re.sub(r"\b(queue|ttft|prefill|decode)=[0-9.]+s", r"\1=", line)
    return re.sub(r"\([0-9.]+ tok/s, ", "(", line)


def phase22() -> dict:
    """Phase 22: the heads-sharded serve (A.12) on two ranks sharing the
    card over gloo, then the serving launcher with ``--model-parallel``."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.mesh import run_ranks
    print("== phase 22: heads-sharded serve, two ranks on one card "
          "(gloo)", flush=True)
    t = time.time()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shutil.rmtree(MESH_OUT, ignore_errors=True)
    os.makedirs(MESH_OUT)
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(phase22_rank, MESH_RANKS, (MESH_OUT,),
                  init_file=os.path.join(tmp, "store"), device="cuda",
                  timeout_s=MESH_TIMEOUT_S)
    res = {}
    for r in range(MESH_RANKS):
        with open(os.path.join(MESH_OUT, f"rank{r}.json")) as f:
            res[f"rank{r}"] = json.load(f)
    print(f"phase 22a-c: {time.time() - t:.1f} s", flush=True)
    res["22d"] = launcher_runs()
    print(f"phase 22: {time.time() - t:.1f} s ({nvidia_smi()}); "
          + json.dumps(res), flush=True)
    return res


def build_other(tree: str) -> dict:
    """Another checkout's ``block_sparse_attn.cu`` and ``strip.cu``, built
    with this checkout's nvcc flags into ``build/bitwise/``."""
    from repro_torch.kernels import _build
    out = os.path.join(ROOT, "build", "bitwise")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for stem in ("block_sparse_attn", "strip"):
        lib = os.path.join(out, f"lib{stem}.so")
        src = os.path.join(tree, "src", "repro_torch", "csrc", f"{stem}.cu")
        procs[stem] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src]))
    libs = {}
    for stem, (lib, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed on the other {stem}.cu")
        libs[stem] = ctypes.CDLL(lib)
    return libs


def c_fn(lib, name: str, n_ptr: int, n_int: int):
    f = getattr(lib, name)
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def bitwise_instances(tree: str) -> int:
    """``--bitwise TREE``: hold this checkout's block-sparse and strip
    instances bitwise to another checkout's (``git archive PARENT | tar -x
    -C build/parent``, then ``--bitwise build/parent``).  Both run on the
    same seeded inputs: B.2, B.6 and B.5 (BATCHED, SINGLE, PAGED) at bs in
    {64, 128} and D in {64, 96, 128}, B.2 and B.6 also at D = 256 and
    (Dqk, Dv) = (192, 128), random causal tables, a random stats gate, W
    capped and not, and B.1 at the equal head dims; float32 and bfloat16.
    Every output and Ã must be ``torch.equal``, but for ``HOPPER_CASE``
    (B.2 in bf16 at bs = 128, D = 128), whose body this checkout may have
    replaced: there both checkouts are held to the plain version within
    ``TOL``.  One line per case, and a non-zero exit on any difference.
    The other checkout's C functions take the same arguments as this
    one's (the V width included).  Then B.2 in bf16 at phase 2's shape is
    timed in both, other, this, this, other."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.kernels import strip as sk
    from repro_torch.kernels.indices import compact_block_mask

    libs = build_other(tree)
    bsa_lib = libs["block_sparse_attn"]
    other_b = c_fn(bsa_lib, "repro_block_sparse_attn", 8, 12)
    other_s = c_fn(bsa_lib, "repro_block_sparse_attn_single", 7, 9)
    other_p = c_fn(bsa_lib, "repro_block_sparse_attn_paged", 9, 12)
    other_strip = c_fn(libs["strip"], "repro_strip", 4, 9)
    P, stream = _build.ptr, _build.stream_of
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hkv, n = 2, 8, 2, 1024
    bad = 0
    widths = ((64, 64), (96, 96), (128, 128), (256, 256), (192, 128))
    for dtype in (torch.float32, torch.bfloat16):
        code = _build.dtype_code(torch.empty(0, dtype=dtype))
        for bs in (64, 128):
            nb = n // bs
            causal = torch.ones(nb, nb, dtype=torch.bool, device=dev).tril()
            masks = (torch.rand((b, h, nb, nb), generator=gen, device=dev)
                     < 0.6) & causal
            masks |= torch.eye(nb, dtype=torch.bool, device=dev)
            gate = (torch.rand((b, h), generator=gen, device=dev)
                    < 0.5).int()
            for d, dv in widths:
                q, k, v = (torch.randn(shape, generator=gen, device=dev)
                           .to(dtype) for shape in
                           ((b, h, n, d), (b, hkv, n, d), (b, hkv, n, dv)))
                equal = d == dv and d != 256
                results = []
                for width in (None, nb // 2):
                    idx, cnt = (x.contiguous() for x in
                                compact_block_mask(masks, width=width))
                    w = idx.shape[-1]
                    mine = bsa.block_sparse_attention_cuda(
                        q, k, v, idx, cnt, block_size=bs, stats_gate=gate)
                    out = q.new_empty((b, h, n, dv))
                    at = torch.full_like(mine[1], float("-inf"))
                    _build.check(other_b(
                        P(q), P(k), P(v), P(idx), P(cnt), P(gate), P(out),
                        P(at), code, b, h, hkv, n, n, d, dv, bs, w, 0, 1,
                        stream(q)), "other batched")
                    plain = (bsa.block_sparse_attention_plain(
                        q, k, v, idx, cnt, block_size=bs, stats_gate=gate)
                        if (str(dtype), bs, d, dv) == HOPPER_CASE else None)
                    results.append(("BATCHED", mine, (out, at), plain))
                    i0, c0 = idx[0].contiguous(), cnt[0].contiguous()
                    mine = bsa.block_sparse_attention_single_cuda(
                        q[0], k[0], v[0], i0, c0, block_size=bs)
                    out = q.new_empty((h, n, dv))
                    st = torch.full_like(mine[1], float("-inf"))
                    _build.check(other_s(
                        P(q[0]), P(k[0]), P(v[0]), P(i0), P(c0), P(out),
                        P(st), code, h, hkv, n, d, dv, bs, w, 1, stream(q)),
                        "other single")
                    results.append(("SINGLE", mine, (out, st), None))
                    if not equal:
                        continue
                    pages = (1 + torch.randperm(b * nb + 2, generator=gen,
                                                device=dev)[:b * nb]).int()
                    table = pages.reshape(b, nb).contiguous()
                    pool_k, pool_v = (torch.zeros((b * nb + 3, hkv, bs, d),
                                                  dtype=dtype, device=dev)
                                      for _ in range(2))
                    for pool, x in ((pool_k, k), (pool_v, v)):
                        pool[table.reshape(-1).long()] = x.reshape(
                            b, hkv, nb, bs, d).transpose(1, 2).reshape(
                            -1, hkv, bs, d)
                    mine = bsa.block_sparse_attention_paged_cuda(
                        q, pool_k, pool_v, table, idx, cnt, block_size=bs,
                        stats_gate=gate)
                    out = torch.empty_like(q)
                    at = torch.full_like(mine[1], float("-inf"))
                    _build.check(other_p(
                        P(q), P(pool_k), P(pool_v), P(table), P(idx),
                        P(cnt), P(gate), P(out), P(at), code, b, h, hkv, n,
                        nb, d, bs, w, 0, 1, b * nb + 3, stream(q)),
                        "other paged")
                    results.append(("PAGED", mine, (out, at), None))
                if not equal:
                    bad += report_cases(dtype, bs, (d, dv), results)
                    continue
                mine = sk.strip_scores_cuda(q, k, bs)
                out = torch.empty_like(mine)
                chunk = sk.strip_chunk(n)
                ml = torch.empty((2, b, h, bs, -(-n // chunk)),
                                 dtype=torch.float32, device=dev)
                _build.check(other_strip(P(q), P(k), P(out), P(ml), code, b,
                                         h, hkv, n, n, d, bs, chunk,
                                         stream(q)), "other strip")
                results.append(("STRIP", (mine,), (out,), None))
                bad += report_cases(dtype, bs, (d, dv), results)
    print(f"bitwise_instances: {bad} cases differ", flush=True)
    # B.2 in bf16 at phase 2's shape, the other checkout's body beside this
    # one's in the order other, this, this, other
    b, h, hkv, n, d, bs = 2, 32, 8, SEQ, 128, 128
    nb = n // bs
    masks = ((torch.rand((b, h, nb, nb), generator=gen, device=dev) < 0.86)
             & torch.ones(nb, nb, dtype=torch.bool, device=dev).tril()
             ) | torch.eye(nb, dtype=torch.bool, device=dev)
    idx, cnt = (x.contiguous() for x in compact_block_mask(masks))
    gate = torch.zeros((b, h), dtype=torch.int32, device=dev)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((b, h, n, d), (b, hkv, n, d), (b, hkv, n, d)))
    out = torch.empty_like(q)
    at = torch.empty((b, h, nb, nb), dtype=torch.float32, device=dev)
    code = _build.dtype_code(q)
    runs = {
        "other": lambda: _build.check(other_b(
            P(q), P(k), P(v), P(idx), P(cnt), P(gate), P(out), P(at), code,
            b, h, hkv, n, n, d, d, bs, idx.shape[-1], 0, 1, stream(q)),
            "other"),
        "this": lambda: bsa.block_sparse_attention_cuda(
            q, k, v, idx, cnt, block_size=bs, stats_gate=gate)}
    times = [(who, cuda_ms(runs[who], 20))
             for who in ("other", "this", "this", "other")]
    print("B.2 bf16 at B=2 H=32 Hkv=8 N=8192 D=128 bs=128, ms: "
          + ", ".join(f"{who} {ms:.4f}" for who, ms in times), flush=True)
    return 1 if bad else 0


# the one case of bitwise_instances whose body this checkout replaced
HOPPER_CASE = ("torch.bfloat16", 128, 128, 128)


def report_cases(dtype, bs: int, widths: tuple, results) -> int:
    """Print one line per (mode, this, other, plain) case of
    ``bitwise_instances``; the number that differ.  A case with a plain
    version (``HOPPER_CASE``) holds both sides to it within ``TOL``
    instead of to each other."""
    import torch
    torch.cuda.synchronize()
    dn = str(dtype)[6:]
    bad = 0
    for mode, a, c, plain in results:
        if plain is None:
            ok = all(torch.equal(x, y) for x, y in zip(a, c))
            what = f"bitwise {ok}"
        else:
            errs = [(max_err(side[0], plain[0]),
                     a_tilde_err(side[1], plain[1])) for side in (a, c)]
            ok = all(e <= TOL[("out", dn)] and ea <= TOL[("a_tilde", dn)]
                     for e, ea in errs)
            what = (f"within TOL of the plain version {ok} (this out "
                    f"{errs[0][0]:.3e} Ã {errs[0][1]:.3e}, other out "
                    f"{errs[1][0]:.3e} Ã {errs[1][1]:.3e})")
        bad += not ok
        print(f"{dn} bs={bs} D={widths[0]}/{widths[1]} {mode}: {what}",
              flush=True)
    return bad



STEPS_PREFILL_BATCH = 1     # 23a: prefill_32k's 32 rows cut to 1
STEPS_DECODE_BATCH = 8      # 23b: decode_32k's 128 rows cut to 8
STEPS_LONG_LAYERS = 24      # 23b: long_500k at 24 of 32 layers
STEPS_PEAK_TOL = 0.15       # the dry-run's peak against the card's rise
STEPS_REPS = 3              # timed decode steps
EXAMPLES = ("quickstart", "serve_longcontext", "train_small",
            "pattern_visualization")
EXAMPLES_TIMEOUT_S = 300


@contextlib.contextmanager
def cut_steps(batch: int, layers=None):
    """``repro_torch.launch.steps`` building its bundles at ``batch`` rows
    (and ``layers`` layers) in place of the registry's shape (and depth)."""
    from repro_torch import configs
    from repro_torch.launch import steps
    old = steps.get_config, steps.get_shape
    steps.get_config = lambda n: (
        dataclasses.replace(configs.get_config(n), num_layers=layers)
        if layers else configs.get_config(n))
    steps.get_shape = lambda n: dataclasses.replace(configs.get_shape(n),
                                                    global_batch=batch)
    try:
        yield
    finally:
        steps.get_config, steps.get_shape = old


@contextlib.contextmanager
def one_rank_world():
    """A gloo world of one rank (this process, the card) and its ``(1, 1)``
    mesh."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            yield make_test_mesh((1, 1))
        finally:
            dist.destroy_process_group()


def card_args(bundle, vocab: int):
    """The bundle's arguments on the card, from the seed: bf16 weights
    N(0, 0.02) (norm scales ones), tokens in the vocabulary, caches
    N(0, 0.5)."""
    import torch
    from repro_torch.launch import steps
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def make(key, shape, dtype):
        t = torch.empty(shape, dtype=dtype, device="cuda")
        if not dtype.is_floating_point:
            return t.random_(0, vocab, generator=gen)
        if key.endswith("scale"):
            return t.fill_(1.0)
        return t.normal_(0.0, 0.02 if key.startswith("0::") else 0.5,
                         generator=gen)
    return steps.plain_args(bundle, make)


def phase23a() -> dict:
    """23a: the prefill bundle at full depth, batch cut to 1 (32768 tokens),
    on real tensors: launches exactly B.1 and B.2 once a layer, last logits
    and cache bitwise ``model.prefill`` called outside the bundle."""
    import torch
    from repro_torch import checkpoint
    from repro_torch import tree as tu
    from repro_torch.configs import get_shape
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    with one_rank_world() as mesh, cut_steps(STEPS_PREFILL_BATCH):
        bundle = steps.build_step(ARCH, "prefill_32k", mesh)
        cfg = bundle.cfg
        n = get_shape("prefill_32k").seq_len
        print(f"23a: {bundle.name}, {cfg.num_layers} layers, reduced: batch "
              f"32 -> {STEPS_PREFILL_BATCH} ({STEPS_PREFILL_BATCH * n} "
              f"tokens); bf16, seed-{SEED} random weights", flush=True)
        args = card_args(bundle, cfg.vocab_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for i in range(2):
            reset_launch_counts()
            t = time.perf_counter()
            out = bundle.fn(*args)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
            counts = launch_counts()
            _expect_counts(f"23a prefill bundle, run {i + 1}", counts, {
                "strip": cfg.num_layers,
                "block_sparse_attn": cfg.num_layers})
            if i == 0:
                del out
        peak = torch.cuda.max_memory_allocated() / 2**30
        direct = build_model(cfg, dtype=torch.bfloat16).prefill(
            checkpoint.params_from_tree(args[0], cfg), args[1],
            steps._sp_for(cfg), method="share")
        torch.cuda.synchronize()
    same_logits = torch.equal(out.last_logits, direct.last_logits)
    same_cache = all(torch.equal(a, b) for a, b in
                     zip(tu.leaves(out.cache), tu.leaves(direct.cache)))
    finite = bool(torch.isfinite(out.last_logits.float()).all())
    print(f"  23a: launches {counts} (each run); prefill_s run 1 "
          f"{runs[0]:.4f}, run 2 {runs[1]:.4f}; peak {peak:.2f} GiB; last "
          f"logits {tuple(out.last_logits.shape)} finite {finite}, bitwise "
          f"model.prefill {same_logits}, cache bitwise {same_cache}",
          flush=True)
    if not (same_logits and same_cache and finite):
        raise AssertionError("23a: the bundle's prefill is not bitwise "
                             "model.prefill, or not finite")
    del out, direct, args
    torch.cuda.empty_cache()
    return {"prefill_s": runs, "peak_gib": peak, "launches": counts}


def phase23b(shape_name: str, batch: int, layers) -> dict:
    """23b: one decode step of ``shape_name``'s bundle at the cut shape on
    the card, against the dry-run's accounting of the same bundle on a fake
    world of one rank: argument bytes and FLOPs exactly, the predicted peak
    (argument + temp + output) within ``STEPS_PEAK_TOL`` of the rise of
    ``max_memory_allocated``; the step time beside the roofline's
    ``memory_s``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                         fake_world, make_test_mesh)
    from repro_torch.launch.step_analysis import roofline_terms, tree_bytes
    full = get_shape(shape_name)
    with cut_steps(batch, layers):
        t = time.time()
        with fake_world(1):
            rec = dryrun.analyse_step(steps.build_step(
                ARCH, shape_name, make_test_mesh((1, 1))))
        dry_s = time.time() - t
        with one_rank_world() as mesh:
            bundle = steps.build_step(ARCH, shape_name, mesh)
            cfg = bundle.cfg
            print(f"23b: {bundle.name}, reduced: batch {full.global_batch} "
                  f"-> {batch}, layers {get_config(ARCH).num_layers} -> "
                  f"{cfg.num_layers}; cache {full.seq_len}; dry-run "
                  f"accounting {dry_s:.1f} s on the CPU", flush=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            args = card_args(bundle, cfg.vocab_size)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with FlopCounterMode(display=False) as fc:
                logits, _ = bundle.fn(*args)
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - base
            times = []
            for _ in range(STEPS_REPS):
                t = time.perf_counter()
                logits, _ = bundle.fn(*args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
    mem = rec["memory"]
    arg_bytes = tree_bytes(args)
    predicted = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                 + mem["output_size_in_bytes"])
    terms = roofline_terms(
        flops=rec["cost"]["flops"], bytes_accessed=rec["cost"]["bytes accessed"],
        coll=rec["collectives"], chips=1, peak_flops=PEAK_FLOPS_BF16,
        hbm_bw=HBM_BW, link_bw=LINK_BW)
    step_s = sorted(times)[len(times) // 2]
    finite = bool(torch.isfinite(logits.float()).all())
    out = {"shape": shape_name, "batch": batch, "layers": cfg.num_layers,
           "arg_bytes_card": arg_bytes, "memory": mem,
           "flops_card": fc.get_total_flops(), "flops_dry": rec["cost"]["flops"],
           "peak_predicted_bytes": predicted, "peak_rise_bytes": rise,
           "peak_ratio": predicted / rise, "step_s": times,
           "memory_s": terms["memory_s"], "compute_s": terms["compute_s"],
           "memory_s_over_step_s": terms["memory_s"] / step_s,
           "logits_finite": finite}
    print("  23b: " + json.dumps(out), flush=True)
    if arg_bytes != mem["argument_size_in_bytes"]:
        raise AssertionError(f"23b {shape_name}: argument bytes {arg_bytes} "
                             f"on the card, {mem['argument_size_in_bytes']} "
                             f"in the dry-run")
    if out["flops_card"] != out["flops_dry"]:
        raise AssertionError(f"23b {shape_name}: FLOPs {out['flops_card']} "
                             f"on the card, {out['flops_dry']} in the dry-run")
    if abs(predicted / rise - 1) > STEPS_PEAK_TOL:
        raise AssertionError(f"23b {shape_name}: predicted peak {predicted} "
                             f"against a rise of {rise}")
    if not finite:
        raise AssertionError(f"23b {shape_name}: non-finite logits")
    del args, logits
    torch.cuda.empty_cache()
    return out


def phase23c() -> dict:
    """23c: the four examples as subprocesses on the card, at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t = time.time()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for name in EXAMPLES}
    outs, failed = {}, []
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=EXAMPLES_TIMEOUT_S)
        finally:
            p.kill()
        outs[name] = out
        if p.returncode:
            failed.append(name)
            print(f"  23c: {name} exited {p.returncode}:\n{err[-3000:]}",
                  flush=True)
    for name, out in outs.items():
        lines = out.strip().splitlines()
        keep = lines if name == "serve_longcontext" else lines[-3:]
        print(f"  23c {name}:\n    " + "\n    ".join(keep), flush=True)
    print(f"  23c: {len(EXAMPLES) - len(failed)} of {len(EXAMPLES)} examples "
          f"exited 0 ({time.time() - t:.1f} s)", flush=True)
    if failed:
        raise AssertionError(f"23c: examples failed: {failed}")
    return {"seconds": time.time() - t}


def phase23() -> dict:
    """Phase 23: the launch layer's step bundles on the card (A.13)."""
    import torch
    print("== phase 23: step bundles on the card, the dry-run's accounting "
          "held against it, the examples", flush=True)
    t = time.time()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res = {"23a": phase23a()}
    res["23b_decode_32k"] = phase23b("decode_32k", STEPS_DECODE_BATCH, None)
    res["23b_long_500k"] = phase23b("long_500k", 1, STEPS_LONG_LAYERS)
    res["23c"] = phase23c()
    print(f"phase 23: {time.time() - t:.1f} s ({nvidia_smi()})", flush=True)
    return res


# ---------------------------------------------------------------- phase 24

# Qwen2.5-7B's attention layer (the prefill cell's): 28 query heads over 4
# kv heads (G = 7), head dim 128, block 128; its buckets
QWEN_HEADS, QWEN_KV_HEADS = 28, 4
QWEN_LENS = (16384, 32768, 65536)
HOPPER_BODY = "bsa_wgmma_kernel"


def shuffled_tables(masks, gen):
    """``compact_block_mask(masks)`` with each row's listed blocks in a
    random order (the kernel takes them in any order)."""
    import torch
    from repro_torch.kernels import compact_block_mask
    idx, cnt = compact_block_mask(masks)
    live = torch.arange(idx.shape[-1], device=idx.device) < cnt[..., None]
    key = torch.where(live, torch.rand(idx.shape, generator=gen,
                                       device=idx.device), 2.0)
    idx = torch.gather(idx, -1, key.argsort(-1))
    return idx.int().contiguous(), cnt.int().contiguous()


def device_names(fn) -> set:
    """The names of the device kernels one call of ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    return {e.key for e in prof.key_averages() if _device_us(e) > 0}


def phase24() -> dict:
    """Phase 24: B.2's Hopper body (``bsa_wgmma_kernel``, BATCHED bf16 at
    bs = 128, D = 128) against its plain version at Qwen2.5-7B's layer
    shape (H = 28, Hkv = 4, N = 16384), with a counts == 0 row, a row
    whose only block is the diagonal, half the heads ungated (their Ã all
    −inf), every row's blocks in a random order, and a 16-block chunk at
    a q_block_offset > 0 (bitwise the full launch's rows); the profiler
    shows which body ran.  Then its times at G = 7 on every causal block
    (the prefill cell's density is 0.99) at 16k, 32k and 64k, every head
    emitting Ã, beside the bound, the plain version (16k: it holds a dense
    (N, N) float32 logit matrix per head) and SDPA's causal kernel on K/V
    expanded to 28 heads (the same work, no Ã)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.kernels import (
        compact_block_mask, expand_kv, table_block_mask)
    print("== phase 24: B.2's Hopper body at Qwen2.5-7B's layer shape",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    h, hkv, d, bs, n = QWEN_HEADS, QWEN_KV_HEADS, 128, 128, QWEN_LENS[0]
    nb = n // bs

    def qkv(length):
        return (torch.randn((1, x, length, d), generator=gen, device=dev)
                .bfloat16() for x in (h, hkv, hkv))

    q, k, v = qkv(n)
    causal = torch.ones(nb, nb, dtype=torch.bool, device=dev).tril()
    masks = ((torch.rand((1, h, nb, nb), generator=gen, device=dev) < 0.9)
             & causal) | torch.eye(nb, dtype=torch.bool, device=dev)
    masks[0, 3, nb // 2] = False                 # a counts == 0 row
    masks[0, 5, nb - 1] = False                  # only the diagonal
    masks[0, 5, nb - 1, nb - 1] = True
    idx, cnt = shuffled_tables(masks, gen)
    gate = (torch.arange(h, device=dev) % 2 == 0)[None]   # half ungated
    run = lambda: bsa.block_sparse_attention_cuda(
        q, k, v, idx, cnt, block_size=bs, stats_gate=gate)
    o1, a1 = run()
    o2, a2 = bsa.block_sparse_attention_plain(q, k, v, idx, cnt,
                                              block_size=bs, stats_gate=gate)
    zero_row = bool((o1[0, 3, (nb // 2) * bs:(nb // 2 + 1) * bs] == 0).all())
    ungated = bool(torch.isinf(a1[:, 1::2]).all())
    names = device_names(run)
    body = sorted(x for x in names if HOPPER_BODY in x)
    print(f"  B.2 [H={h} Hkv={hkv} N={n}, shuffled rows]: counts==0 row "
          f"zeros {zero_row}, ungated heads' Ã all -inf {ungated}, device "
          f"kernels {sorted(names)}", flush=True)
    if not (zero_row and ungated and body):
        raise AssertionError("the Hopper body's edge rows, gate or launch "
                             "failed")
    err = {"out": max_err(o1, o2), "a_tilde": a_tilde_err(a1, a2)}
    for what, e in err.items():
        check(f"  {what}", e, TOL[(what, "bfloat16")])
    # a 16-block chunk at q block off (chunked prefill's rectangular launch)
    off = nb - 24
    rows = slice(off * bs, (off + 16) * bs)
    qc = q[:, :, rows].contiguous()
    cidx, ccnt = (x[:, :, off:off + 16].contiguous() for x in (idx, cnt))
    oc, ac = bsa.block_sparse_attention_cuda(
        qc, k, v, cidx, ccnt, block_size=bs, stats_gate=gate,
        q_block_offset=off)
    op, ap = bsa.block_sparse_attention_plain(
        qc, k, v, cidx, ccnt, block_size=bs, stats_gate=gate,
        q_block_offset=off)
    same = (torch.equal(oc, o1[:, :, rows])
            and torch.equal(ac, a1[:, :, off:off + 16]))
    print(f"  B.2 [16-block chunk at q block {off}]: bitwise the full "
          f"launch's rows {same}", flush=True)
    if not same:
        raise AssertionError("the chunk launch differs from the full "
                             "launch's rows")
    check("  out", max_err(oc, op), TOL[("out", "bfloat16")])
    check("  a_tilde", a_tilde_err(ac, ap), TOL[("a_tilde", "bfloat16")])
    res = {"max_abs_err": max(err["out"], max_err(oc, op))}
    del q, k, v, o1, o2, a1, a2, oc, op, ac, ap
    torch.cuda.empty_cache()

    # times at every causal block, every head emitting Ã
    for n in QWEN_LENS:
        nb = n // bs
        q, k, v = qkv(n)
        full = torch.ones(nb, nb, dtype=torch.bool, device=dev).tril()
        idx, cnt = (x.int().contiguous() for x in
                    compact_block_mask(full.expand(1, h, nb, nb)))
        gate = torch.ones((1, h), dtype=torch.bool, device=dev)
        vis = table_block_mask(idx, cnt, nb)
        entries, tiles = bsa_work(vis, h // hkv, bs, 0)
        b24 = bound(2 * h * n * d * 2 + 2 * tiles * bs * d * 2
                    + idx.numel() * 4 + cnt.numel() * 4 + h * nb * nb * 4,
                    4.0 * d * entries, torch.bfloat16)
        run = lambda: bsa.block_sparse_attention_cuda(
            q, k, v, idx, cnt, block_size=bs, stats_gate=gate)
        kx, vx = expand_kv(k, v, h)
        lib = library_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, is_causal=True), 3)
        del kx, vx
        plain = (cuda_ms(lambda: bsa.block_sparse_attention_plain(
            q, k, v, idx, cnt, block_size=bs, stats_gate=gate), 1)
            if n == QWEN_LENS[0] else None)
        r = dict(ms=cuda_ms(run, 10), device_ms=device_ms(run, 5),
                 bound_ms=b24[0], bound_by=b24[1], plain_ms=plain,
                 library_ms=lib)
        r["bound_frac"] = r["bound_ms"] / r["ms"]
        res[f"n{n}"] = r
        print(f"  B.2 bf16 G=7 N={n}: {r['ms']:.3f} ms (device "
              f"{r['device_ms']:.3f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}, bound_frac {r['bound_frac']:.4f}, plain "
              f"{plain}, library {lib})", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    print(f"phase 24 ({nvidia_smi()})", flush=True)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.checkpoint import num_params
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    smi = nvidia_smi()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--profiler-probe"]:
        return profiler_probe()         # no kernels, no result line
    if sys.argv[1:2] == ["--profiler-probe-run"]:
        profiler_probe_run(sys.argv[2])
        return 0
    os.environ["TEARDOWN_CUPTI"] = "1"  # before the first session: traced()

    t = time.time()
    _build.build_all()
    print(f"build_s {time.time() - t:.2f}", flush=True)
    only = sys.argv[1:]
    if len(only) == 2 and only[0] == "--bitwise":
        return bitwise_instances(only[1])  # no result line
    alone = {"14": phase14, "15": phase15, "16": phase16, "18": phase18,
             "19": phase19, "20": phase20, "21": phase21, "22": phase22,
             "23": phase23, "24": phase24}
    if len(only) == 2 and only[0] == "--phase" and only[1] in alone:
        # a check of phase 14, 15, 16 or 18 to 24 alone; it prints no
        # result line
        alone[only[1]]()
        return 0

    cfg = get_config(ARCH)
    model = build_model(cfg, dtype=torch.bfloat16)
    t = time.time()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{num_params(params) / 1e9:.3f} B params in bf16, init "
          f"{time.time() - t:.2f} s", flush=True)

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    toks = np.zeros((len(prompts), SEQ), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tokens = torch.as_tensor(toks, device="cuda")
    plens = torch.tensor(PROMPT_LENS, device="cuda")
    layers = cfg.num_layers
    if only == ["--phase", "12"]:
        # a check of phase 12 alone; it prints no result line
        rng = np.random.default_rng(SEED + 2)
        paged_prompts = [rng.integers(0, cfg.vocab_size, n)
                         for n, _ in PAGED_REQUESTS]
        phase12(model, params, prompts, paged_prompts, layers)
        return 0
    if only == ["--phase", "13"]:
        phase13(model, params, layers)  # alone; no result line
        return 0
    if only == ["--phase", "17"]:
        phase17(model, params, prompts, tokens)     # alone; no result line
        return 0
    if only:
        raise SystemExit(f"unknown arguments {only}; use --phase 12 to 24, "
                         "--bitwise TREE, --profiler-probe, or none")

    print("== phase 2: kernels against their plain versions", flush=True)
    res = check_kernels(model, params, tokens, plens)
    torch.cuda.empty_cache()
    print("== phase 3: small serve, kernels against the CPU", flush=True)
    small_serve_agreement()
    print("== phase 4: full-width serve", flush=True)
    torch.cuda.reset_peak_memory_stats()
    with record_share_masks() as share_masks:
        batch = serve_full(model, params, prompts, {
            "strip": layers, "block_sparse_attn": layers,
            "decode_attn": layers * (NEW_TOKENS - 1)})
    batch["share_masks"] = share_masks
    counts = dict(batch["counts"])
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    profile_serve("(phase 4, 4 new tokens)", lambda wrap: ServingEngine(
        wrap(model), params, model.default_share_prefill(),
        EngineConfig(method="share", decode_sparse=True, max_batch=2,
                     seq_buckets=(SEQ,))).serve(
        [Request(uid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)]))
    torch.cuda.empty_cache()
    print("== phase 5: paged decode kernel against its plain version",
          flush=True)
    res["decode_attn_paged"] = check_paged_decode(model, params, prompts)
    torch.cuda.empty_cache()
    print("== phase 6: full-width continuous-batching serve, paged pool",
          flush=True)
    rng = np.random.default_rng(SEED + 2)
    paged_prompts = [rng.integers(0, cfg.vocab_size, n)
                     for n, _ in PAGED_REQUESTS]
    torch.cuda.reset_peak_memory_stats()
    paged = serve_paged(model, params, paged_prompts, layers)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    counts["decode_attn_paged"] = paged["counts"]["decode_attn_paged"]
    profile_serve("(phase 6, paged scheduler)", lambda wrap: scheduler_serve(
        wrap(model), params, paged_prompts,
        [m for _, m in PAGED_REQUESTS], paged=True, num_pages=NUM_PAGES))
    torch.cuda.empty_cache()
    print("== phase 7: kernel API kernels against their plain versions",
          flush=True)
    api, api_counts = check_kernel_api(model, params, tokens, prompts[0])
    res.update(api)
    for name in ("block_sparse_attn_paged", "decode_attn_dense",
                 "decode_attn_sparse"):
        counts[name] = api_counts[name]
    g12 = check_group12(torch.device("cuda"))
    for name in ("decode_attn", "decode_attn_paged", "decode_attn_dense",
                 "decode_attn_sparse"):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], g12[name])
    torch.cuda.empty_cache()
    print("== phase 8: full-width serve through the per-sample path",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    single = serve_per_sample(model, params, prompts, layers, batch)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    counts["block_sparse_attn_single"] = single["block_sparse_attn_single"]
    profile_serve("(phase 8, per-sample, 4 new tokens)",
                  lambda wrap: ServingEngine(
                      wrap(model), params, model.default_share_prefill(),
                      EngineConfig(method="share", attn_impl="kernel",
                                   decode_sparse=True, max_batch=2,
                                   seq_buckets=(SEQ,))).serve(
                      [Request(uid=i, prompt=p, max_new_tokens=4)
                       for i, p in enumerate(prompts)]))
    torch.cuda.empty_cache()
    print("== phase 9: chunked prefill through the paged scheduler",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    serve_chunked(model, params, paged_prompts, layers, paged)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    profile_serve("(phase 9, chunked paged scheduler)",
                  lambda wrap: scheduler_serve(
                      wrap(model), params, paged_prompts,
                      [m for _, m in PAGED_REQUESTS], paged=True,
                      num_pages=NUM_PAGES, prefill_chunk=CHUNK))
    del paged
    torch.cuda.empty_cache()
    print("== phase 10: the repaired configs at full width", flush=True)
    for arch, depth, lens, new in REPAIRED:
        serve_repaired(arch, depth, lens, new)
    print("== phase 11: the paper's baselines at full width", flush=True)
    t = time.time()
    launches = serve_baselines(model, params, prompts, paged_prompts, layers,
                               batch)
    print(f"phase 11: {time.time() - t:.1f} s; launches by run "
          + json.dumps(launches), flush=True)
    del batch
    torch.cuda.empty_cache()
    phase12(model, params, prompts, paged_prompts, layers)
    phase13(model, params, layers)
    clustered = phase17(model, params, prompts, tokens,
                        res["block_sparse_attn"])
    for r in clustered["block_sparse_attn"].values():
        res["block_sparse_attn"]["max_abs_err"] = max(
            res["block_sparse_attn"]["max_abs_err"], r["max_abs_err"])
    del model, params
    torch.cuda.empty_cache()
    mix = phase14()
    for name in ("strip", "block_sparse_attn", "block_sparse_attn_single",
                 "decode_attn", "decode_attn_paged"):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                       mix[name]["max_abs_err"])
    for later in (phase15, phase16, phase18, phase19, phase20):
        for name, r in later().items():
            if name in KERNELS:
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                               r["max_abs_err"])
    phase21()
    phase22()
    phase23()
    res["block_sparse_attn"]["max_abs_err"] = max(
        res["block_sparse_attn"]["max_abs_err"], phase24()["max_abs_err"])

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = res[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "bound_frac": r["bound_ms"] / r["ms"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as exc:            # any failed phase fails the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        code = 1
    # a process whose profiler sessions tore CUPTI down (TEARDOWN_CUPTI=1,
    # see traced()) can hang in the interpreter's exit (--profiler-probe):
    # leave without it
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
