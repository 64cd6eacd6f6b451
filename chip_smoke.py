#!/usr/bin/env python
"""Chip smoke of the PyTorch/CUDA port (dflash_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Six paths are driven: the bf16/f32 path (float weights and KV cache), the
int8 serving path (int8 weights from quantize_target_params /
quantize_draft_params, and kv_quant=True), the attn_impl="pallas" path
(verify and AR step through qwen3.forward and the frontier-bounded
verify_attention kernel), filtered sampling (generate(top_k, top_p),
whose exact keep set comes from the filter_stats kernel), the batched
engine (spec/batched.py: R request lanes in one forward per cycle, the
attention kernels' lane entries with per-lane frontiers on the card), on the
float and the int8 path, and the serving entry point (engine/batching.py's
continuous batching engine behind engine/server.py's HTTP server, with
per-lane top-k / top-p) with each of its admission routes: batched
admission, the prompt-prefix cache, chunk-interleaved admission,
prefill-ahead and a disaggregated prefill worker.

Phases, each fatal on failure (nothing is caught):
  1. device: card name and power limit; TF32 off for matmuls and cuDNN.
  2. build: every CUDA kernel from dflash_tpu_torch/kernels/csrc, in parallel.
  3. kernels vs plain at the main path's shapes, bf16 and f32: verify_fused
     (bf16/f32 ctx and int8 ctx; nh 32, n_kv 8, d 128; ctx_len in {0, 1,
     700, T - 16} and on both sides of the bf16 kernel's first split
     boundary, each with NaN ctx K/V, or int8 scales, past ctx_len),
     prefill_flash (S in {128, 130, 640, 2048}), and
     matmul_int8 at every Qwen3-8B projection shape x S in {1, 15, 16, 640}
     (and 2048 for bf16 x), one [matmul] line each with its plan
     (matmul_q.plan: variant, tile, K split): max abs error against the plain
     PyTorch version, tolerance, kernel / plain / library times from CUDA
     events, and the bound max(bytes / 3.35 TB/s, flops / peak) of the same
     work.  Library yardsticks, which the port
     never calls: scaled_dot_product_attention (over K/V dequantized
     beforehand for the int8 ctx), torch.mm with the weight dequantized
     beforehand to x's dtype, and torch._weight_int8pack_mm where the
     installed PyTorch runs it on CUDA.
     Then filter_stats (x f32 [N, 151,936], N in {1, 16}, T in {16, 32, 64}
     thresholds from the rows' own values plus 0xFFFFFFFF and a pattern below
     the row minimum; counts exact, the rest within 2e-6, a second call
     bit-equal; no library call computes these outputs), each with its plan
     (filter_stats.plan: chunk, blocks per row) and the device kernels one
     call launches (torch.profiler: the kernel's own, and all told); the
     keep sets of filtered_logits_topk_topp at full vocabulary, with the
     kernel's stats and with the plain version's, against a full-sort f64
     keep rule; and verify_attention (bf16 and f32,
     B in {16, 1}, start in {0, 1, 700, T - 16} and on both sides of the
     bf16 kernel's first split boundary, T = 1024, each with NaN K/V past
     the frontier; yardstick scaled_dot_product_attention over the valid
     rows with the offset causal mask).
     Lane entries ([kernel-lanes] lines): verify_fused with L in {1, 4, 8}
     lanes, each value of LANE_STARTS and T - 16 as some lane's frontier (an
     int32 tensor on the card), bf16 / f32 / int8 ctx, B 16 and 1, NaN past
     every lane's frontier bit-equal, f32 lane rows bit-equal to L = 1 calls;
     prefill_flash with L in {1, 4} lanes of S = 640, bf16 and f32, lane
     rows bit-equal to L = 1 calls.  Timed: verify_fused at 8 lanes at 700
     (bf16 and int8 ctx; SDPA batched over the lanes) and prefill_flash at 4
     lanes ([kernel] lines with "L").
  4. exact parity, f32, Qwen3-8B at full width and depth, random weights from
     a seed: SpecEngine.generate == SpecEngine.ar_generate token for token on
     two 600-token prompts (padded to 640), and the kernel launch counts of
     that run are exactly what the path implies.  4: the bf16/f32 path;
     4b: the int8 path, weights quantized by the port; 4c: the
     attn_impl="pallas" engine on phase 4's weights; 4d: two filtered
     requests whose keep set is the argmax alone (temperature 1.5, top_k 1;
     temperature 2, top_k 2, top_p 1e-6) on phase 4's engine, which must
     give the greedy tokens with exactly 1 + n_cycles filter_stats launches;
     4e: the batched engine on phase 4's weights, R = 4 lanes (prompts A, B,
     A and a 530-token C): lanes 0 and 2 identical, lanes 0 and 1 phase 4's
     tokens, lane 3 generate's on C, and one request's launch counts per
     cycle (verify_fused 37) and per prefill (prefill_flash 36) whatever R;
     4f: the same on the int8 path against phase 4b's tokens; 4g: the serving
     engine on phase 4's weights (ContinuousBatchingEngine, 4 lanes, 64 new
     tokens, sampling_filters) with six requests A, B, A, C, B (32 new
     tokens) and A at temperature 2 / top_k 2 / top_p 1e-6 (its keep set is
     the argmax): each equals its single-request tokens (the 32-token B
     their prefix), with verify_fused 37 launches per cycle run,
     prefill_flash 36 per admission and filter_stats 1 per sampling call of
     the filtered request (1 + its cycles); then two /generate bodies (one
     streamed) through EngineHTTPServer on 127.0.0.1 give A's tokens; and
     after 4f one A request through an int8 engine (kv_quant) gives 4b's.
     4h: the serving engine's admission routes on phase 4's weights, 4
     lanes, 64 new tokens, each token list equal to its single-request
     tokens and each run's launch counts exact: batch_admission (A, B, A, C
     as one group: prefill_flash 36 in all); the prefix cache (A cold
     publishes its 512-row prefix, D, which shares A's first 512 tokens,
     resumes from it with no prefill_flash launch, then D cold after a
     flush; 1 hit); admission_chunk 256 (B and C, then A while they
     decode: no prefill_flash); prefill_ahead 2 (six requests, two staged
     while every lane is busy); a prefill worker on the same card (its
     weights the engine's tensors; no prefill_flash); and after 4f A
     through an int8 engine's prefix cache, cold then warm, equal to 4b's
     tokens.  A difference prints the first token that differs and the
     reference's top-2 logit margin there, and fails.
  5. timing, bf16, same shapes: TTFT, AR TPOT, spec TPOT at the random
     draft's real acceptance and at an emulated tau of 7.46, and the spec/AR
     agreement length (printed, not asserted: bf16 greedy can flip on ties).
     5: the bf16 path; 5c: the attn_impl="pallas" path on the same weights,
     and filtered spec decoding (temperature 0.8, top_k 50, top_p 0.95) on
     the default path; 5e: the batched engine at R in {1, 4, 8, 16} lanes,
     128 new tokens each, at the random draft's tau and the forced 7.46: tok/s
     summed over the lanes, the batched prefill's TTFT, launches per cycle;
     5f: the serving engine (16 lanes, 128 new tokens, steps_per_sync 4)
     behind the HTTP server, driven by bench/serving.py's client at
     concurrency 1, 4 and 16 with 2 x concurrency distinct random 600-token
     prompts, at the random draft's tau and the emulated 7.46: tok/s, mean
     accept length, mean end-to-end latency (timed, not gated); 5h: the
     same serving setup at the emulated 7.46 through each admission route:
     batch_admission off / on in turns (three pairs at concurrency 16, one
     at 4; medians and spread), 512-token shared-prefix traffic with the
     prefix cache off / on (1024 MB), admission_chunk 256, prefill_ahead 2
     and a same-card prefill worker at 16: tok/s, mean e2e latency, accept
     length, cycles and prefill_flash launches per run;
     5b: the int8 path; 5g: the server's own entry point, `python -m
     dflash_tpu_torch.engine.server --model-name-or-path qwen3-8b
     --num-lanes 8`, in a child process that answers one /generate and is
     then stopped.
``[phase]`` lines give the seconds since the start at the end of each group
of phases.  The last lines are the card's name and power limit, the
kernels' JSON summary and the device JSON.  Exits non-zero, printing no result, without
CUDA.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import select
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dflash_tpu_torch.bench import serving
from dflash_tpu_torch.bench.tokenizer import SyntheticTokenizer
from dflash_tpu_torch.cache.kv import init_kv_cache, quantize_rows
from dflash_tpu_torch.core.config import QWEN3_8B, dflash_draft_config
from dflash_tpu_torch.engine import ContinuousBatchingEngine, EngineConfig, PrefillWorker, Request
from dflash_tpu_torch.engine.server import EngineHTTPServer
from dflash_tpu_torch.kernels import _build, attention, filter_stats, matmul_q, prefill_flash, verify_fused
from dflash_tpu_torch.models import dflash_draft, qwen3
from dflash_tpu_torch.ops import sampling
from dflash_tpu_torch.ops.linear import QTensor, dequantize
from dflash_tpu_torch.quant import quantize_draft_params, quantize_target_params
from dflash_tpu_torch.spec import batched
from dflash_tpu_torch.spec import engine as spec_engine
from dflash_tpu_torch.spec.engine import SpecEngine

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate; bf16 tensor-core and
# f32 non-tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=5e-5, rtol=0.0), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# matmul_int8, either x dtype, f32 out: a bf16 or f32 value times an int8
# value is exact in f32, so kernel and plain differ only in how the f32 sums
# over K (up to 12288 terms) are ordered, and on the tensor cores (bf16 x,
# S > 1) rounded.
MM_TOL = dict(atol=1e-4, rtol=1e-5)
# filter_stats: counts exact; lse, row_min and mass_gt within 2e-6, f32 sums
# of 151,936 terms taken in another order (per-block partials merged by
# rescaling, against torch.logsumexp and a masked sum of exp(x - lse)).
FS_ATOL = 2e-6
# filtered sampling's keep-set check: top-p tokens whose f64 mass-before lies
# this close to p may fall either way under f32 masses, and are not compared.
P_MARGIN = 2e-6
KEEP_CASES = ((1, 1.0), (20, 1.0), (1000, 1.0), (0, 0.9), (50, 0.95), (0, 0.999))

NH, NKV, D = QWEN3_8B.num_attention_heads, QWEN3_8B.num_key_value_heads, QWEN3_8B.head_dim
H, I, V = QWEN3_8B.hidden_size, QWEN3_8B.intermediate_size, QWEN3_8B.vocab_size
PAD_TO = 512
# (K, N) of every projection on the int8 path: wq/wo/draft fc, wk/wv,
# gate/up, down, lm_head (N = V padded to PAD_TO).
MM_SHAPES = ((H, NH * D), (H, NKV * D), (H, I), (I, H), (H, V))
MM_LONG_S = 2048  # a long prompt: the wgmma variant's second grid shape
BLOCK = 16
PROMPT_LEN, PROMPT_CAP = 600, 640
PARITY_NEW, TIMING_NEW = 64, 128
REF_TAU = 7.46
PALLAS_T = 1024  # the timing engine's total_len (785) rounded up to 512 on the "pallas" path
FILTERED = dict(temperature=0.8, top_k=50, top_p=0.95)
# lane frontiers of phase 3's lane cases (with T - BLOCK), and the lanes of
# phase 5e
LANE_STARTS = (0, 1, 63, 64, 65, 700)
LANES_TIMED = (1, 4, 8, 16)
C_LEN = 530  # the shorter prompt of phases 4e-4g
# phase 5f: the serving engine's lanes and the client concurrencies
SERVE_LANES, SERVE_CONCURRENCY = 16, (1, 4, 16)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_done(name: str, t_start: float) -> None:
    """A ``[phase]`` line: the seconds since the smoke started, at the end of
    each group of phases (where the run's time goes as the script grows)."""
    log(f"[phase] {name} done at {time.perf_counter() - t_start:.1f} s")


def make_forced_acc(n_cycles: int, block_size: int, tau_target: float, seed: int = 0) -> np.ndarray:
    """Deterministic acc (= tau - 1) pattern with mean tau ~= tau_target (the
    JAX package's bench.py emulation, copied)."""
    rng = np.random.default_rng(seed)
    lo = int(np.floor(tau_target))
    frac = tau_target - lo
    taus = np.where(rng.random(n_cycles) < frac, lo + 1, lo)
    return (np.clip(taus, 1, block_size) - 1).astype(np.int32)


def cuda_ms(fns: list, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls cycling through ``fns``
    (one per input copy, so the working set exceeds L2 as the model's layers
    do).  The calls are captured in one CUDA graph and the replay is timed
    with CUDA events, so host launch time between calls is not counted."""
    for fn in fns[:2]:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    """Input copies whose total exceeds the 50 MB L2 cache."""
    return max(1, min(32, math.ceil(120e6 / nbytes)))


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def verify_case(dtype, B: int, all_true: bool, ctx_len: int, T: int, g, int8: bool = False) -> dict:
    """verify_fused at one shape; ``int8``: the int8-ctx branch (ctx K/V
    quantized with the cache's quantize_rows, f32 scales per row and head).
    Then the ctx K/V past ctx_len (int8: their scales) set to NaN must leave
    the output finite and bit-equal."""
    es = torch.tensor([], dtype=dtype).element_size()
    ctx_es = 1 if int8 else es
    scale_bytes = 2 * NKV * 4 if int8 else 0  # per ctx row
    per_call = 2 * T * NKV * D * ctx_es + T * scale_bytes + (2 * B * NH * D + 2 * B * NKV * D) * es
    n = copies_for(per_call)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731

    def ctx():
        k, v = randn(1, T, NKV, D), randn(1, T, NKV, D)
        if not int8:
            return k, None, v, None
        (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
        return kq, ks, vq, vs

    # (q, ctx_k, ctx_ks, ctx_v, ctx_vs, blk_k, blk_v)
    sets = [(randn(1, B, NH, D), *ctx(), randn(1, B, NKV, D), randn(1, B, NKV, D)) for _ in range(n)]
    mask = torch.ones(B, B, dtype=torch.bool, device="cuda")
    if not all_true:
        mask = torch.tril(mask)
    scale = D ** -0.5

    def kernel(s):
        return verify_fused.fused_ctx_block_attention(*s[:5], s[5], s[6], ctx_len, mask, scale)

    def plain(s):
        return verify_fused.plain(s[0], s[1], s[3], s[5], s[6], ctx_len, mask, scale, s[2], s[4])

    out, ref = kernel(sets[0]), plain(sets[0])
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    dirty = [t.clone() if t is not None else None for t in sets[0]]
    for i in ((2, 4) if int8 else (1, 3)):  # the scales, or the K/V rows
        dirty[i][:, ctx_len:] = float("nan")
    dirty_out = kernel(dirty)
    nan_equal = bool(torch.isfinite(dirty_out).all()) and torch.equal(dirty_out, out)
    assert nan_equal, "verify_fused read the ctx past ctx_len"
    del dirty, dirty_out

    def sdpa_inputs(q, ck, cks, cv, cvs, bk, bv):
        if int8:  # dequantized beforehand: the yardstick reads q's dtype
            ck = (ck.float() * cks[..., None]).to(dtype)
            cv = (cv.float() * cvs[..., None]).to(dtype)
        k = torch.cat([ck[0, :ctx_len], bk[0]]).transpose(0, 1)[None]  # [1, n_kv, ctx+B, d]
        v = torch.cat([cv[0, :ctx_len], bv[0]]).transpose(0, 1)[None]
        m = torch.cat([torch.ones(B, ctx_len, dtype=torch.bool, device="cuda"), mask], dim=1)
        return q[0].transpose(0, 1)[None], k, v, m

    lib = [sdpa_inputs(*s) for s in sets]
    ms = cuda_ms([lambda s=s: kernel(s) for s in sets], 50)
    plain_ms = cuda_ms([lambda s=s: plain(s) for s in sets], 10)
    library_ms = cuda_ms([lambda a=a: F.scaled_dot_product_attention(
        a[0], a[1], a[2], attn_mask=a[3], scale=scale, enable_gqa=True) for a in lib], 50)
    nbytes = ((2 * B * NH * D + 2 * B * NKV * D) * es + 2 * ctx_len * NKV * D * ctx_es
              + ctx_len * scale_bytes + B * B)
    flops = 4 * NH * D * (B * ctx_len + int(mask.sum()))
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    return dict(kernel="verify_fused_int8_ctx" if int8 else "verify_fused",
                dtype=str(dtype).split(".")[-1], B=B,
                mask="all_true" if all_true else "causal", T=T, ctx_len=ctx_len,
                max_abs_err=err, tol=TOL[dtype], nan_past_frontier_bit_equal=nan_equal,
                kernel_ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def lane_starts_sets(T: int, L: int) -> list:
    """Frontier sets for an L-lane call: each value of LANE_STARTS + [T - B]
    (none, one row, both sides of the bf16 kernel's first split boundary, the
    main path's 700, a full cache) in some lane: one call per value at L = 1,
    a rotation of the list across lanes otherwise."""
    pool = list(LANE_STARTS) + [T - BLOCK]
    if L == 1:
        return [[s] for s in pool]
    n = -(-len(pool) // L)
    return [[pool[(i * L + l) % len(pool)] for l in range(L)] for i in range(n)]


def verify_lanes_case(dtype, L: int, B: int, starts: list, T: int, g, int8: bool = False,
                      timed: bool = False) -> dict:
    """verify_fused's lane entry: L lanes, each with its own ctx [T, n_kv, d]
    and frontier (an int32 tensor on the card), against the lane plain
    version; f32: each lane's rows bit-equal to an L = 1 call on its inputs;
    NaN past every lane's frontier (int8: in its scales) must leave the
    output bit-equal.  ``timed``: kernel, plain and SDPA times (batched over
    the lanes: valid only with equal frontiers, which the timed cases use)."""
    es = torch.tensor([], dtype=dtype).element_size()
    ctx_es = 1 if int8 else es
    scale_bytes = 2 * NKV * 4 if int8 else 0  # per ctx row
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731

    def make():
        k, v = randn(L, T, NKV, D), randn(L, T, NKV, D)
        ctx = (k, None, v, None)
        if int8:
            (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
            ctx = (kq, ks, vq, vs)
        return (randn(L, 1, B, NH, D), *ctx, randn(L, 1, B, NKV, D), randn(L, 1, B, NKV, D))

    per_call = L * (2 * T * NKV * D * ctx_es + T * scale_bytes + (2 * B * NH * D + 2 * B * NKV * D) * es)
    sets = [make() for _ in range(copies_for(per_call) if timed else 1)]
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    mask = torch.tril(torch.ones(B, B, dtype=torch.bool, device="cuda"))
    scale = D ** -0.5

    def kernel(s):
        return verify_fused.fused_ctx_block_attention_lanes(*s[:5], s[5], s[6], st, max(starts), mask, scale)

    def plain(s):
        return verify_fused.plain_lanes(s[0], s[1], s[3], s[5], s[6], st, mask, scale, s[2], s[4])

    s0 = sets[0]
    out, ref = kernel(s0), plain(s0)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    lanes_equal_single = None
    if dtype == torch.float32:
        for l in range(L):
            sc = (None, None) if s0[2] is None else (s0[2][l:l + 1], s0[4][l:l + 1])
            one = verify_fused.fused_ctx_block_attention(s0[0][l], s0[1][l:l + 1], sc[0], s0[3][l:l + 1], sc[1],
                                                         s0[5][l], s0[6][l], starts[l], mask, scale)
            assert torch.equal(out[l], one), f"f32 lane {l} differs from an L = 1 call"
        lanes_equal_single = True
    dirty = [t.clone() if t is not None else None for t in s0]
    for l, s in enumerate(starts):
        for i in ((2, 4) if int8 else (1, 3)):  # the scales, or the K/V rows
            dirty[i][l, s:] = float("nan")
    dirty_out = kernel(dirty)
    nan_equal = bool(torch.isfinite(dirty_out).all()) and torch.equal(dirty_out, out)
    assert nan_equal, f"verify_fused (lanes {starts}) read a ctx past its lane's frontier"
    del dirty, dirty_out
    res = dict(kernel="verify_fused_lanes_int8_ctx" if int8 else "verify_fused_lanes",
               dtype=str(dtype).split(".")[-1], L=L, B=B, T=T, starts=starts, max_abs_err=err,
               tol=TOL[dtype], f32_lanes_bit_equal_to_single=lanes_equal_single,
               nan_past_frontiers_bit_equal=nan_equal)
    if not timed:
        return res
    assert len(set(starts)) == 1, "the SDPA yardstick batches equal frontiers"
    c = starts[0]

    def sdpa_inputs(q, ck, cks, cv, cvs, bk, bv):
        if int8:  # dequantized beforehand: the yardstick reads q's dtype
            ck = (ck.float() * cks[..., None]).to(dtype)
            cv = (cv.float() * cvs[..., None]).to(dtype)
        k = torch.cat([ck[:, :c], bk[:, 0]], dim=1).transpose(1, 2)  # [L, n_kv, c + B, d]
        v = torch.cat([cv[:, :c], bv[:, 0]], dim=1).transpose(1, 2)
        m = torch.cat([torch.ones(B, c, dtype=torch.bool, device="cuda"), mask], dim=1)
        return q[:, 0].transpose(1, 2), k, v, m

    lib = [sdpa_inputs(*s) for s in sets]
    ms = cuda_ms([lambda s=s: kernel(s) for s in sets], 50)
    plain_ms = cuda_ms([lambda s=s: plain(s) for s in sets], 5)
    library_ms = cuda_ms([lambda a=a: F.scaled_dot_product_attention(
        a[0], a[1], a[2], attn_mask=a[3], scale=scale, enable_gqa=True) for a in lib], 50)
    nbytes = sum((2 * B * NH * D + 2 * B * NKV * D) * es + 2 * s * NKV * D * ctx_es + s * scale_bytes
                 for s in starts) + B * B + 4 * L
    flops = sum(4 * NH * D * (B * s + int(mask.sum())) for s in starts)
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    return dict(res, kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def prefill_lanes_case(dtype, L: int, S: int, g, timed: bool = False) -> dict:
    """prefill_flash with L lanes of S rows: against the plain version, and
    each lane's rows bit-equal to an L = 1 call on them (either dtype);
    ``timed``: kernel, plain and SDPA (batched, causal) times."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = L * (2 * S * NH * D + 2 * S * NKV * D) * es
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    sets = [(randn(L, S, NH, D), randn(L, S, NKV, D), randn(L, S, NKV, D))
            for _ in range(copies_for(nbytes) if timed else 1)]
    scale = D ** -0.5
    q, k, v = sets[0]
    out = prefill_flash.flash_prefill_attention(q, k, v, scale)
    ref = prefill_flash.plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    for l in range(L):
        one = prefill_flash.flash_prefill_attention(q[l:l + 1], k[l:l + 1], v[l:l + 1], scale)
        assert torch.equal(out[l], one[0]), f"prefill lane {l} differs from an L = 1 call"
    res = dict(kernel="prefill_flash_lanes", dtype=str(dtype).split(".")[-1], L=L, S=S, max_abs_err=err,
               tol=TOL[dtype], lanes_bit_equal_to_single=True)
    if not timed:
        return res
    lib = [tuple(t.transpose(1, 2) for t in s) for s in sets]
    ms = cuda_ms([lambda s=s: prefill_flash.flash_prefill_attention(*s, scale) for s in sets], 20)
    plain_ms = cuda_ms([lambda s=s: prefill_flash.plain(*s, scale) for s in sets], 3)
    library_ms = cuda_ms([lambda a=a: F.scaled_dot_product_attention(
        *a, is_causal=True, scale=scale, enable_gqa=True) for a in lib], 20)
    b_ms, b_by = bound_ms(nbytes, L * 4 * NH * D * (S * (S + 1) // 2), dtype)
    return dict(res, kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def int8pack_runs() -> bool:
    """Whether the installed PyTorch runs torch._weight_int8pack_mm on CUDA
    (a yardstick only; the port never calls it)."""
    x = torch.zeros((1, 64), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((64, 64), dtype=torch.int8, device="cuda")
    try:
        torch._weight_int8pack_mm(x, w, torch.ones(64, dtype=torch.bfloat16, device="cuda"))
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"[kernel] torch._weight_int8pack_mm does not run on CUDA here: {str(e).splitlines()[0]}")
        return False
    return True


def matmul_case(dtype, K: int, N: int, S: int, g, int8pack: bool) -> dict:
    """matmul_int8 at one projection shape: x [S, K] in ``dtype``, int8
    weight [K, N_pad] (N padded to PAD_TO, as quantize_target_params pads),
    f32 out [S, N]."""
    es = torch.tensor([], dtype=dtype).element_size()
    N_pad = -(-N // PAD_TO) * PAD_TO
    nbytes = K * N_pad + 4 * N_pad + S * K * es + 4 * S * N
    copies = copies_for(nbytes)
    sets = []
    for _ in range(copies):
        x = torch.randn((S, K), generator=g, device="cuda").to(dtype)
        q = torch.randint(-127, 128, (K, N_pad), generator=g, dtype=torch.int8, device="cuda")
        sc = torch.rand((1, N_pad), generator=g, device="cuda") * (0.05 / 127) + 1e-5
        sets.append((x, q, sc))
    x, q, sc = sets[0]
    out, ref = matmul_q.matmul_int8(x, q, sc, N), matmul_q.plain(x, q, sc, N)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **MM_TOL)

    iters = int(min(50, max(3, 2e11 / (S * K * N_pad))))
    ms = cuda_ms([lambda s=s: matmul_q.matmul_int8(*s, N) for s in sets], iters)
    plain_ms = cuda_ms([lambda s=s: matmul_q.plain(*s, N) for s in sets], max(2, iters // 5))
    deq = [(s[0], dequantize(QTensor(s[1], s[2], N), dtype)) for s in sets]
    library_ms = cuda_ms([lambda a=a: torch.mm(*a) for a in deq], iters)
    del deq
    int8pack_ms = None
    if int8pack and dtype == torch.bfloat16:
        packed = [(s[0], s[1][:, :N].t().contiguous(), s[2][0, :N].to(dtype)) for s in sets]
        int8pack_ms = cuda_ms([lambda a=a: torch._weight_int8pack_mm(*a) for a in packed], iters)
        del packed
    b_ms, b_by = bound_ms(nbytes, 2 * S * K * N, dtype)
    return dict(kernel="matmul_int8", dtype=str(dtype).split(".")[-1], S=S, K=K, N=N, N_pad=N_pad,
                plan=dataclasses.asdict(matmul_q.plan(dtype, S, K, N_pad)), max_abs_err=err, tol=MM_TOL, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, library="torch.mm, weight dequantized to x's dtype",
                int8pack_ms=int8pack_ms, bound_ms=b_ms, bound_by=b_by)


def matmul_line(c: dict) -> str:
    p = c["plan"]
    return (f"[matmul] {c['dtype']} K={c['K']} N={c['N']} S={c['S']}: kernel {c['kernel_ms']:.4f} ms, "
            f"plain {c['plain_ms']:.4f}, torch.mm {c['library_ms']:.4f}, bound {c['bound_ms']:.4f} "
            f"({c['bound_by']}); plan {p['variant']} {p['rows']}x{p['cols']} split {p['split']}")


def prefill_case(dtype, S: int, g) -> dict:
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * S * NH * D + 2 * S * NKV * D) * es
    n = copies_for(nbytes)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    sets = [(randn(1, S, NH, D), randn(1, S, NKV, D), randn(1, S, NKV, D)) for _ in range(n)]
    scale = D ** -0.5
    q, k, v = sets[0]
    out = prefill_flash.flash_prefill_attention(q, k, v, scale)
    ref = prefill_flash.plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])

    lib = [tuple(t[0].transpose(0, 1)[None] for t in s) for s in sets]
    iters = 20 if S <= 640 else 5
    ms = cuda_ms([lambda s=s: prefill_flash.flash_prefill_attention(*s, scale) for s in sets], iters)
    plain_ms = cuda_ms([lambda s=s: prefill_flash.plain(*s, scale) for s in sets], 3)
    library_ms = cuda_ms([lambda a=a: F.scaled_dot_product_attention(
        *a, is_causal=True, scale=scale, enable_gqa=True) for a in lib], iters)
    flops = 4 * NH * D * (S * (S + 1) // 2)
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    return dict(kernel="prefill_flash", dtype=str(dtype).split(".")[-1], S=S, max_abs_err=err,
                tol=TOL[dtype], kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by)


def device_kernels(fn) -> list:
    """Names of the device kernels that one call of ``fn`` launches (from the
    second of two profiled calls: the first session may miss its kernels)."""
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def filter_stats_case(N: int, T: int, g) -> dict:
    """filter_stats at x f32 [N, V], T thresholds drawn from the rows' own
    values, the last two replaced by 0xFFFFFFFF (padding) and a pattern below
    the row minimum."""
    nbytes = N * V * 4 + N * T * 4 + N * T * 12 + N * 8
    sets = []
    for _ in range(copies_for(N * V * 4)):
        x = torch.randn((N, V), generator=g, device="cuda") * 3.0
        bits = filter_stats.ordered_bits(x)
        thr = torch.gather(bits, 1, torch.randint(0, V, (N, T), generator=g, device="cuda"))
        thr[:, -1] = 0xFFFFFFFF
        thr[:, -2] = bits.amin(dim=1) - 1
        sets.append((x, thr))
    out, ref = filter_stats.filter_stats(*sets[0]), filter_stats.plain(*sets[0])
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]), "filter_stats counts differ"
    err = max((a - b).abs().max().item() for a, b in zip(out[2:], ref[2:]))
    for a, b in zip(out[2:], ref[2:]):
        torch.testing.assert_close(a, b, atol=FS_ATOL, rtol=0)
    again = filter_stats.filter_stats(*sets[0])
    assert all(torch.equal(a, b) for a, b in zip(again, out)), "filter_stats differs from call to call"
    ms = cuda_ms([lambda s=s: filter_stats.filter_stats(*s) for s in sets], 50)
    plain_ms = cuda_ms([lambda s=s: filter_stats.plain(*s) for s in sets], 5)
    names = device_kernels(lambda: filter_stats.filter_stats(*sets[0]))
    # what the function needs, not this kernel's loop: ~5 operations per
    # element (max, min, exp, sum, the bits) and, for the thresholds, a
    # binary search over them sorted (ceil(log2 T)) plus ~2 to bin the
    # element; the per-row sort and suffix sums over T bins are negligible
    b_ms, b_by = bound_ms(nbytes, N * V * (5 + (T - 1).bit_length() + 2), torch.float32)
    return dict(kernel="filter_stats", N=N, T=T, V=V, max_abs_err=err, tol=dict(atol=FS_ATOL),
                kernel_ms=ms, plain_ms=plain_ms, library_ms=None,
                library="none: no one PyTorch call computes the five outputs",
                bound_ms=b_ms, bound_by=b_by, plan=dataclasses.asdict(filter_stats.plan(N, V)),
                device_launches_per_call=sum("dflash_fs" in n for n in names),
                device_kernels_per_call=len(names))


def filter_stats_line(c: dict) -> str:
    p = c["plan"]
    return (f"[filter_stats] N={c['N']} T={c['T']}: kernel {c['kernel_ms']:.4f} ms, plain {c['plain_ms']:.4f}, "
            f"bound {c['bound_ms']:.5f} ({c['bound_by']}); plan chunk {p['chunk']} x {p['blocks_per_row']} "
            f"blocks a row; device launches a call {c['device_launches_per_call']} "
            f"(device kernels a call, all told: {c['device_kernels_per_call']})")


def keep_set_case(top_k: int, top_p: float, g) -> dict:
    """filtered_logits_topk_topp on 16 rows at temperature 0.8, with the
    kernel's stats and with the plain version's, against a full-sort f64
    keep rule (rank < k, value ties straddling rank k kept, and mass before
    the token < p)."""
    temp = 0.8
    logits = torch.randn((BLOCK, V), generator=g, device="cuda") * 3.0
    before = filter_stats.filter_stats.launches
    kernel_keep = torch.isfinite(sampling.filtered_logits_topk_topp(logits, temp, top_k, top_p,
                                                                    sampling.TOPK_POOL))
    passes = filter_stats.filter_stats.launches - before
    plain_keep = torch.isfinite(sampling.filtered_logits_topk_topp(
        logits, temp, top_k, top_p, sampling.TOPK_POOL, stats=filter_stats.plain))
    svals, order = torch.sort((logits / temp).double(), dim=-1, descending=True, stable=True)
    probs = torch.softmax(svals, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    k_eff = V if top_k <= 0 else min(top_k, V)
    keep_sorted = (svals >= svals[:, k_eff - 1:k_eff]) & (cum_before < top_p)
    near_sorted = (cum_before - top_p).abs() < P_MARGIN if top_p < 1.0 else torch.zeros_like(keep_sorted)
    want = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    near = torch.zeros_like(near_sorted).scatter(1, order, near_sorted)
    res = dict(kernel="keep_set", top_k=top_k, top_p=top_p, rows=BLOCK, temperature=temp,
               kept_per_row=[int(c) for c in want.sum(dim=-1).tolist()],
               stats_passes=passes, refinement_rounds=passes - 1, near_p_tokens=int(near.sum()))
    for name, got in (("kernel stats", kernel_keep), ("plain stats", plain_keep)):
        diff = (got != want) & ~near
        assert not diff.any(), f"keep set ({name}) differs from the full sort at {int(diff.sum())} tokens: {res}"
    return res


def verify_attention_case(dtype, B: int, start: int, g) -> dict:
    """verify_attention at one shape: q [1, B, nh, d], cache [1, T, n_kv, d],
    T = PALLAS_T; then K/V rows past start + B set to NaN must leave the
    output finite and bit-equal."""
    T = PALLAS_T
    es = torch.tensor([], dtype=dtype).element_size()
    L = start + B
    n = copies_for(2 * T * NKV * D * es)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    sets = [(randn(1, B, NH, D), randn(1, T, NKV, D), randn(1, T, NKV, D)) for _ in range(n)]
    q, k, v = sets[0]
    out, ref = attention.verify_attention(q, k, v, start, B), attention.plain(q, k, v, start, B)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    k2, v2 = k.clone(), v.clone()
    k2[:, L:], v2[:, L:] = float("nan"), float("nan")
    dirty = attention.verify_attention(q, k2, v2, start, B)
    nan_equal = bool(torch.isfinite(dirty).all()) and torch.equal(dirty, out)
    assert nan_equal, "verify_attention read K/V past the frontier"
    scale = D ** -0.5
    mask = torch.arange(L, device="cuda")[None, :] <= start + torch.arange(B, device="cuda")[:, None]
    lib = [(s[0][0].transpose(0, 1)[None], s[1][0, :L].transpose(0, 1)[None].contiguous(),
            s[2][0, :L].transpose(0, 1)[None].contiguous()) for s in sets]
    ms = cuda_ms([lambda s=s: attention.verify_attention(*s, start, B) for s in sets], 50)
    plain_ms = cuda_ms([lambda s=s: attention.plain(*s, start, B) for s in sets], 10)
    library_ms = cuda_ms([lambda a=a: F.scaled_dot_product_attention(
        *a, attn_mask=mask, scale=scale, enable_gqa=True) for a in lib], 50)
    nbytes = (2 * B * NH * D + 2 * L * NKV * D) * es
    b_ms, b_by = bound_ms(nbytes, 4 * NH * D * (B * start + B * (B + 1) // 2), dtype)
    return dict(kernel="verify_attention", dtype=str(dtype).split(".")[-1], B=B, T=T, start=start,
                max_abs_err=err, tol=TOL[dtype], nan_past_frontier_bit_equal=nan_equal, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

def build_params(dtype, int8: bool = False) -> tuple:
    """(dcfg, target params, draft params): Qwen3-8B + a 1-layer draft,
    random weights from seeds 0/1; ``int8``: the weights quantized by the
    port (consuming the float dicts)."""
    dcfg = dflash_draft_config(QWEN3_8B, num_draft_layers=1, block_size=BLOCK)
    assert dcfg.target_layer_ids == (18,)
    t_params = qwen3.init_params(0, QWEN3_8B, dtype, device="cuda")
    d_params = dflash_draft.init_params(1, dcfg, dtype, device="cuda")
    if int8:
        t_params = quantize_target_params(t_params, QWEN3_8B, PAD_TO)
        d_params = quantize_draft_params(d_params, dcfg, PAD_TO)
        assert isinstance(t_params["lm_head"], QTensor) and isinstance(d_params["fc"], QTensor)
    return dcfg, t_params, d_params


def make_engine(params: tuple, max_new: int, int8: bool = False, attn_impl: str = "xla") -> SpecEngine:
    """An engine on ``params`` (shared, not copied); ``int8``: the int8 KV cache."""
    dcfg, t_params, d_params = params
    return SpecEngine(QWEN3_8B, dcfg, t_params, d_params, max_new_tokens=max_new,
                      block_size=BLOCK, prompt_cap=PROMPT_CAP, prompt_bucket=128, device="cuda",
                      kv_quant=int8, attn_impl=attn_impl)


def release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def prompts() -> list:
    return [np.random.default_rng(s).integers(1, QWEN3_8B.vocab_size - 2, size=(1, PROMPT_LEN))
            for s in range(2)]


def reset_counts() -> None:
    verify_fused.fused_ctx_block_attention.launches = 0
    verify_fused.fused_ctx_block_attention.launches_int8 = 0
    prefill_flash.flash_prefill_attention.launches = 0
    matmul_q.matmul_int8.launches = 0
    filter_stats.filter_stats.launches = 0
    attention.verify_attention.launches = 0


def counts() -> dict:
    return {"verify_fused": verify_fused.fused_ctx_block_attention.launches,
            "verify_fused_int8_ctx": verify_fused.fused_ctx_block_attention.launches_int8,
            "prefill_flash": prefill_flash.flash_prefill_attention.launches,
            "matmul_int8": matmul_q.matmul_int8.launches,
            "filter_stats": filter_stats.filter_stats.launches,
            "verify_attention": attention.verify_attention.launches}


def path_name(int8: bool, attn_impl: str = "xla") -> str:
    if int8:
        return "int8 path (int8 weights, kv_quant)"
    return "attn_impl='pallas' path" if attn_impl == "pallas" else "bf16/f32 path"


def parity_phase(engine: SpecEngine, tag: str) -> tuple:
    """f32 spec == AR on both prompts with exact launch counts; returns the
    counts and the spec outputs."""
    int8, pallas = engine.kv_quant, engine.attn_impl == "pallas"
    log(f"{tag} f32 Qwen3-8B (L=36, H=4096) + 1-layer draft, {path_name(int8, engine.attn_impl)}, "
        f"total_len={engine.total_len}")
    L = QWEN3_8B.num_hidden_layers
    Ld = engine.dcfg.model.num_hidden_layers
    # matmul_int8 launches: a target forward (7 projections a layer) + its
    # lm_head; a draft context append (fc, then wk and wv a layer); a draft
    # forward (7 a layer) + the lm_head on its rows
    target_fwd, draft_append, draft_fwd = 7 * L + 1, 1 + 2 * Ld, 7 * Ld + 1
    reset_counts()
    expected = dict.fromkeys(counts(), 0)
    outputs = []
    for i, prompt in enumerate(prompts()):
        spec = engine.generate(prompt, temperature=0.0)
        ar = engine.ar_generate(prompt, temperature=0.0)
        outputs.append(spec.output_ids)
        n_cycles = len(spec.acceptance_lengths)
        expected["prefill_flash"] += 2 * L
        target_attn = "verify_attention" if pallas else "verify_fused_int8_ctx" if int8 else "verify_fused"
        expected[target_attn] += (n_cycles + PARITY_NEW) * L
        expected["verify_fused"] += n_cycles * Ld  # the draft's float context cache
        if int8:
            expected["matmul_int8"] += (target_fwd + draft_append  # spec prefill
                                        + n_cycles * (draft_append + draft_fwd + target_fwd)
                                        + (1 + PARITY_NEW) * target_fwd)  # AR prefill + steps
        gen = spec.output_ids[0, PROMPT_LEN:]
        assert gen.size > 0 and gen.min() >= 0 and gen.max() < QWEN3_8B.vocab_size
        log(f"{tag} prompt {i}: spec {spec.num_output_tokens} tokens in {n_cycles} cycles, "
            f"AR {ar.num_output_tokens} tokens; spec == AR: "
            f"{np.array_equal(spec.output_ids, ar.output_ids)}")
        np.testing.assert_array_equal(spec.output_ids, ar.output_ids)
    got = counts()
    log(f"{tag} launches {json.dumps(got)} expected {json.dumps(expected)}")
    assert got == expected, (got, expected)
    path_kernels = ["verify_fused", "prefill_flash"] + (["verify_fused_int8_ctx", "matmul_int8"] if int8 else [])
    path_kernels += ["verify_attention"] if pallas else []
    assert all(got[k] > 0 for k in path_kernels), got
    return got, outputs


def filtered_parity_phase(engine: SpecEngine, greedy: list) -> dict:
    """Phase 4d: requests whose keep set is the argmax alone give the greedy
    spec tokens, every sample (first token, each verify posterior) through
    the filtered sampler with no refinement round: exactly 1 + n_cycles
    filter_stats launches per request."""
    L = QWEN3_8B.num_hidden_layers
    Ld = engine.dcfg.model.num_hidden_layers
    reset_counts()
    expected = dict.fromkeys(counts(), 0)
    for i, prompt in enumerate(prompts()):
        for temperature, top_k, top_p in ((1.5, 1, 1.0), (2.0, 2, 1e-6)):
            before = filter_stats.filter_stats.launches
            out = engine.generate(prompt, temperature=temperature, top_k=top_k, top_p=top_p, seed=i)
            n_cycles = len(out.acceptance_lengths)
            launches = filter_stats.filter_stats.launches - before
            log(f"[parity-filtered] prompt {i}: temperature {temperature}, top_k {top_k}, top_p {top_p}: "
                f"{out.num_output_tokens} tokens in {n_cycles} cycles, filter_stats launches {launches} "
                f"(1 + n_cycles = {1 + n_cycles}); == greedy: {np.array_equal(out.output_ids, greedy[i])}")
            np.testing.assert_array_equal(out.output_ids, greedy[i])
            assert launches == 1 + n_cycles, (launches, n_cycles)
            expected["filter_stats"] += 1 + n_cycles
            expected["prefill_flash"] += L
            expected["verify_fused"] += n_cycles * (L + Ld)
    got = counts()
    log(f"[parity-filtered] launches {json.dumps(got)} expected {json.dumps(expected)}")
    assert got == expected, (got, expected)
    return got


def agreement(a: np.ndarray, b: np.ndarray) -> int:
    a, b = a[0, PROMPT_LEN:], b[0, PROMPT_LEN:]
    n = min(a.size, b.size)
    diff = np.nonzero(a[:n] != b[:n])[0]
    return int(diff[0]) if diff.size else n


def timing_phase(engine: SpecEngine) -> dict:
    ps = prompts()
    forced = make_forced_acc(TIMING_NEW, BLOCK, REF_TAU)
    engine.generate(ps[0])  # warm-up: cuBLAS heuristics, allocator
    engine.ar_generate(ps[0])
    reset_counts()
    runs = {"ar": [], "spec": [], "spec_forced": []}
    for rep in range(3):
        p = ps[rep % 2]
        runs["ar"].append(engine.ar_generate(p))
        runs["spec"].append(engine.generate(p))
        runs["spec_forced"].append(engine.generate(p, forced_acc=forced))
    med = lambda xs: float(np.median(xs))  # noqa: E731
    res = {
        "ttft_spec_ms": med([r.time_to_first_token for r in runs["spec"]]) * 1e3,
        "ttft_ar_ms": med([r.time_to_first_token for r in runs["ar"]]) * 1e3,
        "ar_tpot_ms": med([r.time_per_output_token for r in runs["ar"]]) * 1e3,
        "spec_tpot_ms": med([r.time_per_output_token for r in runs["spec"]]) * 1e3,
        "spec_tau": float(np.mean([t for r in runs["spec"] for t in r.acceptance_lengths])),
        "spec_forced_tpot_ms": med([r.time_per_output_token for r in runs["spec_forced"]]) * 1e3,
        "spec_forced_tau": float(np.mean([t for r in runs["spec_forced"] for t in r.acceptance_lengths])),
        "agreement_tokens": [agreement(s.output_ids, a.output_ids)
                             for s, a in zip(runs["spec"], runs["ar"])],
        "path": path_name(engine.kv_quant, engine.attn_impl),
        "new_tokens": TIMING_NEW,
        "total_len": engine.total_len,
        "spread_ms": {k: [round(r.time_per_output_token * 1e3, 4) for r in v] for k, v in runs.items()},
        "launches": counts(),
    }
    return res


def filtered_timing_phase(engine: SpecEngine) -> dict:
    """Phase 5c: filtered spec decoding on the default path, 3 runs."""
    ps = prompts()
    engine.generate(ps[0], seed=0, **FILTERED)  # warm-up
    reset_counts()
    runs = [engine.generate(ps[rep % 2], seed=rep, **FILTERED) for rep in range(3)]
    calls = sum(1 + len(r.acceptance_lengths) for r in runs)  # first token + one per cycle
    launches = filter_stats.filter_stats.launches
    return {
        "path": "bf16/f32 path, filtered sampling", **FILTERED, "new_tokens": TIMING_NEW,
        "spec_tpot_ms": float(np.median([r.time_per_output_token for r in runs])) * 1e3,
        "spec_tau": float(np.mean([t for r in runs for t in r.acceptance_lengths])),
        "ttft_ms": float(np.median([r.time_to_first_token for r in runs])) * 1e3,
        "spread_ms": [round(r.time_per_output_token * 1e3, 4) for r in runs],
        "sampling_calls": calls, "filter_stats_launches": launches,
        "refinement_rounds_per_call": (launches - calls) / calls,
        "launches": counts(),
    }


# ---------------------------------------------------------------------------
# phases 4e, 4f and 5e: the batched engine (spec/batched.py)
# ---------------------------------------------------------------------------

def lane_prompts(R: int) -> tuple:
    """R prompts of PROMPT_LEN tokens (seeds 0 .. R-1; lanes 0 and 1 are
    phase 4's two prompts), padded to the 640 bucket: ([R, 640], lens)."""
    ids = np.zeros((R, PROMPT_CAP), np.int64)
    for r in range(R):
        ids[r, :PROMPT_LEN] = np.random.default_rng(r).integers(1, QWEN3_8B.vocab_size - 2, size=PROMPT_LEN)
    return ids, np.full(R, PROMPT_LEN, np.int64)


def lanes_expected(int8: bool, cycles: int, Ld: int) -> dict:
    """Launch counts of one batched prefill and ``cycles`` batched cycles:
    the counts of one request's, whatever the lanes."""
    L = QWEN3_8B.num_hidden_layers
    target_fwd, draft_append, draft_fwd = 7 * L + 1, 1 + 2 * Ld, 7 * Ld + 1
    expected = dict.fromkeys(counts(), 0)
    expected["prefill_flash"] = L
    expected["verify_fused_int8_ctx" if int8 else "verify_fused"] += cycles * L
    expected["verify_fused"] += cycles * Ld
    if int8:
        expected["matmul_int8"] = target_fwd + draft_append + cycles * (draft_append + draft_fwd + target_fwd)
    return expected


def c_prompt() -> np.ndarray:
    return np.random.default_rng(2).integers(1, QWEN3_8B.vocab_size - 2, size=C_LEN)


def batched_parity_phase(engine: SpecEngine, single: list, tag: str) -> np.ndarray:
    """Phases 4e / 4f: f32, R = 4 lanes with prompts A, B, A and C (C: 530
    tokens, so the frontiers differ), batched_prefill + batched_decode on the
    engine's weights: lanes 0 and 2 identical, lanes 0 and 1 equal to the
    single-request tokens ``single`` for A and B (phase 4 / 4b), lane 3 equal
    to the engine's generate on C; launch counts exact (one request's per
    cycle, whatever R).  Returns generate's tokens on C."""
    int8 = engine.kv_quant
    log(f"{tag} f32 batched engine, R = 4 lanes (prompts A, B, A, C), {path_name(int8)}")
    ids, lens = lane_prompts(3)
    ids = np.concatenate([ids[:2], ids[:1], np.zeros((1, PROMPT_CAP), np.int64)])
    c_len = C_LEN
    ids[3, :c_len] = c_prompt()
    lens = np.asarray([PROMPT_LEN, PROMPT_LEN, PROMPT_LEN, c_len])
    kw = dict(tcfg=QWEN3_8B, dcfg=engine.dcfg)
    reset_counts()
    st = batched.batched_prefill(engine.t_params, engine.d_params, ids, lens, 0.0, total_len=engine.total_len,
                                 max_cycles=PARITY_NEW, kv_quant=int8, **kw)
    st = batched.batched_decode(engine.t_params, engine.d_params, st, lens + PARITY_NEW, 0.0, block_size=BLOCK,
                                stop_token_ids=(), max_cycles=PARITY_NEW, **kw)
    got = counts()
    cycles = int(st.host_cycle_idx.max())  # the loop's cycles: the longest lane ran in every one
    expected = lanes_expected(int8, cycles, engine.dcfg.model.num_hidden_layers)
    log(f"{tag} {cycles} cycles, per-lane cycles {st.host_cycle_idx.tolist()}, frontiers "
        f"{st.host_start.tolist()}; launches {json.dumps(got)} expected {json.dumps(expected)}")
    assert got == expected, (got, expected)
    path_kernels = ["prefill_flash", "verify_fused"] + (["verify_fused_int8_ctx", "matmul_int8"] if int8 else [])
    assert all(got[k] > 0 for k in path_kernels), got
    outs = batched.lane_outputs(st, lens, PARITY_NEW, engine.dcfg.mask_token_id)
    alone = engine.generate(ids[3:4, :c_len])
    checks = {"lanes 0 == 2": np.array_equal(outs[0], outs[2]),
              "lane 0 == single A": np.array_equal(outs[0], single[0]),
              "lane 1 == single B": np.array_equal(outs[1], single[1]),
              "lane 3 == single C": np.array_equal(outs[3], alone.output_ids)}
    log(f"{tag} {json.dumps(checks)}; tokens per lane {[int(o.shape[1] - l) for o, l in zip(outs, lens)]}")
    assert all(checks.values()), checks
    return alone.output_ids


# ---------------------------------------------------------------------------
# phases 4g and 5f: the serving engine (engine/batching.py, engine/server.py)
# ---------------------------------------------------------------------------

def serving_engine(params: tuple, lanes: int, max_new: int, prefill_worker=None, **kw) -> ContinuousBatchingEngine:
    dcfg, t_params, d_params = params
    cfg = EngineConfig(num_lanes=lanes, max_new_tokens=max_new, block_size=BLOCK, prompt_cap=PROMPT_CAP, **kw)
    return ContinuousBatchingEngine(QWEN3_8B, dcfg, t_params, d_params, cfg, tokenizer=SyntheticTokenizer(V),
                                    prefill_worker=prefill_worker, device="cuda")


def served(req, tag: str) -> np.ndarray:
    assert req.done_event.is_set() and req.error is None, (tag, req.error)
    return req.output_ids


def serving_parity_phase(params: tuple, greedy: list, c_tokens: np.ndarray) -> dict:
    """Phase 4g: six requests on four lanes of the serving engine (more
    requests than lanes: two are admitted while the others decode), each
    equal to its single-request tokens, with exact launch counts; then the
    same engine behind the HTTP server."""
    log("[serving] f32 ContinuousBatchingEngine, 4 lanes, sampling_filters; requests A, B, A, C, B (32 new), "
        "A filtered (temperature 2, top_k 2, top_p 1e-6)")
    engine = serving_engine(params, 4, PARITY_NEW, sampling_filters=True)
    a, b = (p[0] for p in prompts())
    reset_counts()
    reqs = [engine.submit(a), engine.submit(b), engine.submit(a), engine.submit(c_prompt()),
            engine.submit(b, max_new_tokens=32), engine.submit(a, temperature=2.0, top_k=2, top_p=1e-6, seed=0)]
    engine.run_until_drained()
    got = counts()
    L, Ld = QWEN3_8B.num_hidden_layers, engine.dcfg.model.num_hidden_layers
    filtered_cycles = reqs[5].meta_info["spec_verify_ct"]
    expected = dict.fromkeys(counts(), 0)
    expected.update(verify_fused=engine.cycle_count * (L + Ld), prefill_flash=len(reqs) * L,
                    filter_stats=1 + filtered_cycles)
    log(f"[serving] {engine.cycle_count} cycles run; per request (tokens, cycles): "
        f"{[(r.meta_info['completion_tokens'], r.meta_info['spec_verify_ct']) for r in reqs]}; "
        f"launches {json.dumps(got)} expected {json.dumps(expected)}")
    assert got == expected, (got, expected)
    outs = [served(r, f"request {i}") for i, r in enumerate(reqs)]
    checks = {"A == single A": np.array_equal(outs[0], greedy[0]),
              "B == single B": np.array_equal(outs[1], greedy[1]),
              "second A == single A": np.array_equal(outs[2], greedy[0]),
              "C == single C": np.array_equal(outs[3], c_tokens),
              "B (32 new) == prefix of single B": np.array_equal(outs[4], greedy[1][:, :PROMPT_LEN + 32]),
              "filtered A == single A": np.array_equal(outs[5], greedy[0])}
    log(f"[serving] {json.dumps(checks)}")
    assert all(checks.values()), checks

    srv = EngineHTTPServer(engine, host="127.0.0.1", port=0, tokenizer=engine.tokenizer)
    srv.start()
    try:
        url = f"http://{srv.host}:{srv.port}"
        body = {"input_ids": a.tolist(), "sampling_params": {"max_new_tokens": PARITY_NEW, "temperature": 0}}
        plain = serving._post(url, body)
        streamed = serving._consume_sse(url, {**body, "stream": True})
    finally:
        srv.stop()
    want = greedy[0][0, PROMPT_LEN:].tolist()
    http = {"/generate == single A": plain["output_ids"] == want,
            "/generate stream == single A": streamed["output_ids"] == want}
    log(f"[serving-http] {url}: {json.dumps(http)}; meta {json.dumps(plain['meta_info'])}")
    assert all(http.values()), http
    return got


def serving_int8_phase(params: tuple, greedy_int8: list) -> None:
    """Phase 4g (int8): one A request through an int8 serving engine
    (kv_quant) equals phase 4b's tokens."""
    engine = serving_engine(params, 4, PARITY_NEW, kv_quant=True)
    reset_counts()
    req = engine.submit(prompts()[0][0])
    engine.run_until_drained()
    got = counts()
    ok = np.array_equal(served(req, "int8 A"), greedy_int8[0])
    log(f"[serving-int8] A through the int8 serving engine == phase 4b's tokens: {ok}; launches {json.dumps(got)}")
    assert ok
    assert all(got[k] > 0 for k in ("prefill_flash", "verify_fused", "verify_fused_int8_ctx", "matmul_int8")), got


# ---------------------------------------------------------------------------
# phases 4h and 5h: the serving engine's admission routes
# ---------------------------------------------------------------------------

def first_difference(got: np.ndarray, want: np.ndarray):
    """Index of the first token where two [1, L] outputs differ (None if equal)."""
    n = min(got.shape[1], want.shape[1])
    diff = np.nonzero(got[0, :n] != want[0, :n])[0]
    if diff.size:
        return int(diff[0])
    return None if got.shape == want.shape else n


def top2_margin(t_params, ids: np.ndarray, pos: int) -> float:
    """The target's top-2 logit gap where it predicts token ``pos`` of ``ids``
    (one prefill over ids[:pos]): how near a tie the two outputs split."""
    x = torch.as_tensor(ids[:pos], device="cuda")[None]
    res = qwen3.forward_prefill(t_params, QWEN3_8B, qwen3.embed(t_params, x), torch.arange(pos, device="cuda")[None])
    top = qwen3.lm_head(t_params, res.hidden[:, -1]).topk(2).values[0]
    return float(top[0] - top[1])


def check_tokens(tag: str, checks: dict, t_params) -> None:
    """``checks``: name -> (got, want) [1, L] outputs.  Every pair must be
    equal; for a pair that is not, logs the first token that differs and the
    reference's top-2 logit margin there, then fails."""
    ok = {name: np.array_equal(got, want) for name, (got, want) in checks.items()}
    log(f"{tag} {json.dumps(ok)}")
    for name, (got, want) in checks.items():
        if not ok[name]:
            i = first_difference(got, want)
            margin = top2_margin(t_params, want[0], i) if i < want.shape[1] else None
            log(f"{tag} {name}: first difference at token {i} (generated token {i - PROMPT_LEN}): "
                f"got {got[0, i] if i < got.shape[1] else 'nothing'}, want {want[0, i] if i < want.shape[1] else 'nothing'}; "
                f"top-2 logit margin of the reference there {margin}")
    assert all(ok.values()), ok


def serving_expected(engine: ContinuousBatchingEngine, cycles: int, prefills: int, resumes: int = 0) -> dict:
    """Launch counts of a serving run: ``prefills`` prefill forwards (36
    prefill_flash each: single-request or a group's batched prefill),
    ``resumes`` prefix resumes and chunk / worker forwards (no attention
    kernel: the "xla" branch), ``cycles`` cycles run (37 verify_fused each,
    the int8 path 36 of them through the int8-ctx branch); the int8 path's
    matmul_int8: 256 per admission (a target forward + the draft's context
    projection) and 264 per cycle."""
    L, Ld = QWEN3_8B.num_hidden_layers, engine.dcfg.model.num_hidden_layers
    expected = dict.fromkeys(counts(), 0)
    expected["prefill_flash"] = prefills * L
    if engine.cfg.kv_quant:
        target_fwd, draft_append, draft_fwd = 7 * L + 1, 1 + 2 * Ld, 7 * Ld + 1
        expected.update(verify_fused=cycles * Ld, verify_fused_int8_ctx=cycles * L,
                        matmul_int8=(prefills + resumes) * (target_fwd + draft_append)
                        + cycles * (draft_append + draft_fwd + target_fwd))
    else:
        expected["verify_fused"] = cycles * (L + Ld)
    return expected


def counted_run(engine: ContinuousBatchingEngine, tag: str, expected_of, drive) -> list:
    """Counts set to 0, ``drive(engine)`` (submits and runs; returns the
    requests), counts read: they must equal ``expected_of(cycles run)``."""
    cycles0 = engine.cycle_count
    reset_counts()
    reqs = drive(engine)
    got = counts()
    cycles = engine.cycle_count - cycles0
    expected = expected_of(cycles)
    log(f"{tag} {cycles} cycles; per request (tokens, cycles): "
        f"{[(r.meta_info['completion_tokens'], r.meta_info['spec_verify_ct']) for r in reqs]}; "
        f"launches {json.dumps(got)} expected {json.dumps(expected)}")
    assert got == expected, (tag, got, expected)
    return [served(r, f"{tag} request {i}") for i, r in enumerate(reqs)]


def d_prompt() -> np.ndarray:
    """Prompt D: A's first 512 tokens (four prompt buckets), then 88 of its own."""
    return np.concatenate([prompts()[0][0, :512],
                           np.random.default_rng(3).integers(1, QWEN3_8B.vocab_size - 2, size=PROMPT_LEN - 512)])


def admission_parity_phase(params: tuple, greedy: list, c_tokens: np.ndarray) -> None:
    """Phase 4h (float): each admission route of the serving engine on four
    lanes gives the single-request tokens of phases 4 / 4g, with the launch
    counts its route implies."""
    dcfg, t_params, _ = params
    a, b = (p[0] for p in prompts())
    c, d = c_prompt(), d_prompt()
    ref_a, ref_b = greedy
    submit_all = lambda *reqs: lambda eng: [eng.submit(p, **kw) for p, kw in reqs]  # noqa: E731

    def drained(submit):
        def drive(eng):
            reqs = submit(eng)
            eng.run_until_drained()
            return reqs
        return drive

    # batched admission: one group, one batched prefill
    engine = serving_engine(params, 4, PARITY_NEW, batch_admission=True)
    outs = counted_run(engine, "[admission-group] A, B, A, C as one group:",
                       lambda cyc: serving_expected(engine, cyc, prefills=1),
                       drained(submit_all((a, {}), (b, {}), (a, {}), (c, {}))))
    check_tokens("[admission-group]", {"A": (outs[0], ref_a), "B": (outs[1], ref_b), "second A": (outs[2], ref_a),
                                        "C": (outs[3], c_tokens)}, t_params)
    del engine
    release()

    # the prefix cache: A cold publishes its 512-token prefix, D resumes from
    # it (no prefill_flash), then D cold after a flush
    engine = serving_engine(params, 4, PARITY_NEW, prefix_cache_mb=1024)
    cache = engine._prefix_cache
    out_a, = counted_run(engine, "[admission-prefix] A cold:", lambda cyc: serving_expected(engine, cyc, 1),
                         drained(submit_all((a, {}))))
    warm_d, = counted_run(engine, "[admission-prefix] D warm (resumes from A's 512 rows):",
                          lambda cyc: serving_expected(engine, cyc, 0, resumes=1), drained(submit_all((d, {}))))
    hits = cache.hits
    engine.flush()
    cold_d, = counted_run(engine, "[admission-prefix] D cold (after a flush):",
                          lambda cyc: serving_expected(engine, cyc, 1), drained(submit_all((d, {}))))
    log(f"[admission-prefix] prefix cache: {hits} hit(s) before the flush, {cache.misses} misses in all")
    assert hits == 1 and cache.misses == 2, (hits, cache.misses)
    check_tokens("[admission-prefix]", {"A": (out_a, ref_a), "D warm == D cold": (warm_d, cold_d)}, t_params)
    del engine, cache
    release()

    # chunk-interleaved admission (256-token chunks): B and C decode while A
    # prefills chunk by chunk; every 600-token prompt takes the chunked route
    engine = serving_engine(params, 4, PARITY_NEW, admission_chunk=256)

    def busy_then_a(eng):
        reqs = [eng.submit(b), eng.submit(c)]
        while sum(r is not None for r in eng._lane_req) < 2:
            eng.step()
        reqs.append(eng.submit(a))
        windows = 0
        while reqs[2] not in eng._lane_req:
            eng.step()
            windows += 1
        log(f"[admission-chunk] A bound after {windows} windows of B and C's decode (2 chunks of 256, then the "
            f"88-token resume)")
        eng.run_until_drained()
        return reqs

    outs = counted_run(engine, "[admission-chunk] B, C, then A:", lambda cyc: serving_expected(engine, cyc, 0, 3),
                       busy_then_a)
    check_tokens("[admission-chunk]", {"B": (outs[0], ref_b), "C": (outs[1], c_tokens), "A": (outs[2], ref_a)},
                 t_params)
    del engine
    release()

    # prefill-ahead: four lanes busy, the next two staged
    engine = serving_engine(params, 4, PARITY_NEW, prefill_ahead=2)

    def staged_drive(eng):
        reqs = [eng.submit(p) for p in (a, b, a, c)] + [eng.submit(b, max_new_tokens=32), eng.submit(a)]
        most = 0
        while eng.step() or not eng._idle():
            most = max(most, len(eng._staged))
        log(f"[admission-ahead] at most {most} staged while every lane was busy")
        assert most == 2, most
        return reqs

    outs = counted_run(engine, "[admission-ahead] A, B, A, C, B (32 new), A:",
                       lambda cyc: serving_expected(engine, cyc, 6), staged_drive)
    check_tokens("[admission-ahead]", {"A": (outs[0], ref_a), "B": (outs[1], ref_b), "second A": (outs[2], ref_a),
                                        "C": (outs[3], c_tokens), "B (32 new)": (outs[4], ref_b[:, :PROMPT_LEN + 32]),
                                        "third A": (outs[5], ref_a)}, t_params)
    del engine
    release()

    # disaggregated prefill on the same card: the worker's parameters are
    # the engine's tensors
    worker = PrefillWorker(QWEN3_8B, dcfg, t_params, prefill_device="cuda", decode_device="cuda")
    try:
        shared = all(worker.t_params["layers"][k] is t_params["layers"][k] for k in t_params["layers"])
        log(f"[admission-disagg] worker on {worker.prefill_device}, engine on {worker.decode_device}; "
            f"the worker's weights are the engine's tensors: {shared}")
        assert shared and worker.t_params["embed"] is t_params["embed"]
        engine = serving_engine(params, 4, PARITY_NEW, prefill_worker=worker)
        outs = counted_run(engine, "[admission-disagg] A, B, C through the worker:",
                           lambda cyc: serving_expected(engine, cyc, 0, 3), drained(submit_all((a, {}), (b, {}), (c, {}))))
    finally:
        worker.stop()
    check_tokens("[admission-disagg]", {"A": (outs[0], ref_a), "B": (outs[1], ref_b), "C": (outs[2], c_tokens)},
                 t_params)
    del engine, worker
    release()


def admission_int8_phase(params: tuple, greedy_int8: list) -> None:
    """Phase 4h (int8): A through the prefix-cache route of an int8 serving
    engine (kv_quant: the entry holds int8 rows and scales), cold then warm,
    equals phase 4b's tokens both times."""
    a = prompts()[0][0]
    engine = serving_engine(params, 4, PARITY_NEW, kv_quant=True, prefix_cache_mb=1024)

    def one(eng):
        req = eng.submit(a)
        eng.run_until_drained()
        return [req]

    cold, = counted_run(engine, "[admission-int8] A cold:", lambda cyc: serving_expected(engine, cyc, 1), one)
    warm, = counted_run(engine, "[admission-int8] A warm (resumes from its own 512 int8 rows):",
                        lambda cyc: serving_expected(engine, cyc, 0, resumes=1), one)
    assert engine._prefix_cache.hits == 1, engine._prefix_cache.hits
    check_tokens("[admission-int8]", {"A cold": (cold, greedy_int8[0]), "A warm": (warm, greedy_int8[0])}, params[1])


def serving_timing_phase(params: tuple, smi: str) -> list:
    """Phase 5f: the bf16 serving engine (SERVE_LANES lanes, TIMING_NEW new
    tokens, steps_per_sync 4) behind the HTTP server, driven by
    bench/serving.py's client at each concurrency c with 2c distinct random
    600-token prompts, at the random draft's tau and the emulated 7.46."""
    rows = []
    rng = np.random.default_rng(100)
    for tau in (None, REF_TAU):
        engine = serving_engine(params, SERVE_LANES, TIMING_NEW, steps_per_sync=4, emulate_tau=tau)
        srv = EngineHTTPServer(engine, host="127.0.0.1", port=0, tokenizer=engine.tokenizer)
        srv.start()
        try:
            url = f"http://{srv.host}:{srv.port}"
            fresh = lambda n: [rng.integers(10, V - 10, size=PROMPT_LEN).tolist() for _ in range(n)]  # noqa: E731
            serving.run_bench_requests(url, fresh(2), 2, TIMING_NEW)  # warm-up
            for conc in SERVE_CONCURRENCY:
                serving._flush(url)
                cycles0 = engine.cycle_count
                m = serving.run_bench_requests(url, fresh(2 * conc), conc, TIMING_NEW)
                assert m.spec_verify_ct_sum > 0, "speculative decoding did not run"
                cycles = engine.cycle_count - cycles0
                row = dict(tau_mode="own" if tau is None else f"forced {tau}", concurrency=conc,
                           requests=m.n_requests, lanes=SERVE_LANES, new_tokens=TIMING_NEW,
                           completion_tokens=m.completion_tokens, wall_s=m.wall_s, tok_s=m.tokens_per_sec,
                           mean_accept_length=m.mean_accept_length, mean_e2e_latency_s=m.mean_e2e_latency_s,
                           cycles=cycles, ms_per_cycle=m.wall_s * 1e3 / max(cycles, 1))
                rows.append(row)
                log("[timing-serving] " + json.dumps(row))
        finally:
            srv.stop()
        del engine, srv
        release()
    for row in rows:
        log(f"[timing-serving] {smi}: tau {row['tau_mode']:12s} conc {row['concurrency']:2d}: "
            f"{row['tok_s']:8.1f} tok/s, accept length {row['mean_accept_length']:.2f}, mean e2e latency "
            f"{row['mean_e2e_latency_s']:.3f} s, {row['ms_per_cycle']:.1f} ms per cycle ({row['cycles']} cycles)")
    return rows


def busy_ms(kernels: list) -> float:
    """Device busy ms: the union of the kernels' intervals."""
    total, end = 0.0, -1.0
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total / 1e3


def admission_cost(route: str, fn, per: int = 1) -> dict:
    """One admission prefill by ``route``: host wall ms (median of 3 calls,
    each ending in a synchronize, after a warm-up), and from a fourth call
    under torch.profiler the device busy ms and kernel launches; ``per``
    requests share one call (a group), and the numbers are per request."""
    fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / per)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    row = dict(route=route, requests_per_call=per, wall_ms=float(np.median(walls)), spread_ms=walls,
               device_busy_ms=busy_ms(kernels) / per, launches=len(kernels) / per)
    log("[admission-cost] " + json.dumps(row))
    return row


def admission_cost_phase(params: tuple, smi: str) -> list:
    """Phase 5h, per admission: the prefill work each route puts on the
    loop's stream for one 600-token request (bf16, the serving engine's
    total_len 785): a single-request prefill, the prefix resume from 512
    cached rows (an 88-row "xla" forward), a group of 16 (per request), one
    256-token chunk forward, and the prefill worker's 512-token prefix."""
    dcfg, t_params, d_params = params
    engine = serving_engine(params, SERVE_LANES, TIMING_NEW, prefix_cache_mb=1024)
    rng = np.random.default_rng(300)
    ids = [rng.integers(10, V - 10, size=PROMPT_LEN) for _ in range(SERVE_LANES)]
    req = Request(rid=0, input_ids=ids[0].astype(np.int32), max_new_tokens=TIMING_NEW, temperature=0.0)
    padded = engine._padded(req)
    rows = [admission_cost("single prefill", lambda: spec_engine._prefill_impl(
        t_params, d_params, torch.from_numpy(padded).cuda(), PROMPT_LEN, 0.0, None, **engine._prefill_common(req)))]
    engine._compute_single(req)  # publishes its 512-row prefix
    entry = engine._prefix_cache.lookup(req.input_ids, PROMPT_LEN - 1)[1]
    rows.append(admission_cost("prefix resume (512 cached rows)",
                               lambda: engine._resume(req, padded, entry.kv_rows, entry.taps)))
    group = np.zeros((SERVE_LANES, PROMPT_CAP), np.int64)
    for j, x in enumerate(ids):
        group[j, :PROMPT_LEN] = x
    rows.append(admission_cost(f"group of {SERVE_LANES}", lambda: batched.batched_prefill(
        t_params, d_params, group, [PROMPT_LEN] * SERVE_LANES, 0.0, tcfg=QWEN3_8B, dcfg=dcfg,
        total_len=engine.total_len, max_cycles=TIMING_NEW), per=SERVE_LANES))
    scratch = init_kv_cache(QWEN3_8B, 1, PROMPT_CAP, torch.bfloat16, "cuda")
    taps = torch.zeros((1, PROMPT_CAP, dcfg.num_taps * QWEN3_8B.hidden_size), dtype=torch.bfloat16, device="cuda")
    chunk_ids = torch.from_numpy(padded[:, 256:512]).cuda()
    rows.append(admission_cost("one 256-token chunk forward", lambda: spec_engine._prefill_chunk_impl(
        t_params, scratch, taps, chunk_ids, 256, tcfg=QWEN3_8B, tap_ids=dcfg.target_layer_ids)))
    worker = PrefillWorker(QWEN3_8B, dcfg, t_params, prefill_device="cuda", decode_device="cuda")
    try:
        rows.append(admission_cost("prefill worker's 512-token prefix", lambda: worker._prefill_prefix(padded, 512)))
    finally:
        worker.stop()
    for row in rows:
        log(f"[admission-cost] {smi}: {row['route']:36s} {row['wall_ms']:7.1f} ms wall, "
            f"{row['device_busy_ms']:6.2f} ms device busy, {row['launches']:6.0f} launches per request")
    del engine, entry, scratch
    release()
    return rows


def admission_timing_phase(params: tuple, smi: str) -> list:
    """Phase 5h: the bf16 serving engine (SERVE_LANES lanes, TIMING_NEW new
    tokens, steps_per_sync 4, tau forced to 7.46) behind the HTTP server,
    driven by bench/serving.py's client with 2 x concurrency requests of
    random 600-token prompts, greedy, through each admission route:
    batch_admission off / on in turns (off, on, on, off, off, on) at
    concurrency 16, and one pair at 4; shared-prefix traffic (every prompt
    starts with one 512-token prefix) with the prefix cache off / on (1024
    MB); admission_chunk 256, prefill_ahead 2 and a prefill worker on the
    same card, once each at 16."""
    dcfg, t_params, _ = params
    rng = np.random.default_rng(200)
    fresh = lambda n: [rng.integers(10, V - 10, size=PROMPT_LEN).tolist() for _ in range(n)]  # noqa: E731
    shared = rng.integers(10, V - 10, size=512).tolist()
    fresh_shared = lambda n: [shared + rng.integers(10, V - 10, size=PROMPT_LEN - 512).tolist()  # noqa: E731
                              for _ in range(n)]
    servers, workers = {}, []

    def serve(name: str, **kw) -> tuple:
        if name not in servers:
            engine = serving_engine(params, SERVE_LANES, TIMING_NEW, steps_per_sync=4, emulate_tau=REF_TAU, **kw)
            srv = EngineHTTPServer(engine, host="127.0.0.1", port=0, tokenizer=engine.tokenizer)
            srv.start()
            url = f"http://{srv.host}:{srv.port}"
            serving.run_bench_requests(url, fresh(2), 2, TIMING_NEW)  # warm-up
            servers[name] = (engine, srv, url)
        return servers[name]

    def stop(*names) -> None:
        for name in names:
            engine, srv, _ = servers.pop(name)
            srv.stop()
        release()

    rows = []

    def run(name: str, conc: int, traffic=fresh, **kw) -> dict:
        engine, _, url = serve(name, **kw)
        serving._flush(url)
        cache = engine._prefix_cache
        cycles0, hits0 = engine.cycle_count, cache.hits if cache is not None else 0
        reset_counts()
        m = serving.run_bench_requests(url, traffic(2 * conc), conc, TIMING_NEW)
        assert m.spec_verify_ct_sum > 0, "speculative decoding did not run"
        row = dict(route=name, concurrency=conc, requests=m.n_requests, tok_s=m.tokens_per_sec,
                   mean_e2e_latency_s=m.mean_e2e_latency_s, mean_accept_length=m.mean_accept_length,
                   cycles=engine.cycle_count - cycles0, wall_s=m.wall_s, launches=counts())
        if cache is not None:
            row["prefix_hits"] = cache.hits - hits0
        rows.append(row)
        log("[timing-admission] " + json.dumps(row))
        return row

    admission_cost_phase(params, smi)
    pairs = {}
    for name in ("plain", "batch_admission", "batch_admission", "plain", "plain", "batch_admission"):
        pairs.setdefault(name, []).append(run(name, 16, batch_admission=name == "batch_admission")["tok_s"])
    for name in ("plain", "batch_admission"):
        run(name, 4, batch_admission=name == "batch_admission")
    stop("plain", "batch_admission")
    for name in ("shared_prefix", "shared_prefix_cache", "shared_prefix_cache", "shared_prefix"):
        pairs.setdefault(name, []).append(
            run(name, 16, fresh_shared, prefix_cache_mb=1024 if name.endswith("cache") else 0)["tok_s"])
    stop("shared_prefix", "shared_prefix_cache")
    run("admission_chunk_256", 16, admission_chunk=256)
    stop("admission_chunk_256")
    run("prefill_ahead_2", 16, prefill_ahead=2)
    stop("prefill_ahead_2")
    worker = PrefillWorker(QWEN3_8B, dcfg, t_params, prefill_device="cuda", decode_device="cuda")
    try:
        run("disagg_same_card", 16, prefill_worker=worker)
        stop("disagg_same_card")
    finally:
        worker.stop()
    for name, tok_s in pairs.items():
        log(f"[timing-admission] {smi}: concurrency 16, {name}: median {float(np.median(tok_s)):.1f} tok/s over "
            f"{len(tok_s)} runs (spread {min(tok_s):.1f}-{max(tok_s):.1f})")
    for row in rows:
        log(f"[timing-admission] {smi}: {row['route']:20s} conc {row['concurrency']:2d}: {row['tok_s']:8.1f} tok/s, "
            f"mean e2e {row['mean_e2e_latency_s']:.3f} s, accept {row['mean_accept_length']:.2f}, "
            f"{row['cycles']} cycles, prefill_flash {row['launches']['prefill_flash']}")
    return rows


def batched_timing_phase(params: tuple) -> list:
    """Phase 5e: the bf16 batched decode at R in LANES_TIMED, TIMING_NEW new
    tokens per lane, at the random draft's own acceptance and at the forced
    tau 7.46: tok/s summed over the lanes, the batched prefill's TTFT,
    and the decode's kernel launches per cycle (one request's, whatever
    R)."""
    dcfg, t_params, d_params = params
    forced = make_forced_acc(TIMING_NEW, BLOCK, REF_TAU)
    T = PROMPT_CAP + TIMING_NEW + BLOCK + 1
    kw = dict(tcfg=QWEN3_8B, dcfg=dcfg)
    rows = []
    for R in LANES_TIMED:
        ids, lens = lane_prompts(R)

        def run(new: int, fa) -> tuple:
            """(state, TTFT s, decode wall s); the counts cover the decode alone."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = batched.batched_prefill(t_params, d_params, ids, lens, 0.0, total_len=T, max_cycles=TIMING_NEW,
                                         **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            reset_counts()
            st = batched.batched_decode(t_params, d_params, st, lens + new, 0.0, block_size=BLOCK,
                                        stop_token_ids=(), max_cycles=TIMING_NEW, forced_acc=fa, **kw)
            torch.cuda.synchronize()
            return st, t1 - t0, time.perf_counter() - t1

        run(8, None)  # warm-up: the allocator and cuBLAS at this R
        for mode, fa in (("own", None), ("forced", np.broadcast_to(forced, (R, TIMING_NEW)))):
            st, ttft, wall = run(TIMING_NEW, fa)
            cycles = int(st.host_cycle_idx.max())
            tokens = int((st.host_start - lens).sum())
            per_cycle = {k: v / cycles for k, v in counts().items() if v}
            n_attn = QWEN3_8B.num_hidden_layers + dcfg.model.num_hidden_layers
            assert counts()["verify_fused"] == n_attn * cycles, (counts(), cycles)  # one request's, whatever R
            row = dict(path=path_name(False) + ", batched", lanes=R, tau_mode=mode,
                       tau=float(st.acc_trace.float()[st.acc_trace > 0].mean()), new_tokens=TIMING_NEW,
                       cycles=cycles, tokens=tokens, tok_s_summed=tokens / wall, decode_wall_s=wall,
                       ms_per_cycle=wall * 1e3 / cycles, ttft_ms=ttft * 1e3, launches_per_cycle=per_cycle)
            rows.append(row)
            log("[timing-lanes] " + json.dumps(row))
            log(f"[timing-lanes] R={R} tau {mode} ({row['tau']:.2f}): {row['tok_s_summed']:.1f} tok/s summed over "
                f"lanes, {row['ms_per_cycle']:.2f} ms per cycle, TTFT {row['ttft_ms']:.1f} ms, verify_fused "
                f"launches per cycle {per_cycle.get('verify_fused', 0):.1f}")
        del ids
        release()
    return rows


def server_entry_phase() -> dict:
    """Phase 5g: the server module's own entry point on the card, in a child
    process: it must print its address, answer one /generate of a 600-token
    prompt with tokens in the vocabulary, and stop when terminated."""
    cmd = [sys.executable, "-m", "dflash_tpu_torch.engine.server", "--model-name-or-path", "qwen3-8b",
           "--num-lanes", "8", "--port", "0", "--prompt-cap", str(PROMPT_CAP), "--max-new-tokens", "32"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
    try:
        line = ""
        while not line.startswith("serving on http://"):
            ready, _, _ = select.select([proc.stdout], [], [], 300)
            assert ready and proc.poll() is None, f"the server did not start: {line}"
            line = proc.stdout.readline()
        url = line.split()[-1]
        start_s = time.perf_counter() - t0
        out = serving._post(url, {"input_ids": prompts()[0][0].tolist(),
                                  "sampling_params": {"max_new_tokens": 32, "temperature": 0}})
        ids = out["output_ids"]
        assert 1 <= len(ids) <= 32 and min(ids) >= 0 and max(ids) < V, out
        res = dict(cmd=" ".join(cmd[1:]), start_s=start_s, tokens=len(ids), meta_info=out["meta_info"])
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    log("[server-main] " + json.dumps(res))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # phase 2: build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {_build.sources()} built in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:72]  # the mangled kernel name
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {entry}: {line.strip()}")

    # phase 3: kernels vs plain
    g = torch.Generator(device="cuda").manual_seed(0)
    T = PROMPT_CAP + TIMING_NEW + BLOCK + 1  # the timing engine's total_len
    # ctx_len: none, one row, both sides of the bf16 kernel's first split
    # boundary (one 64-key tile a split at these sizes), the main path's 700, full
    edge = verify_fused.KEY_TILE * verify_fused.split_tiles(BLOCK, NH, NKV, verify_fused.KEY_TILE)
    ctx_lens = (0, 1, edge - 1, edge, edge + 1, 700, T - 16)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for B, all_true in ((16, False), (16, True), (1, False)):
            for ctx_len in ctx_lens:
                cases.append(verify_case(dtype, B, all_true, ctx_len, T, g))
                log("[kernel] " + json.dumps(cases[-1]))
        for S in (128, 130, 640, 2048):
            cases.append(prefill_case(dtype, S, g))
            log("[kernel] " + json.dumps(cases[-1]))
    int8pack = int8pack_runs()
    for dtype in (torch.bfloat16, torch.float32):
        for B, all_true in ((16, False), (16, True), (1, False)):
            for ctx_len in ctx_lens:
                cases.append(verify_case(dtype, B, all_true, ctx_len, T, g, int8=True))
                log("[kernel] " + json.dumps(cases[-1]))
        for K, N in MM_SHAPES:
            for S in (1, BLOCK - 1, BLOCK, PROMPT_CAP) + ((MM_LONG_S,) if dtype == torch.bfloat16 else ()):
                cases.append(matmul_case(dtype, K, N, S, g, int8pack))
                log("[kernel] " + json.dumps(cases[-1]))
                log(matmul_line(cases[-1]))
    for N in (1, BLOCK):
        for T_thr in (2 * sampling.REPAIR_W, 2 * sampling.REFINE_W, filter_stats.THR_CAP):
            cases.append(filter_stats_case(N, T_thr, g))
            log("[kernel] " + json.dumps(cases[-1]))
            log(filter_stats_line(cases[-1]))
    for top_k, top_p in KEEP_CASES:
        log("[keep-set] " + json.dumps(keep_set_case(top_k, top_p, g)))
    for dtype in (torch.bfloat16, torch.float32):
        for B in (BLOCK, 1):
            edge = attention.KEY_TILE  # the first split boundary of the bf16 kernel
            for start in sorted({0, 1, 700, PALLAS_T - 16, edge - B, edge - B + 1, edge - B // 2, edge}):
                cases.append(verify_attention_case(dtype, B, start, g))
                log("[kernel] " + json.dumps(cases[-1]))

    # the lane entries, on inputs of their own (the cases above keep theirs):
    # every frontier of lane_starts_sets in some lane, bf16 / f32 / int8 ctx,
    # B 16 and 1; timed: 8 lanes at 700, B 16, and prefill at 4 lanes
    g = torch.Generator(device="cuda").manual_seed(1)
    for int8 in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            for B in (BLOCK, 1):
                for L in (1, 4, 8):
                    for starts in lane_starts_sets(T, L):
                        log("[kernel-lanes] " + json.dumps(verify_lanes_case(dtype, L, B, starts, T, g, int8)))
            if dtype == torch.bfloat16:
                cases.append(verify_lanes_case(dtype, 8, BLOCK, [700] * 8, T, g, int8, timed=True))
                log("[kernel] " + json.dumps(cases[-1]))
    for dtype in (torch.bfloat16, torch.float32):
        for L in (1, 4):
            cases.append(prefill_lanes_case(dtype, L, PROMPT_CAP, g, timed=L == 4))
            log("[kernel] " + json.dumps(cases[-1]))

    phase_done("3 (kernels vs plain)", t_start)

    # phase 4: exact parity through the kernels, f32, on one set of weights:
    # 4 the default engine, 4c the "pallas" engine, 4d filtered requests, 4e
    # the batched engine, 4g the serving engine; 4b: the int8 path, 4f its
    # batched engine and 4g's int8 request
    t0 = time.perf_counter()
    params = build_params(torch.float32)
    torch.cuda.synchronize()
    log(f"[parity] f32 weights initialised in {time.perf_counter() - t0:.1f} s")
    engine = make_engine(params, PARITY_NEW)
    launches, greedy = parity_phase(engine, "[parity]")
    launches_pallas, pallas_out = parity_phase(make_engine(params, PARITY_NEW, attn_impl="pallas"),
                                               "[parity-pallas]")
    log("[parity-pallas] tokens agreeing with phase 4's, per prompt: "
        f"{[agreement(a, b) for a, b in zip(pallas_out, greedy)]} of {PARITY_NEW}")
    launches_filtered = filtered_parity_phase(engine, greedy)
    c_tokens = batched_parity_phase(engine, greedy, "[parity-lanes]")
    del engine
    release()
    serving_parity_phase(params, greedy, c_tokens)
    release()
    phase_done("4-4g (float)", t_start)
    admission_parity_phase(params, greedy, c_tokens)
    del params
    release()
    phase_done("4h (float)", t_start)
    params = build_params(torch.float32, int8=True)
    engine = make_engine(params, PARITY_NEW, int8=True)
    launches_int8, greedy_int8 = parity_phase(engine, "[parity-int8]")
    batched_parity_phase(engine, greedy_int8, "[parity-int8-lanes]")
    del engine
    release()
    serving_int8_phase(params, greedy_int8)
    release()
    admission_int8_phase(params, greedy_int8)
    del params
    release()
    phase_done("4b, 4f, 4g and 4h (int8)", t_start)

    # phase 5: timing, bf16; 5c: the "pallas" path and filtered sampling, 5e
    # the batched engine, 5f the serving engine, on the same weights; 5b: the
    # int8 path
    params = build_params(torch.bfloat16)
    engine = make_engine(params, TIMING_NEW)
    timing = timing_phase(engine)
    log("[timing] " + json.dumps(timing))
    timing_pallas = timing_phase(make_engine(params, TIMING_NEW, attn_impl="pallas"))
    log("[timing-pallas] " + json.dumps(timing_pallas))
    timing_filtered = filtered_timing_phase(engine)
    log("[timing-filtered] " + json.dumps(timing_filtered))
    del engine
    release()
    phase_done("5, 5c", t_start)
    timing_lanes = batched_timing_phase(params)
    phase_done("5e", t_start)
    serving_timing_phase(params, smi)
    phase_done("5f", t_start)
    admission_timing_phase(params, smi)
    del params
    release()
    phase_done("5h", t_start)
    timing_int8 = timing_phase(make_engine(build_params(torch.bfloat16, int8=True), TIMING_NEW, int8=True))
    log("[timing-int8] " + json.dumps(timing_int8))
    release()
    server_entry_phase()
    phase_done("5b, 5g", t_start)
    for key in ("ttft_spec_ms", "ttft_ar_ms", "ar_tpot_ms", "spec_tpot_ms", "spec_forced_tpot_ms"):
        log(f"[timing] {key}: bf16 path {timing[key]:.3f}, pallas path {timing_pallas[key]:.3f}, "
            f"int8 path {timing_int8[key]:.3f}")
    log(f"[timing-int8] int8 path beside the bf16 path of this run: TTFT AR {timing_int8['ttft_ar_ms']:.3f} vs "
        f"{timing['ttft_ar_ms']:.3f} ms, TTFT spec {timing_int8['ttft_spec_ms']:.3f} vs {timing['ttft_spec_ms']:.3f}, "
        f"TPOT AR {timing_int8['ar_tpot_ms']:.3f} vs {timing['ar_tpot_ms']:.3f}, TPOT spec "
        f"{timing_int8['spec_tpot_ms']:.3f} vs {timing['spec_tpot_ms']:.3f}")
    for row in timing_lanes:
        log(f"[timing-lanes] {smi}: R={row['lanes']:2d} tau {row['tau_mode']:6s} {row['tok_s_summed']:9.1f} tok/s "
            f"summed, {row['ms_per_cycle']:7.2f} ms/cycle, TTFT {row['ttft_ms']:7.1f} ms")
    log(f"[timing] filtered spec TPOT {timing_filtered['spec_tpot_ms']:.3f} ms (tau "
        f"{timing_filtered['spec_tau']:.3f}, {timing_filtered['refinement_rounds_per_call']:.2f} refinement "
        f"rounds per sampling call) beside greedy spec TPOT {timing['spec_tpot_ms']:.3f} ms (tau "
        f"{timing['spec_tau']:.3f}) of the same run")

    def pick(kernel, **match):
        return next(c for c in cases if c["kernel"] == kernel and all(c[k] == v for k, v in match.items()))

    # name: (case at the main path's shape, source, TPU kernel replaced, launches)
    verify_src = "dflash_tpu_torch/kernels/csrc/verify_fused.cu"
    main = {
        "verify_fused": (pick("verify_fused", dtype="bfloat16", B=16, mask="causal", ctx_len=700),
                         verify_src, "dflash_tpu/kernels/verify_fused.py:219", launches["verify_fused"]),
        "verify_fused_int8_ctx": (
            pick("verify_fused_int8_ctx", dtype="bfloat16", B=16, mask="causal", ctx_len=700),
            verify_src, "dflash_tpu/kernels/verify_fused.py:219", launches_int8["verify_fused_int8_ctx"]),
        "prefill_flash": (pick("prefill_flash", dtype="bfloat16", S=640),
                          "dflash_tpu_torch/kernels/csrc/prefill_flash.cu",
                          "dflash_tpu/kernels/prefill_flash.py:111", launches["prefill_flash"]),
        "matmul_int8": (pick("matmul_int8", dtype="bfloat16", S=BLOCK, K=H, N=I),
                        "dflash_tpu_torch/kernels/csrc/matmul_q.cu",
                        "dflash_tpu/kernels/matmul_q.py:56", launches_int8["matmul_int8"]),
        "filter_stats": (pick("filter_stats", N=BLOCK, T=2 * sampling.REPAIR_W),
                         "dflash_tpu_torch/kernels/csrc/filter_stats.cu",
                         "dflash_tpu/kernels/filter_stats.py:117", launches_filtered["filter_stats"]),
        "verify_attention": (pick("verify_attention", dtype="bfloat16", B=BLOCK, start=700),
                             "dflash_tpu_torch/kernels/csrc/attention.cu",
                             "dflash_tpu/kernels/attention.py:113", launches_pallas["verify_attention"]),
    }
    summary = [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": n, "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"],
    } for name, (c, src, replaces, n) in main.items()]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
