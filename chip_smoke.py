#!/usr/bin/env python
"""Chip smoke of the PyTorch/CUDA port (dflash_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Four paths are driven: the bf16/f32 path (float weights and KV cache), the
int8 serving path (int8 weights from quantize_target_params /
quantize_draft_params, and kv_quant=True), the attn_impl="pallas" path
(verify and AR step through qwen3.forward and the frontier-bounded
verify_attention kernel) and filtered sampling (generate(top_k, top_p),
whose exact keep set comes from the filter_stats kernel).

Phases, each fatal on failure (nothing is caught):
  1. device: card name and power limit; TF32 off for matmuls and cuDNN.
  2. build: every CUDA kernel from dflash_tpu_torch/kernels/csrc, in parallel.
  3. kernels vs plain at the main path's shapes, bf16 and f32: verify_fused
     (bf16/f32 ctx and int8 ctx; nh 32, n_kv 8, d 128; ctx_len in {0, 1,
     700, T - 16} and on both sides of the bf16 kernel's first split
     boundary, each with NaN ctx K/V, or int8 scales, past ctx_len),
     prefill_flash (S in {128, 130, 640, 2048}), and
     matmul_int8 at every Qwen3-8B projection shape x S in {1, 16, 640}: max
     abs error against the plain PyTorch version, tolerance, kernel / plain /
     library times from CUDA events, and the bound max(bytes / 3.35 TB/s,
     flops / peak) of the same work.  Library yardsticks, which the port
     never calls: scaled_dot_product_attention (over K/V dequantized
     beforehand for the int8 ctx), torch.mm with the weight dequantized
     beforehand to x's dtype, and torch._weight_int8pack_mm where the
     installed PyTorch runs it on CUDA.
     Then filter_stats (x f32 [N, 151,936], N in {1, 16}, T in {16, 32, 64}
     thresholds from the rows' own values plus 0xFFFFFFFF and a pattern below
     the row minimum; counts exact, the rest within 2e-6; no library call
     computes these outputs); the keep sets of filtered_logits_topk_topp at
     full vocabulary, with the kernel's stats and with the plain version's,
     against a full-sort f64 keep rule; and verify_attention (bf16 and f32,
     B in {16, 1}, start in {0, 1, 700, T - 16} and on both sides of the
     bf16 kernel's first split boundary, T = 1024, each with NaN K/V past
     the frontier; yardstick scaled_dot_product_attention over the valid
     rows with the offset causal mask).
  4. exact parity, f32, Qwen3-8B at full width and depth, random weights from
     a seed: SpecEngine.generate == SpecEngine.ar_generate token for token on
     two 600-token prompts (padded to 640), and the kernel launch counts of
     that run are exactly what the path implies.  4: the bf16/f32 path;
     4b: the int8 path, weights quantized by the port; 4c: the
     attn_impl="pallas" engine on phase 4's weights; 4d: two filtered
     requests whose keep set is the argmax alone (temperature 1.5, top_k 1;
     temperature 2, top_k 2, top_p 1e-6) on phase 4's engine, which must
     give the greedy tokens with exactly 1 + n_cycles filter_stats launches.
  5. timing, bf16, same shapes: TTFT, AR TPOT, spec TPOT at the random
     draft's real acceptance and at an emulated tau of 7.46, and the spec/AR
     agreement length (printed, not asserted: bf16 greedy can flip on ties).
     5: the bf16 path; 5c: the attn_impl="pallas" path on the same weights,
     and filtered spec decoding (temperature 0.8, top_k 50, top_p 0.95) on
     the default path; 5b: the int8 path.
The last lines are the card's name and power limit, the kernels' JSON
summary and the device JSON.  Exits non-zero, printing no result, without
CUDA.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dflash_tpu_torch.cache.kv import quantize_rows
from dflash_tpu_torch.core.config import QWEN3_8B, dflash_draft_config
from dflash_tpu_torch.kernels import _build, attention, filter_stats, matmul_q, prefill_flash, verify_fused
from dflash_tpu_torch.models import dflash_draft, qwen3
from dflash_tpu_torch.ops import sampling
from dflash_tpu_torch.ops.linear import QTensor, dequantize
from dflash_tpu_torch.quant import quantize_draft_params, quantize_target_params
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
BLOCK = 16
PROMPT_LEN, PROMPT_CAP = 600, 640
PARITY_NEW, TIMING_NEW = 64, 128
REF_TAU = 7.46
PALLAS_T = 1024  # the timing engine's total_len (785) rounded up to 512 on the "pallas" path
FILTERED = dict(temperature=0.8, top_k=50, top_p=0.95)


def log(msg: str) -> None:
    print(msg, flush=True)


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
                k_split=matmul_q.k_split(K, N_pad), max_abs_err=err, tol=MM_TOL, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, library="torch.mm, weight dequantized to x's dtype",
                int8pack_ms=int8pack_ms, bound_ms=b_ms, bound_by=b_by)


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
    ms = cuda_ms([lambda s=s: filter_stats.filter_stats(*s) for s in sets], 50)
    plain_ms = cuda_ms([lambda s=s: filter_stats.plain(*s) for s in sets], 5)
    # ~3 operations per element and threshold (two compares, a masked add),
    # ~5 per element besides (max, min, exp, sum, the bits), at the f32 rate
    b_ms, b_by = bound_ms(nbytes, N * V * (3 * T + 5), torch.float32)
    return dict(kernel="filter_stats", N=N, T=T, V=V, max_abs_err=err, tol=dict(atol=FS_ATOL),
                kernel_ms=ms, plain_ms=plain_ms, library_ms=None,
                library="none: no one PyTorch call computes the five outputs",
                bound_ms=b_ms, bound_by=b_by)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
            for S in (1, BLOCK, PROMPT_CAP):
                cases.append(matmul_case(dtype, K, N, S, g, int8pack))
                log("[kernel] " + json.dumps(cases[-1]))
    for N in (1, BLOCK):
        for T_thr in (2 * sampling.REPAIR_W, 2 * sampling.REFINE_W, filter_stats.THR_CAP):
            cases.append(filter_stats_case(N, T_thr, g))
            log("[kernel] " + json.dumps(cases[-1]))
    for top_k, top_p in KEEP_CASES:
        log("[keep-set] " + json.dumps(keep_set_case(top_k, top_p, g)))
    for dtype in (torch.bfloat16, torch.float32):
        for B in (BLOCK, 1):
            edge = attention.KEY_TILE  # the first split boundary of the bf16 kernel
            for start in sorted({0, 1, 700, PALLAS_T - 16, edge - B, edge - B + 1, edge - B // 2, edge}):
                cases.append(verify_attention_case(dtype, B, start, g))
                log("[kernel] " + json.dumps(cases[-1]))

    # phase 4: exact parity through the kernels, f32, on one set of weights:
    # 4 the default engine, 4c the "pallas" engine, 4d filtered requests;
    # 4b: the int8 path
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
    del engine, params
    release()
    launches_int8, _ = parity_phase(make_engine(build_params(torch.float32, int8=True), PARITY_NEW, int8=True),
                                    "[parity-int8]")
    release()

    # phase 5: timing, bf16; 5c: the "pallas" path and filtered sampling on
    # the same weights; 5b: the int8 path
    params = build_params(torch.bfloat16)
    engine = make_engine(params, TIMING_NEW)
    timing = timing_phase(engine)
    log("[timing] " + json.dumps(timing))
    timing_pallas = timing_phase(make_engine(params, TIMING_NEW, attn_impl="pallas"))
    log("[timing-pallas] " + json.dumps(timing_pallas))
    timing_filtered = filtered_timing_phase(engine)
    log("[timing-filtered] " + json.dumps(timing_filtered))
    del engine, params
    release()
    timing_int8 = timing_phase(make_engine(build_params(torch.bfloat16, int8=True), TIMING_NEW, int8=True))
    log("[timing-int8] " + json.dumps(timing_int8))
    release()
    for key in ("ttft_spec_ms", "ttft_ar_ms", "ar_tpot_ms", "spec_tpot_ms", "spec_forced_tpot_ms"):
        log(f"[timing] {key}: bf16 path {timing[key]:.3f}, pallas path {timing_pallas[key]:.3f}, "
            f"int8 path {timing_int8[key]:.3f}")
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
