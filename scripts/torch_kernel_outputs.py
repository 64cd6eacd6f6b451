#!/usr/bin/env python
"""Save the attention and int8 matmul kernels' outputs at fixed inputs, or
compare two saves bit for bit: shows that a change to a kernel source left a
branch's numbers exactly as they were.  Needs an NVIDIA GPU.

    python scripts/torch_kernel_outputs.py save OUT.pt     # from a checkout's root
    python scripts/torch_kernel_outputs.py compare A.pt B.pt [PREFIX ...]

``save`` imports the kernels of the checkout it runs from (its working
directory), so one copy of this script saves both sides: run it from inside
each checkout.  ``compare`` reports every entry and fails
unless all are bitwise equal, leaving out the entries whose names start with
a PREFIX given (the branches the change meant to move).

Covers, at the main path's head shapes (nh 32, n_kv 8, d 128), bf16 and f32:
verify_fused (float ctx and int8 ctx), prefill_flash and verify_attention;
matmul_int8 (``matmul_<x dtype>_<S>_<K>x<N>``, f32 out) for f32 and
bf16 x, S in {1, 16, 640}, at Qwen3-8B's wq, wk and gate shapes; and
filter_stats (``filter_stats_<N>_<T>_<output>``) on f32 logits [N, 151,936],
N in {1, 16}, T in {16, 32}.  Lane entries (``verify_lanes_*``,
``verify_int8_lanes_*``: 4 lanes with frontiers 0, 65, 700 and 769;
``prefill_lanes_*``: 3 lanes of 640 rows) where the checkout's kernels have
a lane axis; a checkout without one saves none, and ``compare`` lists entries
found on one side only without failing, unless A has an entry B lacks.
Each group draws its inputs from a generator of
its own, so adding a group leaves the earlier entries' inputs as they were.
"""

from __future__ import annotations

import sys

import torch


def outputs() -> dict:
    from dflash_tpu_torch.cache.kv import quantize_rows
    from dflash_tpu_torch.kernels import attention, filter_stats, matmul_q, prefill_flash, verify_fused

    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
        for B, T, ctx_len, causal in ((16, 785, 700, True), (16, 785, 769, False), (1, 785, 700, True)):
            q, bk, bv = randn(1, B, 32, 128), randn(1, B, 8, 128), randn(1, B, 8, 128)
            ck, cv = randn(1, T, 8, 128), randn(1, T, 8, 128)
            mask = torch.ones(B, B, dtype=torch.bool, device="cuda")
            if causal:
                mask = torch.tril(mask)
            res[f"verify_{dtype}_{B}_{ctx_len}"] = verify_fused.fused_ctx_block_attention(
                q, ck, None, cv, None, bk, bv, ctx_len, mask, 128 ** -0.5).cpu()
        for S in (128, 640):
            q, k, v = randn(1, S, 32, 128), randn(1, S, 8, 128), randn(1, S, 8, 128)
            res[f"prefill_{dtype}_{S}"] = prefill_flash.flash_prefill_attention(q, k, v, 128 ** -0.5).cpu()
        for B, T, ctx_len in ((16, 785, 700), (1, 785, 700)):
            q, bk, bv = randn(1, B, 32, 128), randn(1, B, 8, 128), randn(1, B, 8, 128)
            (kq, ks), (vq, vs) = quantize_rows(randn(1, T, 8, 128)), quantize_rows(randn(1, T, 8, 128))
            mask = torch.tril(torch.ones(B, B, dtype=torch.bool, device="cuda"))
            res[f"verify_int8_{dtype}_{B}_{ctx_len}"] = verify_fused.fused_ctx_block_attention(
                q, kq, ks, vq, vs, bk, bv, ctx_len, mask, 128 ** -0.5).cpu()
        for B, T, start in ((16, 1024, 700), (1, 1024, 700)):
            q, k, v = randn(1, B, 32, 128), randn(1, T, 8, 128), randn(1, T, 8, 128)
            res[f"verify_attention_{dtype}_{B}_{start}"] = attention.verify_attention(q, k, v, start, B).cpu()
    g = torch.Generator(device="cuda").manual_seed(1)  # its own stream: the entries above keep their inputs
    for K, N in ((4096, 4096), (4096, 1024), (4096, 12288)):
        q = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        scale = torch.rand((1, N), generator=g, device="cuda") * 1e-3
        x = torch.randn((640, K), generator=g, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            for S in (1, 16, 640):
                res[f"matmul_{dtype}_{S}_{K}x{N}"] = matmul_q.matmul_int8(x[:S].to(dtype), q, scale, N).cpu()
    g = torch.Generator(device="cuda").manual_seed(2)
    for N in (1, 16):
        for T in (16, 32):
            x = torch.randn((N, 151936), generator=g, device="cuda") * 3.0
            thr = torch.gather(filter_stats.ordered_bits(x), 1,
                               torch.randint(0, 151936, (N, T), generator=g, device="cuda"))
            names = ("count_ge", "count_gt", "mass_gt", "lse", "row_min")
            for name, out in zip(names, filter_stats.filter_stats(x, thr)):
                res[f"filter_stats_{N}_{T}_{name}"] = out.cpu()
    if hasattr(verify_fused, "fused_ctx_block_attention_lanes"):  # the lane entries, where the kernels have them
        g = torch.Generator(device="cuda").manual_seed(3)
        starts_h = [0, 65, 700, 769]
        starts = torch.tensor(starts_h, dtype=torch.int32, device="cuda")
        L, B, T = len(starts_h), 16, 785
        mask = torch.tril(torch.ones(B, B, dtype=torch.bool, device="cuda"))
        for dtype in (torch.bfloat16, torch.float32):
            randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
            q, bk, bv = randn(L, 1, B, 32, 128), randn(L, 1, B, 8, 128), randn(L, 1, B, 8, 128)
            ck, cv = randn(L, T, 8, 128), randn(L, T, 8, 128)
            res[f"verify_lanes_{dtype}_{L}"] = verify_fused.fused_ctx_block_attention_lanes(
                q, ck, None, cv, None, bk, bv, starts, max(starts_h), mask, 128 ** -0.5).cpu()
            (kq, ks), (vq, vs) = quantize_rows(ck), quantize_rows(cv)
            res[f"verify_int8_lanes_{dtype}_{L}"] = verify_fused.fused_ctx_block_attention_lanes(
                q, kq, ks, vq, vs, bk, bv, starts, max(starts_h), mask, 128 ** -0.5).cpu()
            q, k, v = randn(3, 640, 32, 128), randn(3, 640, 8, 128), randn(3, 640, 8, 128)
            res[f"prefill_lanes_{dtype}_3_640"] = prefill_flash.flash_prefill_attention(q, k, v, 128 ** -0.5).cpu()
    return res


def main() -> int:
    if sys.argv[1] == "save":
        if not torch.cuda.is_available():
            print("torch_kernel_outputs: no CUDA device", file=sys.stderr)
            return 1
        sys.path.insert(0, ".")
        torch.save(outputs(), sys.argv[2])
        return 0
    a, b = torch.load(sys.argv[2]), torch.load(sys.argv[3])
    may_differ = tuple(sys.argv[4:])
    missing = sorted(set(a) - set(b))  # an entry of A that B lost fails the check
    same = {k: torch.equal(a[k], b[k]) for k in a if k in b}
    held = {k: v for k, v in same.items() if not (may_differ and k.startswith(may_differ))}
    ok = all(held.values()) and not missing
    print({"bitwise_equal": same, "may_differ": list(may_differ), "only_in_a": missing,
           "only_in_b": sorted(set(b) - set(a)), "held_equal": ok})
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
