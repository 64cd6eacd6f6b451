#!/usr/bin/env python
"""Save the attention kernels' outputs at fixed inputs, or compare two saves
bit for bit: shows that a change to a kernel source left a branch's numbers
exactly as they were.  Needs an NVIDIA GPU.

    python scripts/torch_kernel_outputs.py save OUT.pt     # from a checkout's root
    python scripts/torch_kernel_outputs.py compare A.pt B.pt [PREFIX ...]

``save`` imports the kernels of the checkout it runs from, so one copy of
this script saves both sides.  ``compare`` reports every entry and fails
unless all are bitwise equal, leaving out the entries whose names start with
a PREFIX given (the branches the change meant to move).

Covers, at the main path's head shapes (nh 32, n_kv 8, d 128), bf16 and f32:
verify_fused (float ctx and int8 ctx), prefill_flash and verify_attention.
"""

from __future__ import annotations

import sys

import torch


def outputs() -> dict:
    from dflash_tpu_torch.cache.kv import quantize_rows
    from dflash_tpu_torch.kernels import attention, prefill_flash, verify_fused

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
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    same = {k: torch.equal(a[k], b[k]) for k in a}
    held = {k: v for k, v in same.items() if not (may_differ and k.startswith(may_differ))}
    print({"bitwise_equal": same, "may_differ": list(may_differ), "held_equal": all(held.values())})
    return 0 if all(held.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
