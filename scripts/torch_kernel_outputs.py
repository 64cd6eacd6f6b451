#!/usr/bin/env python
"""Save the attention kernels' outputs at fixed inputs, or compare two saves
bit for bit: shows that a change to a kernel source left a branch's numbers
exactly as they were.  Needs an NVIDIA GPU.

    python scripts/torch_kernel_outputs.py save OUT.pt     # from a checkout's root
    python scripts/torch_kernel_outputs.py compare A.pt B.pt

Covers the bf16/f32 branch of verify_fused and prefill_flash at the main
path's head shapes (nh 32, n_kv 8, d 128).
"""

from __future__ import annotations

import sys

import torch


def outputs() -> dict:
    from dflash_tpu_torch.kernels import prefill_flash, verify_fused

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
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    same = {k: torch.equal(a[k], b[k]) for k in a}
    print({"bitwise_equal": same, "all": all(same.values())})
    return 0 if all(same.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
