"""Causal prefill attention: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``dflash_tpu/kernels/prefill_flash.py::_flash_lanes``
(``pl.pallas_call`` at :111; public entry ``flash_prefill_attention``): tiled
causal GQA flash attention over ``q [L, S, nh, d]``, ``k, v [L, S, n_kv, d]``,
query row i attending key rows j <= i, as ``gqa_attention`` with the causal
mask computes it.  It runs 36 times per target prefill.

What bounds it on the H100: operations, for a long prompt.  A call does
~2 * nh * S^2 * d flops (half of the square, two products) and must move q,
k, v and the output once: in bf16 that is ~800 flops a byte at S = 2048,
above the card's ~295 flop/byte balance point, and ~260 at S = 640.  So the
products must run on the tensor cores.  What the bf16 design does about it
(``csrc/attn_mma.cuh``, FlashAttention-2 shaped): QK^T and PV run as
``mma.sync`` m16n8k16 bf16 tiles fed by ``ldmatrix``; a block of 4 warps
serves all g query heads of a kv head (64 packed rows: 64 / g positions x g
heads), so each 64-key K/V tile is staged once for the g heads, as bf16, by
``cp.async`` two tiles deep; the online softmax stays on the accumulator
fragments and P goes to the value product in registers.  Key tiles above the
diagonal are neither loaded nor computed and only the diagonal tile is
masked; the [S, S] scores never leave the block.  One launch per call.  f32
keeps the FMA walk of ``csrc/attn_tile.cuh`` (one query head a block):
tensor cores would mean TF32, too coarse for the f32 tolerance and the exact
f32 spec == AR run.

Lanes (the Pallas ``_flash_lanes`` grid axis and its ``custom_vmap`` rule):
q [L, S, nh, d] and k/v [L, S, n_kv, d] run L prompts of one bucket S in one
call, the lane a grid axis of both kernels; a lane's rows are computed as an
L = 1 call on them computes them, bit for bit (the bf16 kernel has no split).
The batched prefill is 36 calls whatever L.

The kernel takes any S (the ragged last tile is masked) and head_dim 64 or
128; the TPU's ``S % 128`` / ``d % 128`` gate and its measured S >= 512
auto-engage do not apply on the card, where every prefill goes through it.
"""

from __future__ import annotations

import ctypes

import torch

from dflash_tpu_torch.kernels import _build
from dflash_tpu_torch.ops.attention import gqa_attention

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_void_p,
]


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain PyTorch version: ``gqa_attention`` with the positional causal
    mask (row i attends keys j <= i of its own lane)."""
    S = q.shape[1]
    idx = torch.arange(S, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    return gqa_attention(q, k, v, causal, scale)


def flash_prefill_attention(
    q: torch.Tensor,  # [L, S, nh, d]: L lanes (requests) of one prompt bucket
    k: torch.Tensor,  # [L, S, n_kv, d]
    v: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Causal prefill attention; returns [L, S, nh * d] in q's dtype.  CPU
    tensors take :func:`plain`; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_attention: no kernel for device {q.device}")
    L, S, nh, d = q.shape
    n_kv = k.shape[2]
    if k.shape != (L, S, n_kv, d) or v.shape != k.shape or not 1 <= L <= 65535:
        raise ValueError(
            f"kernel takes q [L, S, nh, d], k/v [L, S, n_kv, d]; got {tuple(q.shape)}, {tuple(k.shape)}"
        )
    if d not in (64, 128) or nh % n_kv:
        raise ValueError(f"kernel takes head_dim 64/128 and nh % n_kv == 0, got d={d} nh={nh} n_kv={n_kv}")
    if q.dtype == torch.bfloat16 and nh // n_kv > 64:
        raise ValueError(f"the bf16 kernel packs the g query heads of a kv head into 64 rows, got g={nh // n_kv}")
    out = torch.empty((L, S, nh * d), dtype=q.dtype, device=q.device)
    ptrs = _build.checked_ptrs("flash_prefill_attention", q, k, v, out)
    fn = _build.function("prefill_flash", "dflash_prefill_flash", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_build.DTYPE_CODES[q.dtype], d, *ptrs, L, S, nh, n_kv, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"prefill_flash kernel launch failed: CUDA error {rc}")
    flash_prefill_attention.launches += 1
    return out


# Kernel launches since the caller last set this to 0.
flash_prefill_attention.launches = 0
