"""Causal prefill attention: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``dflash_tpu/kernels/prefill_flash.py::_flash_lanes``
(``pl.pallas_call`` at :111; public entry ``flash_prefill_attention``): tiled
causal GQA flash attention over ``q [1, S, nh, d]``, ``k, v [1, S, n_kv, d]``,
query row i attending key rows j <= i, as ``gqa_attention`` with the causal
mask computes it.  It runs 36 times per target prefill.

What bounds it on the H100: operations, for a long prompt.  A call does
~2 * nh * S^2 * d flops (half of the square, two products) and must move q,
k, v and the output once: in bf16 that is ~800 flops a byte at S = 2048,
above the card's ~295 flop/byte balance point, and ~260 at S = 640.  What the design does about it: key
tiles above the diagonal are neither loaded nor computed (half the square),
the [S, S] scores never leave the block, and the softmax is online, so there
is one pass.  The products run on FMA units from shared memory, far below the
tensor cores' rate: ``mma``/``wgmma`` on bf16 tiles, a block that serves all
g query heads of a kv head, and ``cp.async``/TMA staging are later work.

The kernel takes any S (the ragged last tile is masked) and head_dim 64 or
128; the TPU's ``S % 128`` / ``d % 128`` gate and its measured S >= 512
auto-engage do not apply on the card, where every prefill goes through it.
"""

from __future__ import annotations

import ctypes

import torch

from dflash_tpu_torch.kernels import _build
from dflash_tpu_torch.ops.attention import gqa_attention

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_void_p,
]


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain PyTorch version: ``gqa_attention`` with the positional causal
    mask (row i attends keys j <= i)."""
    S = q.shape[1]
    idx = torch.arange(S, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    return gqa_attention(q, k, v, causal, scale)


def flash_prefill_attention(
    q: torch.Tensor,  # [1, S, nh, d]
    k: torch.Tensor,  # [1, S, n_kv, d]
    v: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Causal prefill attention; returns [1, S, nh * d] in q's dtype.  CPU
    tensors take :func:`plain`; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_attention: no kernel for device {q.device}")
    Bq, S, nh, d = q.shape
    n_kv = k.shape[2]
    if Bq != 1 or k.shape != (1, S, n_kv, d) or v.shape != k.shape:
        raise ValueError(
            f"kernel takes q [1, S, nh, d], k/v [1, S, n_kv, d]; got {tuple(q.shape)}, {tuple(k.shape)}"
        )
    if d not in (64, 128) or nh % n_kv:
        raise ValueError(f"kernel takes head_dim 64/128 and nh % n_kv == 0, got d={d} nh={nh} n_kv={n_kv}")
    out = torch.empty((1, S, nh * d), dtype=q.dtype, device=q.device)
    ptrs = _build.checked_ptrs("flash_prefill_attention", q, k, v, out)
    fn = _build.function("prefill_flash", "dflash_prefill_flash", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_build.DTYPE_CODES[q.dtype], d, *ptrs, S, nh, n_kv, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"prefill_flash kernel launch failed: CUDA error {rc}")
    flash_prefill_attention.launches += 1
    return out


# Kernel launches since the caller last set this to 0.
flash_prefill_attention.launches = 0
