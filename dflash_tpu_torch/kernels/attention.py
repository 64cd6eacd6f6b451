"""Frontier-bounded verify attention: hand-written CUDA kernel and its plain
version.

Replaces the TPU kernel ``dflash_tpu/kernels/attention.py::_call_kernel``
(``pl.pallas_call`` at :113; public entry ``verify_attention``): single-part
causal GQA attention of a block of B query rows at positions
``start .. start + B - 1`` over the KV cache, batch 1, after the block's own
K/V rows were written into the cache at ``start``.  Query row r attends key j
iff j <= start + r, and rows at or past ``start + B`` are never read, so a
call's traffic is O(start + B) rather than O(T).  It carries attention in
``qwen3.forward(attn_impl="pallas")``: 36 times per verify (B = 16) and per AR
step (B = 1) of ``SpecEngine(attn_impl="pallas")``.

What bounds it on the H100: bytes.  A call must read the 2 * (start + B) *
n_kv * d valid K/V elements and does ~4 * B * nh * (start + B) * d flops on
them, about B * g = 64 flops a byte at B = 16 in bf16, far below the card's
~295 flop/byte balance point.  At the main path's sizes (start ~700) those
bytes are ~3 MB, under a microsecond at full rate, so what a call costs is
latency: how many SMs share the read, and how long each waits on its loads.
What the bf16 design does about it (``csrc/attn_mma.cuh``): the g query
heads of a kv head are served together (packed into the M dimension of
``mma.sync`` tiles), so each K/V tile is read once for all g heads; the keys
below ``start + B`` are split over blocks (:func:`split_tiles`, about one
wave of 132 blocks), each split staging its 64-key tiles with ``cp.async``
two deep, and a second launch merges the splits in a fixed order, so the
bits do not change from run to run.  A bf16 call is 2 device launches, or 1
when there is one split.  Key tiles at or past the frontier are never loaded
(the TPU kernel's frontier-bounded DMA loop), the scores never leave the
block, and the softmax is online.

f32 keeps the FMA walk of ``csrc/attn_tile.cuh`` (the single-part case of
``verify_fused.cu``, one launch): tensor cores would mean TF32, and the exact
f32 spec == AR run needs a row's result not to depend on B, which that walk
gives.  The TPU's ``T % 128`` rule does not apply: the kernel takes any cache
length, and head_dim 64 or 128.
"""

from __future__ import annotations

import ctypes

import torch

from dflash_tpu_torch.kernels import _build
from dflash_tpu_torch.ops.attention import gqa_attention

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p,
]
KEY_TILE = 64  # keys per tile of the bf16 kernel
SM_COUNT = 132  # H100 SXM: the splits aim at about one block per SM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_tiles(B: int, nh: int, n_kv: int, start: int) -> int:
    """64-key tiles per split of the bf16 kernel: the fewest that keep the
    grid (splits x n_kv x row groups of 64 packed rows) within about one wave
    of SM_COUNT blocks."""
    units = n_kv * _cdiv(nh // n_kv * B, 64)
    return max(1, _cdiv(_cdiv(start + B, KEY_TILE) * units, SM_COUNT))


def workspace_floats(B: int, nh: int, n_kv: int, start: int, d: int) -> int:
    """f32 partials (acc, m, l per split and packed row) of a bf16 call; 0
    when the keys form one split."""
    n_splits = _cdiv(_cdiv(start + B, KEY_TILE), split_tiles(B, nh, n_kv, start))
    return 0 if n_splits == 1 else n_splits * nh * B * (d + 2)


def plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, start: int,
          block: int) -> torch.Tensor:
    """The plain PyTorch version: ``gqa_attention`` over the cache rows below
    ``start + block`` under the causal mask of positions ``start + i``.  The
    rows are sliced first, so nothing past the frontier (stale or NaN) can
    reach the output."""
    d = q.shape[-1]
    limit = start + block
    q_pos = start + torch.arange(block, device=q.device)
    mask = torch.arange(limit, device=q.device)[None, :] <= q_pos[:, None]
    return gqa_attention(q, k_cache[:, :limit], v_cache[:, :limit], mask, d ** -0.5)


def verify_attention(
    q: torch.Tensor,  # [1, B, nh, d]
    k_cache: torch.Tensor,  # [1, T, n_kv, d]; rows start .. start+B-1 hold the block's K
    v_cache: torch.Tensor,
    start: int,  # frontier: position of q's first row
    block: int,  # B
) -> torch.Tensor:
    """Returns [1, B, nh * d] in q's dtype.  CPU tensors take :func:`plain`;
    CUDA tensors launch the kernel (bf16: with a workspace from
    ``torch.empty`` when the keys are split) or raise."""
    _, B, nh, d = q.shape
    T, n_kv = k_cache.shape[1], k_cache.shape[2]
    if block != B:
        raise ValueError(f"block {block} != q rows {B}")
    if not 0 <= start <= T - B:
        raise ValueError(f"block [{start}, {start + B}) outside the cache [0, {T})")
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, start, block)
    if q.device.type != "cuda":
        raise ValueError(f"verify_attention: no kernel for device {q.device}")
    if q.shape[0] != 1 or k_cache.shape != (1, T, n_kv, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"kernel takes q [1, B, nh, d], cache [1, T, n_kv, d]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    if d not in (64, 128) or nh % n_kv:
        raise ValueError(f"kernel takes head_dim 64/128 and nh % n_kv == 0, got d={d} nh={nh} n_kv={n_kv}")
    out = torch.empty((1, B, nh * d), dtype=q.dtype, device=q.device)
    ptrs = _build.checked_ptrs("verify_attention", q, k_cache, v_cache, out)
    tiles, n_ws = 0, 0
    if q.dtype == torch.bfloat16:
        tiles, n_ws = split_tiles(B, nh, n_kv, start), workspace_floats(B, nh, n_kv, start, d)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    fn = _build.function("attention", "dflash_verify_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_build.DTYPE_CODES[q.dtype], d, *ptrs, None if ws is None else ws.data_ptr(), B, nh, n_kv,
                int(start), tiles, float(d ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(f"verify_attention kernel launch failed: CUDA error {rc}")
    verify_attention.launches += 1
    return out


# Kernel launches since the caller last set this to 0.
verify_attention.launches = 0
