"""Two-part verify attention: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``dflash_tpu/kernels/verify_fused.py::_fused_lanes``
(``pl.pallas_call`` at :219; public entry ``fused_ctx_block_attention``).  It
computes, for queries ``q [C, B, nh, d]``, the softmax over [shared ctx rows
< ctx_len | the candidate's own block rows allowed by ``blk_mask``], as
``ops/attention.py::gqa_attention_quant_ctx_plus_block`` does.  It runs 36
times per verify (B = 16), once per draft forward (the draft's non-causal
attention: ctx rows < start plus an all-true block mask) and 36 times per AR
step (B = 1).

What bounds it on the H100: bytes.  Per call it must read the valid ctx K/V
rows (2 * ctx_len * n_kv * d elements) and does ~4 * R * nh * ctx_len * d
flops on them, about R * g = 64 flops a byte at B = 16 in bf16: far below the
card's ~295 flop/byte balance point.  At the main path's sizes (ctx ~700)
those bytes are ~3 MB, under a microsecond at full rate, so what a call costs
is latency: how many SMs share the read, and how long each waits on its
loads.  What the bf16 design does about it (``csrc/attn_mma.cuh``, the design
of ``attention.py``'s kernel with a second part): the g query heads of a kv
head are served together (packed into the M dimension of ``mma.sync``
tiles), so each K/V tile is read once for all g heads; the ctx keys below
``ctx_len`` are split over blocks (:func:`split_tiles`, about one wave of 132
blocks with the block part's own split), each split staging its 64-key tiles
with ``cp.async`` two deep; the R block keys are one more split, masked by
the routing mask; and a second launch merges the splits in a fixed order, so
the bits do not change from run to run.  A bf16 call is 2 device launches,
or 1 when ``ctx_len == 0`` (the block split alone).  Ctx rows at or past the
frontier are never loaded (the Pallas kernel's frontier-clamped index map),
and the scores never leave the block.

The int8 ctx branch (the int8 KV cache of ``kv_quant``): ctx K/V int8
[1, T, n_kv, d] with f32 scales [1, T, n_kv] per row and kv head, the block
K/V in q's dtype.  In bf16 the int8 rows are staged with ``cp.async`` (16
values per 16 bytes) and widened exactly to bf16 in shared memory; the key
scale multiplies the score, ``s * (ks * scale)``, and the value scale the
probability after ``l`` has summed it unscaled, before p is rounded to bf16
for the value product, as the Pallas kernel orders it.  Its bound is half
the bf16 ctx bytes plus the scales.  It runs 36 times per verify and per AR
step of a ``kv_quant`` engine; the draft's context cache stays in the
activation dtype, so the draft keeps the bf16/f32 branch.  Launches are
counted per branch, one per call whatever the device launches.

f32 (either ctx) keeps the FMA walk of ``csrc/attn_tile.cuh``, one launch:
tensor cores would mean TF32, and the exact f32 spec == AR run needs a row's
result not to depend on B, which that walk gives.  The kernel takes any
cache length T (the TPU's ``T % 128`` gate does not apply) and head_dim 64
or 128.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dflash_tpu_torch.kernels import _build
from dflash_tpu_torch.kernels.attention import KEY_TILE, SM_COUNT
from dflash_tpu_torch.ops.attention import gqa_attention_quant_ctx_plus_block

_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + _TAIL
_ARGTYPES_INT8 = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10 + _TAIL


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_tiles(R: int, nh: int, n_kv: int, ctx_len: int) -> int:
    """64-key ctx tiles per split of the bf16 kernel: the fewest that keep
    the ctx splits (x n_kv x row groups of 64 packed rows) within the blocks
    of one wave of SM_COUNT that the block part's split leaves."""
    units = n_kv * _cdiv(nh // n_kv * R, 64)
    return max(1, _cdiv(_cdiv(ctx_len, KEY_TILE) * units, max(1, SM_COUNT - units)))


def n_splits(R: int, nh: int, n_kv: int, ctx_len: int) -> int:
    """Splits of a bf16 call: the ctx splits, plus one for the block keys."""
    return _cdiv(_cdiv(ctx_len, KEY_TILE), split_tiles(R, nh, n_kv, ctx_len)) + 1


def workspace_floats(R: int, nh: int, n_kv: int, ctx_len: int, d: int) -> int:
    """f32 partials (acc, m, l per split and packed row) of a bf16 call; 0
    when the block split is the only one (ctx_len == 0)."""
    n = n_splits(R, nh, n_kv, ctx_len)
    return 0 if n == 1 else n * nh * R * (d + 2)


def plain(
    q: torch.Tensor, ctx_k: torch.Tensor, ctx_v: torch.Tensor, blk_k: torch.Tensor,
    blk_v: torch.Tensor, ctx_len: int, blk_mask: torch.Tensor, scale: float,
    ctx_ks: Optional[torch.Tensor] = None, ctx_vs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version: ``gqa_attention_quant_ctx_plus_block`` with
    the ctx mask built from the frontier (int8 ctx when the scales are given).
    Candidates are isolated by its per-candidate block einsum."""
    T = ctx_k.shape[1]
    ctx_mask = torch.arange(T, device=q.device) < ctx_len
    return gqa_attention_quant_ctx_plus_block(
        q, ctx_k, ctx_ks, ctx_v, ctx_vs, blk_k, blk_v, ctx_mask, blk_mask, scale
    )


def routing_mask(blk_mask: torch.Tensor, C: int) -> torch.Tensor:
    """[C*B, C*B] bool: row (c, i) may attend key (c', j) iff c == c' and
    blk_mask[i, j] (candidate isolation for C > 1)."""
    if C == 1:
        return blk_mask.to(torch.bool)
    iso = torch.eye(C, dtype=torch.bool, device=blk_mask.device)
    B = blk_mask.shape[0]
    return (iso[:, None, :, None] & blk_mask.to(torch.bool)[None, :, None, :]).reshape(C * B, C * B)


def _check_int8_ctx(ctx_kq, ctx_ks, ctx_vq, ctx_vs, device) -> list[int]:
    """Pointers of the int8 ctx and its scales, after the kernel's checks."""
    T, n_kv = ctx_kq.shape[1], ctx_kq.shape[2]
    for t, dtype, shape in ((ctx_kq, torch.int8, ctx_kq.shape), (ctx_vq, torch.int8, ctx_kq.shape),
                            (ctx_ks, torch.float32, (1, T, n_kv)), (ctx_vs, torch.float32, (1, T, n_kv))):
        if t.dtype != dtype or t.shape != shape or t.device != device:
            raise ValueError(f"int8 ctx: expected {dtype} {tuple(shape)} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("int8 ctx: inputs must be contiguous and 16-byte aligned")
    return [ctx_kq.data_ptr(), ctx_ks.data_ptr(), ctx_vq.data_ptr(), ctx_vs.data_ptr()]


def fused_ctx_block_attention(
    q: torch.Tensor,  # [C, B, nh, d]
    ctx_kq: torch.Tensor,  # [1, T, n_kv, d] cache layer: q's dtype, or int8 with scales
    ctx_ks: Optional[torch.Tensor],  # [1, T, n_kv] f32 key scales; None = unquantized ctx
    ctx_vq: torch.Tensor,
    ctx_vs: Optional[torch.Tensor],
    blk_k: torch.Tensor,  # [C, B, n_kv, d]
    blk_v: torch.Tensor,
    ctx_len: int,  # ctx rows < ctx_len are valid
    blk_mask: torch.Tensor,  # [B, B] bool
    scale: float,
) -> torch.Tensor:
    """Returns [C, B, nh * d] in q's dtype.  CPU tensors take :func:`plain`;
    CUDA tensors launch the kernel (bf16: with a workspace from
    ``torch.empty`` when the keys are split) or raise."""
    quant = ctx_ks is not None
    if quant != (ctx_vs is not None):
        raise ValueError("int8 ctx needs both key and value scales")
    if q.device.type == "cpu":
        return plain(q, ctx_kq, ctx_vq, blk_k, blk_v, ctx_len, blk_mask, scale, ctx_ks, ctx_vs)
    if q.device.type != "cuda":
        raise ValueError(f"fused_ctx_block_attention: no kernel for device {q.device}")
    C, B, nh, d = q.shape
    T, n_kv = ctx_kq.shape[1], ctx_kq.shape[2]
    R = C * B
    if ctx_kq.shape != (1, T, n_kv, d) or ctx_vq.shape != ctx_kq.shape:
        raise ValueError(f"ctx K/V must be [1, T, n_kv, {d}], got {tuple(ctx_kq.shape)}")
    if blk_k.shape != (C, B, n_kv, d) or blk_v.shape != blk_k.shape:
        raise ValueError(f"block K/V must be [{C}, {B}, {n_kv}, {d}], got {tuple(blk_k.shape)}")
    if d not in (64, 128) or nh % n_kv:
        raise ValueError(f"kernel takes head_dim 64/128 and nh % n_kv == 0, got d={d} nh={nh} n_kv={n_kv}")
    if not 0 <= ctx_len <= T:
        raise ValueError(f"ctx_len {ctx_len} outside [0, {T}]")
    mask = routing_mask(blk_mask, C).to(q.device).contiguous()
    out = torch.empty((C, B, nh * d), dtype=q.dtype, device=q.device)
    tiles, n_ws = 0, 0
    if q.dtype == torch.bfloat16:
        tiles, n_ws = split_tiles(R, nh, n_kv, ctx_len), workspace_floats(R, nh, n_kv, ctx_len, d)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    tail = (None if ws is None else ws.data_ptr(), R, nh, n_kv, int(ctx_len), tiles, float(scale))
    if quant:
        q_ptr, bk_ptr, bv_ptr, out_ptr = _build.checked_ptrs(
            "fused_ctx_block_attention", q, blk_k, blk_v, out)
        ctx_ptrs = _check_int8_ctx(ctx_kq, ctx_ks, ctx_vq, ctx_vs, q.device)
        fn = _build.function("verify_fused", "dflash_verify_fused_int8", _ARGTYPES_INT8)
        args = (q_ptr, *ctx_ptrs, bk_ptr, bv_ptr, mask.data_ptr(), out_ptr, *tail)
    else:
        ptrs = _build.checked_ptrs("fused_ctx_block_attention", q, ctx_kq, ctx_vq, blk_k, blk_v, out)
        fn = _build.function("verify_fused", "dflash_verify_fused", _ARGTYPES)
        args = (*ptrs[:5], mask.data_ptr(), ptrs[5], *tail)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_build.DTYPE_CODES[q.dtype], d, *args, stream)
    if rc != 0:
        raise RuntimeError(f"verify_fused kernel launch failed: CUDA error {rc}")
    if quant:
        fused_ctx_block_attention.launches_int8 += 1
    else:
        fused_ctx_block_attention.launches += 1
    return out


# Kernel launches since the caller last set these to 0: the bf16/f32 ctx
# branch and the int8 ctx branch.
fused_ctx_block_attention.launches = 0
fused_ctx_block_attention.launches_int8 = 0
