"""int8 weight-only matmul: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``dflash_tpu/kernels/matmul_q.py::matmul_int8``
(``pl.pallas_call`` at :56).  It computes ``x @ (w_q * scale)`` as f32:
x [S, K] (bf16 or f32), w_q [K, N_pad] int8, scale [1, N_pad] f32 per output
channel, applied once on the f32 accumulator; out [S, n] (the logical width,
padding columns are never written), cast to ``out_dtype`` with one rounding.
That is the JAX package's default (XLA) branch of ``ops/linear.py``,
``einsum(x, q.astype(x.dtype), f32 accumulate) * scale``, which the JAX engine
runs on every backend and the CPU tests compare against.  With bf16 x it is
also exactly what the Pallas kernel computes (a bf16 x int8 product is exact
in f32).  With f32 x it keeps f32 activations, where the Pallas kernel would
round x to bf16 first.

Every projection of the int8 target and draft goes through it: 7 per layer
(wq, wk, wv, wo, gate, up, down), the lm_head and the draft's ``fc``, at
S = 1 (AR step), 15-16 (verify, draft) and the padded prompt (prefill).

What bounds it on the H100: bytes, up to the prompt.  At S = 16 a call reads
K * N_pad weight bytes and does 2 * S * K * N flops, 32 flops a byte, far
below the card's ~295 flop/byte (bf16 tensor-core) balance point; S = 1 is a
GEMV; only the S = 640 prefill is bound by operations.  What the design does:
each weight byte crosses device memory once per call (the row tiles of one
column tile are neighbouring blocks and share it through L2), int8 stays int8
in flight (half the bf16 bytes) and becomes exact floats or bf16 in
registers, and the x rows are staged once per block in shared memory.  Enough
blocks to fill the 132 SMs come from splitting K over blocks when the weight
is narrow (wk/wv have N = 1024), with a second, fixed-order pass that sums the
partial products: no atomics, so results are deterministic.  The split is a
function of (K, N_pad) only.

Three variants, chosen by S and x's dtype (csrc/matmul_q.cu):
  * S = 1, either dtype: f32 FMAs, one row per block (the AR step's GEMV).
  * f32 x, S > 1: the same FMA loop over 4- or 16-row tiles.  Every output
    element's sum runs in one order for every S and every place of the row
    in its tile, so the f32 AR step (S = 1) and verify (S = 16) give bit-
    identical projections: the exact spec == AR run sees no near-tie flips
    from them.
  * bf16 x, S > 1: tensor cores (``mma.sync`` m16n8k16, bf16 in, f32
    accumulate), 16-row tiles up to S = 32 (verify, draft) and 64-row tiles
    beyond (prefill), so each weight fragment feeds 4 row tiles.  Rows are
    bit-identical within the 16-row variant; the tensor cores sum each k16
    slice in their own order, so bf16 rows agree with the S = 1 GEMV to
    rounding only.
Not done yet: ``wgmma``, TMA/``cp.async`` staging, and an int8 weight layout
that suits the fragments (at S = 640 a layer's products run several times
slower than bf16 cuBLAS products of the same shapes; PERF.md).
"""

from __future__ import annotations

import ctypes

import torch

from dflash_tpu_torch.kernels import _build

_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
COLS_PER_BLOCK = 128  # output columns of one thread block (csrc/matmul_q.cu kCols)


def plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, n: int,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version: ``(x.float() @ q.float()) * scale``, sliced
    to the logical width ``n`` and cast once."""
    return ((x.float() @ q.float()) * scale)[:, :n].to(out_dtype)


def k_split(K: int, N_pad: int) -> int:
    """Blocks that share one column tile's K range (a power of two): enough
    to put ~2 blocks on each of the 132 SMs, each block keeping at least 128
    rows of K.  A function of the weight's shape only, never of S."""
    col_blocks = -(-N_pad // COLS_PER_BLOCK)
    ks = 1
    while col_blocks * ks < 264 and K % (32 * ks) == 0 and K // (2 * ks) >= 128:
        ks *= 2
    return ks


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, n: int, out_dtype) -> None:
    S, K = x.shape
    if x.dtype not in _build.DTYPE_CODES or out_dtype not in _OUT_CODES:
        raise ValueError(f"matmul_int8: x {x.dtype} -> {out_dtype} not supported (float32, bfloat16)")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"matmul_int8: weight must be int8 with float32 scales, got {q.dtype}/{scale.dtype}")
    if q.dim() != 2 or q.shape[0] != K or scale.shape != (1, q.shape[1]):
        raise ValueError(f"matmul_int8: shapes x {tuple(x.shape)}, q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    if S < 1 or K % 16 or q.shape[1] % 4 or not 0 < n <= q.shape[1]:
        raise ValueError(f"matmul_int8: needs S >= 1, K % 16 == 0, N_pad % 4 == 0, 0 < n <= N_pad; "
                         f"got S={S} K={K} N_pad={q.shape[1]} n={n}")
    for t in (x, q, scale):
        if t.device != x.device:
            raise ValueError("matmul_int8: inputs must share one device")
        if not t.is_contiguous():
            raise ValueError("matmul_int8: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("matmul_int8: inputs must be 16-byte aligned")


def matmul_int8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, n: int,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [S, K] @ dequantized q [K, N_pad] -> [S, n] in ``out_dtype``.  CPU
    tensors take :func:`plain`; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return plain(x, q, scale, n, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int8: no kernel for device {x.device}")
    _check(x, q, scale, n, out_dtype)
    S, K = x.shape
    N_pad = q.shape[1]
    ks = k_split(K, N_pad)
    out = torch.empty((S, n), dtype=out_dtype, device=x.device)
    partial = torch.empty((ks, S, N_pad), dtype=torch.float32, device=x.device) if ks > 1 else None
    fn = _build.function("matmul_q", "dflash_matmul_int8", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _build.DTYPE_CODES[x.dtype], _OUT_CODES[out_dtype], x.data_ptr(), q.data_ptr(),
            scale.data_ptr(), out.data_ptr(), partial.data_ptr() if partial is not None else None,
            S, K, N_pad, n, ks, stream,
        )
    if rc != 0:
        raise RuntimeError(f"matmul_int8 kernel launch failed: CUDA error {rc}")
    matmul_int8.launches += 1
    return out


# Kernel launches since the caller last set this to 0.
matmul_int8.launches = 0
