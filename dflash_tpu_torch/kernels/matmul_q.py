"""int8 weight-only matmul: hand-written CUDA kernels and their plain version.

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

What bounds it on the H100: bytes up to S = 32, operations at the prompt.  At
S = 16 a call reads K * N_pad weight bytes and does 2 * S * K * N flops, 32
flops a byte, far below the card's ~295 flop/byte (bf16 tensor-core) balance
point; S = 1 is a GEMV; the S = 640 prefill is bound by operations.  Each
weight byte crosses device memory once per call and stays int8 in flight
(half the bf16 bytes) until the registers, where it becomes an exact bf16 or
f32 value.  :func:`plan` picks one of four variants (csrc/matmul_q.cu) from
(x dtype, S, K, N_pad):

  * ``fma`` (f32 x, every S): f32 FMAs over 1-, 4- or 16-row tiles, K split
    over blocks by :func:`k_split` with a fixed-order second pass.  Every
    output element's sum runs in one order for every S and every place of
    the row in its tile, so the f32 AR step (S = 1) and verify (S = 16) give
    bit-identical projections: the exact spec == AR run sees no near-tie
    flips from them.
  * ``stream`` (bf16 x, S <= 32: AR step, verify, draft): bound by bytes.
    int8 weight tiles stream through a 4-stage ring of 16-byte ``cp.async``
    copies; x's rows ride along in each stage (S = 1 is a zero-padded m16
    tile); ``mma.sync`` m16n8k16 on the widened weight.  The narrow weights
    (wk/wv, N = 1024) split K by :func:`k_split` and merge in the same launch:
    the last block of a column tile to finish (an integer counter) sums the
    partials in increasing z.  Rows are bit-identical for every S in 1..32.
  * ``wgmma`` (bf16 x, S > 32: the prompt): bound by operations.  A TMA ring
    (one producer warp, ``mbarrier``s) brings x as bf16 and the weight as int8
    into 128-byte-swizzled stages; two consumer warpgroups run
    ``wgmma.mma_async``.  ``wgmma`` has no bf16 x int8 form, so the operands
    are swapped, out^T = W^T x^T: the weight is widened in registers into the
    register A operand and x is the shared-memory B operand as TMA wrote it.
    That was chosen over a widening pass into a bf16 B tile because it needs
    no second copy of the weight in shared memory, no extra barrier between
    the pass and the product, and x [S, K] is already the K-major B layout.
    No K split: each output is summed in one block, in one order, in one
    launch.  Long tensor-core sums are promoted into f32 registers every
    256 k (a long wgmma chain loses more than f32 rounding would).
    :func:`wgmma_tile` picks 160, 128 or 64 rows of x a block to fill the
    132 SMs.
  * ``ragged`` (bf16 x, N_pad % 16 != 0, which TMA and 16-byte copies cannot
    address; the quantizer pads every model weight to 512): ``mma.sync``
    tiles that read the weight by 4-byte loads, no K split.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from dflash_tpu_torch.kernels import _build

_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
COLS_PER_BLOCK = 128  # output columns of one block of the fma and stream variants (csrc kCols)
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
SKINNY_ROWS = 32  # bf16 x up to this many rows streams the weight; longer x is a prompt
FMA, RAGGED, STREAM, WGMMA = "fma", "ragged", "stream", "wgmma"
_VARIANT_CODES = {FMA: 0, RAGGED: 1, STREAM: 2, WGMMA: 3}


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which kernel runs: ``variant``, its block tile (``rows`` of x by
    ``cols`` output columns) and ``split``, the blocks that share one column
    tile's K range."""

    variant: str
    rows: int
    cols: int
    split: int


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


def wgmma_tile(S: int, N_pad: int) -> tuple[int, int]:
    """The wgmma tile (rows of x, weight columns) for x [S, K] and N_pad
    weight columns: always 128 columns (2 consumer warpgroups of one m64
    tile each), and 160, 128 or 64 rows.  64 rows when S
    <= 64 or when 128-row tiles would leave more than half the 132 SMs idle;
    else 160 or 128 rows, whichever leaves the busiest SM the fewest rows of
    work (waves of blocks, ceil(blocks / 132), times the rows of one), 128 on
    a tie.  At S = 640, 160 rows make one wave of 128 blocks for a 4096-wide
    weight, where 128 rows would make 160 blocks and a second, mostly idle,
    wave."""
    col_tiles = -(-N_pad // 128)
    if S <= 64 or -(-S // 128) * col_tiles < SM_COUNT // 2:
        return 64, 128
    return min((128, 160), key=lambda r: -(-(-(-S // r) * col_tiles) // SM_COUNT) * r), 128


def plan(dtype: torch.dtype, S: int, K: int, N_pad: int) -> Plan:
    """The variant, tile and K split of ``matmul_int8`` for x [S, K] of
    ``dtype`` and an int8 weight [K, N_pad]: a function of these alone."""
    if dtype == torch.float32:
        return Plan(FMA, 1 if S == 1 else 4 if S <= 4 else 16, COLS_PER_BLOCK, k_split(K, N_pad))
    if N_pad % 16:
        return Plan(RAGGED, 16 if S <= SKINNY_ROWS else 64, COLS_PER_BLOCK, 1)
    if S <= SKINNY_ROWS:
        return Plan(STREAM, 16 if S <= 16 else 32, COLS_PER_BLOCK, k_split(K, N_pad))
    return Plan(WGMMA, *wgmma_tile(S, N_pad), 1)


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
    p = plan(x.dtype, S, K, N_pad)
    out = torch.empty((S, n), dtype=out_dtype, device=x.device)
    partial = torch.empty((p.split, S, N_pad), dtype=torch.float32, device=x.device) if p.split > 1 else None
    counters = (_build.merge_counters(x.device, -(-N_pad // p.cols))
                if p.variant == STREAM and p.split > 1 else None)
    fn = _build.function("matmul_q", "dflash_matmul_int8", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _VARIANT_CODES[p.variant], _build.DTYPE_CODES[x.dtype], _OUT_CODES[out_dtype], x.data_ptr(),
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), partial.data_ptr() if partial is not None else None,
            counters.data_ptr() if counters is not None else None,
            S, K, N_pad, n, p.rows, p.cols, p.split, stream,
        )
    if rc != 0:
        raise RuntimeError(f"matmul_int8 kernel launch failed: CUDA error {rc}")
    matmul_int8.launches += 1
    return out


# Kernel launches since the caller last set this to 0.
matmul_int8.launches = 0
