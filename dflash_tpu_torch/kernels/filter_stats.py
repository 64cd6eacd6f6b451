"""Filter statistics for exact top-k / top-p sampling: hand-written CUDA
kernel and its plain version.

Replaces the TPU kernel ``dflash_tpu/kernels/filter_stats.py::filter_stats_tpu``
(``pl.pallas_call`` at :117; public entry ``filter_stats``).  For each f32
logits row (already temperature-scaled) and each of its T <= 64 thresholds,
given as ordered float bits (:func:`ordered_bits`), it returns in one read of
the row: ``count_ge`` and ``count_gt`` [N, T] int32 (elements at-or-above and
strictly above the threshold), ``mass_gt`` [N, T] (softmax mass strictly
above it, normalized over the full row), ``lse`` [N] and ``row_min`` [N].
The sampler (``ops/sampling.py::exact_filter_thresholds``) calls it once per
filtered sampling call with 16 thresholds, plus once per refinement round
with 32.

Ordered bits are carried as int64 holding 0 .. 2^32 - 1 on the torch side
(torch has no ``uint32`` comparison on the CPU); the kernel reads the low
32 bits of each, the uint32 pattern that :func:`bits_as_int32` gives, so a
call is one device launch.

What bounds it on the H100 and the design (one launch: each block takes a
chunk of a row into registers, loops over the thresholds outside its
registers, and the row's last block merges the partials in a fixed order;
no float atomics): see the note at the top of ``csrc/filter_stats.cu``.
:func:`plan` sizes the chunk.  The JAX package folds vmapped batch axes into
kernel rows (``_stats_call_vmap``); here leading axes are flattened into rows
the same way, and the thresholds broadcast over them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from dflash_tpu_torch.kernels import _build

THR_CAP = 64
THREADS = 256  # threads of a block (kThreads in csrc/filter_stats.cu)
PER_THREAD = (4, 8, 16, 32)  # logits a thread holds in registers: the kernel's instances
PACK_CAP = 0xFFFF  # count_ge and count_gt of a block share an int32, 16 bits each
MAX_BLOCKS_PER_ROW = 2048  # the merge's scale table (kMaxBlocksPerRow)
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
# A block's fixed work (loads in flight, three block reductions, the partials
# and the counter), counted as this many more logits per thread.
BLOCK_OVERHEAD = 4
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class Plan:
    """``chunk`` logits of a row per block of ``threads`` threads, and the
    ``blocks_per_row`` that cover V."""

    chunk: int
    blocks_per_row: int
    threads: int


def plan(N: int, V: int) -> Plan:
    """The chunk of a block for x [N, V].  Each SM takes whole blocks, so
    the busiest one holds ceil(N * blocks_per_row / 132) of them: pick the
    logits per thread k that make its work, blocks times (k + BLOCK_OVERHEAD),
    least (the larger k on a tie), among the k that give every SM a block
    where any does.  [16, 151,936] gets 4096 logits a block (608 blocks,
    5 on the busiest SM); [1, 151,936] 1024 (149 blocks)."""
    options = []
    for k in PER_THREAD:
        chunk = THREADS * k
        bpr = -(-V // chunk)
        if bpr <= MAX_BLOCKS_PER_ROW:
            busiest = -(-N * bpr // SM_COUNT)
            options.append((N * bpr < SM_COUNT, busiest * (k + BLOCK_OVERHEAD), -k, Plan(chunk, bpr, THREADS)))
    if not options:
        raise ValueError(f"filter_stats: rows of {V} logits need more than {MAX_BLOCKS_PER_ROW} blocks")
    return min(options, key=lambda o: o[:3])[3]


def workspace_words(p: Plan, N: int, T: int) -> int:
    """4-byte words of the partials of one launch: per block of a row its
    max, sum and min, and per threshold its packed counts and mass."""
    return N * p.blocks_per_row * (3 + 2 * T)


def ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) preserving the total order of the floats
    (negative floats reverse, positives offset): JAX's ``_ordered_bits`` as
    unsigned values."""
    b = x.float().contiguous().view(torch.int32)
    u = torch.where(b < 0, ~b, b ^ torch.iinfo(torch.int32).min)
    return u.to(torch.int64) & 0xFFFFFFFF


def bits_as_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same 32-bit pattern."""
    return (u - (u >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32)


def plain(x: torch.Tensor, thr_bits: torch.Tensor) -> tuple:
    """The plain PyTorch version, JAX's ``filter_stats_xla``: x f32 [N, V],
    thr_bits int64 [N, T].  Same math, T-fold reads of the row."""
    u = ordered_bits(x)
    ge = u[:, None, :] >= thr_bits[:, :, None]  # [N, T, V]
    gt = u[:, None, :] > thr_bits[:, :, None]
    lse = torch.logsumexp(x, dim=-1)
    probs = torch.exp(x - lse[:, None])
    mass_gt = torch.where(gt, probs[:, None, :], 0.0).sum(-1)
    return (ge.sum(-1).to(torch.int32), gt.sum(-1).to(torch.int32), mass_gt, lse,
            x.amin(dim=-1))


def _launch(x: torch.Tensor, thr_bits: torch.Tensor) -> tuple:
    N, V = x.shape
    T = thr_bits.shape[1]
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("filter_stats: x must be contiguous float32")
    if thr_bits.dtype != torch.int64:
        raise ValueError(f"filter_stats: thresholds must be int64 ordered bits, got {thr_bits.dtype}")
    thr_bits = thr_bits.contiguous()
    p = plan(N, V)
    dev = x.device
    workspace = torch.empty(workspace_words(p, N, T), dtype=torch.float32, device=dev)
    counters = _build.merge_counters(dev, N)  # one per row
    c_ge = torch.empty((N, T), dtype=torch.int32, device=dev)
    c_gt = torch.empty((N, T), dtype=torch.int32, device=dev)
    mass_gt = torch.empty((N, T), dtype=torch.float32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    row_min = torch.empty((N,), dtype=torch.float32, device=dev)
    fn = _build.function("filter_stats", "dflash_filter_stats", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), thr_bits.data_ptr(), workspace.data_ptr(), counters.data_ptr(), c_ge.data_ptr(),
                c_gt.data_ptr(), mass_gt.data_ptr(), lse.data_ptr(), row_min.data_ptr(), N, V, T, p.chunk,
                stream)
    if rc != 0:
        raise RuntimeError(f"filter_stats kernel launch failed: CUDA error {rc}")
    filter_stats.launches += 1
    return c_ge, c_gt, mass_gt, lse, row_min


def filter_stats(x: torch.Tensor, thr_bits: torch.Tensor) -> tuple:
    """x f32 [..., V], thr_bits int64 [..., T] (broadcast over x's leading
    axes, T <= 64).  Returns (count_ge, count_gt, mass_gt) [..., T] and (lse,
    row_min) [...].  CPU tensors take :func:`plain`; CUDA tensors launch the
    kernel or raise."""
    V, T = x.shape[-1], thr_bits.shape[-1]
    if T > THR_CAP:
        raise ValueError(f"filter_stats takes at most {THR_CAP} thresholds, got {T}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, V)
    t2 = thr_bits.broadcast_to(lead + (T,)).reshape(-1, T)
    if x.device.type == "cpu":
        out = plain(x2, t2)
    elif x.device.type == "cuda":
        out = _launch(x2, t2)
    else:
        raise ValueError(f"filter_stats: no kernel for device {x.device}")
    c_ge, c_gt, mass_gt, lse, row_min = out
    return (c_ge.reshape(lead + (T,)), c_gt.reshape(lead + (T,)), mass_gt.reshape(lead + (T,)),
            lse.reshape(lead), row_min.reshape(lead))


# Kernel launches since the caller last set this to 0.
filter_stats.launches = 0
