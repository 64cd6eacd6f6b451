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
(torch has no ``uint32`` comparison on the CPU); they become uint32 bit
patterns only at the kernel boundary.

What bounds it on the H100, and the design (two passes, partials per block
of 1024 logits merged in a fixed order, no atomics): see the note at the top
of ``csrc/filter_stats.cu``.  The JAX package folds vmapped batch axes into
kernel rows (``_stats_call_vmap``); here leading axes are flattened into rows
the same way, and the thresholds broadcast over them.
"""

from __future__ import annotations

import ctypes

import torch

from dflash_tpu_torch.kernels import _build

THR_CAP = 64
CHUNK = 1024  # logits per block of the first pass (kChunk in csrc/filter_stats.cu)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    thr32 = bits_as_int32(thr_bits).contiguous()
    nb = -(-V // CHUNK)
    dev = x.device
    workspace = torch.empty(N * nb * (3 + 3 * T), dtype=torch.float32, device=dev)
    c_ge = torch.empty((N, T), dtype=torch.int32, device=dev)
    c_gt = torch.empty((N, T), dtype=torch.int32, device=dev)
    mass_gt = torch.empty((N, T), dtype=torch.float32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    row_min = torch.empty((N,), dtype=torch.float32, device=dev)
    fn = _build.function("filter_stats", "dflash_filter_stats", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), thr32.data_ptr(), workspace.data_ptr(), c_ge.data_ptr(),
                c_gt.data_ptr(), mass_gt.data_ptr(), lse.data_ptr(), row_min.data_ptr(), N, V, T,
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
