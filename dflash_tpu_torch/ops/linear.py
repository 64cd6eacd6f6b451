"""Linear projection with optional int8 weight-only quantization.  Port of
``dflash_tpu/ops/linear.py``: the dense branch and the ``QTensor`` branch.

Dense weights: the JAX function returns an f32 product unrounded when asked
for ``out_dtype=float32`` (the MLP's gate/up, the lm_head logits).  A bf16
``torch.matmul`` would round its output to bf16 first, which moves logits near
argmax ties.  So on the card a bf16 product goes through ``torch.mm`` with
``out_dtype=torch.float32`` (cuBLAS, f32 accumulator and f32 output) and is
cast to ``out_dtype`` afterwards: one rounding, as in JAX.  An f32 product is
a plain f32 matmul.  This is a large matrix product outside any kernel of the
repo, so the library does it, as XLA did for the JAX package.

``QTensor`` weights (int8, one f32 scale per output channel) go through
``kernels/matmul_q.py::matmul_int8``: on the card the hand-written kernel, on
the CPU its plain version.  It computes the JAX default (XLA) branch,
``einsum(x, q.astype(x.dtype), f32 accumulate) * scale``.  The JAX W8A8
branch (int8 activations, behind ``DFLASH_W8A8``, off by default) is not
ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from dflash_tpu_torch.kernels.matmul_q import matmul_int8


class QTensor:
    """Weight-only quantized matrix: ``w ~= q.float() * scale``.

    ``q`` is [K, N_pad] int8 (columns padded to ``pad_to``), ``scale``
    [1, N_pad] float32 per output channel (1.0 on padding columns), ``n`` the
    logical output width.  A layer stack holds ``q`` [L, K, N_pad] and
    ``scale`` [L, 1, N_pad]; indexing it by layer gives that layer's QTensor.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, n: int):
        self.q = q
        self.scale = scale
        self.n = int(n)

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.q[idx], self.scale[idx], self.n)

    def __repr__(self):
        return f"QTensor(q={tuple(self.q.shape)}, n={self.n})"


Weight = Union[torch.Tensor, QTensor]


def quantize_weight(w: torch.Tensor, pad_to: int = 1) -> QTensor:
    """Per-output-channel symmetric int8 quantization of ``w`` [K, N], bit for
    bit as the JAX function: ``scale = max(absmax, 1e-8) / 127`` (a division),
    round half to even, clip to +-127; padding columns get scale 1.0."""
    K, N = w.shape
    wf = w.float()
    absmax = wf.abs().amax(dim=0, keepdim=True)  # [1, N]
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    # contiguous: a transposed view (a tied embedding's lm_head) must not
    # hand its strides on to q
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8).contiguous()
    if pad_to > 1 and N % pad_to:
        pad = pad_to - N % pad_to
        q = torch.nn.functional.pad(q, (0, pad))
        scale = torch.nn.functional.pad(scale, (0, pad), value=1.0)
    return QTensor(q, scale, N)


def dequantize(w: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.scale).to(dtype)[..., : w.n]


def linear(x: torch.Tensor, w: Weight, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` for x [..., K], w [K, N] or a QTensor; returns ``out_dtype``
    (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if isinstance(w, QTensor):
        out = matmul_int8(x2d, w.q, w.scale, w.n, out_dtype=out_dtype)
        return out.reshape(*lead, w.n)
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w).to(out_dtype)
    if x2d.is_cuda:
        out = torch.mm(x2d, w, out_dtype=torch.float32)
    else:
        out = torch.mm(x2d.float(), w.float())
    return out.reshape(*lead, w.shape[-1]).to(out_dtype)
