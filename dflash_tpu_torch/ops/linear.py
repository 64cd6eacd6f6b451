"""Dense projection ``x @ w`` with float32 accumulation.  Port of the dense
branch of ``dflash_tpu/ops/linear.py``; the int8 ``QTensor`` branch is not
ported yet.

The JAX function returns an f32 product unrounded when asked for
``out_dtype=float32`` (the MLP's gate/up, the lm_head logits).  A bf16
``torch.matmul`` would round its output to bf16 first, which moves logits near
argmax ties.  So on the card a bf16 product goes through ``torch.mm`` with
``out_dtype=torch.float32`` (cuBLAS, f32 accumulator and f32 output) and is
cast to ``out_dtype`` afterwards: one rounding, as in JAX.  An f32 product is
a plain f32 matmul.  This is a large matrix product outside any kernel of the
repo, so the library does it, as XLA did for the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def linear(x: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` for x [..., K], w [K, N]; returns ``out_dtype`` (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w).to(out_dtype)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if x2d.is_cuda:
        out = torch.mm(x2d, w, out_dtype=torch.float32)
    else:
        out = torch.mm(x2d.float(), w.float())
    return out.reshape(*lead, w.shape[-1]).to(out_dtype)
