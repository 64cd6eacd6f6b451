"""RMSNorm (Qwen3/Llama style): variance in float32, result cast back to the
input dtype.  Port of ``dflash_tpu/ops/norms.py``."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(dtype)
