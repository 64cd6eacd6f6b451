"""Rotary position embeddings: plain RoPE (Qwen3) plus Llama-3.1 frequency
scaling.  Port of ``dflash_tpu/ops/rope.py``; cos/sin are computed for the
exact absolute positions of the tensor being rotated."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _inv_freq(
    head_dim: int, theta: float, rope_scaling: Optional[Tuple[float, float, float, int]],
    device=None,
) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    if rope_scaling is None:
        return inv_freq
    # Llama-3.1 rope scaling (HF _compute_llama3_parameters).
    factor, low_ff, high_ff, orig_max = rope_scaling
    low_freq_wavelen = orig_max / low_ff
    high_freq_wavelen = orig_max / high_ff
    wavelen = 2.0 * math.pi / inv_freq
    scaled = inv_freq / factor
    smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
    smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
    out = torch.where(wavelen > low_freq_wavelen, scaled, inv_freq)
    is_mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return torch.where(is_mid, smoothed, out)


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    rope_scaling: Optional[Tuple[float, float, float, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin of shape ``positions.shape + (head_dim,)``, the
    half-frequencies duplicated (HF convention: concat(freqs, freqs))."""
    inv_freq = _inv_freq(head_dim, theta, rope_scaling, positions.device)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., S, n_heads, head_dim] by per-position cos/sin [..., S, head_dim]."""
    dtype = x.dtype
    xf = x.float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return (xf * c + _rotate_half(xf) * s).to(dtype)
