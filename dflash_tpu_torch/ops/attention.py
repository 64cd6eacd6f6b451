"""Grouped-query attention with boolean masks: the plain PyTorch versions of
the port's two attention kernels.  Port of ``gqa_attention`` and of
``gqa_attention_quant_ctx_plus_block`` (bf16/f32 and int8 ctx) in
``dflash_tpu/ops/attention.py``.

Query head ``h`` reads kv head ``h // g`` (JAX's ``q.reshape(..., n_kv, g, d)``).
Masked key rows get a -1e30 score in float32 before the softmax, so they carry
zero weight.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def gqa_attention(
    q: torch.Tensor,  # [B, Sq, n_heads, d]
    k: torch.Tensor,  # [B, Sk, n_kv, d]
    v: torch.Tensor,  # [B, Sk, n_kv, d]
    mask: torch.Tensor,  # bool [B, Sq, Sk] or [Sq, Sk]; True = attend
    scale: float,
) -> torch.Tensor:
    """Returns [B, Sq, n_heads * d] in q's dtype."""
    b, sq, n_heads, d = q.shape
    n_kv = k.shape[2]
    groups = n_heads // n_kv
    qg = q.reshape(b, sq, n_kv, groups, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, n_heads * d).to(q.dtype)


def gqa_attention_quant_ctx_plus_block(
    q: torch.Tensor,  # [C, B, n_heads, d]: C candidates x B block queries
    ctx_kq: torch.Tensor,  # [1, T, n_kv, d] shared ctx keys: int8, or bf16/f32 when unscaled
    ctx_ks: Optional[torch.Tensor],  # [1, T, n_kv] f32 per-row key scales; None = unquantized
    ctx_vq: torch.Tensor,  # [1, T, n_kv, d]
    ctx_vs: Optional[torch.Tensor],  # [1, T, n_kv]; None = unquantized
    blk_k: torch.Tensor,  # [C, B, n_kv, d] per-candidate block keys
    blk_v: torch.Tensor,  # [C, B, n_kv, d]
    ctx_mask: torch.Tensor,  # [T] bool: valid committed rows (< frontier)
    blk_mask: torch.Tensor,  # [B, B] bool: attendability within the block
    scale: float,
) -> torch.Tensor:
    """Shared-context + per-candidate-block attention, merged by log-sum-exp.
    Mathematically the softmax over the concatenation [ctx rows | block rows].
    int8 ctx rows are exact in q's dtype; their key scales multiply the scores
    and their value scales the weights before the value product.
    Returns [C, B, n_heads * d]."""
    Cc, B, n_heads, d = q.shape
    n_kv = ctx_kq.shape[2]
    groups = n_heads // n_kv
    qg = q.reshape(Cc, B, n_kv, groups, d).float()

    # ctx part: cache rows shared across candidates (batch dim 1)
    s1 = torch.einsum("cqkgd,skd->ckgqs", qg, ctx_kq[0].float())
    if ctx_ks is not None:
        ks = ctx_ks[0].movedim(-1, 0)[None, :, None, None, :]  # [1, n_kv, 1, 1, T]
        s1 = s1 * (ks * scale)
    else:
        s1 = s1 * scale
    s1 = torch.where(ctx_mask[None, None, None, None, :], s1, _NEG_INF)
    m1 = s1.amax(dim=-1)  # [C, n_kv, g, B]
    e1 = torch.exp(s1 - m1[..., None])
    l1 = e1.sum(dim=-1)
    if ctx_vs is not None:
        e1 = e1 * ctx_vs[0].movedim(-1, 0)[None, :, None, None, :]
    o1 = torch.einsum("ckgqs,skd->ckgqd", e1.to(q.dtype).float(), ctx_vq[0].float())

    # block part: per-candidate rows
    s2 = torch.einsum("cqkgd,cskd->ckgqs", qg, blk_k.float()) * scale
    s2 = torch.where(blk_mask[None, None, None, :, :], s2, _NEG_INF)
    m2 = s2.amax(dim=-1)
    e2 = torch.exp(s2 - m2[..., None])
    l2 = e2.sum(dim=-1)
    o2 = torch.einsum("ckgqs,cskd->ckgqd", e2.to(blk_v.dtype).float(), blk_v.float())

    # LSE merge
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    denom = a1 * l1 + a2 * l2
    out = (a1[..., None] * o1 + a2[..., None] * o2) / denom[..., None]
    out = out.movedim(3, 1)  # [C, B, n_kv, g, d]
    return out.reshape(Cc, B, n_heads * d).to(q.dtype)
