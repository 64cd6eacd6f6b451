"""DFlash block-diffusion draft model.  Port of ``dflash_tpu/models/dflash_draft.py``.

The draft is a small Qwen3-style stack whose attention is non-causal: the
queries are the noise-block positions, the keys/values are (a) per-layer
projections of the target's tap features at the committed context positions
and (b) projections of the block's own hidden states.  The context K/V never
attend to anything, so the draft's context cache is append-only derived
state: after each verify the newly committed feature rows are projected and
written at their absolute positions.

The draft attention (ctx rows < ctx_len plus every block row) goes through
the lane entry of the ``verify_fused`` kernel with an all-true block mask:
the same keys that JAX's ``gqa_attention`` attends over the concatenation
[ctx cache | block], without the concatenation copy.  ``fc`` and the layer weights may be int8
``QTensor``s (``quant/quantize.py``); the context cache stays in the
activation dtype even when the target's cache is int8, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dflash_tpu_torch.cache.kv import KVCache, update_any
from dflash_tpu_torch.core.config import DraftConfig
from dflash_tpu_torch.kernels.verify_fused import fused_ctx_block_attention_lanes
from dflash_tpu_torch.models import qwen3
from dflash_tpu_torch.ops.linear import linear
from dflash_tpu_torch.ops.norms import rms_norm
from dflash_tpu_torch.ops.rope import apply_rope, rope_cos_sin


def init_params(seed: int, cfg: DraftConfig, dtype=torch.bfloat16, device="cuda") -> dict:
    m = cfg.model
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "layers": qwen3.init_layer_params(g, m, dtype, device),
        "final_norm": torch.ones((m.hidden_size,), dtype=dtype, device=device),
        "fc": qwen3._normal(g, (cfg.num_taps * m.hidden_size, m.hidden_size), dtype, device),
        "hidden_norm": torch.ones((m.hidden_size,), dtype=dtype, device=device),
    }


def project_features(params: dict, cfg: DraftConfig, features: torch.Tensor) -> torch.Tensor:
    """``hidden_norm(fc(features))``: the shared context input of every layer."""
    h = linear(features, params["fc"], out_dtype=features.dtype)
    return rms_norm(h, params["hidden_norm"], cfg.model.rms_norm_eps)


def ctx_kv(
    params: dict,
    cfg: DraftConfig,
    features: torch.Tensor,  # [B, S, n_taps * H] target tap features
    positions: torch.Tensor,  # [B, S] absolute positions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer context K/V [L_draft, B, S, n_kv, d], k_norm and RoPE applied."""
    m = cfg.model
    nkv, d = m.num_key_value_heads, m.head_dim
    B, S = features.shape[:2]
    ctx = project_features(params, cfg, features)
    cos, sin = rope_cos_sin(positions, d, m.rope_theta, m.rope_scaling)
    ks, vs = [], []
    for l in range(m.num_hidden_layers):
        p = qwen3._layer(params, l)
        k = linear(ctx, p["wk"]).reshape(B, S, nkv, d)
        v = linear(ctx, p["wv"]).reshape(B, S, nkv, d)
        if m.use_qk_norm:
            k = rms_norm(k, p["k_norm"], m.rms_norm_eps)
        ks.append(apply_rope(k, cos, sin))
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def append_ctx(
    params: dict,
    cfg: DraftConfig,
    cache: KVCache,
    features: torch.Tensor,  # [B, S, n_taps * H]
    positions: torch.Tensor,  # [B, S]
    write_pos,  # an int, or [B] per lane (then max_pos bounds it)
    max_pos: Optional[int] = None,
) -> KVCache:
    """Project feature rows and write their K/V into the draft context cache
    (in place; returns the same cache), at one position, or at each lane's
    own (``cache.kv.update_any``)."""
    k_new, v_new = ctx_kv(params, cfg, features, positions)
    return update_any(cache, k_new, v_new, write_pos, max_pos)


def forward(
    params: dict,
    cfg: DraftConfig,
    noise_embeds: torch.Tensor,  # [R, Bk, H] target embedding of the current block, R lanes
    block_positions: torch.Tensor,  # [R, Bk] absolute positions
    ctx_cache: KVCache,  # [L_d, R, T, n_kv, d] context K/V
    ctx_len,  # valid context frontier (== start): an int for every lane, or [R] int32 on the device
    max_start: Optional[int] = None,  # a [R] ctx_len: a host bound on it
) -> torch.Tensor:
    """One non-causal draft forward over the noise block: every block query
    attends all context rows < ctx_len plus every block row.  Returns
    final-norm'd hidden states [R, Bk, H]; the caller applies the target's
    lm_head to rows 1..Bk-1.  The R lanes run in one forward, each layer's
    attention one lane call of ``verify_fused`` (a host frontier is every
    lane's, passed as the kernel's bound with no device copy)."""
    m = cfg.model
    Bk = noise_embeds.shape[1]
    if not isinstance(ctx_len, torch.Tensor):
        ctx_len, max_start = None, int(ctx_len)
    elif max_start is None:
        raise ValueError("per-lane frontiers need max_start, a host bound on them")
    scale = m.head_dim ** -0.5
    cos, sin = rope_cos_sin(block_positions, m.head_dim, m.rope_theta, m.rope_scaling)
    all_true = torch.ones((Bk, Bk), dtype=torch.bool, device=noise_embeds.device)
    hidden = noise_embeds
    for l in range(m.num_hidden_layers):
        p = qwen3._layer(params, l)
        q, k, v = qwen3._qkv(p, m, hidden, cos, sin)
        attn = fused_ctx_block_attention_lanes(
            q[:, None], ctx_cache.k[l], None, ctx_cache.v[l], None, k[:, None], v[:, None], ctx_len,
            max_start, all_true, scale)[:, 0]
        hidden = qwen3._finish_layer(p, m, hidden, attn)
    return rms_norm(hidden, params["final_norm"], m.rms_norm_eps)
