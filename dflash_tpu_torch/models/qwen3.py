"""Qwen3/Llama-family dense target model with mid-layer feature taps.

Port of the dense part of ``dflash_tpu/models/qwen3.py``.  Parameters are a
dict with the JAX package's keys, weights ``[K, N]`` stacked on a leading
layer axis; the forward passes loop over the layers in Python where JAX runs
a ``lax.scan``.  The hidden state of each tap layer (after that layer's
residual adds, before the final norm) is captured and concatenated along the
feature axis, in ``tap_ids`` order.

Attention goes through the port's kernels: ``forward_prefill`` through
``prefill_flash``, ``forward_block_candidates`` through ``verify_fused`` (its
int8 branch when the context cache is a ``QuantKVCache``), and the
full-buffer ``forward`` with ``attn_impl="pallas"`` through
``verify_attention``.  Weights may
be int8 ``QTensor`` stacks (``quant/quantize.py``); ``linear`` then runs
``matmul_int8``.  On CPU tensors the kernels run their plain versions.  The
MoE MLP is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dflash_tpu_torch.cache.kv import AnyKVCache, QuantKVCache, update_layer
from dflash_tpu_torch.core.config import ModelConfig
from dflash_tpu_torch.kernels.attention import verify_attention
from dflash_tpu_torch.kernels.prefill_flash import flash_prefill_attention
from dflash_tpu_torch.kernels.verify_fused import fused_ctx_block_attention, fused_ctx_block_attention_lanes
from dflash_tpu_torch.ops.linear import linear
from dflash_tpu_torch.ops.norms import rms_norm
from dflash_tpu_torch.ops.rope import apply_rope, rope_cos_sin


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError("the MoE target is not ported to dflash_tpu_torch yet")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _normal(g: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 0.02^2) drawn in f32 and cast.  Stacked weights are drawn one
    layer at a time: one f32 draw of a whole [L, K, N] stack would hold a
    multi-GB f32 transient."""
    if len(shape) >= 3:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = torch.randn(shape[1:], generator=g, dtype=torch.float32, device=device) * 0.02
        return out
    return (torch.randn(shape, generator=g, dtype=torch.float32, device=device) * 0.02).to(dtype)


def init_layer_params(
    g: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16, device="cuda"
) -> dict:
    """Stacked decoder-layer parameters, leading axis = layer."""
    _require_dense(cfg)
    L, H, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    nh, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params = {
        "input_ln": ones(L, H),
        "post_ln": ones(L, H),
        "wq": _normal(g, (L, H, nh * d), dtype, device),
        "wk": _normal(g, (L, H, nkv * d), dtype, device),
        "wv": _normal(g, (L, H, nkv * d), dtype, device),
        "wo": _normal(g, (L, nh * d, H), dtype, device),
    }
    if cfg.use_qk_norm:
        params["q_norm"] = ones(L, d)
        params["k_norm"] = ones(L, d)
    params["gate"] = _normal(g, (L, H, I), dtype, device)
    params["up"] = _normal(g, (L, H, I), dtype, device)
    params["down"] = _normal(g, (L, I, H), dtype, device)
    return params


def init_params(seed: int, cfg: ModelConfig, dtype=torch.bfloat16, device="cuda") -> dict:
    """Random target weights drawn from ``seed`` with a generator on ``device``
    (the JAX package's distributions: normal * 0.02, ones for the norms)."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": _normal(g, (cfg.vocab_size, cfg.hidden_size), dtype, device),
        "layers": init_layer_params(g, cfg, dtype, device),
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _normal(g, (cfg.hidden_size, cfg.vocab_size), dtype, device)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(token_ids, params["embed"])


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Logits in float32 ([..., V])."""
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return linear(hidden, w, out_dtype=torch.float32)


def _dense_mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, lp["gate"], out_dtype=torch.float32)
    u = linear(x, lp["up"], out_dtype=torch.float32)
    act = (F.silu(g) * u).to(x.dtype)
    return linear(act, lp["down"])


def _layer(params: dict, l: int) -> dict:
    """Layer ``l`` of every stack (a QTensor stack gives that layer's QTensor)."""
    return {name: w[l] for name, w in params["layers"].items()}


def _qkv(p: dict, cfg: ModelConfig, hidden: torch.Tensor, cos, sin):
    """Pre-norm q/k/v projections with qk-norm and RoPE, shaped [..., S, heads, d]."""
    lead = hidden.shape[:-1]
    nh, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    h_norm = rms_norm(hidden, p["input_ln"], cfg.rms_norm_eps)
    q = linear(h_norm, p["wq"]).reshape(*lead, nh, d)
    k = linear(h_norm, p["wk"]).reshape(*lead, nkv, d)
    v = linear(h_norm, p["wv"]).reshape(*lead, nkv, d)
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _finish_layer(p: dict, cfg: ModelConfig, hidden: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Output projection, residual, post-norm MLP, residual."""
    hidden = hidden + linear(attn, p["wo"], out_dtype=hidden.dtype)
    h_norm2 = rms_norm(hidden, p["post_ln"], cfg.rms_norm_eps)
    return hidden + _dense_mlp(p, h_norm2)


def _concat_taps(taps: dict, tap_ids: Tuple[int, ...], like: torch.Tensor) -> torch.Tensor:
    if not tap_ids:
        return torch.zeros_like(like)
    return torch.cat([taps[l] for l in tap_ids], dim=-1)


class ForwardResult(NamedTuple):
    hidden: torch.Tensor  # [B, S, H]: final-norm'd hidden states
    taps: torch.Tensor  # [B, S, n_taps * H]
    kv: AnyKVCache  # the cache, with this call's K/V rows written (in place)


def forward(
    params: dict,
    cfg: ModelConfig,
    embeds: torch.Tensor,  # [B, S, H]
    positions: torch.Tensor,  # [B, S] absolute positions
    kv: AnyKVCache,
    write_pos: int,  # cache row of embeds[:, 0]
    mask: Optional[torch.Tensor],  # [S, T] over the full buffer: the "xla" branch's (not ported)
    tap_ids: Tuple[int, ...] = (),
    attn_impl: str = "xla",
) -> ForwardResult:
    """One target forward over S tokens that writes their K/V into ``kv`` at
    ``write_pos``, layer by layer and in place, and attends over the cache
    after the write.

    Only ``attn_impl="pallas"`` is ported: attention through the
    frontier-bounded ``verify_attention`` kernel, which reads cache rows below
    ``write_pos + S`` and lets row i attend keys j <= write_pos + i.  Valid
    when ``positions[0, i] == write_pos + i`` (the verify / AR decode pattern),
    batch 1, unquantized cache; ``mask`` is not read there.  The "xla",
    "bucketed" and quantized-cache branches (``_attend_cache``,
    ``gqa_attention_quant(_bucketed)``) are ROADMAP Queue 1 item 13.
    """
    _require_dense(cfg)
    if attn_impl != "pallas":
        raise NotImplementedError(
            f"qwen3.forward(attn_impl={attn_impl!r}) is not ported to dflash_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 13); attn_impl='pallas' is")
    B, S, _ = embeds.shape
    if B != 1 or isinstance(kv, QuantKVCache):
        raise ValueError("attn_impl='pallas' needs batch 1 + bf16 cache")
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    hidden = embeds
    taps = {}
    for l in range(cfg.num_hidden_layers):
        p = _layer(params, l)
        q, k, v = _qkv(p, cfg, hidden, cos, sin)
        update_layer(kv.k[l], kv.v[l], k, v, write_pos)
        attn = verify_attention(q, kv.k[l], kv.v[l], write_pos, block=S)
        hidden = _finish_layer(p, cfg, hidden, attn)
        if l in tap_ids:
            taps[l] = hidden
    out = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    return ForwardResult(out, _concat_taps(taps, tap_ids, embeds), kv)


class PrefillResult(NamedTuple):
    hidden: torch.Tensor  # [B, S, H]: final-norm'd hidden states
    taps: torch.Tensor  # [B, S, n_taps * H]
    k: torch.Tensor  # [L, B, S, n_kv, d]: prompt K rows (pre-cache)
    v: torch.Tensor  # [L, B, S, n_kv, d]


def forward_prefill(
    params: dict,
    cfg: ModelConfig,
    embeds: torch.Tensor,  # [R, S, H]: one prompt, or R lanes padded to one bucket
    positions: torch.Tensor,  # [1, S] (or [R, S]) = arange(S)
    tap_ids: Tuple[int, ...] = (),
) -> PrefillResult:
    """Cache-free causal prefill over S prompt tokens; the produced K/V rows
    are returned for the caller to write into the cache at position 0.  R
    lanes (the batched prefill) run as one forward: the products on all
    R * S rows, each layer's attention one lane call of ``prefill_flash``.

    Causality is positional (row i attends rows j <= i), which is the JAX
    mask ``positions[:, None] >= positions[None, :]`` for the arange
    positions the engine passes.  Padded tail rows sit at the end, so no real
    row attends one.
    """
    _require_dense(cfg)
    scale = cfg.head_dim ** -0.5
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    hidden = embeds
    taps, ks, vs = {}, [], []
    for l in range(cfg.num_hidden_layers):
        p = _layer(params, l)
        q, k, v = _qkv(p, cfg, hidden, cos, sin)
        attn = flash_prefill_attention(q, k, v, scale)
        hidden = _finish_layer(p, cfg, hidden, attn)
        if l in tap_ids:
            taps[l] = hidden
        ks.append(k)
        vs.append(v)
    out = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    return PrefillResult(out, _concat_taps(taps, tap_ids, embeds), torch.stack(ks), torch.stack(vs))


class CandidateForwardResult(NamedTuple):
    hidden: torch.Tensor  # [C, B, H] ([R, C, B, H] with lanes)
    taps: torch.Tensor  # [C, B, n_taps * H]
    blk_k: torch.Tensor  # [L, C, B, n_kv, d]: per-candidate block keys ([L, R, C, B, ...])
    blk_v: torch.Tensor  # [L, C, B, n_kv, d]


def forward_block_candidates(
    params: dict,
    cfg: ModelConfig,
    embeds: torch.Tensor,  # [C, B, H]: C candidate blocks; [R, C, B, H] with R lanes
    positions: torch.Tensor,  # [C, B] absolute positions (identical rows); [R, C, B]
    ctx_kv: AnyKVCache,  # committed-context cache (bf16/f32 or int8): batch 1, or R lanes
    ctx_len,  # frontier (ctx rows < ctx_len are valid): an int; lanes: [R] int32 on the device
    tap_ids: Tuple[int, ...] = (),
    blk_mask: Optional[torch.Tensor] = None,  # [B, B] override of the causal block mask
    max_start: Optional[int] = None,  # lanes: a host bound on every lane's frontier
) -> CandidateForwardResult:
    """Verify C candidate blocks in one forward over a SHARED, read-only
    context cache.  Query i of candidate c attends every ctx row < ctx_len
    plus its own block rows allowed by ``blk_mask`` (causal by default).  The
    block K/V are returned for the caller to commit.

    Lanes (4-D ``embeds``): R requests in one forward, lane r over its own
    cache lane ``ctx_kv.k[l][r]`` below its own frontier ``ctx_len[r]``; the
    products run on all R * C * B rows at once, so the lanes share each
    weight read, and each layer's attention is one lane call of
    ``verify_fused``."""
    _require_dense(cfg)
    lanes = embeds.dim() == 4
    if lanes and max_start is None:
        raise ValueError("lanes need max_start, a host bound on the frontiers")
    B = embeds.shape[-2]
    scale = cfg.head_dim ** -0.5
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    if blk_mask is None:
        idx = torch.arange(B, device=embeds.device)
        blk_mask = idx[None, :] <= idx[:, None]  # [B, B]: row i attends rows j <= i
    quant = isinstance(ctx_kv, QuantKVCache)
    hidden = embeds
    taps, ks, vs = {}, [], []
    for l in range(cfg.num_hidden_layers):
        p = _layer(params, l)
        q, k, v = _qkv(p, cfg, hidden, cos, sin)
        scales = (ctx_kv.k_scale[l], ctx_kv.v_scale[l]) if quant else (None, None)
        if lanes:
            attn = fused_ctx_block_attention_lanes(
                q, ctx_kv.k[l], scales[0], ctx_kv.v[l], scales[1], k, v, ctx_len, max_start, blk_mask, scale)
        else:
            attn = fused_ctx_block_attention(
                q, ctx_kv.k[l], scales[0], ctx_kv.v[l], scales[1], k, v, ctx_len, blk_mask, scale)
        hidden = _finish_layer(p, cfg, hidden, attn)
        if l in tap_ids:
            taps[l] = hidden
        ks.append(k)
        vs.append(v)
    out = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    return CandidateForwardResult(out, _concat_taps(taps, tap_ids, embeds), torch.stack(ks), torch.stack(vs))


def causal_mask(q_positions: torch.Tensor, cache_len: int) -> torch.Tensor:
    """[S, T] mask: key row s attendable iff s <= q_pos."""
    key_pos = torch.arange(cache_len, device=q_positions.device)[None, :]
    return key_pos <= q_positions[:, None]
