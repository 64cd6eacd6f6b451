"""Fixed-shape KV cache indexed by absolute token position, with an implicit
frontier.  Port of ``dflash_tpu/cache/kv.py``: the bf16/f32 cache and the
int8 cache with per-row scales.

Layout ``[num_layers, batch, max_len, num_kv_heads, head_dim]``.  Rollback is
free: the frontier only feeds the attention mask, and the next cycle's writes
overwrite rejected rows before they can be attended.

Unlike the JAX functions, which return new arrays, the writes here update the
cache tensors IN PLACE (slice assignment) and return the same cache; no copy
of the cache is made per cycle.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from dflash_tpu_torch.core.config import ModelConfig


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, T, n_kv, d]
    v: torch.Tensor  # [L, B, T, n_kv, d]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"
) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


class QuantKVCache(NamedTuple):
    """int8 K/V with one f32 scale per (position, kv head): half the bytes of a
    bf16 cache.  Rollback works as for :class:`KVCache`."""

    k: torch.Tensor  # [L, B, T, n_kv, d] int8
    k_scale: torch.Tensor  # [L, B, T, n_kv] f32
    v: torch.Tensor  # int8
    v_scale: torch.Tensor  # f32

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


AnyKVCache = Union[KVCache, QuantKVCache]


def init_quant_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> QuantKVCache:
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return QuantKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
    )


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., d] -> (int8 values, f32 scale over the last axis), bit for bit as
    the JAX function: ``scale = max(absmax, 1e-8) / 127``, round half to even,
    clip to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _check_window(S: int, T: int, write_pos: int) -> None:
    # JAX's dynamic_update_slice clamps an out-of-range start; the engine
    # never relies on that, so a write past the buffer is a caller bug here.
    if write_pos < 0 or write_pos + S > T:
        raise ValueError(f"cache write [{write_pos}, {write_pos + S}) outside [0, {T})")


def update_layer(
    k_layer: torch.Tensor,  # [..., T, n_kv, d]: one layer [B, T, ...] or a stack [L, B, T, ...]
    v_layer: torch.Tensor,
    k_new: torch.Tensor,  # [..., S, n_kv, d]
    v_new: torch.Tensor,
    write_pos: int,  # absolute position of the first new row
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write new rows at ``write_pos`` of the position axis, in place;
    returns the same tensors."""
    S = k_new.shape[-3]
    _check_window(S, k_layer.shape[-3], write_pos)
    k_layer[..., write_pos:write_pos + S, :, :] = k_new
    v_layer[..., write_pos:write_pos + S, :, :] = v_new
    return k_layer, v_layer


def update_layer_quant(
    k_layer: torch.Tensor,  # [..., T, n_kv, d] int8
    ks_layer: torch.Tensor,  # [..., T, n_kv] f32
    v_layer: torch.Tensor,
    vs_layer: torch.Tensor,
    k_new: torch.Tensor,  # [..., S, n_kv, d] in the activation dtype
    v_new: torch.Tensor,
    write_pos: int,
):
    """Quantize new rows and write them and their scales at ``write_pos``, in
    place; returns the same tensors."""
    S = k_new.shape[-3]
    _check_window(S, k_layer.shape[-3], write_pos)
    kq, ks = quantize_rows(k_new)
    vq, vs = quantize_rows(v_new)
    k_layer[..., write_pos:write_pos + S, :, :] = kq
    ks_layer[..., write_pos:write_pos + S, :] = ks
    v_layer[..., write_pos:write_pos + S, :, :] = vq
    vs_layer[..., write_pos:write_pos + S, :] = vs
    return k_layer, ks_layer, v_layer, vs_layer


def write_prompt_rows(kv: AnyKVCache, k_rows: torch.Tensor, v_rows: torch.Tensor) -> AnyKVCache:
    """Write prompt K/V rows [L, B, S, n_kv, d] of all layers at position 0, in
    place (quantizing on the way in for the int8 cache)."""
    return update_any(kv, k_rows, v_rows, 0)


def update_any(cache: AnyKVCache, k_new: torch.Tensor, v_new: torch.Tensor, write_pos: int) -> AnyKVCache:
    """Write new K/V rows [L, B, S, n_kv, d] into every layer of ``cache`` (of
    either type) at ``write_pos``, in place.  The JAX engine vmaps its
    per-layer ``update_any`` over the layer axis; this takes the stacked rows
    directly."""
    if isinstance(cache, QuantKVCache):
        update_layer_quant(cache.k, cache.k_scale, cache.v, cache.v_scale, k_new, v_new, write_pos)
    else:
        update_layer(cache.k, cache.v, k_new, v_new, write_pos)
    return cache
