"""Fixed-shape KV cache indexed by absolute token position, with an implicit
frontier.  Port of the bf16/f32 part of ``dflash_tpu/cache/kv.py``.

Layout ``[num_layers, batch, max_len, num_kv_heads, head_dim]``.  Rollback is
free: the frontier only feeds the attention mask, and the next cycle's writes
overwrite rejected rows before they can be attended.

Unlike the JAX functions, which return new arrays, the writes here update the
cache tensors IN PLACE (slice assignment) and return the same ``KVCache``; no
copy of the cache is made per cycle.  The int8 cache is not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

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


def update_layer(
    k_layer: torch.Tensor,  # [..., T, n_kv, d]: one layer [B, T, ...] or a stack [L, B, T, ...]
    v_layer: torch.Tensor,
    k_new: torch.Tensor,  # [..., S, n_kv, d]
    v_new: torch.Tensor,
    write_pos: int,  # absolute position of the first new row
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write new rows at ``write_pos`` of the position axis, in place;
    returns the same tensors."""
    S, T = k_new.shape[-3], k_layer.shape[-3]
    # JAX's dynamic_update_slice clamps an out-of-range start; the engine
    # never relies on that, so a write past the buffer is a caller bug here.
    if write_pos < 0 or write_pos + S > T:
        raise ValueError(f"cache write [{write_pos}, {write_pos + S}) outside [0, {T})")
    k_layer[..., write_pos:write_pos + S, :, :] = k_new
    v_layer[..., write_pos:write_pos + S, :, :] = v_new
    return k_layer, v_layer


def write_prompt_rows(kv: KVCache, k_rows: torch.Tensor, v_rows: torch.Tensor) -> KVCache:
    """Write prompt K/V rows [L, B, S, n_kv, d] of all layers at position 0, in place."""
    return update_any(kv, k_rows, v_rows, 0)


def update_any(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, write_pos: int) -> KVCache:
    """Write new K/V rows [L, B, S, n_kv, d] into every layer of ``cache`` at
    ``write_pos``, in place.  The JAX engine vmaps its per-layer
    ``update_any`` over the layer axis; this takes the stacked rows directly."""
    update_layer(cache.k, cache.v, k_new, v_new, write_pos)
    return cache
