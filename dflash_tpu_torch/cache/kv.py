"""Fixed-shape KV cache indexed by absolute token position, with an implicit
frontier.  Port of ``dflash_tpu/cache/kv.py``: the bf16/f32 cache and the
int8 cache with per-row scales.

Layout ``[num_layers, batch, max_len, num_kv_heads, head_dim]``.  Rollback is
free: the frontier only feeds the attention mask, and the next cycle's writes
overwrite rejected rows before they can be attended.

Unlike the JAX functions, which return new arrays, the writes here update the
cache tensors IN PLACE (slice assignment) and return the same cache; no copy
of the cache is made per cycle.  The batch axis holds the request lanes of
the batched engine (``spec/batched.py``, JAX's ``STATE_AXES``: behind the
layer axis, so a layer of the cache is the attention kernels' [lanes, T,
n_kv, d]); a write takes one position per lane as a device tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

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


WritePos = Union[int, torch.Tensor]


def _window(k_layer: torch.Tensor, S: int, write_pos: WritePos, max_pos: Optional[int]) -> tuple:
    """The index of the rows a write covers, up to the position axis, after
    the bounds check.  An int position: the slice [write_pos, write_pos + S).  A per-lane position
    ([R] int tensor, lane axis just before the position axis): the
    (lane, row) index pair of one indexed write, rows ``write_pos[r] + i``;
    its bound is checked from ``max_pos``, the caller's host-known upper
    bound on every lane's position, with no read of the tensor."""
    T = k_layer.shape[-3]
    if not isinstance(write_pos, torch.Tensor):
        _check_window(S, T, write_pos)
        return (Ellipsis, slice(write_pos, write_pos + S))
    if max_pos is None:
        raise ValueError("a per-lane write position needs max_pos, a host bound on it")
    _check_window(S, T, max_pos)
    R = write_pos.shape[0]
    if k_layer.shape[-4] != R:
        raise ValueError(f"{R} write positions for a cache of {k_layer.shape[-4]} lanes")
    lanes = torch.arange(R, device=write_pos.device)[:, None]
    rows = write_pos.to(torch.long)[:, None] + torch.arange(S, device=write_pos.device)
    return (Ellipsis, lanes, rows)


def update_layer(
    k_layer: torch.Tensor,  # [..., T, n_kv, d]: one layer [B, T, ...] or a stack [L, B, T, ...]
    v_layer: torch.Tensor,
    k_new: torch.Tensor,  # [..., S, n_kv, d]
    v_new: torch.Tensor,
    write_pos: WritePos,  # absolute position of the first new row: an int, or [B] per lane
    max_pos: Optional[int] = None,  # per-lane positions: a host bound on every one of them
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write new rows at ``write_pos`` of the position axis, in place;
    returns the same tensors.  Per-lane positions write each lane's rows at
    its own position in one indexed write per tensor."""
    idx = _window(k_layer, k_new.shape[-3], write_pos, max_pos) + (slice(None), slice(None))
    k_layer[idx] = k_new
    v_layer[idx] = v_new
    return k_layer, v_layer


def update_layer_quant(
    k_layer: torch.Tensor,  # [..., T, n_kv, d] int8
    ks_layer: torch.Tensor,  # [..., T, n_kv] f32
    v_layer: torch.Tensor,
    vs_layer: torch.Tensor,
    k_new: torch.Tensor,  # [..., S, n_kv, d] in the activation dtype
    v_new: torch.Tensor,
    write_pos: WritePos,
    max_pos: Optional[int] = None,
):
    """Quantize new rows and write them and their scales at ``write_pos`` (an
    int, or one per lane as in :func:`update_layer`), in place; returns the
    same tensors."""
    rows = _window(k_layer, k_new.shape[-3], write_pos, max_pos)
    kq, ks = quantize_rows(k_new)
    vq, vs = quantize_rows(v_new)
    k_layer[rows + (slice(None), slice(None))] = kq
    ks_layer[rows + (slice(None),)] = ks
    v_layer[rows + (slice(None), slice(None))] = vq
    vs_layer[rows + (slice(None),)] = vs
    return k_layer, ks_layer, v_layer, vs_layer


def write_prompt_rows(kv: AnyKVCache, k_rows: torch.Tensor, v_rows: torch.Tensor) -> AnyKVCache:
    """Write prompt K/V rows [L, B, S, n_kv, d] of all layers at position 0, in
    place (quantizing on the way in for the int8 cache)."""
    return update_any(kv, k_rows, v_rows, 0)


def update_any(cache: AnyKVCache, k_new: torch.Tensor, v_new: torch.Tensor, write_pos: WritePos,
               max_pos: Optional[int] = None) -> AnyKVCache:
    """Write new K/V rows [L, B, S, n_kv, d] into every layer of ``cache`` (of
    either type) at ``write_pos`` (an int, or a [B] tensor with one position
    per lane and its host bound ``max_pos``), in place.  The JAX engine vmaps
    its per-layer ``update_any`` over the layer axis (and the batched engine
    over lanes); this takes the stacked rows directly."""
    if isinstance(cache, QuantKVCache):
        update_layer_quant(cache.k, cache.k_scale, cache.v, cache.v_scale, k_new, v_new, write_pos, max_pos)
    else:
        update_layer(cache.k, cache.v, k_new, v_new, write_pos, max_pos)
    return cache
