"""Batched (multi-request) speculative decoding: R request lanes decoded
together, each with its own frontier.  Port of ``dflash_tpu/spec/batched.py``
(``batched_prefill``, ``batched_decode``, ``batched_cycles``,
``batched_cycle``), with the same arguments.

JAX lifts the single-request cycle through ``vmap``; the Pallas kernels fold
the lane axis into their grids.  Here the stages are written for R lanes
(``spec/engine.py``: ``_prefill_lanes``, ``_cycle``): one target forward and
one draft forward per cycle carry every lane, so the products read each
weight once for all R lanes and the host launches one cycle's kernels
whatever R.  Each layer's attention is one lane call of ``verify_fused``
(``prefill_flash`` in the prefill), with the per-lane frontiers an int32
tensor on the device that the kernels read.  The caches put the lane axis
behind the layer axis (JAX's ``STATE_AXES``), so a cache layer is the
kernels' [R, T, n_kv, d] without a copy.

Finished lanes freeze as in JAX's ``batched_decode``: the commit leaves
their tokens, frontier, flags and trace as they were (a masked write of
their small state), while their caches and features advance harmlessly (no
select over those buffers).  A frozen lane whose frontier leaves no room for
a block works at the last position that has room, where JAX's
``dynamic_update_slice`` clamps; an active lane there raises instead, as the
port's cache writes past the buffer raise.  The loop reads every lane's
frontier, stop flag and cycle count back once per cycle.

Temperature: a scalar or one per lane; sampled lanes draw from one
``torch.Generator`` per lane, seeded from ``keys`` (JAX's per-lane PRNG
keys; the same distribution, not the same tokens).  Not ported (they raise
``NotImplementedError``): per-lane top-k / top-p ``filters`` and the mesh
(``state_shardings``, ``shard_state``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dflash_tpu_torch.core.config import DraftConfig, ModelConfig
from dflash_tpu_torch.ops.sampling import GREEDY_TEMP_EPS, TOPK_POOL
from dflash_tpu_torch.spec.engine import (
    LaneState,
    _cycle,
    _prefill_lanes,
    lane_temperatures,
    trim_output,
)


def _no_filters(filters) -> None:
    if filters is not None:
        raise NotImplementedError("per-lane top-k / top-p filters are not ported to the batched engine yet")


def state_shardings(mesh):
    raise NotImplementedError("meshes are not ported to dflash_tpu_torch yet")


def shard_state(state: LaneState, mesh) -> LaneState:
    raise NotImplementedError("meshes are not ported to dflash_tpu_torch yet")


def _generators(keys, R: int, temps: list, device: torch.device) -> Optional[list]:
    """One generator per lane, seeded from ``keys`` (R seeds; None: 0 .. R-1),
    when a lane samples."""
    if all(t < GREEDY_TEMP_EPS for t in temps):
        return None
    seeds = [int(k) for k in (range(R) if keys is None else keys)]
    if len(seeds) != R:
        raise ValueError(f"{len(seeds)} keys for {R} lanes")
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def batched_prefill(
    t_params,
    d_params,
    input_ids,  # [R, 1, P] or [R, P], padded to one bucket
    prompt_lens,  # [R]
    temperature,  # scalar or [R]
    keys=None,  # R seeds of the sampled lanes' generators (JAX: [R, 2] PRNG keys)
    *,
    tcfg: ModelConfig,
    dcfg: DraftConfig,
    total_len: int,
    max_cycles: int,
    kv_quant: bool = False,
    filters=None,
    topk_pool: int = TOPK_POOL,
) -> LaneState:
    """Prefill of every lane in one target forward; returns the lanes'
    decode state (the lane axis leading everywhere except the KV caches,
    where it sits behind the layer axis)."""
    _no_filters(filters)
    device = t_params["final_norm"].device
    ids = torch.as_tensor(np.asarray(input_ids)).to(device=device, dtype=torch.long)
    ids = ids.reshape(ids.shape[0], ids.shape[-1])
    R, P = ids.shape
    lens = np.asarray(prompt_lens, np.int64).reshape(R)
    if lens.min() < 1 or lens.max() > P or total_len < P + 1:
        raise ValueError(f"prompt_lens {lens.tolist()} must lie in [1, {P}], total_len {total_len} above {P}")
    temps = lane_temperatures(temperature, R)
    return _prefill_lanes(t_params, d_params, ids, lens, temps, _generators(keys, R, temps, device),
                          tcfg=tcfg, dcfg=dcfg, total_len=total_len, max_cycles=max_cycles, kv_quant=kv_quant)


def _loop_inputs(state: LaneState, temperature, max_lengths, forced_acc, stop_token_ids) -> tuple:
    """The decode loop's inputs for R lanes: host temperatures, max_lengths
    on the host and the device, forced_acc as an int64 [R, n] device tensor
    (per lane [R, n], or one row [n] shared by every lane) and the stop ids."""
    R = state.start.shape[0]
    device = state.start.device
    ml = np.asarray(max_lengths, np.int64).reshape(R)
    fa = None
    if forced_acc is not None:
        fa = torch.as_tensor(np.asarray(forced_acc, np.int64), device=device)
        fa = fa.reshape(R, -1) if fa.dim() == 2 else fa[None].expand(R, -1)
    stop = None
    if stop_token_ids:
        stop = torch.tensor([int(s) for s in stop_token_ids], dtype=torch.long, device=device)
    return lane_temperatures(temperature, R), ml, torch.as_tensor(ml, device=device), fa, stop


def batched_decode(
    t_params,
    d_params,
    state: LaneState,
    max_lengths,  # [R]: prompt_len + max_new_tokens per lane
    temperature,  # scalar or [R]
    *,
    tcfg: ModelConfig,
    dcfg: DraftConfig,
    block_size: int,
    stop_token_ids: Tuple[int, ...],
    max_cycles: int,
    forced_acc=None,  # optional [R, max_cycles] per-lane acceptance override
    filters=None,
    topk_pool: int = TOPK_POOL,
) -> LaneState:
    """Cycle every lane until each reaches its ``max_length``, commits a stop
    token or runs ``max_cycles`` cycles; finished lanes freeze (see the
    module docstring).  Updates ``state`` in place and returns it."""
    _no_filters(filters)
    temps, ml, ml_dev, fa, stop = _loop_inputs(state, temperature, max_lengths, forced_acc, stop_token_ids)
    while True:
        host_active = (state.host_start < ml) & ~state.host_done & (state.host_cycle_idx < max_cycles)
        if not host_active.any():
            return state
        active = (state.start < ml_dev) & ~state.done & (state.cycle_idx < max_cycles)
        _cycle(state, t_params, d_params, temps, active, host_active, tcfg=tcfg, dcfg=dcfg,
               block_size=block_size, stop_ids=stop, forced_acc=fa)


def batched_cycles(
    state: LaneState,
    t_params,
    d_params,
    temperature,  # scalar or [R]
    max_lengths,  # [R] per-lane prompt_len + max_new_tokens
    *,
    tcfg: ModelConfig,
    dcfg: DraftConfig,
    block_size: int,
    stop_token_ids: Tuple[int, ...],
    n_steps: int = 1,
    forced_acc=None,  # optional [max_cycles] shared acceptance override
    filters=None,
    topk_pool: int = TOPK_POOL,
) -> LaneState:
    """``n_steps`` cycles of every active lane (the continuous-batching
    engine's multi-step unit).  Lanes that finish mid-window freeze as in
    :func:`batched_decode`; there is no cycle cap.  Once no lane is active
    the remaining steps change nothing and are not run."""
    _no_filters(filters)
    temps, ml, ml_dev, fa, stop = _loop_inputs(state, temperature, max_lengths, forced_acc, stop_token_ids)
    for _ in range(n_steps):
        host_active = (state.host_start < ml) & ~state.host_done
        if not host_active.any():
            break
        active = (state.start < ml_dev) & ~state.done
        _cycle(state, t_params, d_params, temps, active, host_active, tcfg=tcfg, dcfg=dcfg,
               block_size=block_size, stop_ids=stop, forced_acc=fa)
    return state


def batched_cycle(
    state: LaneState,
    t_params,
    d_params,
    temperature,  # scalar or [R]
    *,
    tcfg: ModelConfig,
    dcfg: DraftConfig,
    block_size: int,
    stop_token_ids: Tuple[int, ...],
) -> LaneState:
    """One draft -> verify -> accept step of every lane, none frozen (the unit
    the continuous-batching scheduler drives)."""
    R = state.start.shape[0]
    temps, _, _, _, stop = _loop_inputs(state, temperature, np.zeros(R), None, stop_token_ids)
    active = torch.ones(R, dtype=torch.bool, device=state.start.device)
    return _cycle(state, t_params, d_params, temps, active, np.ones(R, bool), tcfg=tcfg, dcfg=dcfg,
                  block_size=block_size, stop_ids=stop)


def lane_outputs(state: LaneState, prompt_lens, max_new_tokens: int, mask_token_id: int,
                 stop_token_ids: Sequence[int] = ()) -> list:
    """Each lane's tokens as ``SpecEngine.generate`` returns them ([1, L]:
    prompt + generation, mask tokens stripped, cut after the first stop
    token)."""
    out = state.output_ids.cpu().numpy()
    lens = np.asarray(prompt_lens, np.int64).reshape(out.shape[0])
    return [trim_output(out[r], int(lens[r]), max_new_tokens, mask_token_id, stop_token_ids)
            for r in range(out.shape[0])]
