"""The draft -> verify -> accept speculative decoding engine.  Port of the
single-request path of ``dflash_tpu/spec/engine.py``.

JAX runs the whole decode as one on-device ``lax.while_loop``.  Here the loop
is a Python ``while`` over device tensors, and the host reads the cycle's
accepted length (and stop flag) back once per cycle: that one sync decides
the next slice positions.  The caches, feature buffer and token buffer keep
the JAX layout (fixed shapes, absolute positions, a frontier) and are updated
in place.  Capturing the cycle as a CUDA graph is later work.

Cycle anatomy:
  1. slice the current block (bonus token + mask tokens) from the output buf
  2. project the newly committed feature rows into the draft context cache
     (a B-row window ending at the frontier; rewrites are idempotent)
  3. draft forward over the block; target lm_head on rows 1..B-1; greedy
     draft tokens fill block[1:]
  4. target verify forward over the block against the read-only cache
  5. acceptance = longest prefix of draft tokens matching the target's
     posterior; commit accepted prefix + bonus token and their K/V rows
  6. write the verify's tap features at the frontier; advance; stop check

``kv_quant=True`` keeps the target's cache in int8 with per-row scales
(``QuantKVCache``): prompt K/V are quantized as they are written, verify and
AR commits quantize their rows, and attention reads the cache through the int8
branch of ``verify_fused``.  The draft's context cache stays in the activation
dtype.  Int8 weights need nothing from the engine: ``linear`` dispatches on
the weight type.

Sampling filters (``generate(top_k, top_p)``) sample the first token, the
verify posterior and the AR steps through ``sample_topk_topp``, whose exact
keep set comes from the ``filter_stats`` kernel.  ``attn_impl="pallas"`` runs
the verify and the AR step through ``qwen3.forward``, which writes the block's
K/V rows into the cache layer by layer and attends through the
frontier-bounded ``verify_attention`` kernel (no separate commit); the draft
stays on ``verify_fused``.  The default ``attn_impl="xla"`` is the two-part
route above.

The lane stages (``LaneState``, ``_prefill_lanes``, ``_draft_stage_lanes``,
``_verify_stage_lanes``, ``_cycle``) run the same cycle for R requests at
once, for ``spec/batched.py`` and the serving engine: every lane's frontier,
stop flag and cycle count live on the device, the commit, the output writes
and the feature recycling are indexed writes over the lanes, and the one
host read of a cycle refreshes their host mirrors.  Each lane samples at its
own temperature and top-k / top-p (``SamplingFilters`` with [R] leaves): the
keep sets of every filtered lane come from one filtered-sampler call.  The
single-request engine keeps its own stages and launch counts.

Prefills beside the one-forward ``_prefill_impl``: ``prefill_chunk`` (an
int, or "auto") runs the prompt C tokens at a time through
``qwen3.forward``'s "xla" branch; ``_prefill_from_prefix_impl`` commits
cached prefix rows and runs the suffix alone; ``_prefill_chunk_impl`` is one
chunk of an interleaved admission (the serving engine's prefix cache, chunked
admission and disaggregated prefill use the last two).

Not ported yet (they raise): ``attn_impl`` "fused" / "bucketed" /
"xla_fullbuf", meshes and sequence sharding.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from dflash_tpu_torch.cache.kv import (
    AnyKVCache,
    KVCache,
    init_kv_cache,
    init_quant_kv_cache,
    update_any,
    write_prompt_rows,
)
from dflash_tpu_torch.core.config import DraftConfig, ModelConfig
from dflash_tpu_torch.models import dflash_draft, qwen3
from dflash_tpu_torch.ops.sampling import TOPK_POOL, acceptance_length, sample, sample_topk_topp

ATTN_IMPLS = ("xla", "pallas")


class SamplingFilters(NamedTuple):
    """Per-request top-k / top-p filters (the rest of the reference serving
    client's ``sampling_params``).  ``top_k <= 0`` and ``top_p >= 1``
    disable.  The lane stages take host scalars (shared by every lane) or R
    host values, one per lane."""

    top_k: int
    top_p: float


def _lane_posterior(logits: torch.Tensor, temps: list, generators, filters: Optional[SamplingFilters],
                    topk_pool: int) -> torch.Tensor:
    """Token ids [R, ...] from lane logits [R, ..., V]: each lane at its own
    temperature and (with ``filters``) its own top-k / top-p."""
    if filters is None:
        return sample(logits, temps, generators)
    return sample_topk_topp(logits, temps, generators, filters.top_k, filters.top_p, pool=topk_pool)


def _sample_posterior(logits: torch.Tensor, temperature: float, generator,
                      filters: Optional[SamplingFilters], topk_pool: int = TOPK_POOL) -> torch.Tensor:
    if filters is None:
        return sample(logits, temperature, generator)
    return sample_topk_topp(logits, temperature, generator, filters.top_k, filters.top_p, pool=topk_pool)


@dataclass
class LoopState:
    """Decode state.  Tensors live on the engine's device; the frontier and
    counters are host integers (the loop reads tau back every cycle)."""

    output_ids: torch.Tensor  # [1, T] int64; committed prefix + mask_id tail
    start: int  # frontier: next block start; row `start` holds the bonus token
    done: bool  # a stop token was committed
    cycle_idx: int
    acc_trace: list  # tau per cycle
    generator: Optional[torch.Generator]  # sampling at temperature > 0
    t_kv: AnyKVCache
    d_kv: KVCache
    features: torch.Tensor  # [1, T, n_taps * H] target tap features per position


class GenerationResult(NamedTuple):
    output_ids: np.ndarray  # [1, L] trimmed (prompt + generation)
    num_input_tokens: int
    num_output_tokens: int
    time_to_first_token: float
    time_per_output_token: float
    acceptance_lengths: list
    decode_wall_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _init_target_cache(t_params, tcfg: ModelConfig, length: int, kv_quant: bool, device) -> AnyKVCache:
    if kv_quant:
        return init_quant_kv_cache(tcfg, 1, length, device)
    return init_kv_cache(tcfg, 1, length, t_params["embed"].dtype, device)


def _prefill_target(t_params, tcfg: ModelConfig, input_ids: torch.Tensor, prompt_len: int,
                    tap_ids, total_len: int, kv_quant: bool, chunk: Optional[int] = None):
    """Target prefill: returns (t_kv, taps [1,P,F], last hidden row [1,1,H]).

    ``chunk`` None: one cache-free forward (``forward_prefill``); the prompt
    K/V stay in the activation dtype through it and are quantized as they
    are written when ``kv_quant``.  ``chunk`` C: C tokens at a time through
    the full-buffer ``qwen3.forward`` ("xla"), each chunk writing its rows
    and attending the rows written before it (JAX's ``fori_loop`` as a
    Python loop); the hidden row at ``prompt_len - 1`` comes from the chunk
    that holds it."""
    P = input_ids.shape[1]
    device = input_ids.device
    t_kv = _init_target_cache(t_params, tcfg, total_len, kv_quant, device)
    embeds = qwen3.embed(t_params, input_ids)
    if chunk is None:
        positions = torch.arange(P, device=device)[None, :]
        res = qwen3.forward_prefill(t_params, tcfg, embeds, positions, tap_ids=tap_ids)
        write_prompt_rows(t_kv, res.k, res.v)
        return t_kv, res.taps, res.hidden[:, prompt_len - 1:prompt_len]
    if P % chunk != 0:
        raise ValueError(f"prompt pad {P} not divisible by prefill chunk {chunk}")
    H = tcfg.hidden_size
    taps = torch.zeros((1, P, max(len(tap_ids), 1) * H), dtype=embeds.dtype, device=device)
    last_hidden = None
    for c0 in range(0, P, chunk):
        pos_c = (c0 + torch.arange(chunk, device=device))[None, :]
        res = qwen3.forward(t_params, tcfg, embeds[:, c0:c0 + chunk], pos_c, t_kv, c0,
                            qwen3.causal_mask(pos_c[0], total_len), tap_ids=tap_ids)
        taps[:, c0:c0 + chunk] = res.taps
        if c0 <= prompt_len - 1 < c0 + chunk:
            last_hidden = res.hidden[:, prompt_len - 1 - c0:prompt_len - c0]
    return t_kv, taps, last_hidden


def _init_output_ids(input_ids: torch.Tensor, prompt_len: int, first_token: torch.Tensor,
                     total_len: int, mask_token_id: int) -> torch.Tensor:
    output_ids = torch.full((1, total_len), mask_token_id, dtype=torch.long, device=input_ids.device)
    output_ids[0, :prompt_len] = input_ids[0, :prompt_len]
    output_ids[0, prompt_len] = first_token.reshape(())
    return output_ids


def _finish_prefill(t_params, d_params, input_ids: torch.Tensor, prompt_len: int, t_kv: AnyKVCache,
                    taps: torch.Tensor, last_hidden: torch.Tensor, temperature: float, generator, *,
                    dcfg: DraftConfig, total_len: int, filters: Optional[SamplingFilters],
                    topk_pool: int) -> LoopState:
    """The first-token sample, the token buffer, the features and the draft
    context prefill over every prompt row's taps [1, P, F]."""
    P = input_ids.shape[1]
    device = input_ids.device
    first_token = _sample_posterior(qwen3.lm_head(t_params, last_hidden), temperature, generator,
                                    filters, topk_pool)
    output_ids = _init_output_ids(input_ids, prompt_len, first_token, total_len, dcfg.mask_token_id)
    features = torch.zeros((1, total_len, taps.shape[-1]), dtype=taps.dtype, device=device)
    features[:, :P] = taps
    d_kv = init_kv_cache(dcfg.model, 1, total_len, t_params["embed"].dtype, device)
    positions = torch.arange(P, device=device)[None, :]
    dflash_draft.append_ctx(d_params, dcfg, d_kv, taps, positions, 0)
    return LoopState(output_ids, prompt_len, False, 0, [], generator, t_kv, d_kv, features)


def _prefill_impl(t_params, d_params, input_ids: torch.Tensor, prompt_len: int,
                  temperature: float, generator, *, tcfg: ModelConfig, dcfg: DraftConfig,
                  total_len: int, kv_quant: bool = False, prefill_chunk: Optional[int] = None,
                  filters: Optional[SamplingFilters] = None, topk_pool: int = TOPK_POOL) -> LoopState:
    """Target prefill (whole, or ``prefill_chunk`` tokens at a time) +
    first-token sample + draft context prefill."""
    t_kv, taps, last_hidden = _prefill_target(
        t_params, tcfg, input_ids, prompt_len, dcfg.target_layer_ids, total_len, kv_quant, prefill_chunk
    )
    return _finish_prefill(t_params, d_params, input_ids, prompt_len, t_kv, taps, last_hidden, temperature,
                           generator, dcfg=dcfg, total_len=total_len, filters=filters, topk_pool=topk_pool)


def _prefill_from_prefix_impl(t_params, d_params, input_ids: torch.Tensor, prompt_len: int, prefix_kv: AnyKVCache,
                              prefix_taps: torch.Tensor, temperature: float, generator, *, tcfg: ModelConfig,
                              dcfg: DraftConfig, total_len: int, kv_quant: bool = False,
                              filters: Optional[SamplingFilters] = None, topk_pool: int = TOPK_POOL) -> LoopState:
    """Prefill resuming from a cached prompt prefix (the engine's prefix
    cache, chunked admission, disaggregated prefill): the prefix rows
    ``prefix_kv`` (leaves [L, 1, P0, ...], in the cache's own
    representation: float, or int8 rows and scales) are committed at
    position 0 with no requantization, and only the suffix [P0, P) runs a
    forward, the full-buffer ``qwen3.forward`` ("xla") under the causal
    mask."""
    P = input_ids.shape[1]
    P0 = prefix_taps.shape[1]
    device = input_ids.device
    t_kv = _init_target_cache(t_params, tcfg, total_len, kv_quant, device)
    for buf, rows in zip(t_kv, prefix_kv):
        buf[:, :, :P0] = rows
    positions = (P0 + torch.arange(P - P0, device=device))[None, :]
    res = qwen3.forward(t_params, tcfg, qwen3.embed(t_params, input_ids[:, P0:]), positions, t_kv, P0,
                        qwen3.causal_mask(positions[0], total_len), tap_ids=dcfg.target_layer_ids)
    taps = torch.cat([prefix_taps.to(res.taps.dtype), res.taps], dim=1)
    last_hidden = res.hidden[:, prompt_len - 1 - P0:prompt_len - P0]
    return _finish_prefill(t_params, d_params, input_ids, prompt_len, t_kv, taps, last_hidden, temperature,
                           generator, dcfg=dcfg, total_len=total_len, filters=filters, topk_pool=topk_pool)


def _prefill_chunk_impl(t_params, scratch_kv: AnyKVCache, taps_buf: torch.Tensor, chunk_ids: torch.Tensor, c0: int,
                        *, tcfg: ModelConfig, tap_ids) -> tuple:
    """One chunk of an interleaved admission prefill: a C-token forward
    ("xla") against the scratch cache [L, 1, Pb, ...] holding the prompt
    rows before ``c0``, its K/V written at ``c0`` and its taps into
    ``taps_buf`` [1, Pb, F] at ``c0``, in place.  Returns (scratch_kv,
    taps_buf)."""
    C = chunk_ids.shape[1]
    pos_c = (c0 + torch.arange(C, device=chunk_ids.device))[None, :]
    res = qwen3.forward(t_params, tcfg, qwen3.embed(t_params, chunk_ids), pos_c, scratch_kv, c0,
                        qwen3.causal_mask(pos_c[0], taps_buf.shape[1]), tap_ids=tap_ids)
    taps_buf[:, c0:c0 + C] = res.taps
    return res.kv, taps_buf


def _draft_stage(state: LoopState, t_params, d_params, *, dcfg: DraftConfig, block_size: int):
    """Draft context append + non-causal draft forward + greedy draft tokens.
    Returns the drafted block [1, B]."""
    B = W = block_size
    T = state.output_ids.shape[1]
    start = state.start
    device = state.output_ids.device
    block = state.output_ids[:, start:start + B]
    block_positions = (start + torch.arange(B, device=device))[None, :]

    # draft context append: W-row window ending at the frontier
    w0 = min(max(start - W, 0), T - W)
    w_positions = (w0 + torch.arange(W, device=device))[None, :]
    dflash_draft.append_ctx(d_params, dcfg, state.d_kv, state.features[:, w0:w0 + W], w_positions, w0)

    # draft forward: unmask the whole block in one pass
    noise_embeds = qwen3.embed(t_params, block)
    d_hidden = dflash_draft.forward(d_params, dcfg, noise_embeds, block_positions, state.d_kv, start)
    draft_tokens = qwen3.lm_head(t_params, d_hidden[:, 1:]).argmax(dim=-1)
    return torch.cat([block[:, :1], draft_tokens], dim=1)


def _verify_stage(state: LoopState, block: torch.Tensor, t_params, temperature: float, *,
                  tcfg: ModelConfig, dcfg: DraftConfig, block_size: int,
                  stop_token_ids: frozenset, forced_acc: Optional[np.ndarray] = None,
                  attn_impl: str = "xla", filters: Optional[SamplingFilters] = None,
                  topk_pool: int = TOPK_POOL) -> None:
    """Target verify of the drafted block [1, B], acceptance, commit at the
    frontier and feature recycling.  Advances ``state`` in place."""
    B = block_size
    start = state.start
    device = block.device
    block_positions = (start + torch.arange(B, device=device))[None, :]
    embeds = qwen3.embed(t_params, block)

    if attn_impl == "pallas":
        # the full-buffer forward writes the block's K/V rows into the cache
        # layer by layer and attends through the frontier-bounded kernel
        res = qwen3.forward(t_params, tcfg, embeds, block_positions, state.t_kv, start, None,
                            tap_ids=dcfg.target_layer_ids, attn_impl="pallas")
    else:
        # two-part verify: the context cache is read-only inside the layer
        # loop; the block's K/V rows commit once, after it
        res = qwen3.forward_block_candidates(
            t_params, tcfg, embeds, block_positions, state.t_kv, start, tap_ids=dcfg.target_layer_ids,
        )
        update_any(state.t_kv, res.blk_k, res.blk_v, start)
    posterior = _sample_posterior(qwen3.lm_head(t_params, res.hidden), temperature, state.generator,
                                  filters, topk_pool)  # [1, B]

    # accept: the one host read of the cycle (acc, the block and the posterior)
    acc_t = acceptance_length(block[:, 1:], posterior)
    host = torch.cat([acc_t, block[0], posterior[0]]).tolist()
    acc, drafted, post = host[0], host[1:B + 1], host[B + 1:]
    if forced_acc is not None and forced_acc[state.cycle_idx] >= 0:
        # Benchmark-only acceptance override: emulates a tau distribution when
        # no trained draft is available; all compute and data movement is the
        # same as under the real rule.
        acc = min(int(forced_acc[state.cycle_idx]), B - 1)
    tau = acc + 1

    # commit: accepted prefix, the bonus token at the new frontier, mask after
    out = state.output_ids
    out[0, start:start + tau] = block[0, :tau]
    out[0, start + tau] = posterior[0, acc]
    out[0, start + tau + 1:start + B + 1] = dcfg.mask_token_id
    committed = drafted[:tau] + [post[acc]]
    # recycle the verify's tap features (they are the next draft context)
    state.features[:, start:start + B] = res.taps

    state.acc_trace.append(tau)
    state.start = start + tau
    state.done = state.done or any(t in stop_token_ids for t in committed)
    state.cycle_idx += 1


def _decode_impl(t_params, d_params, state: LoopState, max_length: int, temperature: float, *,
                 tcfg: ModelConfig, dcfg: DraftConfig, block_size: int,
                 stop_token_ids: frozenset, max_cycles: int,
                 forced_acc: Optional[np.ndarray] = None, attn_impl: str = "xla",
                 filters: Optional[SamplingFilters] = None, topk_pool: int = TOPK_POOL) -> LoopState:
    while state.start < max_length and not state.done and state.cycle_idx < max_cycles:
        block = _draft_stage(state, t_params, d_params, dcfg=dcfg, block_size=block_size)
        _verify_stage(
            state, block, t_params, temperature, tcfg=tcfg, dcfg=dcfg, block_size=block_size,
            stop_token_ids=stop_token_ids, forced_acc=forced_acc, attn_impl=attn_impl,
            filters=filters, topk_pool=topk_pool,
        )
    return state


# ---------------------------------------------------------------------------
# Lanes: R requests decoded together (spec/batched.py drives these)
# ---------------------------------------------------------------------------

@dataclass
class LaneState:
    """Decode state of R request lanes, the JAX ``LoopState`` with its lane
    axis (``STATE_AXES``): leading on every tensor except the caches, where
    it sits behind the layer axis.  ``start``, ``done`` and ``cycle_idx`` are
    device tensors, as the kernels and the commit read them; the ``host_*``
    arrays mirror them, refreshed by the one host read of each cycle, and give
    the loop condition and the host bounds (``max_start``) of the kernels."""

    output_ids: torch.Tensor  # [R, T] int64; committed prefix + mask_id tail
    start: torch.Tensor  # [R] int32 frontiers
    done: torch.Tensor  # [R] bool: a stop token was committed
    cycle_idx: torch.Tensor  # [R] int32
    acc_trace: torch.Tensor  # [R, max_cycles] int32: tau per cycle
    generators: Optional[list]  # one torch.Generator per lane (sampled lanes), else None
    t_kv: AnyKVCache  # [layers, R, T, ...]
    d_kv: KVCache
    features: torch.Tensor  # [R, T, n_taps * H]
    host_start: np.ndarray  # [R] int64 mirrors
    host_done: np.ndarray  # [R] bool
    host_cycle_idx: np.ndarray  # [R] int64

    def refresh(self) -> None:
        """The cycle's one host read: every lane's frontier, stop flag and
        cycle count."""
        host = torch.stack([self.start, self.done.to(torch.int32), self.cycle_idx]).cpu().numpy()
        self.host_start = host[0].astype(np.int64)
        self.host_done = host[1] != 0
        self.host_cycle_idx = host[2].astype(np.int64)


def lane_temperatures(temperature, R: int) -> list:
    """A scalar or R per-lane temperatures, as R host floats."""
    t = np.broadcast_to(np.asarray(temperature, np.float32), (R,))
    return [float(x) for x in t]


def _prefill_lanes(t_params, d_params, input_ids: torch.Tensor, prompt_lens: np.ndarray, temps: list,
                   generators, *, tcfg: ModelConfig, dcfg: DraftConfig, total_len: int, max_cycles: int,
                   kv_quant: bool = False, filters: Optional[SamplingFilters] = None,
                   topk_pool: int = TOPK_POOL) -> LaneState:
    """Target prefill of R prompts padded to one bucket ``input_ids`` [R, P]
    (one forward), each lane's first token from its last prompt row, and the
    draft context prefill (JAX's ``_prefill_impl`` vmapped over lanes)."""
    R, P = input_ids.shape
    device = input_ids.device
    dtype = t_params["embed"].dtype
    if kv_quant:
        t_kv = init_quant_kv_cache(tcfg, R, total_len, device)
    else:
        t_kv = init_kv_cache(tcfg, R, total_len, dtype, device)
    positions = torch.arange(P, device=device)[None, :]
    res = qwen3.forward_prefill(t_params, tcfg, qwen3.embed(t_params, input_ids), positions,
                                tap_ids=dcfg.target_layer_ids)
    write_prompt_rows(t_kv, res.k, res.v)
    lanes = torch.arange(R, device=device)
    pl = torch.as_tensor(prompt_lens, dtype=torch.long).to(device)
    last_hidden = res.hidden[lanes, pl - 1][:, None]  # [R, 1, H]
    first = _lane_posterior(qwen3.lm_head(t_params, last_hidden), temps, generators, filters, topk_pool)  # [R, 1]

    output_ids = torch.full((R, total_len), dcfg.mask_token_id, dtype=torch.long, device=device)
    output_ids[:, :P] = torch.where(positions < pl[:, None], input_ids, dcfg.mask_token_id)
    output_ids[lanes, pl] = first[:, 0]
    features = torch.zeros((R, total_len, res.taps.shape[-1]), dtype=res.taps.dtype, device=device)
    features[:, :P] = res.taps
    d_kv = init_kv_cache(dcfg.model, R, total_len, dtype, device)
    dflash_draft.append_ctx(d_params, dcfg, d_kv, res.taps, positions, 0)
    return LaneState(
        output_ids=output_ids, start=pl.to(torch.int32), done=torch.zeros(R, dtype=torch.bool, device=device),
        cycle_idx=torch.zeros(R, dtype=torch.int32, device=device),
        acc_trace=torch.zeros((R, max_cycles), dtype=torch.int32, device=device),
        generators=generators, t_kv=t_kv, d_kv=d_kv, features=features,
        host_start=np.asarray(prompt_lens, np.int64).copy(), host_done=np.zeros(R, bool),
        host_cycle_idx=np.zeros(R, np.int64),
    )


class _Frontier(NamedTuple):
    """Where a cycle works on each lane: the frontier clamped so that every
    write of the cycle (B + 1 rows) stays in the buffer (only frozen lanes
    are ever clamped), on the device and as its host bound."""

    pos: torch.Tensor  # [R] int32
    max_pos: int
    block_idx: torch.Tensor  # [R, B] int64: positions pos .. pos + B - 1


def _frontier(state: LaneState, active: np.ndarray, block_size: int) -> _Frontier:
    T = state.output_ids.shape[1]
    last = T - block_size - 1  # the commit writes B + 1 rows
    if (state.host_start[active] > last).any():
        raise ValueError(f"an active lane's frontier {int(state.host_start[active].max())} leaves no room for a "
                         f"block in a buffer of {T} rows: size total_len for max_length + block + 1")
    pos = state.start if state.host_start.max() <= last else torch.clamp(state.start, max=last)
    idx = pos.to(torch.long)[:, None] + torch.arange(block_size, device=pos.device)
    return _Frontier(pos, int(min(state.host_start.max(), last)), idx)


def _draft_stage_lanes(state: LaneState, fr: _Frontier, t_params, d_params, *, dcfg: DraftConfig,
                       block_size: int) -> torch.Tensor:
    """Every lane's draft context append and the draft forward, each lane at
    its own frontier, in one pass; returns the drafted blocks [R, B]."""
    B = W = block_size
    R, T = state.output_ids.shape
    device = state.output_ids.device
    block = state.output_ids.gather(1, fr.block_idx)  # [R, B]

    # draft context append: the W-row window ending at each lane's frontier
    w0 = torch.clamp(fr.pos - W, 0, T - W)
    w_idx = w0.to(torch.long)[:, None] + torch.arange(W, device=device)
    lanes = torch.arange(R, device=device)[:, None]
    dflash_draft.append_ctx(d_params, dcfg, state.d_kv, state.features[lanes, w_idx], w_idx, w0,
                            max_pos=min(max(fr.max_pos - W, 0), T - W))

    d_hidden = dflash_draft.forward(d_params, dcfg, qwen3.embed(t_params, block), fr.block_idx, state.d_kv,
                                    fr.pos, max_start=fr.max_pos)
    draft_tokens = qwen3.lm_head(t_params, d_hidden[:, 1:]).argmax(dim=-1)
    return torch.cat([block[:, :1], draft_tokens], dim=1)


def _verify_stage_lanes(state: LaneState, fr: _Frontier, block: torch.Tensor, t_params, temps: list,
                        active: torch.Tensor, host_active: np.ndarray, *, tcfg: ModelConfig, dcfg: DraftConfig,
                        block_size: int, stop_ids: Optional[torch.Tensor], forced_acc: Optional[torch.Tensor],
                        filters: Optional[SamplingFilters] = None, topk_pool: int = TOPK_POOL) -> None:
    """Every lane's verify in one target forward, acceptance, commit at its
    frontier and feature recycling, all on the device.  Lanes not ``active``
    keep their tokens, frontier, flags and trace (JAX's freeze select); their
    caches and features advance harmlessly, as in JAX.  Their posterior is
    discarded, so they take the argmax: a frozen lane draws nothing from its
    generator and adds no rows to the filtered sampler."""
    B = block_size
    R = block.shape[0]
    device = block.device
    res = qwen3.forward_block_candidates(
        t_params, tcfg, qwen3.embed(t_params, block)[:, None], fr.block_idx[:, None], state.t_kv, fr.pos,
        tap_ids=dcfg.target_layer_ids, max_start=fr.max_pos)
    update_any(state.t_kv, res.blk_k[:, :, 0], res.blk_v[:, :, 0], fr.pos, fr.max_pos)
    temps = [t if a else 0.0 for t, a in zip(temps, host_active)]
    posterior = _lane_posterior(qwen3.lm_head(t_params, res.hidden[:, 0]), temps, state.generators, filters,
                                topk_pool)  # [R, B]

    acc = acceptance_length(block[:, 1:], posterior)  # [R]
    # cycle indices clamp to the array, as JAX's gather and update clamp them
    cyc = torch.clamp(state.cycle_idx, max=state.acc_trace.shape[1] - 1).to(torch.long)[:, None]
    if forced_acc is not None:
        # benchmark-only acceptance override, per lane at its own cycle
        fcyc = torch.clamp(state.cycle_idx, max=forced_acc.shape[1] - 1).to(torch.long)[:, None]
        f = forced_acc.gather(1, fcyc)[:, 0]
        acc = torch.where(f >= 0, torch.clamp(f, max=B - 1), acc)
    tau = acc + 1
    j = torch.arange(B + 1, device=device)
    commit = torch.cat([block, torch.full((R, 1), dcfg.mask_token_id, dtype=block.dtype, device=device)], 1)
    commit = torch.where(j <= acc[:, None], commit, dcfg.mask_token_id)
    commit = torch.where(j == tau[:, None], posterior.gather(1, acc[:, None]), commit)
    rows = fr.block_idx[:, :1] + j
    act = active[:, None]
    state.output_ids.scatter_(1, rows, torch.where(act, commit, state.output_ids.gather(1, rows)))
    lanes = torch.arange(R, device=device)[:, None]
    state.features[lanes, fr.block_idx] = res.taps[:, 0]  # the next draft context

    state.acc_trace.scatter_(1, cyc, torch.where(act, tau[:, None].to(torch.int32), state.acc_trace.gather(1, cyc)))
    state.start = torch.where(active, state.start + tau.to(torch.int32), state.start)
    state.cycle_idx = torch.where(active, state.cycle_idx + 1, state.cycle_idx)
    if stop_ids is not None:
        hit = (torch.isin(commit, stop_ids) & (j <= tau[:, None])).any(dim=1)
        state.done = state.done | (active & hit)


def _cycle(state: LaneState, t_params, d_params, temps: list, active: torch.Tensor, host_active: np.ndarray, *,
           tcfg: ModelConfig, dcfg: DraftConfig, block_size: int, stop_ids: Optional[torch.Tensor],
           forced_acc: Optional[torch.Tensor] = None, filters: Optional[SamplingFilters] = None,
           topk_pool: int = TOPK_POOL) -> LaneState:
    """One draft -> verify -> accept cycle of every lane (JAX's ``_cycle``
    under the batched engine's vmap) and its one host read.  ``active`` [R]
    (device) and ``host_active``: the lanes whose small state advances."""
    fr = _frontier(state, host_active, block_size)
    block = _draft_stage_lanes(state, fr, t_params, d_params, dcfg=dcfg, block_size=block_size)
    _verify_stage_lanes(state, fr, block, t_params, temps, active, host_active, tcfg=tcfg, dcfg=dcfg,
                        block_size=block_size, stop_ids=stop_ids, forced_acc=forced_acc, filters=filters,
                        topk_pool=topk_pool)
    state.refresh()
    return state


# ---------------------------------------------------------------------------
# Autoregressive baseline: one target token per step, the correctness oracle.
# ---------------------------------------------------------------------------

@dataclass
class ARState:
    output_ids: torch.Tensor
    start: int
    done: bool
    generator: Optional[torch.Generator]
    t_kv: AnyKVCache


def _ar_prefill(t_params, input_ids: torch.Tensor, prompt_len: int, temperature: float,
                generator, *, tcfg: ModelConfig, total_len: int, mask_token_id: int,
                kv_quant: bool = False, prefill_chunk: Optional[int] = None,
                filters: Optional[SamplingFilters] = None) -> ARState:
    t_kv, _, last_hidden = _prefill_target(t_params, tcfg, input_ids, prompt_len, (), total_len,
                                           kv_quant, prefill_chunk)
    first_token = _sample_posterior(qwen3.lm_head(t_params, last_hidden), temperature, generator,
                                    filters)
    output_ids = _init_output_ids(input_ids, prompt_len, first_token, total_len, mask_token_id)
    return ARState(output_ids, prompt_len, False, generator, t_kv)


def _ar_decode(t_params, state: ARState, max_length: int, temperature: float, *,
               tcfg: ModelConfig, stop_token_ids: frozenset, attn_impl: str = "xla",
               filters: Optional[SamplingFilters] = None) -> ARState:
    """AR decode, one target token per step.  ``attn_impl="xla"``:
    ``forward_block_candidates`` with B = 1 and one commit, through the
    ``verify_fused`` kernel (the JAX engine's "xla" AR step).  "pallas":
    ``qwen3.forward`` with S = 1, which writes the row and attends through
    ``verify_attention``."""
    device = state.output_ids.device
    while state.start < max_length and not state.done:
        s = state.start
        tok = state.output_ids[:, s:s + 1]
        positions = torch.full((1, 1), s, dtype=torch.long, device=device)
        embeds = qwen3.embed(t_params, tok)
        if attn_impl == "pallas":
            res = qwen3.forward(t_params, tcfg, embeds, positions, state.t_kv, s, None, attn_impl="pallas")
        else:
            res = qwen3.forward_block_candidates(t_params, tcfg, embeds, positions, state.t_kv, s)
            update_any(state.t_kv, res.blk_k, res.blk_v, s)
        nxt = _sample_posterior(qwen3.lm_head(t_params, res.hidden), temperature, state.generator,
                                filters)[0, 0]
        state.output_ids[0, s + 1] = nxt
        if stop_token_ids:  # host read only when there is something to stop on
            state.done = any(t in stop_token_ids for t in torch.stack([nxt, tok[0, 0]]).tolist())
        state.start = s + 1
    return state


# ---------------------------------------------------------------------------
# Host-level engine
# ---------------------------------------------------------------------------

def trim_output(output_ids: np.ndarray, prompt_len: int, max_new_tokens: int, mask_token_id: int,
                stop_token_ids: Sequence[int] = ()) -> np.ndarray:
    """One sequence's token buffer [T] as the user sees it, [1, L]: cut at
    prompt_len + max_new_tokens, mask tokens stripped from the generated
    region, truncated after the first stop token."""
    seq = output_ids[:prompt_len + max_new_tokens]
    gen = seq[prompt_len:]
    gen = gen[gen != mask_token_id]
    if stop_token_ids:
        hits = np.nonzero(np.isin(gen, list(stop_token_ids)))[0]
        if hits.size > 0:
            gen = gen[: hits[0] + 1]
    return np.concatenate([seq[:prompt_len], gen])[None, :]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SpecEngine:
    """Single-request speculative / AR generation.

    Prompts are padded to ``prompt_bucket`` multiples and the token / cache
    buffers are sized ``prompt_cap + max_new_tokens + block + 1``.  The
    parameters (float, or int8 from ``dflash_tpu_torch.quant``) must already
    live on ``device``; the default is the card, and building on a machine
    without one raises.  ``kv_quant=True`` keeps the target's KV cache in int8.
    ``attn_impl``: "xla" (the two-part verify, default) or "pallas" (the
    full-buffer forward through the frontier-bounded kernel; the buffers are
    rounded up to a multiple of 512 rows, as in JAX).  ``prefill_chunk``: None
    (one prefill forward), a chunk size that divides the padded prompt, or
    "auto" (``_resolve_chunk``).  ``topk_pool``: the filtered sampler's
    candidate pool; ``generate`` rejects a wider top_k.
    """

    def __init__(
        self,
        tcfg: ModelConfig,
        dcfg: DraftConfig,
        t_params: dict,
        d_params: dict,
        *,
        max_new_tokens: int,
        block_size: Optional[int] = None,
        prompt_cap: int = 1024,
        prompt_bucket: int = 128,
        stop_token_ids: Sequence[int] = (),
        device: str | torch.device = "cuda",
        kv_quant: bool = False,
        prefill_chunk: Optional[int | str] = None,
        mesh=None,
        seq_axis: Optional[str] = None,
        attn_impl: str = "xla",
        topk_pool: int = TOPK_POOL,
    ):
        if mesh is not None or seq_axis is not None:
            raise NotImplementedError("mesh and seq_axis are not ported to dflash_tpu_torch yet")
        if attn_impl not in ATTN_IMPLS:
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} is not ported to dflash_tpu_torch yet; it has {ATTN_IMPLS}")
        if attn_impl == "pallas" and kv_quant:
            raise ValueError("attn_impl='pallas' needs batch 1 + bf16 cache (kv_quant=False)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SpecEngine(device='cuda'): no CUDA device; pass device='cpu' to run on the CPU")
        for name, params in (("t_params", t_params), ("d_params", d_params)):
            where = params["final_norm"].device
            if where.type != self.device.type:
                raise ValueError(f"{name} live on {where}, the engine runs on {self.device}")
        self.tcfg = tcfg
        self.dcfg = dcfg
        self.t_params = t_params
        self.d_params = d_params
        self.max_new_tokens = int(max_new_tokens)
        self.block_size = int(block_size if block_size is not None else dcfg.block_size)
        self.prompt_cap = int(prompt_cap)
        self.prompt_bucket = int(prompt_bucket)
        self.stop_token_ids = tuple(int(s) for s in stop_token_ids)
        self.kv_quant = bool(kv_quant)
        # "auto": the one-forward prefill up to 16384 padded tokens, chunked
        # past that (JAX's rule)
        self.prefill_chunk = prefill_chunk
        self.attn_impl = attn_impl
        self.topk_pool = int(topk_pool)
        self.total_len = self.prompt_cap + self.max_new_tokens + self.block_size + 1
        if attn_impl == "pallas":
            self.total_len = _round_up(self.total_len, 512)

    def _resolve_chunk(self, padded_len: int) -> Optional[int]:
        """The prefill chunk for a prompt padded to ``padded_len``: "auto"
        keeps the one-forward prefill up to 16384 tokens, then takes the
        largest of 512 / 256 / 128 that divides the pad (None if none
        does)."""
        if self.prefill_chunk == "auto":
            if padded_len <= 16384:
                return None
            return next((c for c in (512, 256, 128) if padded_len % c == 0), None)
        return self.prefill_chunk

    def _pad_prompt(self, input_ids: np.ndarray) -> tuple[torch.Tensor, int, int]:
        input_ids = np.asarray(input_ids)
        if input_ids.ndim == 1:
            input_ids = input_ids[None, :]
        prompt_len = int(input_ids.shape[1])
        if prompt_len > self.prompt_cap:
            raise ValueError(f"prompt_len {prompt_len} exceeds prompt_cap {self.prompt_cap}")
        P = min(self.prompt_cap, _round_up(max(prompt_len, 1), self.prompt_bucket))
        padded = np.zeros((1, P), np.int64)
        padded[0, :prompt_len] = input_ids[0]
        return torch.from_numpy(padded).to(self.device), prompt_len, P

    def _trim(self, output_ids: np.ndarray, prompt_len: int) -> np.ndarray:
        return trim_output(output_ids[0], prompt_len, self.max_new_tokens, self.dcfg.mask_token_id,
                           self.stop_token_ids)

    @staticmethod
    def _filters(top_k: int, top_p: float) -> Optional[SamplingFilters]:
        """None when both filters are no-ops (the unfiltered sampler)."""
        if top_k <= 0 and top_p >= 1.0:
            return None
        return SamplingFilters(int(top_k), float(top_p))

    def _generator(self, temperature: float, seed: int) -> Optional[torch.Generator]:
        if temperature <= 0.0:
            return None
        return torch.Generator(device=self.device).manual_seed(seed)

    def _result(self, output_ids: torch.Tensor, prompt_len: int, ttft: float, decode_wall: float,
                acceptance_lengths: Optional[list]) -> GenerationResult:
        seq = self._trim(output_ids.cpu().numpy(), prompt_len)
        num_out = int(seq.shape[1] - prompt_len)
        return GenerationResult(
            output_ids=seq,
            num_input_tokens=prompt_len,
            num_output_tokens=num_out,
            time_to_first_token=ttft,
            time_per_output_token=decode_wall / max(num_out, 1),
            acceptance_lengths=acceptance_lengths if acceptance_lengths is not None else [1] * num_out,
            decode_wall_s=decode_wall,
        )

    def generate(
        self,
        input_ids: np.ndarray,
        temperature: float = 0.0,
        seed: int = 0,
        forced_acc: Optional[np.ndarray] = None,
        top_k: int = 0,
        top_p: float = 1.0,
    ) -> GenerationResult:
        if top_k > self.topk_pool:
            raise ValueError(
                f"top_k={top_k} exceeds the engine's exact pool (topk_pool={self.topk_pool}); "
                f"build the engine with a wider topk_pool instead of silently clamping")
        ids, prompt_len, padded_len = self._pad_prompt(input_ids)
        max_length = prompt_len + self.max_new_tokens
        filters = self._filters(top_k, top_p)

        t0 = time.perf_counter()
        state = _prefill_impl(
            self.t_params, self.d_params, ids, prompt_len, temperature,
            self._generator(temperature, seed), tcfg=self.tcfg, dcfg=self.dcfg,
            total_len=self.total_len, kv_quant=self.kv_quant,
            prefill_chunk=self._resolve_chunk(padded_len), filters=filters, topk_pool=self.topk_pool,
        )
        _sync(self.device)
        ttft = time.perf_counter() - t0

        if forced_acc is not None:
            fa = np.full((self.max_new_tokens,), -1, np.int64)
            forced = np.asarray(forced_acc, np.int64)[: self.max_new_tokens]
            fa[: len(forced)] = forced
            forced_acc = fa

        t1 = time.perf_counter()
        state = _decode_impl(
            self.t_params, self.d_params, state, max_length, temperature,
            tcfg=self.tcfg, dcfg=self.dcfg, block_size=self.block_size,
            stop_token_ids=frozenset(self.stop_token_ids), max_cycles=self.max_new_tokens,
            forced_acc=forced_acc, attn_impl=self.attn_impl, filters=filters,
            topk_pool=self.topk_pool,
        )
        _sync(self.device)
        decode_wall = time.perf_counter() - t1
        return self._result(state.output_ids, prompt_len, ttft, decode_wall, state.acc_trace)

    def ar_generate(self, input_ids: np.ndarray, temperature: float = 0.0, seed: int = 0) -> GenerationResult:
        ids, prompt_len, padded_len = self._pad_prompt(input_ids)
        max_length = prompt_len + self.max_new_tokens

        t0 = time.perf_counter()
        state = _ar_prefill(
            self.t_params, ids, prompt_len, temperature, self._generator(temperature, seed),
            tcfg=self.tcfg, total_len=self.total_len, mask_token_id=self.dcfg.mask_token_id,
            kv_quant=self.kv_quant, prefill_chunk=self._resolve_chunk(padded_len),
        )
        _sync(self.device)
        ttft = time.perf_counter() - t0

        t1 = time.perf_counter()
        state = _ar_decode(
            self.t_params, state, max_length, temperature,
            tcfg=self.tcfg, stop_token_ids=frozenset(self.stop_token_ids),
            attn_impl=self.attn_impl,
        )
        _sync(self.device)
        decode_wall = time.perf_counter() - t1
        return self._result(state.output_ids, prompt_len, ttft, decode_wall, None)
