"""The draft -> verify -> accept speculative decoding engine.  Port of the
single-request greedy path of ``dflash_tpu/spec/engine.py``.

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

Not ported yet (they raise): sampling filters, chunked / prefix prefill,
meshes and sequence sharding.
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
from dflash_tpu_torch.ops.sampling import acceptance_length, sample


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

def _prefill_target(t_params, tcfg: ModelConfig, input_ids: torch.Tensor, prompt_len: int,
                    tap_ids, total_len: int, kv_quant: bool):
    """Target prefill (one cache-free forward): returns (t_kv, taps [1,P,F],
    last hidden row [1,1,H]).  The prompt K/V stay in the activation dtype
    through the prefill and are quantized as they are written when
    ``kv_quant``."""
    P = input_ids.shape[1]
    device = input_ids.device
    if kv_quant:
        t_kv = init_quant_kv_cache(tcfg, 1, total_len, device)
    else:
        t_kv = init_kv_cache(tcfg, 1, total_len, t_params["embed"].dtype, device)
    positions = torch.arange(P, device=device)[None, :]
    res = qwen3.forward_prefill(
        t_params, tcfg, qwen3.embed(t_params, input_ids), positions, tap_ids=tap_ids
    )
    write_prompt_rows(t_kv, res.k, res.v)
    return t_kv, res.taps, res.hidden[:, prompt_len - 1:prompt_len]


def _init_output_ids(input_ids: torch.Tensor, prompt_len: int, first_token: torch.Tensor,
                     total_len: int, mask_token_id: int) -> torch.Tensor:
    output_ids = torch.full((1, total_len), mask_token_id, dtype=torch.long, device=input_ids.device)
    output_ids[0, :prompt_len] = input_ids[0, :prompt_len]
    output_ids[0, prompt_len] = first_token.reshape(())
    return output_ids


def _prefill_impl(t_params, d_params, input_ids: torch.Tensor, prompt_len: int,
                  temperature: float, generator, *, tcfg: ModelConfig, dcfg: DraftConfig,
                  total_len: int, kv_quant: bool = False) -> LoopState:
    """Target prefill + first-token sample + draft context prefill."""
    P = input_ids.shape[1]
    device = input_ids.device
    dtype = t_params["embed"].dtype
    t_kv, taps, last_hidden = _prefill_target(
        t_params, tcfg, input_ids, prompt_len, dcfg.target_layer_ids, total_len, kv_quant
    )
    first_token = sample(qwen3.lm_head(t_params, last_hidden), temperature, generator)
    output_ids = _init_output_ids(input_ids, prompt_len, first_token, total_len, dcfg.mask_token_id)

    features = torch.zeros((1, total_len, taps.shape[-1]), dtype=taps.dtype, device=device)
    features[:, :P] = taps
    d_kv = init_kv_cache(dcfg.model, 1, total_len, dtype, device)
    positions = torch.arange(P, device=device)[None, :]
    dflash_draft.append_ctx(d_params, dcfg, d_kv, taps, positions, 0)
    return LoopState(output_ids, prompt_len, False, 0, [], generator, t_kv, d_kv, features)


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
                  stop_token_ids: frozenset, forced_acc: Optional[np.ndarray] = None) -> None:
    """Target verify of the drafted block [1, B], acceptance, commit at the
    frontier and feature recycling.  Advances ``state`` in place."""
    B = block_size
    start = state.start
    device = block.device
    block_positions = (start + torch.arange(B, device=device))[None, :]

    # verify forward: the context cache is read-only inside the layer loop;
    # the block's K/V rows commit once, after it
    res = qwen3.forward_block_candidates(
        t_params, tcfg, qwen3.embed(t_params, block), block_positions, state.t_kv, start,
        tap_ids=dcfg.target_layer_ids,
    )
    update_any(state.t_kv, res.blk_k, res.blk_v, start)
    posterior = sample(qwen3.lm_head(t_params, res.hidden), temperature, state.generator)  # [1, B]

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
                 forced_acc: Optional[np.ndarray] = None) -> LoopState:
    while state.start < max_length and not state.done and state.cycle_idx < max_cycles:
        block = _draft_stage(state, t_params, d_params, dcfg=dcfg, block_size=block_size)
        _verify_stage(
            state, block, t_params, temperature, tcfg=tcfg, dcfg=dcfg, block_size=block_size,
            stop_token_ids=stop_token_ids, forced_acc=forced_acc,
        )
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
                kv_quant: bool = False) -> ARState:
    t_kv, _, last_hidden = _prefill_target(t_params, tcfg, input_ids, prompt_len, (), total_len,
                                           kv_quant)
    first_token = sample(qwen3.lm_head(t_params, last_hidden), temperature, generator)
    output_ids = _init_output_ids(input_ids, prompt_len, first_token, total_len, mask_token_id)
    return ARState(output_ids, prompt_len, False, generator, t_kv)


def _ar_decode(t_params, state: ARState, max_length: int, temperature: float, *,
               tcfg: ModelConfig, stop_token_ids: frozenset) -> ARState:
    """AR decode.  Each step is ``forward_block_candidates`` with B = 1 and one
    commit, through the ``verify_fused`` kernel: the structure of the JAX
    engine's ``attn_impl="xla"`` AR step.  This is deliberate: JAX's
    ``attn_impl="fused"`` engine runs its AR step through ``qwen3.forward``
    instead, which the port does not have; the oracle keeps the same math."""
    device = state.output_ids.device
    while state.start < max_length and not state.done:
        s = state.start
        tok = state.output_ids[:, s:s + 1]
        positions = torch.full((1, 1), s, dtype=torch.long, device=device)
        res = qwen3.forward_block_candidates(
            t_params, tcfg, qwen3.embed(t_params, tok), positions, state.t_kv, s,
        )
        update_any(state.t_kv, res.blk_k, res.blk_v, s)
        nxt = sample(qwen3.lm_head(t_params, res.hidden), temperature, state.generator)[0, 0]
        state.output_ids[0, s + 1] = nxt
        if stop_token_ids:  # host read only when there is something to stop on
            state.done = any(t in stop_token_ids for t in torch.stack([nxt, tok[0, 0]]).tolist())
        state.start = s + 1
    return state


# ---------------------------------------------------------------------------
# Host-level engine
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SpecEngine:
    """Single-request speculative / AR generation.

    Prompts are padded to ``prompt_bucket`` multiples and the token / cache
    buffers are sized ``prompt_cap + max_new_tokens + block + 1``.  The
    parameters (float, or int8 from ``dflash_tpu_torch.quant``) must already
    live on ``device``; the default is the card, and building on a machine
    without one raises.  ``kv_quant=True`` keeps the target's KV cache in int8.
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
        prefill_chunk: Optional[int] = None,
        mesh=None,
        seq_axis: Optional[str] = None,
    ):
        if prefill_chunk is not None or mesh is not None or seq_axis is not None:
            raise NotImplementedError(
                "prefill_chunk, mesh and seq_axis are not ported to dflash_tpu_torch yet"
            )
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
        self.total_len = self.prompt_cap + self.max_new_tokens + self.block_size + 1

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
        """Cut at max_length, strip mask tokens from the generated region,
        truncate at the first stop token."""
        max_length = prompt_len + self.max_new_tokens
        seq = output_ids[0, :max_length]
        gen = seq[prompt_len:]
        gen = gen[gen != self.dcfg.mask_token_id]
        if self.stop_token_ids:
            hits = np.nonzero(np.isin(gen, list(self.stop_token_ids)))[0]
            if hits.size > 0:
                gen = gen[: hits[0] + 1]
        return np.concatenate([seq[:prompt_len], gen])[None, :]

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
        if top_k > 0 or top_p < 1.0:
            raise NotImplementedError("top-k / top-p filters are not ported to dflash_tpu_torch yet")
        ids, prompt_len, _ = self._pad_prompt(input_ids)
        max_length = prompt_len + self.max_new_tokens

        t0 = time.perf_counter()
        state = _prefill_impl(
            self.t_params, self.d_params, ids, prompt_len, temperature,
            self._generator(temperature, seed), tcfg=self.tcfg, dcfg=self.dcfg,
            total_len=self.total_len, kv_quant=self.kv_quant,
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
            forced_acc=forced_acc,
        )
        _sync(self.device)
        decode_wall = time.perf_counter() - t1
        return self._result(state.output_ids, prompt_len, ttft, decode_wall, state.acc_trace)

    def ar_generate(self, input_ids: np.ndarray, temperature: float = 0.0, seed: int = 0) -> GenerationResult:
        ids, prompt_len, _ = self._pad_prompt(input_ids)
        max_length = prompt_len + self.max_new_tokens

        t0 = time.perf_counter()
        state = _ar_prefill(
            self.t_params, ids, prompt_len, temperature, self._generator(temperature, seed),
            tcfg=self.tcfg, total_len=self.total_len, mask_token_id=self.dcfg.mask_token_id,
            kv_quant=self.kv_quant,
        )
        _sync(self.device)
        ttft = time.perf_counter() - t0

        t1 = time.perf_counter()
        state = _ar_decode(
            self.t_params, state, max_length, temperature,
            tcfg=self.tcfg, stop_token_ids=frozenset(self.stop_token_ids),
        )
        _sync(self.device)
        decode_wall = time.perf_counter() - t1
        return self._result(state.output_ids, prompt_len, ttft, decode_wall, None)
