"""Continuous batching engine: R request lanes decoded together, requests
admitted into free lanes while the others decode and retired as they finish.
Port of ``dflash_tpu/engine/batching.py`` (``EngineConfig``, ``Request``,
``ContinuousBatchingEngine``, ``BucketSpec``, ``BucketedEngine``).

The lanes are one ``LaneState`` (``spec/engine.py``); every window runs
``spec/batched.py``'s ``batched_cycles`` over all of them, each lane at its
own frontier, temperature and top-k / top-p, and finished or idle lanes
freeze (an idle lane is ``done`` with ``max_length`` 0, so it never counts
as active).  Admission writes a prefilled request's state into lane j of
the running state: the caches at axis 1, everything else at axis 0, as JAX's
donated ``_admit`` does.  Everything runs in order on one CUDA stream, so the
admission writes land after the last window's kernels.  Lanes never interact,
so a request's tokens do not depend on its lane or its neighbours.

Admission routes, as in JAX (``_admit_pending``):
  * one request alone (``_prefill_impl``, the single-request prefill), or
    resumed from the prompt-prefix cache (``prefix_cache_mb``,
    ``engine/prefix_cache.py``: cached rows plus one suffix forward);
  * ``batch_admission``: a burst of requests with equal (temperature, top_k,
    top_p) in one ``spec/batched.batched_prefill`` and one multi-lane write
    (``_admit_many``); each request samples from its own generator, so a
    seeded request gets the same tokens alone or in a group.  Not with the
    prefix cache (the group prefill has no resume path);
  * ``prefill_ahead``: while every lane is busy, queued requests are
    prefilled into staged single states between windows and admitted by a
    lane write when a lane frees;
  * ``admission_chunk``: a long prompt's prefix is prefilled
    ``admission_chunk`` tokens per window into a scratch cache, its lane
    reserved (idle until bound), then admitted through the prefix resume;
  * ``prefill_worker`` (``engine/disagg.py``): a long prompt's prefix is
    prefilled by the worker's thread and admitted through the prefix resume
    when the handoff lands.

Where the port differs in form: the lane loop reads every lane's frontier
back once per cycle (``LaneState.refresh``), so a window of
``steps_per_sync`` cycles syncs that many times and ``overlap=True`` hides
nothing in eager PyTorch; it is kept, with JAX's lane epochs, and gives the
same tokens as ``overlap=False``.  For the same reason prefill-ahead's
staging runs in the loop's one stream and hides nothing behind the decode.
A window stops early once no lane is active (``cycle_count`` counts the
cycles run).  A group admission prefills exactly its k requests, where JAX
pads the group to a power of two so that it compiles fewer executables (the
tokens are the same).  Admission writes lanes in place, where JAX donates
the whole state: a write that fails partway leaves the lanes it touched
half-written but never active (their ``max_length`` stays 0 until the
request is bound), and they are set back to idle; only if that fails too is
the lane state lost (``_EngineStateLost``: the active requests fail, the
state is rebuilt, the engine keeps serving).  Sampled requests draw from a
``torch.Generator`` per lane on the engine's device, seeded from the
request's ``seed``, or else from :func:`request_seed` of the engine seed and
the request id: the same distribution as JAX's per-request PRNG keys, not
the same tokens; a seed gives the same tokens in any lane, admission order
or route.

Threads: only the thread that steps the engine (the ``start`` loop, or the
caller of ``step`` / ``run_until_drained``) touches the lane state;
``submit`` and ``abort`` only enqueue or mark, ``flush`` from another thread
runs on the loop thread, and a prefill worker's thread touches only its own
tensors until its handoff is polled.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dflash_tpu_torch.cache.kv import AnyKVCache, init_kv_cache, init_quant_kv_cache
from dflash_tpu_torch.core.config import DraftConfig, ModelConfig
from dflash_tpu_torch.engine.prefix_cache import PrefixCache, PrefixEntry
from dflash_tpu_torch.ops.sampling import GREEDY_TEMP_EPS
from dflash_tpu_torch.spec import batched as sb
from dflash_tpu_torch.spec.batched import batched_cycles
from dflash_tpu_torch.spec.engine import (
    LaneState,
    LoopState,
    SamplingFilters,
    _prefill_chunk_impl,
    _prefill_from_prefix_impl,
    _prefill_impl,
)


@dataclass
class EngineConfig:
    """The JAX package's fields and defaults (see its comments for the
    measurements behind them, which were taken on a TPU)."""

    num_lanes: int = 4
    max_new_tokens: int = 256
    block_size: int = 16
    prompt_cap: int = 512
    prompt_bucket: int = 128
    stop_token_ids: Tuple[int, ...] = ()
    temperature: float = 0.0
    seed: int = 0
    kv_quant: bool = False  # int8 KV cache
    # cycles per window: the host retires and admits every steps_per_sync cycles
    steps_per_sync: int = 4
    # size each window to the earliest predicted lane finish while requests
    # wait (power-of-two sizes up to steps_per_sync)
    adaptive_window: bool = False
    # admit a burst of requests with equal sampling params in one batched
    # prefill and one multi-lane write
    batch_admission: bool = False
    # prompt-prefix cache budget (MiB of prefix rows and taps); 0 disables
    prefix_cache_mb: int = 0
    # dispatch window N, then harvest window N - pipeline_depth's peek
    overlap: bool = True
    pipeline_depth: int = 1
    # per-request top-k / top-p; without it, requests with filters that are
    # not no-ops are refused at submit()
    sampling_filters: bool = False
    # candidate pool of the filtered sampler: it only seeds the threshold
    # search, the keep set is exact for any top_k (a wider one refines)
    topk_pool: int = 64
    # streaming / stop-string lanes read the output buffer every
    # stream_interval-th window (finishing and aborted lanes always)
    stream_interval: int = 4
    # chunk-interleaved admission: a long prompt's prefix prefills this many
    # tokens per window, between decode windows; None disables
    admission_chunk: Optional[int] = None
    admission_chunks_per_step: int = 1  # chunk forwards per window, all tasks
    # prefill up to this many queued requests while every lane is busy
    # (each staged state holds a full total_len cache); 0 disables
    prefill_ahead: int = 0
    # at most this many admissions (prefills) per scheduling window; None: no cap
    max_admissions_per_step: Optional[int] = None
    # benchmark-only: force each lane's acceptance to a pattern of mean tau
    # (random-weight drafts accept ~1 token a cycle)
    emulate_tau: Optional[float] = None


@dataclass
class Request:
    rid: int
    input_ids: np.ndarray  # [P] int32
    max_new_tokens: int
    temperature: float
    top_k: int = 0  # <= 0 disables
    top_p: float = 1.0  # >= 1 disables
    # sampling seed: None derives one from the engine seed and the rid; an
    # explicit seed gives the same tokens whatever the lane or admission order
    seed: Optional[int] = None
    # generation halts when one appears in the decoded text; the match is
    # excluded from the output (checked once per serviced window)
    stop_strings: Tuple[str, ...] = ()
    scanned_tokens: int = 0  # generated tokens already scanned clean of stop strings
    submitted_at: float = field(default_factory=time.perf_counter)
    # streaming: {"token_ids": [...], "finished": False} per serviced window,
    # then one item with finished=True and meta_info
    stream_queue: Optional["queue.Queue"] = None
    streamed: int = 0  # generated tokens already pushed to stream_queue
    # filled on completion:
    output_ids: Optional[np.ndarray] = None
    meta_info: Optional[dict] = None
    error: Optional[str] = None  # per-request failure, surfaced not fatal
    done_event: threading.Event = field(default_factory=threading.Event)


class _GroupPrefillError(RuntimeError):
    """A group admission failed and left every lane as it was (idle): the
    caller may retry the requests one at a time."""


class _EngineStateLost(RuntimeError):
    """A group admission's lane write failed and the lanes it touched could
    not be set back to idle: the lane state can no longer be trusted.  The
    engine fails the active requests and rebuilds an empty state
    (``_recover_lost_state``); it keeps serving."""


@dataclass
class _PrefillTask:
    """An in-flight chunk-interleaved admission: the prompt prefix [0, p0)
    is prefilled chunk by chunk between decode windows into a scratch cache
    of its own; when it is done the request is admitted through the prefix
    resume."""

    req: "Request"
    lane: int
    padded: np.ndarray  # [1, Pb] bucket-padded prompt ids
    scratch_kv: AnyKVCache  # [L, 1, Pb, ...]
    taps_buf: torch.Tensor  # [1, Pb, n_taps * H]
    c0: int  # next chunk start (a multiple of the chunk)
    p0: int  # the prefix: the largest chunk multiple <= prompt_len - 1


def request_seed(engine_seed: int, rid: int) -> int:
    """The sampling seed of a request without its own: 63 bits of numpy's
    ``SeedSequence((engine_seed, rid))``, unique per request id."""
    return int(np.random.SeedSequence((engine_seed, rid)).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _admit(state: LaneState, lane: int, single: LoopState) -> None:
    """Write a single-request state into lane ``lane`` of ``state``, in place:
    the whole small state (tokens, frontier, flags, trace, generator) at axis
    0 and every cache tensor (int8 rows and scales under ``kv_quant``) at
    axis 1, so nothing of the lane's previous request survives."""
    state.output_ids[lane] = single.output_ids[0]
    state.start[lane] = single.start
    state.done[lane] = single.done
    state.cycle_idx[lane] = single.cycle_idx
    state.acc_trace[lane] = 0
    state.generators[lane] = single.generator
    for full, one in zip((*state.t_kv, *state.d_kv), (*single.t_kv, *single.d_kv)):
        full[:, lane] = one[:, 0]
    state.features[lane] = single.features[0]
    state.host_start[lane] = single.start
    state.host_done[lane] = single.done
    state.host_cycle_idx[lane] = single.cycle_idx


def _lane_view(group: LaneState, j: int) -> LoopState:
    """Lane ``j`` of a batched prefill's state as a single-request state
    (views: the lane axis kept with one row)."""
    one = lambda cache: type(cache)(*(x[:, j:j + 1] for x in cache))  # noqa: E731
    return LoopState(output_ids=group.output_ids[j:j + 1], start=int(group.host_start[j]), done=False,
                     cycle_idx=0, acc_trace=[], generator=group.generators[j] if group.generators else None,
                     t_kv=one(group.t_kv), d_kv=one(group.d_kv), features=group.features[j:j + 1])


def _admit_many(state: LaneState, lanes: Sequence[int], group: LaneState) -> None:
    """Write rows 0 .. k-1 of a group prefill into ``lanes`` (JAX's
    one-dispatch ``_admit_many``; here k in-place lane writes)."""
    for j, lane in enumerate(lanes):
        _admit(state, lane, _lane_view(group, j))


def _idle_lanes(state: LaneState, lanes: Sequence[int]) -> None:
    """Set ``lanes`` back to idle (``done``; their ``max_length`` is 0 while
    no request is bound), after a lane write failed partway."""
    for lane in lanes:
        state.done[lane] = True
        state.host_done[lane] = True


def _peek(state: LaneState) -> tuple:
    """What the scheduler needs to retire lanes, as copies the next window
    cannot overwrite: start, done and cycle_idx from the host mirrors (equal
    to the device values after every cycle and every admission), output_ids
    and acc_trace as device copies."""
    return (state.host_start.copy(), state.host_done.copy(), state.host_cycle_idx.copy(),
            state.output_ids.clone(), state.acc_trace.clone())


class ContinuousBatchingEngine:
    """Host scheduler around the batched speculative cycle.

    Use either synchronously (``submit`` + ``run_until_drained``) or as a
    background loop (``start``/``stop``) serving concurrent callers.  The
    parameters must live on ``device`` (the card by default; building on a
    machine without one raises).
    """

    def __init__(self, tcfg: ModelConfig, dcfg: DraftConfig, t_params, d_params,
                 cfg: EngineConfig, tokenizer=None, prefill_worker=None,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("ContinuousBatchingEngine(device='cuda'): no CUDA device; "
                                   "pass device='cpu' to run on the CPU")
            if self.device.index is None:  # the loop thread sets it as its current device
                self.device = torch.device("cuda", torch.cuda.current_device())
        for name, params in (("t_params", t_params), ("d_params", d_params)):
            where = params["final_norm"].device
            if where.type != self.device.type:
                raise ValueError(f"{name} live on {where}, the engine runs on {self.device}")
        self.tcfg, self.dcfg = tcfg, dcfg
        self.t_params, self.d_params = t_params, d_params
        self.cfg = cfg
        self.tokenizer = tokenizer  # needed only for stop-string requests
        # disaggregated prefill (engine/disagg.py): long admissions' prefix
        # forwards run on the worker, and come back as (kv_rows, taps) for
        # the prefix resume
        self._disagg = prefill_worker
        self._disagg_pending = 0
        if prefill_worker is not None:
            if prefill_worker.kv_quant != cfg.kv_quant:
                raise ValueError("prefill_worker.kv_quant must match EngineConfig.kv_quant "
                                 "(handoff rows are in the cache's own representation)")
            if prefill_worker.decode_device != self.device:
                raise ValueError(f"prefill_worker ships rows to {prefill_worker.decode_device}, "
                                 f"the engine runs on {self.device}")
        R = cfg.num_lanes
        self.total_len = cfg.prompt_cap + cfg.max_new_tokens + cfg.block_size + 1
        self.max_cycles = cfg.max_new_tokens

        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._lane_req: List[Optional[Request]] = [None] * R
        # idle lanes: max_length 0 (never active), greedy, filters off
        self._lane_max_length = np.zeros((R,), np.int64)
        self._lane_prompt_len = np.zeros((R,), np.int64)
        self._lane_temp = np.zeros((R,), np.float32)
        self._lane_top_k = np.zeros((R,), np.int64)
        self._lane_top_p = np.ones((R,), np.float32)
        # overlap: oldest-first peeks of the windows in flight, each with the
        # lane epochs at its dispatch (a lane re-admitted since is skipped)
        self._peek_pending: deque = deque()
        self._window_count = 0  # harvested windows (stream_interval cadence)
        self._lane_epoch = np.zeros((R,), np.int64)
        self._last_start_host: Optional[np.ndarray] = None
        self._rid = itertools.count()
        # chunk-interleaved admissions in flight and their reserved lanes
        self._prefill_tasks: List[_PrefillTask] = []
        self._lane_reserved: set = set()
        # prefill-ahead: (request, prefilled single state) pairs staged while
        # every lane was busy, admitted the moment a lane frees
        self._staged: List[tuple] = []
        self._aborted: set = set()  # rids to force-finish at the next harvest
        # rids popped from the queue but not yet bound to a lane (abort sees them)
        self._pending_admit: set = set()
        self._abort_lock = threading.Lock()
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._calls: "queue.Queue[tuple]" = queue.Queue()  # work for the loop thread
        self.completed: Dict[int, Request] = {}
        self.cycle_count = 0

        self._forced_acc = None
        if cfg.emulate_tau is not None:
            rng = np.random.default_rng(0)
            lo = int(np.floor(cfg.emulate_tau))
            taus = np.where(rng.random(self.max_cycles) < cfg.emulate_tau - lo, lo + 1, lo)
            self._forced_acc = np.clip(taus, 1, cfg.block_size).astype(np.int64) - 1
        self._set_windows(cfg.steps_per_sync)
        # running estimate of tokens per cycle, for the adaptive window
        self._tau_est = max(1.0, cfg.block_size / 2)
        self._prefix_cache: Optional[PrefixCache] = None
        if cfg.prefix_cache_mb > 0:
            self._prefix_cache = PrefixCache(cfg.prefix_cache_mb * (1 << 20), cfg.prompt_bucket)
        self._state = self._empty_state(R)

    def _set_windows(self, steps_per_sync: int) -> None:
        """The window sizes: steps_per_sync, and with the adaptive window the
        powers of two below it."""
        self._max_window = max(1, steps_per_sync)
        sizes = {self._max_window}
        n = 1
        while self.cfg.adaptive_window and n < self._max_window:
            sizes.add(n)
            n *= 2
        self._windows = sorted(sizes)

    def set_steps_per_sync(self, n: int) -> None:
        """Change the window size on a live, idle engine (for A/B runs on one
        engine)."""
        if any(r is not None for r in self._lane_req) or self._peek_pending:
            raise RuntimeError("set_steps_per_sync needs an idle engine")
        self.cfg = dataclasses.replace(self.cfg, steps_per_sync=int(n))
        self._set_windows(int(n))

    # -- state management ---------------------------------------------------

    def _empty_state(self, R: int) -> LaneState:
        """Every lane idle: ``done``, frontier 0, mask tokens, zero caches."""
        dtype = self.t_params["embed"].dtype
        if dtype not in (torch.bfloat16, torch.float32):
            dtype = torch.bfloat16
        T, dev = self.total_len, self.device
        t_kv = (init_quant_kv_cache(self.tcfg, R, T, dev) if self.cfg.kv_quant
                else init_kv_cache(self.tcfg, R, T, dtype, dev))
        return LaneState(
            output_ids=torch.full((R, T), self.dcfg.mask_token_id, dtype=torch.long, device=dev),
            start=torch.zeros(R, dtype=torch.int32, device=dev),
            done=torch.ones(R, dtype=torch.bool, device=dev),
            cycle_idx=torch.zeros(R, dtype=torch.int32, device=dev),
            acc_trace=torch.zeros((R, self.max_cycles), dtype=torch.int32, device=dev),
            generators=[None] * R,
            t_kv=t_kv,
            d_kv=init_kv_cache(self.dcfg.model, R, T, dtype, dev),
            features=torch.zeros((R, T, self.dcfg.num_taps * self.tcfg.hidden_size), dtype=dtype, device=dev),
            host_start=np.zeros(R, np.int64), host_done=np.ones(R, bool), host_cycle_idx=np.zeros(R, np.int64),
        )

    # -- public API ---------------------------------------------------------

    def submit(self, input_ids: np.ndarray, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None, top_k: int = 0,
               top_p: float = 1.0, stop: Optional[Sequence[str]] = None,
               stream: bool = False, seed: Optional[int] = None) -> Request:
        input_ids = np.asarray(input_ids).reshape(-1)
        if input_ids.shape[0] > self.cfg.prompt_cap:
            raise ValueError(f"prompt length {input_ids.shape[0]} exceeds prompt_cap {self.cfg.prompt_cap}")
        stop_strings = (stop,) if isinstance(stop, str) else tuple(stop or ())
        if stop_strings and self.tokenizer is None:
            raise ValueError("stop strings need an engine tokenizer")
        temperature = self.cfg.temperature if temperature is None else temperature
        if top_k == 1:
            # argmax over one candidate == greedy; normalize so the common
            # serving-client default (T=0, top_k=1, top_p=1) needs no filters
            temperature, top_k, top_p = 0.0, 0, 1.0
        if temperature == 0.0:
            top_k, top_p = 0, 1.0  # greedy ignores filters
        if not self.cfg.sampling_filters and (top_k > 0 or top_p < 1.0):
            raise ValueError("request has top_k/top_p but the engine was built with sampling_filters=False")
        # any top_k below the vocabulary is served exactly: the pool only
        # seeds the threshold search, a top_k beyond it refines
        if top_k >= self.tcfg.vocab_size:
            top_k = 0  # keep-everything == filter off
        req = Request(
            rid=next(self._rid),
            input_ids=input_ids.astype(np.int32),
            max_new_tokens=min(max_new_tokens or self.cfg.max_new_tokens, self.cfg.max_new_tokens),
            temperature=temperature,
            top_k=int(top_k),
            top_p=float(top_p),
            stop_strings=stop_strings,
            stream_queue=queue.Queue() if stream else None,
            seed=seed,
        )
        self._queue.put(req)
        return req

    def abort(self, rid: int) -> bool:
        """Cancel a request: a queued one never runs; an active one (or one
        being admitted) is force-finished at the next harvest with its
        committed tokens and ``finish_reason {"type": "abort"}``.  Returns
        False for unknown or completed rids."""
        with self._abort_lock:
            drained: List[Request] = []
            hit = False
            while True:
                try:
                    r = self._queue.get_nowait()
                except queue.Empty:
                    break
                if r.rid == rid:
                    hit = True
                    r.error = "aborted before admission"
                    r.meta_info = {"error": r.error, "finish_reason": {"type": "abort"}}
                    self.completed[rid] = r
                    if r.stream_queue is not None:
                        r.stream_queue.put({"token_ids": [], "finished": True, "meta_info": r.meta_info})
                    r.done_event.set()
                else:
                    drained.append(r)
            for r in drained:
                self._queue.put(r)
            if hit:
                return True
            if any(r is not None and r.rid == rid for r in self._lane_req) or rid in self._pending_admit:
                self._aborted.add(rid)
                return True
            return False

    def step(self) -> int:
        """Land finished disaggregated prefills, admit waiting requests into
        free lanes, run one window of ``steps_per_sync`` cycles, advance the
        chunked admissions and stage prefill-ahead requests behind it, retire
        finished requests.  Returns the active lanes plus the admissions in
        flight (chunk tasks, staged requests, worker prefills).  With
        ``cfg.overlap`` the harvest reads the window ``pipeline_depth`` back
        (JAX's overlapped scheduler: retire and admit decisions lag, tokens
        do not change, since a finished lane freezes)."""
        self._drain_disagg()
        self._admit_pending()
        n_active = sum(r is not None for r in self._lane_req)
        if n_active == 0 and self._disagg_pending and not self._prefill_tasks:
            # only the worker has work: yield instead of spinning on the poll
            time.sleep(0.001)
        if not self.cfg.overlap:
            if n_active == 0:
                self._step_prefill_tasks()
                return self._in_flight()
            self._dispatch_window()
            self._step_prefill_tasks()
            self._stage_pending()
            self._retire_finished()
            return n_active + self._in_flight()
        new_peek = None
        if n_active:
            self._dispatch_window()
            new_peek = (_peek(self._state), self._lane_epoch.copy())
        # admission chunks and prefill-ahead run behind the window
        self._step_prefill_tasks()
        self._stage_pending()
        if new_peek is not None:
            self._peek_pending.append(new_peek)
            while len(self._peek_pending) > max(1, self.cfg.pipeline_depth):
                self._harvest(self._peek_pending.popleft())
        else:
            # nothing dispatched: drain the windows in flight so finished
            # lanes retire when the engine goes idle
            while self._peek_pending:
                self._harvest(self._peek_pending.popleft())
        return n_active + self._in_flight()

    def _in_flight(self) -> int:
        """Admissions under way outside the lanes."""
        return len(self._prefill_tasks) + self._disagg_pending + len(self._staged)

    def _dispatch_window(self) -> None:
        window = self._pick_window()
        filters = None
        if self.cfg.sampling_filters:
            filters = SamplingFilters(top_k=self._lane_top_k.copy(), top_p=self._lane_top_p.copy())
        before = self._state.host_cycle_idx.copy()
        batched_cycles(
            self._state, self.t_params, self.d_params, self._lane_temp.tolist(), self._lane_max_length.copy(),
            tcfg=self.tcfg, dcfg=self.dcfg, block_size=self.cfg.block_size,
            stop_token_ids=tuple(self.cfg.stop_token_ids), n_steps=window, forced_acc=self._forced_acc,
            filters=filters, topk_pool=self.cfg.topk_pool,
        )
        # within a window lanes only freeze, so the longest-running lane ran
        # in every cycle of it
        self.cycle_count += int((self._state.host_cycle_idx - before).max())

    def _harvest(self, pending: tuple) -> None:
        """Retire lanes from a window's peek (overlap: a window or more
        stale; sync mode passes the live state through the same path).  Lanes
        re-admitted since the peek are skipped.  Streaming and stop-string
        lanes are serviced every stream_interval-th window, and always in the
        window they finish or are aborted in."""
        (start, done, cycle_idx, output_ids_d, acc_trace_d), epochs = pending
        fresh = epochs == self._lane_epoch
        self._window_count += 1
        service_window = self._window_count % max(1, self.cfg.stream_interval) == 0
        if self._last_start_host is None:
            self._last_start_host = np.where(fresh, start, 0)
        else:
            self._last_start_host = np.where(fresh, start, self._last_start_host)
        out_h = acc_h = None
        for lane in range(self.cfg.num_lanes):
            req = self._lane_req[lane]
            if req is None or not fresh[lane]:
                continue
            finished = bool(done[lane] or start[lane] >= self._lane_max_length[lane])
            aborted = req.rid in self._aborted
            needs_scan = bool((req.stop_strings or req.stream_queue is not None)
                              and (service_window or finished or aborted))
            if not (finished or needs_scan or aborted):
                continue
            if out_h is None:  # one read of each buffer for every lane of this harvest
                out_h = output_ids_d.cpu().numpy()
                acc_h = acc_trace_d.cpu().numpy()
            n_cycles = int(cycle_idx[lane])
            if aborted:
                self._aborted.discard(req.rid)
                gen = self._committed_gen(lane, req, int(start[lane]), out_h[lane])
                self._push_stream(req, gen)
                seq = np.concatenate([req.input_ids, gen]).astype(np.int32)
                self._complete(lane, req, seq, n_cycles, acc_h[lane][:n_cycles], {"type": "abort"})
                continue
            if needs_scan and self._service_lane(lane, req, int(start[lane]), out_h[lane], n_cycles,
                                                 acc_h[lane][:n_cycles]):
                continue  # force-finished on a stop-string hit
            if finished:
                self._finish(lane, req, out_h[lane], n_cycles, acc_h[lane][:n_cycles])

    def _pick_window(self) -> int:
        """Cycles of the next window.  With requests queued and the adaptive
        window on, the smallest size covering the earliest predicted lane
        finish, so the freed lane is refilled promptly; else the full
        window."""
        if not self.cfg.adaptive_window or self._queue.empty():
            return self._max_window
        if self.cfg.overlap:
            if self._last_start_host is None:
                return self._max_window
            start = self._last_start_host
        else:
            start = self._state.host_start
        need = None
        for lane, req in enumerate(self._lane_req):
            if req is None:
                continue
            remaining = max(1, int(self._lane_max_length[lane]) - int(start[lane]))
            cycles = int(np.ceil(remaining / max(1.0, self._tau_est)))
            need = cycles if need is None else min(need, cycles)
        if need is None:
            return self._max_window
        return next((n for n in self._windows if n >= need), self._max_window)

    def _free_lanes(self) -> List[int]:
        return [lane for lane in range(self.cfg.num_lanes)
                if self._lane_req[lane] is None and lane not in self._lane_reserved]

    def _admit_pending(self) -> None:
        # staged prefill-ahead states admit first: one lane write each
        for lane in self._free_lanes():
            while self._staged:
                req, single = self._staged.pop(0)
                if req.rid in self._aborted:
                    self._complete_aborted_admission(req)
                    continue  # the lane is still free: try the next staged
                _admit(self._state, lane, single)
                self._bind_lane(lane, req)
                break
        free = self._free_lanes()
        if self.cfg.max_admissions_per_step is not None:
            free = free[: max(1, self.cfg.max_admissions_per_step)]
        reqs: List[Request] = []
        with self._abort_lock:  # pop + register atomically against abort()'s scan
            while len(reqs) < len(free):
                try:
                    r = self._queue.get_nowait()
                except queue.Empty:
                    break
                reqs.append(r)
                self._pending_admit.add(r.rid)
        # a burst with equal sampling params is one group: one batched
        # prefill and one multi-lane write (not with the prefix cache, which
        # the group prefill would bypass)
        grouping = self.cfg.batch_admission and self._prefix_cache is None
        sp = lambda r: (r.temperature, r.top_k, r.top_p)  # noqa: E731
        i = 0
        while i < len(reqs):
            group = [reqs[i]]
            while grouping and i + len(group) < len(reqs) and sp(reqs[i + len(group)]) == sp(group[0]):
                group.append(reqs[i + len(group)])
            lanes, free = free[:len(group)], free[len(group):]
            if len(group) > 1:
                try:
                    self._admit_group(lanes, group)
                    i += len(group)
                    continue
                except _GroupPrefillError:
                    pass  # every lane idle again: admit the requests one at a time below
                except _EngineStateLost as e:
                    self._recover_lost_state(group, reqs[i + len(group):], str(e))
                    return
            # a bad request (a prefill that raises) fails alone and is
            # surfaced on the request; the other lanes keep serving
            for lane, req in zip(lanes, group):
                try:
                    p0_disagg = self._disagg_prefix(req)
                    if p0_disagg:
                        self._start_disagg(lane, req, p0_disagg)
                    elif self._chunk_prefix(req):
                        self._start_prefill_task(lane, req)
                    else:
                        self._admit_request(lane, req)
                except Exception as e:  # noqa: BLE001 — isolate per-request faults
                    self._fail_request(req, f"{type(e).__name__}: {e}")
            i += len(group)

    def _disagg_prefix(self, req: Request) -> int:
        """The prefix the prefill worker would take (whole prompt buckets
        below the last prompt row), 0 when the request does not go to it."""
        if self._disagg is None:
            return 0
        g = self.cfg.prompt_bucket
        p0 = ((len(req.input_ids) - 1) // g) * g
        return p0 if p0 >= g else 0

    def _chunk_prefix(self, req: Request) -> int:
        """The prefix chunked admission would prefill (whole chunks below the
        last prompt row), 0 when the request is not chunked."""
        chunk = self.cfg.admission_chunk
        if chunk is None:
            return 0
        return ((len(req.input_ids) - 1) // chunk) * chunk

    def _plain_path(self, req: Request) -> bool:
        """True when admission would run the one-request prefill (neither the
        prefill worker nor the chunked route takes it)."""
        return not (self._disagg_prefix(req) or self._chunk_prefix(req))

    def _complete_aborted_admission(self, req: Request) -> None:
        """A request aborted while its prefill was under way (staged, chunk
        task or worker): complete it with the abort finish_reason before it
        ever touches a lane."""
        with self._abort_lock:
            self._aborted.discard(req.rid)
            self._pending_admit.discard(req.rid)
        req.error = "aborted before admission"
        req.meta_info = {"error": req.error, "finish_reason": {"type": "abort"}}
        self.completed[req.rid] = req
        if req.stream_queue is not None:
            req.stream_queue.put({"token_ids": [], "finished": True, "meta_info": req.meta_info})
        req.done_event.set()

    def _fail_request(self, req: Request, msg: str) -> None:
        """Surface a per-request failure: error recorded, stream consumers
        unblocked, waiters released; the engine keeps serving."""
        req.error = msg
        req.meta_info = {"error": req.error}
        self.completed[req.rid] = req
        with self._abort_lock:
            self._pending_admit.discard(req.rid)
            self._aborted.discard(req.rid)
        if req.stream_queue is not None:
            req.stream_queue.put({"token_ids": [], "finished": True, "meta_info": req.meta_info})
        req.done_event.set()

    def _recover_lost_state(self, failed: List[Request], requeue: List[Request], cause: str) -> None:
        """Rebuild after ``_EngineStateLost``: every active request and the
        group fail (their lanes cannot be trusted), the requests whose
        prefill had not started go back to the queue, the lane epochs move
        on (a peek of the old state is ignored), and a fresh empty state
        replaces the old one; the engine keeps serving."""
        victims = list(failed) + [r for r in self._lane_req if r is not None]
        for req in victims:
            self._fail_request(req, f"engine state lost during admission: {cause}")
        with self._abort_lock:
            for req in requeue:
                self._pending_admit.discard(req.rid)
                self._queue.put(req)
        self._lane_req = [None] * self.cfg.num_lanes
        # every lane idle: never active, greedy, filters off
        self._lane_max_length[:] = 0
        self._lane_temp[:] = 0.0
        self._lane_top_k[:] = 0
        self._lane_top_p[:] = 1.0
        self._lane_epoch += 1
        self._peek_pending.clear()
        self._last_start_host = None
        self._state = None  # release the old buffers before allocating new ones
        self._state = self._empty_state(self.cfg.num_lanes)

    def _prompt_bucket(self, prompt_len: int) -> int:
        """Smallest prompt_bucket multiple covering prompt_len, capped."""
        g = self.cfg.prompt_bucket
        return min(self.cfg.prompt_cap, ((max(prompt_len, 1) + g - 1) // g) * g)

    def _padded(self, req: Request) -> np.ndarray:
        """The prompt padded to its bucket, [1, Pb] int64."""
        P = len(req.input_ids)
        padded = np.zeros((1, self._prompt_bucket(P)), np.int64)
        padded[0, :P] = req.input_ids
        return padded

    def _admit_group(self, lanes: List[int], reqs: List[Request]) -> None:
        """Prefill ``k`` requests with equal sampling params in one batched
        prefill (exactly k rows, padded to the bucket of the longest) and
        write them into ``lanes``.  Each request samples its first token
        from its own generator.  Raises :class:`_GroupPrefillError` when the
        prefill or a lane write fails and every touched lane is idle again,
        :class:`_EngineStateLost` when the lanes could not be set back."""
        try:
            padded = np.zeros((len(reqs), self._prompt_bucket(max(len(r.input_ids) for r in reqs))), np.int64)
            for j, req in enumerate(reqs):
                padded[j, :len(req.input_ids)] = req.input_ids
            group = sb.batched_prefill(
                self.t_params, self.d_params, padded, [len(r.input_ids) for r in reqs], reqs[0].temperature,
                [self._req_seed(r) for r in reqs], tcfg=self.tcfg, dcfg=self.dcfg, total_len=self.total_len,
                max_cycles=self.max_cycles, kv_quant=self.cfg.kv_quant, filters=self._req_filters(reqs[0]),
                topk_pool=self.cfg.topk_pool)
        except Exception as e:  # noqa: BLE001 — nothing written yet: retry one at a time
            raise _GroupPrefillError(f"{type(e).__name__}: {e}") from e
        try:
            _admit_many(self._state, lanes, group)
        except Exception as e:  # noqa: BLE001 — classified by whether the lanes could be reset
            try:
                _idle_lanes(self._state, lanes)
            except Exception as lost:  # noqa: BLE001
                raise _EngineStateLost(f"{type(e).__name__}: {e}; then {type(lost).__name__}: {lost}") from lost
            raise _GroupPrefillError(f"{type(e).__name__}: {e}") from e
        for lane, req in zip(lanes, reqs):
            self._bind_lane(lane, req)

    def _req_seed(self, req: Request) -> int:
        """The request's sampling seed: ``req.seed``, else :func:`request_seed`."""
        return int(req.seed) if req.seed is not None else request_seed(self.cfg.seed, req.rid)

    def _req_generator(self, req: Request) -> Optional[torch.Generator]:
        """The request's generator on the engine's device (None when greedy)."""
        if req.temperature < GREEDY_TEMP_EPS:
            return None
        return torch.Generator(device=self.device).manual_seed(self._req_seed(req))

    def _req_filters(self, req: Request) -> Optional[SamplingFilters]:
        """Scalar filters for a request's prefill; None when the engine runs
        without filters (submit() refused every request that needs them)."""
        if not self.cfg.sampling_filters:
            return None
        return SamplingFilters(top_k=req.top_k, top_p=req.top_p)

    def _bind_lane(self, lane: int, req: Request) -> None:
        with self._abort_lock:
            self._pending_admit.discard(req.rid)
        self._lane_req[lane] = req
        self._lane_prompt_len[lane] = len(req.input_ids)
        self._lane_max_length[lane] = len(req.input_ids) + req.max_new_tokens
        self._lane_temp[lane] = req.temperature
        self._lane_top_k[lane] = req.top_k
        self._lane_top_p[lane] = req.top_p
        self._lane_epoch[lane] += 1

    def _prefill_common(self, req: Request) -> dict:
        return dict(tcfg=self.tcfg, dcfg=self.dcfg, total_len=self.total_len, kv_quant=self.cfg.kv_quant,
                    filters=self._req_filters(req), topk_pool=self.cfg.topk_pool)

    def _resume(self, req: Request, padded: np.ndarray, kv_rows: AnyKVCache, taps: torch.Tensor) -> LoopState:
        """The prefix-resume prefill of ``req`` from prefix rows and taps."""
        return _prefill_from_prefix_impl(
            self.t_params, self.d_params, torch.from_numpy(padded).to(self.device), len(req.input_ids),
            kv_rows, taps, req.temperature, self._req_generator(req), **self._prefill_common(req))

    def _publish_prefix(self, req: Request, kv: AnyKVCache, taps: torch.Tensor, n: int) -> None:
        """Insert the prompt's first ``n`` rows, cut to a whole number of
        prompt buckets, into the prefix cache (a copy: the entry owns its
        rows)."""
        if self._prefix_cache is None:
            return
        g = self.cfg.prompt_bucket
        P0 = (n // g) * g
        if P0 >= g:
            self._prefix_cache.insert(req.input_ids, PrefixEntry.copy_of(kv, taps, P0))

    def _compute_single(self, req: Request) -> LoopState:
        """A plain-path admission's prompt prefill: the single-request state
        that admission writes into a lane.  With the prefix cache, a hit
        resumes from the cached rows; a miss publishes its prefix."""
        P = len(req.input_ids)
        padded = self._padded(req)
        hit = self._prefix_cache.lookup(req.input_ids, P - 1) if self._prefix_cache is not None else None
        if hit is not None:
            _, entry = hit
            return self._resume(req, padded, entry.kv_rows, entry.taps)
        single = _prefill_impl(
            self.t_params, self.d_params, torch.from_numpy(padded).to(self.device), P, req.temperature,
            self._req_generator(req), **self._prefill_common(req))
        self._publish_prefix(req, single.t_kv, single.features, P - 1)
        return single

    def _admit_request(self, lane: int, req: Request) -> None:
        single = self._compute_single(req)
        _admit(self._state, lane, single)
        self._bind_lane(lane, req)

    def _stage_pending(self) -> None:
        """Prefill-ahead: while every lane is busy, prefill queued plain-path
        requests into staged single states (at most ``prefill_ahead`` staged,
        two a window, or ``max_admissions_per_step``), so that a freed lane
        is refilled by one lane write."""
        cap = self.cfg.prefill_ahead
        if cap <= 0 or len(self._staged) >= cap or self._free_lanes():
            return
        budget = (max(1, self.cfg.max_admissions_per_step) if self.cfg.max_admissions_per_step is not None
                  else 2)
        while len(self._staged) < cap and budget > 0:
            budget -= 1
            with self._queue.mutex:  # peek the FIFO head without popping
                head = self._queue.queue[0] if self._queue.queue else None
            if head is None or not self._plain_path(head):
                return  # long prompts keep their chunked / worker routes
            with self._abort_lock:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
                self._pending_admit.add(req.rid)
            if not self._plain_path(req):
                # abort() rebuilt the queue in between and another request
                # surfaced: put it back at the front, FIFO kept
                with self._abort_lock:
                    self._pending_admit.discard(req.rid)
                with self._queue.mutex:
                    self._queue.queue.appendleft(req)
                    self._queue.not_empty.notify()
                return
            try:
                self._staged.append((req, self._compute_single(req)))
            except Exception as e:  # noqa: BLE001 — isolate per-request faults
                self._fail_request(req, f"{type(e).__name__}: {e}")

    def _start_disagg(self, lane: int, req: Request, p0: int) -> None:
        """Hand an admission's prefix prefill to the prefill worker: the lane
        is reserved until :meth:`_drain_disagg` lands the handoff."""
        self._lane_reserved.add(lane)
        self._disagg_pending += 1
        self._disagg.submit(req, lane, self._padded(req), p0)

    def _drain_disagg(self) -> None:
        """Admit the finished worker handoffs (rows already on this device)
        through the prefix resume; publish their prefixes."""
        if self._disagg is None:
            return
        for res in self._disagg.poll():
            req = res.req
            self._disagg_pending -= 1
            self._lane_reserved.discard(res.lane)
            if req.rid in self._aborted:
                self._complete_aborted_admission(req)
                continue
            if res.error is not None:
                self._fail_request(req, f"disagg prefill failed: {res.error}")
                continue
            try:
                single = self._resume(req, res.padded, res.kv_rows, res.taps)
                self._publish_prefix(req, res.kv_rows, res.taps, res.p0)
                _admit(self._state, res.lane, single)
                self._bind_lane(res.lane, req)
            except Exception as e:  # noqa: BLE001 — isolate per-request faults
                self._fail_request(req, f"{type(e).__name__}: {e}")

    def _start_prefill_task(self, lane: int, req: Request) -> None:
        """Begin a chunk-interleaved admission: a bucket-sized scratch cache
        (seeded, chunk-aligned, from the prefix cache when it holds a chunk
        of the prompt or more), the lane reserved; ``_step_prefill_tasks``
        advances it between windows."""
        chunk = self.cfg.admission_chunk
        padded = self._padded(req)
        bucket = padded.shape[1]
        p0 = self._chunk_prefix(req)
        dtype = self.t_params["embed"].dtype
        if dtype not in (torch.bfloat16, torch.float32):
            dtype = torch.bfloat16
        scratch = (init_quant_kv_cache(self.tcfg, 1, bucket, self.device) if self.cfg.kv_quant
                   else init_kv_cache(self.tcfg, 1, bucket, dtype, self.device))
        taps_buf = torch.zeros((1, bucket, self.dcfg.num_taps * self.tcfg.hidden_size), dtype=dtype,
                               device=self.device)
        c0 = 0
        hit = self._prefix_cache.lookup(req.input_ids, p0) if self._prefix_cache is not None else None
        if hit is not None:
            n_hit, entry = hit
            n0 = (n_hit // chunk) * chunk  # resume at a chunk boundary
            if n0 >= chunk:
                for buf, rows in zip(scratch, entry.kv_rows):
                    buf[:, :, :n0] = rows[:, :, :n0]
                taps_buf[:, :n0] = entry.taps[:, :n0]
                c0 = n0
        self._lane_reserved.add(lane)
        self._prefill_tasks.append(_PrefillTask(req=req, lane=lane, padded=padded, scratch_kv=scratch,
                                                taps_buf=taps_buf, c0=c0, p0=p0))

    def _step_prefill_tasks(self) -> None:
        """Advance the chunked admissions: ``admission_chunks_per_step``
        chunk forwards in all per window (admission order), finalizing the
        tasks whose prefix is done."""
        if not self._prefill_tasks:
            return
        budget = max(1, self.cfg.admission_chunks_per_step)
        C = self.cfg.admission_chunk
        for task in list(self._prefill_tasks):
            req = task.req
            if req.rid in self._aborted:  # dropped before admission
                self._complete_aborted_admission(req)
                self._lane_reserved.discard(task.lane)
                self._prefill_tasks.remove(task)
                continue
            if budget <= 0:
                break
            try:
                while budget > 0 and task.c0 < task.p0:
                    ids_c = torch.from_numpy(task.padded[:, task.c0:task.c0 + C]).to(self.device)
                    task.scratch_kv, task.taps_buf = _prefill_chunk_impl(
                        self.t_params, task.scratch_kv, task.taps_buf, ids_c, task.c0, tcfg=self.tcfg,
                        tap_ids=self.dcfg.target_layer_ids)
                    task.c0 += C
                    budget -= 1
                if task.c0 >= task.p0:
                    self._finalize_prefill_task(task)
                    self._prefill_tasks.remove(task)
            except Exception as e:  # noqa: BLE001 — isolate per-request faults
                self._fail_request(req, f"{type(e).__name__}: {e}")
                self._lane_reserved.discard(task.lane)
                self._prefill_tasks.remove(task)

    def _finalize_prefill_task(self, task: _PrefillTask) -> None:
        """The prefix is prefilled: admit through the prefix resume (one
        suffix forward) and publish the prefix."""
        rows = type(task.scratch_kv)(*(x[:, :, :task.p0] for x in task.scratch_kv))
        single = self._resume(task.req, task.padded, rows, task.taps_buf[:, :task.p0])
        self._publish_prefix(task.req, task.scratch_kv, task.taps_buf, task.p0)
        _admit(self._state, task.lane, single)
        self._lane_reserved.discard(task.lane)
        self._bind_lane(task.lane, task.req)

    def _retire_finished(self) -> None:
        """Sync-mode retire: the live state through the shared harvest path
        (one bulk read per buffer, not per lane)."""
        st = self._state
        self._harvest(((st.host_start.copy(), st.host_done.copy(), st.host_cycle_idx.copy(), st.output_ids,
                        st.acc_trace), self._lane_epoch.copy()))

    def _committed_gen(self, lane: int, req: Request, start_l: int, out_row: np.ndarray) -> np.ndarray:
        """Committed generated tokens so far: region [P, start] inclusive (row
        start holds the bonus token), mask-stripped, cut after the first
        engine stop token."""
        P = int(self._lane_prompt_len[lane])
        end = min(start_l + 1, P + req.max_new_tokens)
        gen = out_row[P:end]
        gen = gen[gen != self.dcfg.mask_token_id]
        if self.cfg.stop_token_ids:
            hits = np.nonzero(np.isin(gen, list(self.cfg.stop_token_ids)))[0]
            if hits.size > 0:
                gen = gen[: hits[0] + 1]
        return gen

    def _service_lane(self, lane: int, req: Request, start_l: int, out_row: np.ndarray, n_cycles: int,
                      acc: np.ndarray) -> bool:
        """Per-window service of a streaming / stop-string lane: push newly
        committed tokens, scan for stop strings.  Returns True when the lane
        was force-finished on a stop match."""
        gen = self._committed_gen(lane, req, start_l, out_row)
        if req.stop_strings:
            cut, matched = self._find_stop_cut(req, gen)
            if cut is not None:
                gen = gen[:cut]
                self._push_stream(req, gen)
                seq = np.concatenate([req.input_ids, gen]).astype(np.int32)
                self._complete(lane, req, seq, n_cycles, acc, {"type": "stop", "matched": matched})
                return True
        self._push_stream(req, gen)
        return False

    def _find_stop_cut(self, req: Request, gen: np.ndarray):
        """(token_count, matched_string) of the earliest stop-string match in
        the decoded generation, or (None, None): the smallest prefix whose
        decoding contains a stop (the boundary token is kept; the server
        trims the text at the match).  Incremental: each call decodes the new
        tokens plus a max-stop-length overlap, and a hit binary-searches the
        cut (the generation is append-only, so a match is monotone in n)."""
        total = len(gen)
        if total == 0:
            return None, None
        dec = lambda n: self.tokenizer.decode(gen[:n], skip_special_tokens=True)  # noqa: E731
        hit = lambda text: any(s in text for s in req.stop_strings)  # noqa: E731
        # a stop of L chars spans at most L 1-char tokens, +4 of margin for
        # byte-level tokens that decode to partial or empty pieces
        max_stop = max(len(s) for s in req.stop_strings)
        lo = max(0, min(req.scanned_tokens, total) - (max_stop + 4))
        tail = self.tokenizer.decode(gen[lo:], skip_special_tokens=True)
        req.scanned_tokens = total
        if not hit(tail):
            return None, None
        if not hit(dec(total)):
            return None, None  # a tail-only decode artifact, not a real match
        # invariant: not hit(dec(lo)), hit(dec(hi)); restart from 0 if a
        # decode-boundary artifact broke it (stops are non-empty)
        if lo > 0 and hit(dec(lo)):
            lo = 0
        hi = total
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if hit(dec(mid)):
                hi = mid
            else:
                lo = mid
        text = dec(hi)
        matched = min((s for s in req.stop_strings if s in text), key=text.index)
        return hi, matched

    @staticmethod
    def _push_stream(req: Request, gen: np.ndarray) -> None:
        if req.stream_queue is None:
            return
        new = gen[req.streamed:]
        if new.size:
            req.stream_queue.put({"token_ids": np.asarray(new).tolist(), "finished": False})
            req.streamed += int(new.size)

    def _finish(self, lane: int, req: Request, out_row: np.ndarray, n_cycles: int, acc: np.ndarray) -> None:
        P = int(self._lane_prompt_len[lane])
        seq = out_row[:P + req.max_new_tokens]
        # strip masks from the generated region only (a prompt may hold the
        # mask id legitimately)
        gen = seq[P:]
        gen = gen[gen != self.dcfg.mask_token_id]
        finish_reason: dict = {"type": "length", "length": req.max_new_tokens}
        if self.cfg.stop_token_ids:
            hits = np.nonzero(np.isin(gen, list(self.cfg.stop_token_ids)))[0]
            if hits.size > 0:
                gen = gen[: hits[0] + 1]
                finish_reason = {"type": "stop"}
        self._complete(lane, req, np.concatenate([seq[:P], gen]).astype(np.int32), n_cycles, acc, finish_reason)

    def _complete(self, lane: int, req: Request, seq: np.ndarray, n_cycles: int, acc: np.ndarray,
                  finish_reason: dict) -> None:
        P = int(self._lane_prompt_len[lane])
        req.output_ids = seq[None, :]
        req.meta_info = {
            "prompt_tokens": P,
            "completion_tokens": int(seq.shape[0] - P),
            "spec_verify_ct": n_cycles,
            "spec_accept_length": float(acc.mean()) if n_cycles else 0.0,
            "e2e_latency_s": time.perf_counter() - req.submitted_at,
            "finish_reason": finish_reason,
        }
        if n_cycles:
            # refine the tokens-per-cycle estimate of the adaptive window
            self._tau_est = 0.7 * self._tau_est + 0.3 * float(acc.mean())
        self.completed[req.rid] = req
        self._lane_req[lane] = None
        # the lane goes idle: frozen on the device, never active, greedy
        self._state.done[lane] = True
        self._state.host_done[lane] = True
        self._lane_max_length[lane] = 0
        self._lane_temp[lane] = 0.0
        self._lane_top_k[lane] = 0
        self._lane_top_p[lane] = 1.0
        if req.stream_queue is not None:
            tail = seq[P + req.streamed:]
            req.streamed += int(tail.size)
            req.stream_queue.put({"token_ids": np.asarray(tail).tolist(), "finished": True,
                                  "meta_info": req.meta_info})
        req.done_event.set()

    def _idle(self) -> bool:
        return (not self._peek_pending and self._queue.empty() and self._in_flight() == 0
                and all(r is None for r in self._lane_req))

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and self._idle():
                return
        raise RuntimeError("run_until_drained exceeded max_steps")

    # -- background serving loop -------------------------------------------

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError("the engine loop did not stop within 30 s")
            self._thread = None

    def _loop(self) -> None:
        """The serving loop: the only thread that touches device tensors
        while it runs."""
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while self._running:
                self._run_calls()
                with self._lock:
                    active = self.step()
                if active == 0 and self._idle():
                    with self._queue.not_empty:  # wait for a request without taking it
                        if not self._queue._qsize():
                            self._queue.not_empty.wait(timeout=0.05)
        except BaseException as e:
            # a failed window leaves the lanes' state unknown: fail every
            # request the engine holds, then let the thread die with the
            # traceback
            self._running = False
            self._fail_all(f"engine loop failed: {type(e).__name__}: {e}")
            raise

    def _fail_all(self, msg: str) -> None:
        held = ([r for r in self._lane_req if r is not None] + [t.req for t in self._prefill_tasks]
                + [r for r, _ in self._staged])
        self._lane_req = [None] * self.cfg.num_lanes
        self._prefill_tasks, self._staged = [], []
        with self._abort_lock:
            while True:
                try:
                    held.append(self._queue.get_nowait())
                except queue.Empty:
                    break
        for req in held:
            self._fail_request(req, msg)

    def _run_calls(self) -> None:
        while True:
            try:
                fn, fut = self._calls.get_nowait()
            except queue.Empty:
                return
            try:
                with self._lock:
                    fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 — handed to the caller's thread
                fut.set_exception(e)

    def _on_loop(self, fn: Callable):
        """Run ``fn`` on the loop thread when one runs (device work stays
        there), else here; returns its result or raises its exception."""
        thread = self._thread
        if thread is None or not thread.is_alive() or thread is threading.current_thread():
            with self._lock:
                return fn()
        fut: Future = Future()
        self._calls.put((fn, fut))
        with self._queue.not_empty:
            self._queue.not_empty.notify()  # wake an idle loop
        return fut.result(timeout=60)

    def flush(self) -> None:
        """Drop all idle state and the prefix cache (the /flush_cache
        equivalent)."""
        self._on_loop(self._flush_now)

    def _flush_now(self) -> None:
        if any(r is not None for r in self._lane_req) or self._in_flight():
            raise RuntimeError("cannot flush with active requests")
        self._peek_pending.clear()
        self._last_start_host = None
        self._state = None  # release the old buffers before allocating new ones
        self._state = self._empty_state(self.cfg.num_lanes)
        if self._prefix_cache is not None:
            self._prefix_cache.clear()


# ---------------------------------------------------------------------------
# Bucket ladder: per-request total_len right-sizing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BucketSpec:
    """One rung of the ladder: lanes sized for requests up to
    prompt_cap + max_new_tokens tokens."""

    prompt_cap: int
    max_new_tokens: int
    num_lanes: int


class BucketedEngine:
    """A ladder of engine pools with tightly sized token/KV buffers: each
    request goes to the smallest pool whose (prompt_cap, max_new_tokens)
    fits it, so short requests decode against short buffers.  The pools
    share the parameters and one prefix cache; the extra memory is each
    pool's lane state."""

    def __init__(self, tcfg: ModelConfig, dcfg: DraftConfig, t_params, d_params,
                 cfg: EngineConfig, buckets: List[BucketSpec], tokenizer=None,
                 device: str | torch.device = "cuda"):
        if not buckets:
            raise ValueError("need at least one BucketSpec")
        self.buckets = sorted(buckets, key=lambda b: b.prompt_cap + b.max_new_tokens)
        self.pools = [
            ContinuousBatchingEngine(
                tcfg, dcfg, t_params, d_params,
                dataclasses.replace(cfg, num_lanes=b.num_lanes, prompt_cap=b.prompt_cap,
                                    max_new_tokens=b.max_new_tokens, prefix_cache_mb=0),
                tokenizer=tokenizer, device=device,
            )
            for b in self.buckets
        ]
        # one prefix cache shared by every pool: entries are cut to
        # prompt_bucket boundaries, so a prefix prefilled in one pool resumes
        # admissions in all of them, and the flag bounds the whole ladder
        self._prefix_cache: Optional[PrefixCache] = None
        if cfg.prefix_cache_mb > 0:
            self._prefix_cache = PrefixCache(cfg.prefix_cache_mb * (1 << 20), cfg.prompt_bucket)
            for p in self.pools:
                p._prefix_cache = self._prefix_cache
        shared_rid = itertools.count()  # one request-id space across pools
        for p in self.pools:
            p._rid = shared_rid

    def _route(self, prompt_len: int, max_new: int) -> ContinuousBatchingEngine:
        for b, pool in zip(self.buckets, self.pools):
            if prompt_len <= b.prompt_cap and max_new <= b.max_new_tokens:
                return pool
        raise ValueError(f"request (prompt {prompt_len}, max_new {max_new}) exceeds every bucket; "
                         f"largest is {self.buckets[-1]}")

    def submit(self, input_ids: np.ndarray, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None, top_k: int = 0,
               top_p: float = 1.0, stop: Optional[Sequence[str]] = None,
               stream: bool = False, seed: Optional[int] = None) -> Request:
        ids = np.asarray(input_ids).reshape(-1)
        biggest = self.pools[-1]
        max_new = min(max_new_tokens or biggest.cfg.max_new_tokens, biggest.cfg.max_new_tokens)
        pool = self._route(ids.shape[0], max_new)
        return pool.submit(ids, max_new_tokens=max_new, temperature=temperature, top_k=top_k, top_p=top_p,
                           stop=stop, stream=stream, seed=seed)

    def abort(self, rid: int) -> bool:
        # rids are unique across pools (shared counter), so at most one hits
        return any(p.abort(rid) for p in self.pools)

    def step(self) -> int:
        return sum(p.step() for p in self.pools)

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        # round-robin: every pool advances one window per pass
        for _ in range(max_steps):
            busy = False
            for p in self.pools:
                busy |= bool(p.step() or not p._idle())
            if not busy:
                return
        raise RuntimeError("run_until_drained exceeded max_steps")

    def start(self) -> None:
        for p in self.pools:
            p.start()

    def stop(self) -> None:
        for p in self.pools:
            p.stop()

    def flush(self) -> None:
        for p in self.pools:
            p.flush()

    @property
    def completed(self) -> Dict[int, Request]:
        out: Dict[int, Request] = {}
        for p in self.pools:
            out.update(p.completed)
        return out
