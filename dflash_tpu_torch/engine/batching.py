"""Continuous batching engine: R request lanes decoded together, requests
admitted into free lanes while the others decode and retired as they finish.
Port of ``dflash_tpu/engine/batching.py`` (``EngineConfig``, ``Request``,
``ContinuousBatchingEngine``, ``BucketSpec``, ``BucketedEngine``).

The lanes are one ``LaneState`` (``spec/engine.py``); every window runs
``spec/batched.py``'s ``batched_cycles`` over all of them, each lane at its
own frontier, temperature and top-k / top-p, and finished or idle lanes
freeze (an idle lane is ``done`` with ``max_length`` 0, so it never counts
as active).  Admission prefills one request alone (``_prefill_impl``, the
single-request engine's prefill) and writes its state into lane j of the
running state: the caches at axis 1, everything else at axis 0, as JAX's
donated ``_admit`` does.  Everything runs in order on one CUDA stream, so the
admission writes land after the last window's kernels.  Lanes never interact,
so a request's tokens do not depend on its lane or its neighbours.

Where the port differs in form: the lane loop reads every lane's frontier
back once per cycle (``LaneState.refresh``), so a window of
``steps_per_sync`` cycles syncs that many times and ``overlap=True`` hides
nothing in eager PyTorch; it is kept, with JAX's lane epochs, and gives the
same tokens as ``overlap=False``.  A window stops early once no lane is
active (``cycle_count`` counts the cycles run).  Sampled requests draw from a
``torch.Generator`` per lane on the engine's device, seeded from the
request's ``seed``, or else from :func:`request_seed` of the engine seed and
the request id: the same distribution as JAX's per-request PRNG keys, not
the same tokens; a seed gives the same tokens in any lane and admission
order.

Threads: only the thread that steps the engine (the ``start`` loop, or the
caller of ``step`` / ``run_until_drained``) touches device tensors;
``submit`` and ``abort`` only enqueue or mark, and ``flush`` from another
thread runs on the loop thread.

Not ported (``NotImplementedError`` at construction, ROADMAP.md Queue 1,
item "Serving, the rest"): the prompt-prefix cache (``prefix_cache_mb``),
chunk-interleaved admission (``admission_chunk``), prefill-ahead
(``prefill_ahead``), batched admission (``batch_admission``) and
disaggregated prefill (``prefill_worker``).
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

from dflash_tpu_torch.cache.kv import init_kv_cache, init_quant_kv_cache
from dflash_tpu_torch.core.config import DraftConfig, ModelConfig
from dflash_tpu_torch.ops.sampling import GREEDY_TEMP_EPS
from dflash_tpu_torch.spec.batched import batched_cycles
from dflash_tpu_torch.spec.engine import LaneState, LoopState, SamplingFilters, _prefill_impl


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
    batch_admission: bool = False  # not ported
    prefix_cache_mb: int = 0  # not ported
    # dispatch window N, then harvest window N - pipeline_depth's peek
    overlap: bool = True
    pipeline_depth: int = 1
    # per-request top-k / top-p; without it, requests with filters that are
    # not no-ops are refused at submit()
    sampling_filters: bool = False
    # candidate pool of the filtered sampler: the keep set is exact for any
    # top_k; submit() refuses top_k > topk_pool
    topk_pool: int = 64
    # streaming / stop-string lanes read the output buffer every
    # stream_interval-th window (finishing and aborted lanes always)
    stream_interval: int = 4
    admission_chunk: Optional[int] = None  # not ported
    admission_chunks_per_step: int = 1
    prefill_ahead: int = 0  # not ported
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


def _peek(state: LaneState) -> tuple:
    """What the scheduler needs to retire lanes, as copies the next window
    cannot overwrite: start, done and cycle_idx from the host mirrors (equal
    to the device values after every cycle and every admission), output_ids
    and acc_trace as device copies."""
    return (state.host_start.copy(), state.host_done.copy(), state.host_cycle_idx.copy(),
            state.output_ids.clone(), state.acc_trace.clone())


def _not_ported(cfg: EngineConfig, prefill_worker) -> None:
    for name, on in (("prefix_cache_mb > 0 (the prompt-prefix cache)", cfg.prefix_cache_mb > 0),
                     ("admission_chunk (chunk-interleaved admission)", cfg.admission_chunk is not None),
                     ("prefill_ahead > 0", cfg.prefill_ahead > 0),
                     ("batch_admission", cfg.batch_admission),
                     ("prefill_worker (disaggregated prefill)", prefill_worker is not None)):
        if on:
            raise NotImplementedError(f"{name} is not ported to dflash_tpu_torch yet "
                                      "(ROADMAP.md Queue 1, item 'Serving, the rest')")


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
        _not_ported(cfg, prefill_worker)
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
        if top_k >= self.tcfg.vocab_size:
            top_k = 0  # keep-everything == filter off
        if top_k > self.cfg.topk_pool:
            raise ValueError(
                f"top_k={top_k} exceeds the engine's exact pool (topk_pool={self.cfg.topk_pool}); "
                f"build the engine with a wider topk_pool instead of silently clamping")
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
        """Admit waiting requests into free lanes, run one window of
        ``steps_per_sync`` cycles, retire finished requests.  Returns the
        active lanes.  With ``cfg.overlap`` the harvest reads the window
        ``pipeline_depth`` back (JAX's overlapped scheduler: retire and admit
        decisions lag, tokens do not change, since a finished lane freezes)."""
        self._admit_pending()
        n_active = sum(r is not None for r in self._lane_req)
        if not self.cfg.overlap:
            if n_active:
                self._dispatch_window()
                self._retire_finished()
            return n_active
        if n_active:
            self._dispatch_window()
            self._peek_pending.append((_peek(self._state), self._lane_epoch.copy()))
            while len(self._peek_pending) > max(1, self.cfg.pipeline_depth):
                self._harvest(self._peek_pending.popleft())
        else:
            # nothing dispatched: drain the windows in flight so finished
            # lanes retire when the engine goes idle
            while self._peek_pending:
                self._harvest(self._peek_pending.popleft())
        return n_active

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

    def _admit_pending(self) -> None:
        free = [lane for lane in range(self.cfg.num_lanes) if self._lane_req[lane] is None]
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
        for lane, req in zip(free, reqs):
            # a bad request (a prefill that raises) fails alone and is
            # surfaced on the request; the other lanes keep serving
            try:
                self._admit_request(lane, req)
            except Exception as e:  # noqa: BLE001 — isolate per-request faults
                self._fail_request(req, f"{type(e).__name__}: {e}")

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

    def _prompt_bucket(self, prompt_len: int) -> int:
        """Smallest prompt_bucket multiple covering prompt_len, capped."""
        g = self.cfg.prompt_bucket
        return min(self.cfg.prompt_cap, ((max(prompt_len, 1) + g - 1) // g) * g)

    def _req_generator(self, req: Request) -> Optional[torch.Generator]:
        """The request's generator on the engine's device (None when greedy):
        seeded from ``req.seed``, else from :func:`request_seed`."""
        if req.temperature < GREEDY_TEMP_EPS:
            return None
        seed = req.seed if req.seed is not None else request_seed(self.cfg.seed, req.rid)
        return torch.Generator(device=self.device).manual_seed(int(seed))

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

    def _compute_single(self, req: Request) -> LoopState:
        """A request's prompt prefill alone: the single-request state that
        admission writes into a lane."""
        P = len(req.input_ids)
        padded = np.zeros((1, self._prompt_bucket(P)), np.int64)
        padded[0, :P] = req.input_ids
        return _prefill_impl(
            self.t_params, self.d_params, torch.from_numpy(padded).to(self.device), P, req.temperature,
            self._req_generator(req), tcfg=self.tcfg, dcfg=self.dcfg, total_len=self.total_len,
            kv_quant=self.cfg.kv_quant, filters=self._req_filters(req), topk_pool=self.cfg.topk_pool,
        )

    def _admit_request(self, lane: int, req: Request) -> None:
        single = self._compute_single(req)
        _admit(self._state, lane, single)
        self._bind_lane(lane, req)

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
        return (not self._peek_pending and self._queue.empty()
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
        held = [r for r in self._lane_req if r is not None]
        self._lane_req = [None] * self.cfg.num_lanes
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
        """Drop all idle state (the /flush_cache equivalent)."""
        self._on_loop(self._flush_now)

    def _flush_now(self) -> None:
        if any(r is not None for r in self._lane_req):
            raise RuntimeError("cannot flush with active requests")
        self._peek_pending.clear()
        self._last_start_host = None
        self._state = None  # release the old buffers before allocating new ones
        self._state = self._empty_state(self.cfg.num_lanes)


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
    share the parameters; the extra memory is each pool's lane state."""

    def __init__(self, tcfg: ModelConfig, dcfg: DraftConfig, t_params, d_params,
                 cfg: EngineConfig, buckets: List[BucketSpec], tokenizer=None,
                 device: str | torch.device = "cuda"):
        if not buckets:
            raise ValueError("need at least one BucketSpec")
        _not_ported(cfg, None)
        self.buckets = sorted(buckets, key=lambda b: b.prompt_cap + b.max_new_tokens)
        self.pools = [
            ContinuousBatchingEngine(
                tcfg, dcfg, t_params, d_params,
                dataclasses.replace(cfg, num_lanes=b.num_lanes, prompt_cap=b.prompt_cap,
                                    max_new_tokens=b.max_new_tokens),
                tokenizer=tokenizer, device=device,
            )
            for b in self.buckets
        ]
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
