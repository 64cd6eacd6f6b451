"""Disaggregated prefill: admission prefills on a worker of their own.  Port
of ``dflash_tpu/engine/disagg.py``.

A :class:`PrefillWorker` holds the target parameters on ``prefill_device``,
runs each long admission's prompt-prefix forward there on a thread of its
own, and hands the finished ``(kv_rows, taps)`` to the decode engine on
``decode_device``, which completes the admission through the prefix-resume
prefill (one suffix forward, ``spec/engine.py``'s
``_prefill_from_prefix_impl``).  The worker runs the same chunk forward as
chunk-interleaved admission (``_prefill_chunk_impl``, over the whole prefix
at once), so a request admitted through it gets the tokens of any other
admission route.

On one card the two devices are the same ``cuda:0``: the worker's parameters
are then the engine's own tensors (``.to`` of a tensor already on its device
returns it), so the weights are not held twice, and the prefix forward
shares the card with the decode.

Threads and streams: the worker thread launches the port's kernels while the
engine's thread does too.  Both launch on their thread's default stream,
which is the device's one legacy default stream, so the two threads' kernels
run in one order: the per-device merge counters that some kernels share
(``kernels/_build.merge_counters``) and the caching allocator's reuse are
safe only under that one stream, and the worker never sets another.  The
launch counters take a lock (``_build.count_launch``).  Before a result is
handed over, the worker waits for the decode device's stream, so the
engine's resume forward reads complete rows.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dflash_tpu_torch.cache.kv import AnyKVCache, init_kv_cache, init_quant_kv_cache
from dflash_tpu_torch.core.config import DraftConfig, ModelConfig
from dflash_tpu_torch.ops.linear import QTensor
from dflash_tpu_torch.spec.engine import _prefill_chunk_impl


@dataclass
class DisaggResult:
    """A finished prefill handoff, its rows already on the decode device."""

    req: object  # the engine's Request
    lane: int
    padded: np.ndarray  # [1, Pb]
    p0: int
    kv_rows: Optional[AnyKVCache]  # tensors [L, 1, P0, ...] on the decode device
    taps: Optional[torch.Tensor]  # [1, P0, n_taps * H] on the decode device
    error: Optional[str] = None


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def params_to(tree, device: torch.device):
    """A parameter dict with every tensor (and int8 ``QTensor``) on
    ``device``; a tensor already there is the same tensor."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to(device), tree.scale.to(device), tree.n)
    return tree.to(device)


class PrefillWorker:
    """Runs admission prompt-prefix prefills on ``prefill_device`` and ships
    the rows to ``decode_device`` (``torch.device``s, or what
    ``torch.device`` takes).  The engine thread never waits on a prefill."""

    def __init__(self, tcfg: ModelConfig, dcfg: DraftConfig, t_params, *, prefill_device, decode_device,
                 kv_quant: bool = False):
        self.tcfg, self.dcfg = tcfg, dcfg
        self.kv_quant = kv_quant
        self.prefill_device = _resolve(prefill_device)
        self.decode_device = _resolve(decode_device)
        self.t_params = params_to(t_params, self.prefill_device)
        self._in: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue[DisaggResult]" = queue.Queue()
        self.inflight = 0
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, req, lane: int, padded: np.ndarray, p0: int) -> None:
        with self._lock:
            self.inflight += 1
        self._in.put((req, lane, padded, p0))

    def poll(self) -> list:
        """The finished handoffs (non-blocking)."""
        out = []
        while True:
            try:
                out.append(self._out.get_nowait())
            except queue.Empty:
                return out

    def stop(self) -> None:
        self._running = False
        self._in.put(None)
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError("the prefill worker did not stop within 30 s")

    # -- worker thread -------------------------------------------------------

    def _prefill_prefix(self, padded: np.ndarray, p0: int) -> tuple:
        """The prompt prefix [0, p0) in one chunk forward on the prefill
        device (no running lanes to stall there, so no chunking), then the
        rows on the decode device, complete."""
        dev = self.prefill_device
        dtype = self.t_params["embed"].dtype
        if dtype not in (torch.bfloat16, torch.float32):
            dtype = torch.bfloat16
        scratch = (init_quant_kv_cache(self.tcfg, 1, p0, dev) if self.kv_quant
                   else init_kv_cache(self.tcfg, 1, p0, dtype, dev))
        taps = torch.zeros((1, p0, self.dcfg.num_taps * self.tcfg.hidden_size), dtype=dtype, device=dev)
        ids = torch.from_numpy(np.ascontiguousarray(padded[:, :p0], np.int64)).to(dev)
        kv, taps = _prefill_chunk_impl(self.t_params, scratch, taps, ids, 0, tcfg=self.tcfg,
                                       tap_ids=self.dcfg.target_layer_ids)
        kv = type(kv)(*(x.to(self.decode_device) for x in kv))
        taps = taps.to(self.decode_device)
        if self.decode_device.type == "cuda":
            torch.cuda.current_stream(self.decode_device).synchronize()
        return kv, taps

    def _run(self) -> None:
        if self.prefill_device.type == "cuda":
            torch.cuda.set_device(self.prefill_device)
        while self._running:
            item = self._in.get()
            if item is None:
                return
            req, lane, padded, p0 = item
            try:
                kv, taps = self._prefill_prefix(padded, p0)
                res = DisaggResult(req=req, lane=lane, padded=padded, p0=p0, kv_rows=kv, taps=taps)
            except Exception as e:  # noqa: BLE001 — the failure belongs to the request
                res = DisaggResult(req=req, lane=lane, padded=padded, p0=p0, kv_rows=None, taps=None,
                                   error=f"{type(e).__name__}: {e}")
            # enqueue before the decrement: a drain check of (inflight == 0
            # and nothing to poll) never sees the gap
            self._out.put(res)
            with self._lock:
                self.inflight -= 1
