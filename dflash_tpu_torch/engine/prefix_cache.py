"""Prompt-prefix cache: reuse prefill work across requests.  Port of
``dflash_tpu/engine/prefix_cache.py``.

An LRU of device tensors: the target-KV rows and tap features of a prompt
prefix at ``granularity``-token boundaries.  An admission that hits resumes
its prefill from the cached frontier (one forward over the suffix) instead of
recomputing the whole prompt.  One inserted prefix registers a key for every
boundary it covers, all sharing one entry (its bytes counted once), so a
prompt that agrees with a cached one on a shorter boundary still hits.

An entry owns its rows: :meth:`PrefixEntry.copy_of` copies them out of the
cache they were prefilled into.  A slice of that cache would be a view that
keeps the whole ``total_len`` buffer alive while ``nbytes`` counts only the
prefix rows.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dflash_tpu_torch.cache.kv import AnyKVCache


class PrefixEntry(NamedTuple):
    """Prefilled prompt-prefix rows: ``kv_rows`` is a ``KVCache`` or
    ``QuantKVCache`` whose tensors hold the cache's first P0 positions
    ([L, 1, P0, ...]: the position axis is axis 2 of every tensor, the int8
    scales' too), so an entry serves a float or an int8 cache in the cache's
    own representation."""

    kv_rows: AnyKVCache
    taps: torch.Tensor  # [1, P0, n_taps * H]

    @classmethod
    def copy_of(cls, kv: AnyKVCache, taps: torch.Tensor, n: int) -> "PrefixEntry":
        """The first ``n`` positions of a cache ([L, 1, T, ...]) and of its
        taps ([1, T, F]), copied into tensors of their own."""
        return cls(kv_rows=type(kv)(*(x[:, :, :n].clone() for x in kv)), taps=taps[:, :n].clone())

    @property
    def prefix_len(self) -> int:
        return self.taps.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in (*self.kv_rows, self.taps))

    def truncated(self, n: int) -> "PrefixEntry":
        """The first ``n`` positions, as views of this entry."""
        if n == self.prefix_len:
            return self
        return PrefixEntry(kv_rows=type(self.kv_rows)(*(x[:, :, :n] for x in self.kv_rows)),
                           taps=self.taps[:, :n])


def _key(ids: np.ndarray, n: int) -> bytes:
    return hashlib.sha1(np.ascontiguousarray(ids[:n], np.int32).tobytes()).digest()


class PrefixCache:
    """Byte-bounded LRU of :class:`PrefixEntry` keyed by token-prefix hash.

    Entries are evicted as wholes (all their boundary keys together), least
    recently looked up or inserted first."""

    def __init__(self, capacity_bytes: int, granularity: int):
        self.capacity = int(capacity_bytes)
        self.granularity = int(granularity)
        # gid -> (entry, boundary keys); LRU order on gids
        self._groups: "OrderedDict[int, Tuple[PrefixEntry, list]]" = OrderedDict()
        self._index: Dict[bytes, Tuple[int, int]] = {}  # key -> (gid, n)
        self._gid = itertools.count()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        # one cache may be shared by several engine pools (the BucketedEngine
        # rungs), each with its own loop thread
        self._lock = threading.Lock()

    def lookup(self, ids: np.ndarray, max_prefix: int) -> Optional[Tuple[int, PrefixEntry]]:
        """(n, entry) of the longest cached prefix of ``ids`` at a granularity
        boundary, at most ``max_prefix`` tokens (callers pass prompt_len - 1:
        at least one suffix token must remain to give the last hidden row),
        or None."""
        ids = np.asarray(ids).reshape(-1)
        n = (min(max_prefix, ids.shape[0] - 1) // self.granularity) * self.granularity
        with self._lock:
            while n >= self.granularity:
                hit = self._index.get(_key(ids, n))
                if hit is not None:
                    gid, n_hit = hit
                    entry, _ = self._groups[gid]
                    self._groups.move_to_end(gid)
                    self.hits += 1
                    return n_hit, entry.truncated(n_hit)
                n -= self.granularity
            self.misses += 1
            return None

    def insert(self, ids: np.ndarray, entry: PrefixEntry) -> None:
        """Register ``entry`` (the first ``entry.prefix_len`` tokens of
        ``ids``) under every boundary it covers.  An entry off a boundary,
        larger than the capacity, or already cached is not added."""
        n_max = entry.prefix_len
        if n_max < self.granularity or n_max % self.granularity:
            return
        ids = np.asarray(ids).reshape(-1)
        with self._lock:
            full_key = _key(ids, n_max)
            if full_key in self._index:
                self._groups.move_to_end(self._index[full_key][0])
                return
            size = entry.nbytes
            if size > self.capacity:
                return
            while self._bytes + size > self.capacity and self._groups:
                self._evict_oldest()
            gid = next(self._gid)
            keys = []
            displaced = set()
            for n in range(self.granularity, n_max + 1, self.granularity):
                key = _key(ids, n)
                old = self._index.get(key)
                if old is not None and old[0] != gid:
                    displaced.add(old[0])
                self._index[key] = (gid, n)
                keys.append(key)
            self._groups[gid] = (entry, keys)
            self._bytes += size
            # a shorter entry whose every boundary key now points at this one
            # is unreachable: free its bytes now, not at the next eviction
            for og in displaced:
                got = self._groups.get(og)
                if got is not None and not any(self._index.get(k, (None,))[0] == og for k in got[1]):
                    self._bytes -= got[0].nbytes
                    del self._groups[og]

    def _evict_oldest(self) -> None:
        gid, (entry, keys) = self._groups.popitem(last=False)
        self._bytes -= entry.nbytes
        for key in keys:
            if self._index.get(key, (None,))[0] == gid:
                del self._index[key]

    def clear(self) -> None:
        with self._lock:
            self._groups.clear()
            self._index.clear()
            self._bytes = 0
