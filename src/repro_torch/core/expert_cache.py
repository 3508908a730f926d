"""Device-resident expert cache with LRU replacement + swap space (paper §3).

The serving engine keeps every expert's weights in the precision rung the
active plan assigns it as a host blob (pinned memory on a CUDA host) and a
bounded device cache keyed by (layer, expert). On a miss the blob is
copied to the device and the copy is timed; hits/misses and transferred
bytes feed the serving metrics and validate the cost model.

Asynchronous staging (DESIGN.md §12) moves transfers off the decode
critical path: :class:`AsyncExpertCache` runs a small pool of
``expert-xfer`` worker threads behind the same interface —
``prefetch``/``hint`` is a non-blocking enqueue, ``wait(keys)`` blocks
only until the named keys are resident. Each worker copies on a CUDA
stream of its own, from pinned memory, and waits on an event, so a copy
overlaps the decode stream's kernels instead of queueing behind them.
Demand traffic (``bytes_in``/``transfer_s``) and speculative traffic
(``prefetch_bytes``/``prefetch_s``) are accounted apart.
:class:`PrefetchingExpertCache` is the synchronous ``hint`` variant.

Ported from ``repro.core.expert_cache`` except ``ScopedExpertCache`` (the
multi-tenant view), which belongs with ``serving/multi.py``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    #: DEMAND traffic only — transfers a decode step actually asked for.
    bytes_in: int = 0
    transfer_s: float = 0.0
    #: SPECULATIVE traffic (hint/prefetch staging) — kept apart so
    #: miss-rate and transfer metrics never conflate demand with
    #: speculation (DESIGN.md §12).
    prefetch_bytes: int = 0
    prefetch_s: float = 0.0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 1.0

    def reset(self):
        self.__init__()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device, non_blocking=tree.is_pinned())


class ExpertCache:
    """LRU cache of expert weight trees (dicts of tensors) under a byte
    budget, staged synchronously: every transfer blocks the caller."""

    #: staging discipline: False = every transfer blocks the caller (the
    #: paper's serial swap); AsyncExpertCache overrides (DESIGN.md §12).
    is_async = False

    def __init__(self, fetch: Callable[[Hashable], object],
                 capacity_bytes: int = 0, device=None):
        if int(capacity_bytes) <= 0:
            raise ValueError("ExpertCache needs a positive capacity_bytes "
                             "(a 0-byte cache would thrash every access)")
        self._fetch = fetch                     # host loader: key -> tree
        self.capacity = int(capacity_bytes)
        self.device = resolve_device(device)
        self._cache: "collections.OrderedDict[Hashable, Tuple[object,int]]" \
            = collections.OrderedDict()
        self._used = 0
        self.stats = CacheStats()

    def get(self, key: Hashable):
        if key in self._cache:
            self._cache.move_to_end(key)
            self.stats.hits += 1
            return self._cache[key][0]
        self.stats.misses += 1
        host = self._fetch(key)
        self._admit(key, host)
        return self._cache[key][0]

    def _peek(self, key: Hashable):
        """Hit path without stats; returns the device tree or None."""
        if key not in self._cache:
            return None
        self._cache.move_to_end(key)
        return self._cache[key][0]

    def _admit(self, key: Hashable, host,
               speculative: bool = False) -> Tuple[int, float]:
        """Copy a host tree to the device (from pinned memory where the
        blob is pinned), wait for the copy and time it; returns (bytes,
        seconds). Demand time goes to ``transfer_s``, speculative time to
        ``prefetch_s``."""
        nb = _nbytes(host)
        self._evict_until(nb)
        dev, dt = self._timed_copy(host)
        if speculative:
            self.stats.prefetch_s += dt
            self.stats.prefetch_bytes += nb
        else:
            self.stats.transfer_s += dt
            self.stats.bytes_in += nb
        self._cache[key] = (dev, nb)
        self._used += nb
        return nb, dt

    def _timed_copy(self, host) -> Tuple[object, float]:
        """Copy a host tree to the device and wait for it; returns (device
        tree, seconds). The serial swap waits for the whole card."""
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        dev = _to_device(host, self.device)
        if sync:
            torch.cuda.synchronize(self.device)
        return dev, time.perf_counter() - t0

    def _credit_eviction(self, key: Hashable):
        """Eviction accounting (the reference also credits the owner of a
        namespaced key here; its multi-tenant views are a later slice)."""
        self.stats.evictions += 1

    def _evict_until(self, need: int):
        while self._cache and self._used + need > self.capacity:
            key, (old, nb) = self._cache.popitem(last=False)
            del old
            self._used -= nb
            self._credit_eviction(key)

    def update(self, key: Hashable, host) -> int:
        """Replace ``key``'s entry with a new host tree — the precision-
        ladder promote/demote path (DESIGN.md §11): the byte accounting
        charges exactly the size delta. Admits the key when absent.
        Returns the byte delta (new - old)."""
        old_nb = 0
        if key in self._cache:
            _, old_nb = self._cache.pop(key)
            self._used -= old_nb
        nb, _ = self._admit(key, host)
        return nb - old_nb

    def pin(self, keys):
        """Pre-load keys (the planner's resident set), most-priority last."""
        for k in keys:
            self.get(k)

    def invalidate(self, keys=None):
        if keys is None:
            for k in list(self._cache):
                self._credit_eviction(k)
            self._cache.clear()
            self._used = 0
            return
        for k in list(keys):
            if k in self._cache:
                self._used -= self._cache.pop(k)[1]
                self._credit_eviction(k)

    def resize(self, capacity_bytes: int):
        """Change the byte budget; a shrink below ``used_bytes`` evicts
        down at once (LRU order)."""
        self.capacity = int(capacity_bytes)
        self._evict_until(0)

    def drain(self):
        """Synchronous staging has nothing in flight — no-op."""

    def close(self):
        """No transfer workers to join — no-op (see AsyncExpertCache)."""

    @property
    def used_bytes(self) -> int:
        return self._used

    def resident_keys(self):
        return list(self._cache.keys())


class PrefetchingExpertCache(ExpertCache):
    """Gate-ahead speculative prefetch: the engine calls ``hint(keys)``
    with the experts it expects next (the previous iteration's demand);
    hints are staged, synchronously, before they are demanded.
    Speculative staging goes to ``stats.prefetch_bytes`` /
    ``stats.prefetch_s`` and never to the demand counters."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prefetch_hits = 0

    def hint(self, keys):
        for k in keys:
            if k not in self._cache:
                self._admit(k, self._fetch(k), speculative=True)
            else:
                self.prefetch_hits += 1


class AsyncExpertCache(ExpertCache):
    """Overlapped expert staging (DESIGN.md §12): a pool of transfer
    workers behind the LRU cache interface.

    * ``prefetch(keys)`` / ``hint(keys)`` — NON-BLOCKING speculative
      enqueue; at most one in-flight future per key.
    * ``wait(keys)`` — block until every key has landed; keys neither
      resident nor in flight are fetched as DEMAND (``misses``/
      ``bytes_in``/``transfer_s``); a key whose speculative fetch is in
      flight blocks only for the remainder of it.
    * ``drain()`` — barrier: every enqueued transfer lands.
    * ``close()`` — drain, then join the ``expert-xfer`` workers;
      idempotent.

    ``staging_buffers`` bounds the CONCURRENT host->device copies; more
    enqueues queue behind the semaphore. Each worker thread runs the
    loader and the copy on a CUDA stream of its own (the legacy default
    stream would serialize every copy behind decode), copies from the
    pinned blob without blocking, records an event and waits on it (the
    wait releases the GIL); the wall time around the copy is the transfer
    time, as in the reference. Nothing here synchronizes the whole
    device: that would wait for the decode stream too. The device copies
    are held, not read by the decode stream (the serve-layout banks stay
    resident, as in the reference on one device); a main-stream reader
    would need ``record_stream`` on them. All cache-dict mutations take
    one lock; in-flight keys are not yet admitted (hence not evictable),
    and a speculative entry evicted before its demand is re-fetched."""

    is_async = True

    def __init__(self, *a, workers: int = 2, staging_buffers: int = 2,
                 **kw):
        super().__init__(*a, **kw)
        self._lock = threading.RLock()
        self._inflight: Dict[Hashable, Future] = {}
        self._staging = threading.BoundedSemaphore(max(int(staging_buffers),
                                                       1))
        self._streams = threading.local()
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(workers), 1),
            thread_name_prefix="expert-xfer")
        self._closed = False
        self.prefetch_hits = 0

    # -- worker side --------------------------------------------------------
    def _side_stream(self):
        """Put this thread's device work on a CUDA stream of its own
        (created on first use); a no-op context on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stream = getattr(self._streams, "stream", None)
        if stream is None:
            stream = self._streams.stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(stream)

    def _timed_copy(self, host) -> Tuple[object, float]:
        """Copy on the current (side) stream and wait for that copy alone:
        an event on the stream, whose wait releases the GIL."""
        t0 = time.perf_counter()
        dev = _to_device(host, self.device)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return dev, time.perf_counter() - t0

    def _stage(self, key: Hashable, speculative: bool,
               fetch: Optional[Callable]) -> Tuple[int, float]:
        try:
            with self._staging, self._side_stream():
                host = (fetch or self._fetch)(key)
                nb = _nbytes(host)
                dev, dt = self._timed_copy(host)
            with self._lock:
                if speculative:
                    self.stats.prefetch_s += dt
                    self.stats.prefetch_bytes += nb
                else:
                    self.stats.transfer_s += dt
                    self.stats.bytes_in += nb
                if key in self._cache:   # raced with an update(): replace
                    self._used -= self._cache.pop(key)[1]
                self._evict_until(nb)
                self._cache[key] = (dev, nb)
                self._used += nb
                self._inflight.pop(key, None)
            return nb, dt
        except BaseException:
            with self._lock:
                self._inflight.pop(key, None)
            raise

    def _submit(self, key: Hashable, speculative: bool,
                fetch: Optional[Callable]) -> Future:
        """Enqueue one transfer; the caller holds the lock."""
        if self._closed:
            raise RuntimeError("AsyncExpertCache is closed")
        fut = self._pool.submit(self._stage, key, speculative, fetch)
        self._inflight[key] = fut
        return fut

    # -- async interface ----------------------------------------------------
    def prefetch(self, keys, fetch: Optional[Callable] = None) -> int:
        """Non-blocking speculative enqueue; returns the number of
        transfers enqueued (resident and in-flight keys are skipped; a
        resident key is LRU-touched, since the prediction says it is
        about to be demanded)."""
        n = 0
        with self._lock:
            for k in keys:
                if k in self._cache:
                    self._cache.move_to_end(k)
                    self.prefetch_hits += 1
                    continue
                if k in self._inflight:
                    continue
                self._submit(k, True, fetch)
                n += 1
        return n

    def hint(self, keys):
        """PrefetchingExpertCache-compatible spelling of :meth:`prefetch`
        (non-blocking)."""
        self.prefetch(keys)

    def wait(self, keys, fetch: Optional[Callable] = None) -> int:
        """Block until every key's transfer has LANDED (each key was
        admitted at least once; under memory pressure a landed entry may
        already be evicted again, and a later access re-demands it).
        Returns the number of DEMAND fetches."""
        fetched = 0
        futs: List[Future] = []
        with self._lock:
            for k in keys:
                if k in self._cache:
                    self._cache.move_to_end(k)
                    self.stats.hits += 1
                    continue
                fut = self._inflight.get(k)
                if fut is None:
                    self.stats.misses += 1
                    fetched += 1
                    fut = self._submit(k, False, fetch)
                else:
                    # demanded while its speculative fetch is in flight:
                    # block only for the remainder of the transfer
                    self.stats.hits += 1
                    self.prefetch_hits += 1
                futs.append(fut)
        for fut in futs:
            fut.result()
        return fetched

    def drain(self):
        while True:
            with self._lock:
                futs = list(self._inflight.values())
            if not futs:
                return
            for fut in futs:
                fut.result()

    def close(self):
        if self._closed:
            return
        try:
            self.drain()
        finally:
            self._closed = True
            self._pool.shutdown(wait=True)

    # -- thread-safe overrides of the sync surface --------------------------
    def get(self, key: Hashable, fetch: Optional[Callable] = None):
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                self.stats.hits += 1
                return self._cache[key][0]
            fut = self._inflight.get(key)
            if fut is None:
                self.stats.misses += 1
                fut = self._submit(key, False, fetch)
            else:
                self.stats.hits += 1
                self.prefetch_hits += 1
        fut.result()
        while True:
            with self._lock:
                entry = self._cache.get(key)
                if entry is not None:
                    self._cache.move_to_end(key)
                    return entry[0]
                fut = self._inflight.get(key)
                if fut is None:
                    # LRU-evicted between landing and this read (tiny
                    # caches): silent re-fetch, no re-count
                    fut = self._submit(key, False, fetch)
            fut.result()

    def update(self, key: Hashable, host) -> int:
        with self._lock, self._side_stream():
            return super().update(key, host)

    def invalidate(self, keys=None):
        with self._lock:
            super().invalidate(keys)

    def resize(self, capacity_bytes: int):
        with self._lock:
            super().resize(capacity_bytes)

    def resident_keys(self):
        with self._lock:
            return super().resident_keys()

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used
