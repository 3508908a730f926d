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

Multi-tenant serving (DESIGN.md §10) shares ONE swap space between N
engines through :meth:`ExpertCache.scoped` views: a
:class:`ScopedExpertCache` namespaces every key with its owner, keeps
per-owner hit/miss/eviction accounting (the parent's LRU and byte budget
stay GLOBAL; an eviction is credited to the owner who lost the entry) and
routes misses to the owner's own host loader. Over an
:class:`AsyncExpertCache` the views share its worker pool.

Ported from ``repro.core.expert_cache``.
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
    budget, staged synchronously: every transfer blocks the caller.

    Used directly (one owner, ``fetch`` bound at construction) or as the
    shared store behind :meth:`scoped` views (``fetch`` may then be None:
    each view brings its own loader)."""

    #: staging discipline: False = every transfer blocks the caller (the
    #: paper's serial swap); AsyncExpertCache overrides (DESIGN.md §12).
    is_async = False

    def __init__(self, fetch: Optional[Callable[[Hashable], object]] = None,
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
        #: owner -> view registry, so evictions of namespaced entries are
        #: credited to the view that loses them (cross-tenant accounting)
        self._views: Dict[str, "ScopedExpertCache"] = {}

    def get(self, key: Hashable):
        if key in self._cache:
            self._cache.move_to_end(key)
            self.stats.hits += 1
            return self._cache[key][0]
        if self._fetch is None:
            raise RuntimeError(
                "shared ExpertCache has no fetch of its own — access it "
                "through a scoped() view (DESIGN.md §10)")
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
        """Per-owner eviction accounting for namespaced entries."""
        self.stats.evictions += 1
        if isinstance(key, tuple) and len(key) == 2 \
                and isinstance(key[0], str) and key[0] in self._views:
            self._views[key[0]].stats.evictions += 1

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

    # -- namespacing (multi-tenant shared swap, DESIGN.md §10) --------------
    def scoped(self, owner: str,
               fetch: Optional[Callable[[Hashable], object]] = None
               ) -> "ScopedExpertCache":
        """A namespaced view for ``owner``: same LRU, same byte budget,
        keys prefixed with the owner so identical (layer, expert) ids of
        different tenants never collide. One view per owner."""
        if owner in self._views:
            raise ValueError(f"owner {owner!r} already has a scoped view")
        view = ScopedExpertCache(self, owner, fetch)
        self._views[owner] = view
        return view

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

    def owner_used_bytes(self, owner: str) -> int:
        return sum(nb for k, (_, nb) in self._cache.items()
                   if isinstance(k, tuple) and len(k) == 2 and k[0] == owner)


class ScopedExpertCache:
    """One owner's view of a shared :class:`ExpertCache` (DESIGN.md §10).

    Presents the single-owner cache interface (``get``/``invalidate``/
    ``resident_keys``/``stats``) over namespaced keys ``(owner, key)``.
    Capacity and LRU order are the PARENT's — the byte budget is jointly
    shared, so this view's misses may evict another owner's entries (and
    vice versa; each eviction is credited to the owner losing the
    entry)."""

    def __init__(self, parent: ExpertCache, owner: str,
                 fetch: Optional[Callable[[Hashable], object]] = None):
        self.parent = parent
        self.owner = owner
        self._fetch = fetch
        self.stats = CacheStats()

    def bind_fetch(self, fetch: Callable[[Hashable], object]):
        """Late-bind the host loader (the serving engine constructs its
        loader after the view exists)."""
        self._fetch = fetch

    def _full(self, key: Hashable) -> Tuple[str, Hashable]:
        return (self.owner, key)

    # -- single-owner cache interface ---------------------------------------
    def get(self, key: Hashable):
        if self.is_async:
            return self._get_async(key)
        full = self._full(key)
        hit = self.parent._peek(full)
        if hit is not None:
            self.stats.hits += 1
            self.parent.stats.hits += 1
            return hit
        if self._fetch is None:
            raise RuntimeError(f"scoped cache {self.owner!r}: no fetch "
                               "bound (bind_fetch first)")
        self.stats.misses += 1
        self.parent.stats.misses += 1
        host = self._fetch(key)
        nb, dt = self.parent._admit(full, host)
        self.stats.bytes_in += nb
        self.stats.transfer_s += dt
        return self.parent._cache[full][0]

    def pin(self, keys):
        for k in keys:
            self.get(k)

    # -- async transfer-engine delegation (DESIGN.md §12) -------------------
    # Per-owner DEMAND accounting is delta-based over the parent's stats:
    # safe because each tenant engine drives its cache view from the one
    # serving thread (workers only touch the speculative counters, which
    # stay parent-global).
    @property
    def is_async(self) -> bool:
        return bool(getattr(self.parent, "is_async", False))

    def _async_parent(self) -> "AsyncExpertCache":
        if not self.is_async:
            raise RuntimeError(
                f"scoped cache {self.owner!r}: the shared swap space is "
                "synchronous — build it as AsyncExpertCache for overlap "
                "serving (DESIGN.md §12)")
        return self.parent

    def _scoped_fetch(self, full_key):
        if self._fetch is None:
            raise RuntimeError(f"scoped cache {self.owner!r}: no fetch "
                               "bound (bind_fetch first)")
        return self._fetch(full_key[1])

    def _get_async(self, key: Hashable):
        p = self._async_parent()
        with p._lock:
            h0, m0 = p.stats.hits, p.stats.misses
            b0, t0 = p.stats.bytes_in, p.stats.transfer_s
        val = p.get(self._full(key), fetch=self._scoped_fetch)
        with p._lock:
            self.stats.hits += p.stats.hits - h0
            self.stats.misses += p.stats.misses - m0
            self.stats.bytes_in += p.stats.bytes_in - b0
            self.stats.transfer_s += p.stats.transfer_s - t0
        return val

    def prefetch(self, keys) -> int:
        """Non-blocking speculative enqueue through the async parent
        (speculative traffic is accounted parent-globally)."""
        return self._async_parent().prefetch(
            [self._full(k) for k in keys], fetch=self._scoped_fetch)

    def hint(self, keys):
        """Speculative staging for this namespace: non-blocking enqueue
        on an async parent, inline speculative admit on a sync one (the
        blocking staging time is mirrored into THIS view's stats so the
        engine's exposed-time accounting sees it)."""
        if self.is_async:
            self.prefetch(keys)
            return
        for k in keys:
            full = self._full(k)
            if self.parent._peek(full) is None:
                nb, dt = self.parent._admit(full, self._scoped_fetch(full),
                                            speculative=True)
                self.stats.prefetch_bytes += nb
                self.stats.prefetch_s += dt

    def wait(self, keys) -> int:
        """Demand-wait through the async parent; per-owner demand stats
        mirror the parent's deltas. Returns the demand-fetch count."""
        p = self._async_parent()
        keys = list(keys)
        with p._lock:
            b0, t0 = p.stats.bytes_in, p.stats.transfer_s
        n = p.wait([self._full(k) for k in keys],
                   fetch=self._scoped_fetch)
        with p._lock:
            self.stats.bytes_in += p.stats.bytes_in - b0
            self.stats.transfer_s += p.stats.transfer_s - t0
        self.stats.misses += n
        self.stats.hits += len(keys) - n
        return n

    def drain(self):
        self.parent.drain()

    def close(self):
        """Drain this view's traffic but leave the SHARED space open — it
        is closed by whoever owns it (e.g. MultiTenantEngine)."""
        self.parent.drain()

    def update(self, key: Hashable, host) -> int:
        """In-place rung promote/demote of this owner's entry (see
        :meth:`ExpertCache.update`); returns the byte delta. On an async
        parent the whole read-update-read runs under its (re-entrant)
        lock so concurrent workers can't skew the deltas."""
        lock = getattr(self.parent, "_lock", None)
        with lock if lock is not None else contextlib.nullcontext():
            bytes_before = self.parent.stats.bytes_in
            time_before = self.parent.stats.transfer_s
            delta = self.parent.update(self._full(key), host)
            self.stats.bytes_in += \
                self.parent.stats.bytes_in - bytes_before
            self.stats.transfer_s += \
                self.parent.stats.transfer_s - time_before
        return delta

    def invalidate(self, keys=None):
        """Drop this owner's entries only — other namespaces are
        untouched."""
        if keys is None:
            full = [k for k in self.parent.resident_keys()
                    if isinstance(k, tuple) and len(k) == 2
                    and k[0] == self.owner]
        else:
            full = [self._full(k) for k in keys]
        self.parent.invalidate(full)

    def resident_keys(self) -> List[Hashable]:
        return [k[1] for k in self.parent.resident_keys()
                if isinstance(k, tuple) and len(k) == 2
                and k[0] == self.owner]

    @property
    def used_bytes(self) -> int:
        return self.parent.owner_used_bytes(self.owner)

    @property
    def capacity(self) -> int:
        return self.parent.capacity


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
    * ``drain()`` — barrier: every enqueued transfer lands. A worker's
      future resolves only after the event recorded behind its copy has
      completed, so waiting on the futures waits on the side-stream
      copies too.
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
                if fetch is None and self._fetch is None:
                    raise RuntimeError(
                        "shared AsyncExpertCache has no fetch of its own "
                        "— access it through a scoped() view "
                        "(DESIGN.md §10)")
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

    def owner_used_bytes(self, owner: str) -> int:
        with self._lock:
            return super().owner_used_bytes(owner)

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used
