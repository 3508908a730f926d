"""The port's expert caches on the CPU device, in the cases of the
reference's ``tests/test_async_cache.py`` (DESIGN.md §12): the async
cache's non-blocking prefetch, demand wait, LRU correctness with fetches in
flight, drain/close lifecycle and worker-thread hygiene; the synchronous
surface (update, pin, resize, invalidate) and the prefetching cache's
demand/speculative split, each against the reference's cache on the same
calls; and a stress test of the shared state under many workers."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.expert_cache import ExpertCache as JExpertCache
from repro.core.expert_cache import \
    PrefetchingExpertCache as JPrefetchingExpertCache
from repro_torch.core.expert_cache import (AsyncExpertCache, ExpertCache,
                                           PrefetchingExpertCache)


def make_async(capacity_experts=4, expert_kb=1, fetch_delay_s=0.0, **kw):
    nbytes = expert_kb * 1024
    fetched = []

    def fetch(key):
        if fetch_delay_s:
            time.sleep(fetch_delay_s)
        fetched.append(key)
        return torch.full((nbytes,), key[1] % 250, dtype=torch.uint8)

    cache = AsyncExpertCache(fetch, capacity_bytes=capacity_experts * nbytes,
                             device="cpu", **kw)
    return cache, fetched, nbytes


def xfer_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("expert-xfer") and t.is_alive()]


class TestAsyncStaging:
    def test_prefetch_is_non_blocking(self):
        c, fetched, _ = make_async(fetch_delay_s=0.05)
        t0 = time.perf_counter()
        n = c.prefetch([(0, 0), (0, 1)])
        enqueue_s = time.perf_counter() - t0
        assert n == 2
        assert enqueue_s < 0.04          # returned before the fetches ran
        c.drain()
        assert set(fetched) == {(0, 0), (0, 1)}
        assert set(c.resident_keys()) == {(0, 0), (0, 1)}
        c.close()

    def test_speculative_traffic_never_pollutes_demand_stats(self):
        c, _, nb = make_async()
        c.prefetch([(0, 0), (0, 1)])
        c.drain()
        assert c.stats.prefetch_bytes == 2 * nb
        assert c.stats.bytes_in == 0
        assert c.stats.misses == 0
        assert c.stats.transfer_s == 0.0
        assert c.stats.prefetch_s > 0.0
        assert c.wait([(0, 0), (0, 1)]) == 0     # a hit, not a transfer
        assert c.stats.hits == 2 and c.stats.bytes_in == 0
        c.close()

    def test_wait_demand_fetches_and_accounts(self):
        c, _, nb = make_async()
        assert c.wait([(1, 0), (1, 1), (1, 2)]) == 3
        assert c.stats.misses == 3
        assert c.stats.bytes_in == 3 * nb
        assert c.stats.transfer_s > 0.0
        assert set(c.resident_keys()) == {(1, 0), (1, 1), (1, 2)}
        c.close()

    def test_demand_on_inflight_speculative_blocks_remainder_only(self):
        c, _, _ = make_async(fetch_delay_s=0.05)
        c.prefetch([(2, 0)])
        # the speculative fetch is still in flight: the demand attaches to
        # its future instead of transferring again
        assert c.wait([(2, 0)]) == 0
        assert c.stats.misses == 0
        assert c.stats.bytes_in == 0
        assert c.stats.prefetch_bytes > 0
        assert (2, 0) in c.resident_keys()
        c.close()

    def test_get_demand_and_hit_paths(self):
        c, _, _ = make_async()
        assert int(c.get((3, 7))[0]) == 7
        assert c.stats.misses == 1
        c.get((3, 7))
        assert c.stats.hits == 1
        c.close()

    def test_prefetch_dedupes_inflight_and_resident(self):
        c, fetched, _ = make_async(fetch_delay_s=0.02)
        assert c.prefetch([(0, 0)]) == 1
        assert c.prefetch([(0, 0)]) == 0        # already in flight
        c.drain()
        assert c.prefetch([(0, 0)]) == 0        # already resident
        assert c.prefetch_hits == 1
        assert fetched.count((0, 0)) == 1
        c.close()


class TestAsyncLRU:
    def test_capacity_respected_with_inflight_fetches(self):
        c, _, _ = make_async(capacity_experts=2, fetch_delay_s=0.005)
        c.prefetch([(0, i) for i in range(6)])
        c.drain()
        assert len(c.resident_keys()) <= 2
        assert c.used_bytes <= c.capacity
        assert c.stats.evictions >= 4
        c.close()

    def test_prefetch_hit_touches_lru_recency(self):
        c, _, _ = make_async(capacity_experts=2)
        c.wait([(0, 0), (0, 1)])                # LRU order: 0 then 1
        c.prefetch([(0, 0)])                    # predicted next: touch
        c.wait([(0, 2)])                        # evicts the LRU, (0, 1)
        assert (0, 0) in c.resident_keys()
        assert (0, 1) not in c.resident_keys()
        c.close()

    def test_evicted_prefetch_is_refetched_on_demand(self):
        c, _, _ = make_async(capacity_experts=2)
        c.prefetch([(0, 0)])
        c.drain()
        c.wait([(0, 1), (0, 2)])                # LRU-evicts (0, 0)
        assert (0, 0) not in c.resident_keys()
        assert c.wait([(0, 0)]) == 1            # an honest demand re-fetch
        assert (0, 0) in c.resident_keys()
        c.close()

    def test_resize_shrink_evicts_down_immediately(self):
        c, _, nb = make_async(capacity_experts=4)
        c.wait([(0, i) for i in range(4)])
        assert c.used_bytes == 4 * nb
        c.resize(2 * nb)
        assert c.used_bytes <= c.capacity == 2 * nb
        assert len(c.resident_keys()) <= 2
        assert c.stats.evictions >= 2
        c.close()


class TestLifecycle:
    def test_close_joins_workers_and_is_idempotent(self):
        c, _, _ = make_async(fetch_delay_s=0.01)
        c.prefetch([(0, i) for i in range(4)])
        c.close()
        assert not xfer_threads()
        c.close()                               # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            c.wait([(9, 9)])

    def test_drain_is_a_barrier(self):
        c, fetched, _ = make_async(capacity_experts=8, fetch_delay_s=0.01)
        c.prefetch([(0, i) for i in range(5)])
        c.drain()
        assert len(fetched) == 5
        c.close()

    def test_staging_buffers_bound_concurrent_copies(self):
        """At most ``staging_buffers`` loads run at once, however many
        workers there are."""
        live, peak, lock = [0], [0], threading.Lock()

        def fetch(key):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.01)
            with lock:
                live[0] -= 1
            return torch.zeros(16, dtype=torch.uint8)

        c = AsyncExpertCache(fetch, capacity_bytes=1 << 20, device="cpu",
                             workers=4, staging_buffers=2)
        c.prefetch([(0, i) for i in range(8)])
        c.close()
        assert peak[0] == 2

    def test_worker_error_reaches_the_waiter(self):
        def fetch(key):
            raise OSError(f"no blob for {key}")

        c = AsyncExpertCache(fetch, capacity_bytes=1024, device="cpu")
        with pytest.raises(OSError, match="no blob"):
            c.wait([(0, 0)])
        assert not c._inflight                  # the failed key is released
        c.close()


def test_stress_shared_state_under_many_workers():
    """Threads demanding and prefetching overlapping keys through 8
    workers with a short switch interval: no lost update — the byte count
    equals the resident entries' sizes and stays within the budget, and
    every transfer is counted exactly once as demand or speculation."""
    nb = 64
    loads = []
    count_lock = threading.Lock()

    def fetch(key):
        with count_lock:
            loads.append(key)
        return torch.zeros(nb, dtype=torch.uint8)

    c = AsyncExpertCache(fetch, capacity_bytes=6 * nb, device="cpu",
                         workers=8, staging_buffers=4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(seed):
            rng = np.random.default_rng(seed)
            for _ in range(60):
                keys = [(0, int(k)) for k in rng.integers(0, 12, 3)]
                if rng.random() < 0.5:
                    c.prefetch(keys)
                else:
                    c.wait(keys)

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        c.drain()
    finally:
        sys.setswitchinterval(old)
    resident = c.resident_keys()
    assert c.used_bytes == nb * len(resident) <= c.capacity
    assert c.stats.bytes_in + c.stats.prefetch_bytes == nb * len(loads)
    c.close()
    assert not xfer_threads()


# --------------------------------------------------------------------------
# The synchronous surface against the reference's caches
# --------------------------------------------------------------------------

def _pair(cls_t, cls_j, capacity_experts=3):
    """The port's and the reference's cache on the same loader (blob sizes
    differ per key, so the byte accounting is exercised)."""
    def size(key):
        return 100 * (1 + key[1] % 3)

    tcache = cls_t(lambda k: torch.zeros(size(k), dtype=torch.uint8),
                   capacity_bytes=capacity_experts * 200, device="cpu")
    jcache = cls_j(lambda k: np.zeros(size(k), np.uint8),
                   capacity_bytes=capacity_experts * 200)
    return tcache, jcache


def _same(tcache, jcache):
    assert tcache.resident_keys() == jcache.resident_keys()
    assert tcache.used_bytes == jcache.used_bytes
    for f in ("hits", "misses", "evictions", "bytes_in", "prefetch_bytes"):
        assert getattr(tcache.stats, f) == getattr(jcache.stats, f), f


def test_sync_surface_follows_the_reference():
    tcache, jcache = _pair(ExpertCache, JExpertCache)
    for c in (tcache, jcache):
        c.pin([(0, 0), (0, 1), (0, 2)])
        c.get((0, 0))
        c.get((1, 4))
    _same(tcache, jcache)
    assert tcache.update((0, 0), torch.zeros(350, dtype=torch.uint8)) == \
        jcache.update((0, 0), np.zeros(350, np.uint8))
    assert tcache.update((5, 5), torch.zeros(50, dtype=torch.uint8)) == \
        jcache.update((5, 5), np.zeros(50, np.uint8)) == 50
    _same(tcache, jcache)
    for c in (tcache, jcache):
        c.invalidate([(0, 0), (9, 9)])
        c.resize(250)
    _same(tcache, jcache)
    assert tcache.used_bytes <= 250
    for c in (tcache, jcache):
        c.invalidate()
        c.drain()
        c.close()
    _same(tcache, jcache)
    assert tcache._peek((0, 1)) is None


def test_prefetching_cache_follows_the_reference():
    tcache, jcache = _pair(PrefetchingExpertCache, JPrefetchingExpertCache)
    for c in (tcache, jcache):
        c.hint([(0, 0), (0, 1)])
        c.get((0, 0))
        c.hint([(0, 0), (0, 2), (0, 4)])
        c.get((0, 3))
    _same(tcache, jcache)
    assert tcache.prefetch_hits == jcache.prefetch_hits
    assert tcache.stats.prefetch_s > 0 and tcache.stats.misses == 1
