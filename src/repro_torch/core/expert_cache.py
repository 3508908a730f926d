"""Device-resident expert cache with LRU replacement + swap space (paper §3).

The serving engine keeps every expert's weights in the precision rung the
active plan assigns it as a host blob (pinned memory on a CUDA host) and a
bounded device cache keyed by (layer, expert). On a miss the blob is
copied to the device and the copy is timed; hits/misses and transferred
bytes feed the serving metrics and validate the cost model.

This slice ports the synchronous ``ExpertCache`` and ``CacheStats`` of
``repro.core.expert_cache``; the asynchronous and prefetching caches are
later work.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Hashable, Tuple

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
    #: SPECULATIVE traffic (kept apart so miss-rate and transfer metrics
    #: never conflate demand with speculation; always 0 in this slice).
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

    def _admit(self, key: Hashable, host) -> None:
        """Copy a host tree to the device (from pinned memory where the
        blob is pinned), wait for the copy and time it."""
        nb = _nbytes(host)
        self._evict_until(nb)
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        dev = _to_device(host, self.device)
        if sync:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.stats.transfer_s += dt
        self.stats.bytes_in += nb
        self._cache[key] = (dev, nb)
        self._used += nb

    def _evict_until(self, need: int):
        while self._cache and self._used + need > self.capacity:
            _, (old, nb) = self._cache.popitem(last=False)
            del old
            self._used -= nb
            self.stats.evictions += 1

    def invalidate(self, keys=None):
        if keys is None:
            self.stats.evictions += len(self._cache)
            self._cache.clear()
            self._used = 0
            return
        for k in list(keys):
            if k in self._cache:
                self._used -= self._cache.pop(k)[1]
                self.stats.evictions += 1

    def close(self):
        """No transfer workers to join — no-op."""

    @property
    def used_bytes(self) -> int:
        return self._used

    def resident_keys(self):
        return list(self._cache.keys())
