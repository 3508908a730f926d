"""Host-side page allocator for the paged KV cache (DESIGN.md §13); a
copy of ``repro.serving.paged_kv`` (numpy only).

The device pool and its gather/scatter live in ``models/model.py``; this
module owns the bookkeeping the engine drives every iteration: the
per-slot page table (chunk index -> physical page, 0 = the reserved null
page), the free list, and the byte accounting that makes the paged win
measurable (``engine.summary()``'s kv columns) and feeds reclaimed HBM
back into the frontier's residency axis (``EngineConfig.kv_reserve``).

Allocation never dead-ends mid-flight: the engine derives an admission
cap (``max_active_tokens``) from the pool size whenever the pool is
smaller than worst case, so ``ensure()`` failing is a logic error, not an
operational state.

A pool placed per data rank (``ranks`` > 1: a mesh that splits the dense
compute, where each data rank's positions hold its slots' pages only)
splits the slots and the pages alike: slot ``s`` belongs to rank ``s //
(num_slots / ranks)`` and takes pages from that rank's range ``[r * n, (r
+ 1) * n)`` (``n = num_pages / ranks``), whose first page is the rank's
own null page; the engine's admission cap then holds per rank. With one
rank the page ids and the allocator's behaviour are the reference's.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List

import numpy as np

__all__ = ["PageAllocator"]


class PageAllocator:
    """Per-slot page table + free list over ``num_pages`` physical pages.

    Page 0 is the reserved null page: it marks unmapped chunks in the
    table and is never handed out. The table is the exact array the
    engine turns into the paged step's index tensors each iteration
    (``models.model.page_table``).
    """

    def __init__(self, num_slots: int, chunks_per_slot: int,
                 num_pages: int, page_size: int, ranks: int = 1):
        if num_slots % ranks or num_pages % ranks:
            raise ValueError(f"{num_slots} slots and {num_pages} pages must "
                             f"split over {ranks} data ranks")
        self.num_slots = num_slots
        self.chunks_per_slot = chunks_per_slot
        self.num_pages = num_pages
        self.page_size = page_size
        self.ranks = ranks
        #: chunk -> physical page; 0 = unmapped (the null page)
        self.table = np.zeros((num_slots, chunks_per_slot), np.int32)
        per = num_pages // ranks
        #: each data rank's free list over its own page range
        self._frees: List[Deque[int]] = [
            deque(range(r * per + 1, (r + 1) * per)) for r in range(ranks)]

    def rank_of(self, slot: int) -> int:
        """The data rank whose pages ``slot`` takes."""
        return slot // (self.num_slots // self.ranks)

    @property
    def usable_pages(self) -> int:
        """Pages that can be handed out (every rank's null page aside)."""
        return self.num_pages - self.ranks

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._frees)

    @property
    def pages_in_use(self) -> int:
        return self.usable_pages - self.free_pages

    def ensure(self, slot: int, chunk: int) -> int:
        """Map ``chunk`` of ``slot`` (no-op if already mapped); returns
        the physical page."""
        page = int(self.table[slot, chunk])
        if page:
            return page
        free = self._frees[self.rank_of(slot)]
        if not free:
            raise RuntimeError(
                f"KV page pool exhausted ({self.usable_pages // self.ranks} "
                "pages per data rank); the admission cap should have "
                "prevented this")
        page = free.popleft()
        self.table[slot, chunk] = page
        return page

    def ensure_prefix(self, slot: int, tokens: int) -> List[int]:
        """Map every chunk a ``tokens``-long prefill writes (ring indices
        0..tokens-1; the scheduler already validated tokens <= window);
        returns the pages touched."""
        chunks = min(-(-tokens // self.page_size), self.chunks_per_slot)
        return [self.ensure(slot, c) for c in range(chunks)]

    def ensure_index(self, slot: int, ring_index: int) -> int:
        """Map the chunk containing ``ring_index`` (the decode write
        target ``position % window``)."""
        return self.ensure(slot, ring_index // self.page_size)

    def truncate(self, slot: int, new_len: int) -> List[int]:
        """Unmap every chunk past a ``new_len``-token ring prefix (chunk
        ``ceil(new_len / page_size)`` onward); returns the freed pages.

        This is the page-residency analog of the device-side rollback:
        rejected speculative tokens and early-stopped requests would
        otherwise hold their tail pages until retire (DESIGN.md §17).
        The caller must already have invalidated the freed pages'
        position tags on device (the speculative rollback bounds tags
        BEFORE truncation; retire uses ``free_slot`` + reset instead).
        No-op (returns []) when the prefix already covers every mapped
        chunk. NOTE: only meaningful while the slot's live ring span is
        the prefix 0..new_len-1 (pre-wraparound) — after the ring wraps,
        every chunk is live and truncate must not be called."""
        keep = min(-(-max(new_len, 0) // self.page_size),
                   self.chunks_per_slot)
        freed = [int(p) for p in self.table[slot, keep:] if p]
        self.table[slot, keep:] = 0
        self._frees[self.rank_of(slot)].extend(freed)
        return freed

    def free_slot(self, slot: int) -> List[int]:
        """Unmap the slot's pages back to the free list; returns the
        freed page ids (the engine invalidates their position tags on
        device before they can be re-handed out)."""
        pages = [int(p) for p in self.table[slot] if p]
        self.table[slot] = 0
        self._frees[self.rank_of(slot)].extend(pages)
        return pages

    def slot_pages(self, slot: int) -> List[int]:
        return [int(p) for p in self.table[slot] if p]
