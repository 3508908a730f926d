"""Admission control with SLO classes, queue caps and priority
preemption (DESIGN.md §14.3).

A tenant is *active* once its trace ``join`` fires and until it leaves;
it only receives service while *admitted* to an engine replica. The
admission controller closes the gap between the two:

* **admission** — pending tenants (new joiners and previously preempted
  ones) are placed on the replica with the most committed-rate headroom,
  highest SLO priority first; a tenant that does not fit anywhere stays
  pending (its queue keeps accruing, capped by its class's
  ``queue_cap_tokens`` — the overflow is *dropped* and accounted).
* **preemption** — a replica whose measured utilization pins at 1 while
  its backlog grows for ``patience_ticks`` consecutive ticks sheds its
  lowest-priority tenants until its committed rate falls to
  ``drain_to`` × capacity. Preempted tenants drain through the replica
  repoint path (the arbiter re-selects the smaller demand's frontier
  point and the diff emits a §10.3
  :class:`~repro_torch.serving.multi.ReplanReport`).
* **aging (no starvation)** — a tenant preempted (or never admitted)
  longer than its class's ``aging_s`` is FORCE-admitted onto the
  least-committed replica, overcommitting it if necessary. Because
  per-replica service is weighted-fair across admitted tenants (never
  strict-priority starvation, §14.3), forced admission guarantees
  progress within one tick; fresh force-admits are shielded from
  immediate re-preemption for one tick.

The controller is deliberately stateless across ticks except for the
per-replica overload streaks — all tenant state lives in the control
plane's arrays, so policies can be swapped per scenario.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["SLOClass", "DEFAULT_SLO_CLASSES", "AdmissionController"]


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service class: admission priority, throughput floor, backlog
    cap, aging window and weighted-fair share weight."""
    name: str
    priority: int             # higher admits first / preempts last
    min_tokens_per_s: float   # per-tenant SLO floor (violation accounting)
    queue_cap_tokens: float   # backlog cap; arrivals beyond are dropped
    aging_s: float            # max unserved span before forced admission
    weight: float = 1.0       # weighted-fair share within a replica

    def __post_init__(self):
        if self.weight <= 0 or self.aging_s <= 0:
            raise ValueError(f"SLO class {self.name!r}: weight and aging_s "
                             "must be positive")


DEFAULT_SLO_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("gold", priority=2, min_tokens_per_s=4.0,
             queue_cap_tokens=2400.0, aging_s=240.0, weight=4.0),
    SLOClass("silver", priority=1, min_tokens_per_s=1.0,
             queue_cap_tokens=1200.0, aging_s=600.0, weight=2.0),
    SLOClass("bronze", priority=0, min_tokens_per_s=0.25,
             queue_cap_tokens=600.0, aging_s=1800.0, weight=1.0),
)


class AdmissionController:
    """Admission / preemption / aging over the control plane's tenant
    arrays (the plane is duck-typed — see ControlPlane for the field
    contract)."""

    def __init__(self, classes: Sequence[SLOClass], *,
                 admit_headroom: float = 0.90,
                 preempt_util: float = 0.999,
                 patience_ticks: int = 3,
                 drain_to: float = 0.85):
        self.classes = tuple(classes)
        self.admit_headroom = admit_headroom
        self.preempt_util = preempt_util
        self.patience_ticks = patience_ticks
        self.drain_to = drain_to
        #: replica id -> consecutive overloaded ticks
        self._streak: Dict[int, int] = {}

    # -- helpers ------------------------------------------------------------
    def _headroom(self, plane, r) -> float:
        cap = r.capacity_tps(plane.scn.slots_per_replica)
        return cap * self.admit_headroom - plane.committed_rate(r.id)

    def _place(self, plane, i: int, now: float, force: bool) -> bool:
        """Assign tenant ``i`` to the replica with the most headroom; a
        forced (aged) placement overcommits the least-committed replica
        instead of failing."""
        best, best_h = None, -np.inf
        for r in plane.replicas:
            h = self._headroom(plane, r)
            if h > best_h:
                best, best_h = r, h
        if best is None:
            return False
        if best_h < plane.base_rate[i] and not force:
            return False
        plane.admit(i, best.id, now, forced=force)
        return True

    # -- the per-tick control pass ------------------------------------------
    def step(self, plane, now: float, dt: float) -> int:
        """Aging readmission -> ordinary admission -> overload
        preemption. Returns the number of tenants preempted this tick
        (the plane re-arbitrates when > 0, draining the preempted load
        through the replica repoint path)."""
        self._admit(plane, now)
        return self._preempt(plane, now, dt)

    def _pending_order(self, plane, ids: np.ndarray) -> list:
        """Priority desc, then longest-unserved first, then id — a
        deterministic total order."""
        pr = plane.priority[ids]
        waited = plane.unserved_since[ids]
        order = np.lexsort((ids, waited, -pr))
        return [int(i) for i in ids[order]]

    def _admit(self, plane, now: float) -> None:
        ids = np.nonzero(plane.active & ~plane.admitted)[0]
        if ids.size == 0 or not plane.replicas:
            return
        for i in self._pending_order(plane, ids):
            aged = (now - plane.unserved_since[i]
                    >= self.classes[plane.cls[i]].aging_s)
            self._place(plane, i, now, force=bool(aged))

    def _preempt(self, plane, now: float, dt: float) -> int:
        preempted = 0
        for r in plane.replicas:
            cap = r.capacity_tps(plane.scn.slots_per_replica)
            overloaded = (plane.replica_util.get(r.id, 0.0)
                          >= self.preempt_util
                          and plane.replica_backlog_growth.get(r.id, 0.0)
                          > 1e-9)
            streak = self._streak.get(r.id, 0) + 1 if overloaded else 0
            self._streak[r.id] = streak
            if streak < self.patience_ticks:
                continue
            target = cap * self.drain_to
            ids = np.nonzero(plane.admitted & (plane.replica_of == r.id))[0]
            # victims: lowest priority first, newest-admitted first;
            # skip force-admitted tenants placed within the last tick
            # (the no-starvation shield)
            order = np.lexsort((-ids, -plane.last_admit_t[ids],
                                plane.priority[ids]))
            for i in ids[order]:
                if plane.committed_rate(r.id) <= target:
                    break
                if now - plane.last_admit_t[i] < 1.5 * dt \
                        and plane.forced_admit[i]:
                    continue
                plane.preempt(int(i), now, reason=f"overload r{r.id}")
                preempted += 1
            self._streak[r.id] = 0
        return preempted
