"""The trace-driven control plane (DESIGN.md §14).

Ties the seeded trace layer, the admission controller, the replica
autoscaler and the SLO ledger into one deterministic event loop over
the :class:`~repro_torch.serving.simulator.VirtualClock` heap:

* **tenants** are fluid flows (offered tokens/s with a backlog queue),
  vectorized in numpy arrays — a thousand tenants cost a handful of
  array ops per tick, which is what lets 1000 tenants x 100k virtual
  seconds replay in seconds of wall-clock;
* **replicas** are :class:`~repro_torch.serving.simulator.SimulatedEngine`
  instances (replica capacity = frontier-point tokens/s x decode
  slots); each serves its admitted tenants by weighted-fair sharing
  (class weights — work-conserving, so no admitted tenant starves);
* **the arbiter** is
  :class:`~repro_torch.serving.multi.ResourceArbiter`
  verbatim: each replica is an arbitration entry whose QoS floor is its
  committed + share-of-pending demand, water-filled under the global
  HBM budget. A re-arbitration runs on exactly four triggers — start,
  budget shock, scale event, preemption drain — and every replica
  point change diffs the old/new precision plans into a §10.3
  :class:`~repro_torch.serving.multi.ReplanReport` whose downtime is charged
  to the hosted tenants.

Same seed => byte-identical report (:meth:`ControlPlane.report_bytes`):
all randomness flows through one seeded generator in fixed draw order,
virtual time never touches the wall clock, and every iteration order is
total. ``tests/test_control_plane.py`` pins determinism, no-starvation,
autoscaler hysteresis and the one-arbitration-per-shock invariant.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.pareto import FrontierPoint, ParetoFrontier, QoSTarget
from repro_torch.core.precision_plan import (migrated_expert_keys,
                                             reconfig_delta)
from repro_torch.serving.multi import (GlobalBudgetInfeasible,
                                       ReplanReport, ResourceArbiter,
                                       TenantSpec)
from repro_torch.serving.simulator import SimulatedEngine, VirtualClock

from .admission import (AdmissionController, DEFAULT_SLO_CLASSES, SLOClass)
from .autoscale import ReplicaAutoscaler
from .ledger import SLOLedger
from .traces import (GIB, Scenario, TraceEvent, build_population,
                     make_arrival_model, trace_events)

__all__ = ["ControlPlane", "Replica", "run_scenario"]


def _r6(x) -> float:
    return round(float(x), 6)


class Replica:
    """One autoscaled engine replica: a SimulatedEngine plus the
    control-plane bookkeeping around it."""

    __slots__ = ("id", "engine", "point", "created_s", "retired_s",
                 "down_until", "replans", "downtime_s", "served_tokens",
                 "prev_backlog")

    def __init__(self, rid: int, engine: SimulatedEngine, created_s: float):
        self.id = rid
        self.engine = engine
        self.point: Optional[FrontierPoint] = None
        self.created_s = created_s
        self.retired_s: Optional[float] = None
        self.down_until = 0.0
        self.replans = 0
        self.downtime_s = 0.0
        self.served_tokens = 0.0
        self.prev_backlog = 0.0

    def capacity_tps(self, slots: int) -> float:
        return 0.0 if self.point is None \
            else self.point.qos.tokens_per_s * slots


def _weighted_fair(queue: np.ndarray, weight: np.ndarray,
                   cap_tokens: float, rounds: int = 4) -> np.ndarray:
    """Work-conserving weighted-fair allocation of ``cap_tokens`` over
    backlogs: iterative filling — every tenant with backlog gets at
    least its weight share per round, surplus from short queues is
    redistributed. Deterministic and O(rounds * n)."""
    served = np.zeros_like(queue)
    rem = queue.copy()
    cap = float(cap_tokens)
    for _ in range(rounds):
        m = rem > 1e-9
        if cap <= 1e-9 or not m.any():
            break
        w = np.where(m, weight, 0.0)
        share = cap * w / w.sum()
        s = np.minimum(rem, share)
        served += s
        rem -= s
        cap -= float(s.sum())
    return served


class ControlPlane:
    """Single-shot deterministic run of one :class:`Scenario`."""

    def __init__(self, scenario: Scenario, *,
                 classes: Sequence[SLOClass] = DEFAULT_SLO_CLASSES,
                 frontier: Optional[ParetoFrontier] = None):
        self.scn = scenario
        self.classes = tuple(classes)
        self.cfg = get_config(scenario.arch)
        self.frontier = frontier if frontier is not None \
            else ParetoFrontier(self.cfg)
        self.cheapest_bytes = min(p.qos.device_bytes
                                  for p in self.frontier.points)
        self.rng = np.random.default_rng(scenario.seed)
        self.pop = build_population(scenario, len(self.classes), self.rng)
        self.arrivals = make_arrival_model(scenario, self.pop)
        self.arrivals.reset(self.pop.n, self.rng)
        self.clock = VirtualClock()
        self._trace: List[TraceEvent] = trace_events(self.pop, scenario)
        self.arbiter = ResourceArbiter(scenario.floor_weight)
        self.admission = AdmissionController(
            self.classes, admit_headroom=scenario.admit_headroom,
            preempt_util=scenario.preempt_util,
            patience_ticks=scenario.preempt_patience_ticks,
            drain_to=scenario.preempt_drain_to)
        self.autoscaler = ReplicaAutoscaler(
            band=scenario.util_band,
            patience_ticks=scenario.scale_patience_ticks,
            cooldown_s=scenario.scale_cooldown_s,
            min_replicas=scenario.min_replicas,
            max_replicas=scenario.max_replicas)
        n = self.pop.n
        self.base_rate = self.pop.base_rate
        self.cls = self.pop.cls
        self.priority = np.array([self.classes[c].priority
                                  for c in self.cls], dtype=np.int64)
        self.weight = np.array([self.classes[c].weight for c in self.cls])
        self.floor = np.array([self.classes[c].min_tokens_per_s
                               for c in self.cls])
        self.queue_cap = np.array([self.classes[c].queue_cap_tokens
                                   for c in self.cls])
        self.active = np.zeros(n, dtype=bool)
        self.admitted = np.zeros(n, dtype=bool)
        self.replica_of = np.full(n, -1, dtype=np.int64)
        self.queue = np.zeros(n)
        #: when the tenant last became active-but-unserved (inf while
        #: served or inactive) — the aging / no-starvation clock
        self.unserved_since = np.full(n, math.inf)
        self.last_admit_t = np.full(n, -math.inf)
        self.forced_admit = np.zeros(n, dtype=bool)
        self.ledger = SLOLedger(n)
        self.replicas: List[Replica] = []
        self._retired: List[Replica] = []
        self._next_rid = 0
        self._committed: Dict[int, float] = {}
        self.replica_util: Dict[int, float] = {}
        self.replica_backlog_growth: Dict[int, float] = {}
        self._budget0 = float(scenario.budget_bytes)
        self.budget_bytes = self._budget0
        self.used_bytes = 0.0
        self.reports: List[ReplanReport] = []
        self.events: List[dict] = []
        self.metrics: Dict[str, float] = {
            "arbitrations": 0, "replans": 0, "migrated_bytes": 0,
            "scale_ups": 0, "scale_downs": 0, "preemptions": 0,
            "forced_admissions": 0, "events_dropped": 0,
            "replicas_peak": 0,
        }
        self._ran = False

    # -- tenant lifecycle (the admission controller's plane contract) -------
    def committed_rate(self, rid: int) -> float:
        return self._committed.get(rid, 0.0)

    def admit(self, i: int, rid: int, now: float, forced: bool = False):
        if math.isfinite(self.unserved_since[i]):
            self.ledger.note_unserved_span(
                i, now - self.unserved_since[i])
        self.admitted[i] = True
        self.replica_of[i] = rid
        self._committed[rid] = self._committed.get(rid, 0.0) \
            + float(self.base_rate[i])
        self.last_admit_t[i] = now
        self.forced_admit[i] = forced
        self.unserved_since[i] = math.inf
        if forced:
            self.metrics["forced_admissions"] += 1

    def preempt(self, i: int, now: float, reason: str = ""):
        self._unassign(i)
        self.ledger.preemptions[i] += 1
        self.metrics["preemptions"] += 1
        self.unserved_since[i] = now

    def _unassign(self, i: int):
        rid = int(self.replica_of[i])
        if rid >= 0:
            self._committed[rid] -= float(self.base_rate[i])
        self.admitted[i] = False
        self.replica_of[i] = -1
        self.forced_admit[i] = False

    def _join(self, i: int, now: float):
        self.active[i] = True
        self.unserved_since[i] = now

    def _leave(self, i: int, now: float):
        if self.admitted[i]:
            self._unassign(i)
        elif math.isfinite(self.unserved_since[i]):
            self.ledger.note_unserved_span(i, now - self.unserved_since[i])
        self.active[i] = False
        # abandoned backlog is accounted as dropped, closing the
        # arrived == served + dropped + backlog balance
        self.ledger.dropped[i] += self.queue[i]
        self.queue[i] = 0.0
        self.unserved_since[i] = math.inf

    # -- replicas / arbitration ---------------------------------------------
    def _can_add_replica(self) -> bool:
        return (len(self.replicas) + 1) * self.cheapest_bytes \
            <= self.budget_bytes

    def _add_replica(self, now: float) -> Replica:
        slots = self.scn.slots_per_replica
        eng = SimulatedEngine(
            throughput_fn=lambda p, it, s=slots: p.qos.tokens_per_s * s)
        r = Replica(self._next_rid, eng, now)
        self._next_rid += 1
        self.replicas.append(r)
        self._committed[r.id] = 0.0
        self.metrics["replicas_peak"] = max(self.metrics["replicas_peak"],
                                            len(self.replicas))
        return r

    def _pick_retire(self) -> Replica:
        return min(self.replicas,
                   key=lambda r: (self._committed[r.id], -r.id))

    def _retire_replica(self, r: Replica, now: float, reason: str):
        self.replicas.remove(r)
        r.retired_s = now
        self._retired.append(r)
        ids = np.nonzero(self.admitted & (self.replica_of == r.id))[0]
        order = np.lexsort((ids, -self.priority[ids]))
        for i in ids[order]:
            i = int(i)
            self._unassign(i)
            # immediate best-effort re-placement; the rest go pending
            if not self.admission._place(self, i, now, force=False):
                self.unserved_since[i] = now
        self._committed.pop(r.id, None)
        self.replica_util.pop(r.id, None)
        self.replica_backlog_growth.pop(r.id, None)

    def _rebalance_to_new(self, now: float):
        """After a scale-up, move low-priority committed load from the
        fullest replicas onto the (empty) newest one until it reaches
        the fleet mean."""
        new = self.replicas[-1]
        mean = sum(self._committed.values()) / len(self.replicas)
        donors = sorted(self.replicas[:-1],
                        key=lambda r: (-self._committed[r.id], r.id))
        for r in donors:
            ids = np.nonzero(self.admitted & (self.replica_of == r.id))[0]
            order = np.lexsort((-ids, self.priority[ids]))
            for i in ids[order]:
                if self._committed[new.id] >= mean \
                        or self._committed[r.id] <= mean:
                    break
                i = int(i)
                self._unassign(i)
                self.admit(i, new.id, now)

    def _arbitrate(self, now: float, reason: str):
        slots = self.scn.slots_per_replica
        pending = float(self.base_rate[self.active & ~self.admitted].sum())
        share = pending / max(len(self.replicas), 1)
        entries = []
        for r in self.replicas:
            req_total = self._committed[r.id] + share
            req_stream = req_total / slots
            tgt = QoSTarget(min_tokens_per_s=req_stream
                            if req_stream > 1e-9 else None)
            entries.append((TenantSpec(f"r{r.id}", tgt,
                                       weight=max(req_total, 1e-3)),
                            self.frontier, 1.0))
        sel, used = self.arbiter.arbitrate(entries, self.budget_bytes)
        self.used_bytes = used
        for r in self.replicas:
            p = sel[f"r{r.id}"]
            if p is not r.point:
                self._repoint(r, p, now)
        self.metrics["arbitrations"] += 1
        self._record_event(now, "arbitrate",
                           f"{reason} R={len(self.replicas)} "
                           f"used={used / GIB:.2f}GiB")

    def _repoint(self, r: Replica, point: FrontierPoint, now: float):
        """Apply a new frontier point to a replica through the partial-
        reconfiguration diff path (DESIGN.md §10.3): only changed
        experts migrate, the transfer downtime stalls the replica and is
        charged to its hosted tenants."""
        old = r.point
        r.engine.apply_frontier_point(point)
        r.point = point
        if old is None:
            return
        delta = reconfig_delta(old.plan, point.plan)
        keys = migrated_expert_keys(delta, point.plan)
        mbytes = sum(self.cfg.expert_param_bytes(int(point.plan.bits[l, e]))
                     for (l, e) in keys)
        downtime = mbytes / self.frontier.hw.host_link_bw
        placement_only = (old.plan.bank_sizes() == point.plan.bank_sizes()
                          and old.plan.seed == point.plan.seed)
        rep = ReplanReport(
            tenant=f"replica-{r.id}", migrated_experts=len(keys),
            evicted_experts=len(delta["to_evict"]),
            migrated_bytes=int(mbytes), downtime_s=downtime,
            placement_only=placement_only)
        self.reports.append(rep)
        r.replans += 1
        r.downtime_s += downtime
        r.down_until = max(r.down_until, now + downtime)
        self.metrics["replans"] += 1
        self.metrics["migrated_bytes"] += rep.migrated_bytes
        self.ledger.charge_downtime(
            self.admitted & (self.replica_of == r.id), downtime)

    # -- events --------------------------------------------------------------
    def _record_event(self, t: float, kind: str, detail: str):
        if len(self.events) < self.scn.max_recorded_events:
            self.events.append({"t": round(float(t), 3), "kind": kind,
                                "detail": detail})
        else:
            self.metrics["events_dropped"] += 1

    def _apply_trace_event(self, ev: TraceEvent, now: float):
        if ev.kind == "join":
            self._join(ev.tenant, now)
        elif ev.kind == "leave":
            self._leave(ev.tenant, now)
        elif ev.kind == "budget":
            self.budget_bytes = ev.value * self._budget0
            self._record_event(now, "budget",
                               f"x{ev.value:g} -> "
                               f"{self.budget_bytes / GIB:.2f}GiB")
            # forced retirement keeps the joint footprint feasible —
            # a deep shock may shrink the fleet below min_replicas
            # (feasibility beats the autoscaler floor); the shock
            # itself re-arbitrates exactly once
            while len(self.replicas) > 1 \
                    and len(self.replicas) * self.cheapest_bytes \
                    > self.budget_bytes:
                self._retire_replica(self._pick_retire(), now, "budget")
                self.metrics["scale_downs"] += 1
            self._arbitrate(now, "budget-shock")
        else:
            raise ValueError(f"unknown trace event kind {ev.kind!r}")

    # -- the tick ------------------------------------------------------------
    def _tick(self, t0: float, t1: float):
        dt = t1 - t0
        scn = self.scn
        slots = scn.slots_per_replica
        act = self.active
        counts = self.arrivals.counts(t0, dt, self.base_rate, act, self.rng)
        self.ledger.arrived += counts
        self.queue += counts
        over = np.maximum(self.queue - self.queue_cap, 0.0)
        self.queue -= over
        self.ledger.dropped += over
        demand_rate = self.queue / dt
        served = np.zeros(self.pop.n)
        for r in self.replicas:
            cap_tps = r.capacity_tps(slots)
            down = min(max(r.down_until - t0, 0.0), dt)
            mask = self.admitted & (self.replica_of == r.id)
            backlog_before = float(self.queue[mask].sum())
            s = _weighted_fair(self.queue[mask], self.weight[mask],
                               cap_tps * (dt - down))
            served[mask] = s
            r_served = float(s.sum())
            r.engine.run_iteration(batch=r_served)
            r.served_tokens += r_served
            denom = cap_tps * dt
            self.replica_util[r.id] = r_served / denom if denom > 0 else 0.0
            end_backlog = backlog_before - r_served
            self.replica_backlog_growth[r.id] = end_backlog - r.prev_backlog
            r.prev_backlog = end_backlog
        self.queue -= served
        self.ledger.served += served
        self.ledger.record_tick(dt, act, self.admitted, demand_rate,
                                served / dt, self.floor, self.queue)
        # control pass: admission/preemption -> autoscaling
        npre = self.admission.step(self, t1, dt)
        if npre:
            self._record_event(t1, "preempt", f"{npre} tenants drained")
            self._arbitrate(t1, "preempt-drain")
        mean_rate = self.arrivals.mean_rate(t1, self.base_rate)
        demand = float(mean_rate[act].sum())
        cap_total = sum(r.capacity_tps(slots) for r in self.replicas)
        demand_util = demand / max(cap_total, 1e-9)
        delta = self.autoscaler.step(
            t1, demand_util, len(self.replicas),
            can_add=self._can_add_replica(),
            can_remove=len(self.replicas) > scn.min_replicas)
        if delta > 0:
            self._add_replica(t1)
            self._rebalance_to_new(t1)
            self.metrics["scale_ups"] += 1
            self._record_event(t1, "scale-up",
                               f"R={len(self.replicas)} "
                               f"util_d={demand_util:.3f}")
            self._arbitrate(t1, "scale-up")
        elif delta < 0:
            r = self._pick_retire()
            self._retire_replica(r, t1, "scale-down")
            self.metrics["scale_downs"] += 1
            self._record_event(t1, "scale-down",
                               f"R={len(self.replicas)} "
                               f"util_d={demand_util:.3f}")
            self._arbitrate(t1, "scale-down")

    # -- the run -------------------------------------------------------------
    def run(self) -> dict:
        if self._ran:
            raise RuntimeError("ControlPlane.run() is single-shot — build "
                               "a fresh plane to replay the scenario")
        self._ran = True
        scn = self.scn
        if scn.min_replicas * self.cheapest_bytes > self.budget_bytes:
            raise GlobalBudgetInfeasible(
                f"{scn.min_replicas} replicas x cheapest point "
                f"{self.cheapest_bytes / GIB:.2f}GiB exceeds the budget "
                f"{self.budget_bytes / GIB:.2f}GiB")
        for i in np.nonzero(self.pop.join_t <= 0)[0]:
            self._join(int(i), 0.0)
        for ev in self._trace:
            self.clock.schedule_at(ev.t, ev)
        for _ in range(scn.min_replicas):
            self._add_replica(0.0)
        self._arbitrate(0.0, "initial")
        t = 0.0
        while t < scn.horizon_s - 1e-9:
            t1 = min(t + scn.tick_s, scn.horizon_s)
            self.clock.advance_to(t1)
            for ev in self.clock.pop_due():
                self._apply_trace_event(ev, t1)
            self._tick(t, t1)
            t = t1
        # close the unserved spans still open at the horizon
        open_ids = np.nonzero(np.isfinite(self.unserved_since)
                              & self.active)[0]
        if open_ids.size:
            self.ledger.note_unserved_span(
                open_ids, scn.horizon_s - self.unserved_since[open_ids])
        return self.report()

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict:
        led = self.ledger
        scn = self.scn
        m = self.metrics
        active_s = float(led.active_s.sum())
        viol = float(led.violation_s.sum())
        all_hist = led.lat_hist.sum(axis=0, keepdims=True)
        reps = sorted(self.replicas + self._retired, key=lambda r: r.id)
        return {
            "schema": 1,
            "scenario": {
                "name": scn.name, "seed": scn.seed, "arch": scn.arch,
                "tenants": scn.tenants, "horizon_s": _r6(scn.horizon_s),
                "tick_s": _r6(scn.tick_s), "arrival": scn.arrival,
                "budget_gib": _r6(self._budget0 / GIB),
                "slots_per_replica": scn.slots_per_replica,
            },
            "totals": {
                "arrived_tokens": _r6(led.arrived.sum()),
                "served_tokens": _r6(led.served.sum()),
                "dropped_tokens": _r6(led.dropped.sum()),
                "goodput_tps": _r6(led.served.sum() / scn.horizon_s),
                "violation_s": _r6(viol),
                "active_tenant_s": _r6(active_s),
                "violation_rate": _r6(viol / max(active_s, 1e-9)),
                "p95_latency_s": _r6(led.percentile(0.95, all_hist)[0]),
                "p99_latency_s": _r6(led.percentile(0.99, all_hist)[0]),
                "max_unserved_span_s": _r6(
                    led.max_unserved_span_s.max(initial=0.0)),
                "preemptions": int(m["preemptions"]),
                "forced_admissions": int(m["forced_admissions"]),
                "arbitrations": int(m["arbitrations"]),
                "replans": int(m["replans"]),
                "migrated_bytes": int(m["migrated_bytes"]),
                "downtime_s": _r6(sum(r.downtime_s for r in reps)),
                "scale_ups": int(m["scale_ups"]),
                "scale_downs": int(m["scale_downs"]),
                "replicas_final": len(self.replicas),
                "replicas_peak": int(m["replicas_peak"]),
                "used_bytes_final": int(self.used_bytes),
                "events_recorded": len(self.events),
                "events_dropped": int(m["events_dropped"]),
            },
            "classes": {
                name: {k: (_r6(v) if isinstance(v, float) else v)
                       for k, v in row.items()}
                for name, row in led.class_rollup(
                    self.cls, [c.name for c in self.classes]).items()
            },
            "replicas": [{
                "id": r.id,
                "created_s": _r6(r.created_s),
                "retired_s": None if r.retired_s is None
                else _r6(r.retired_s),
                "replans": r.replans,
                "downtime_s": _r6(r.downtime_s),
                "served_tokens": _r6(r.served_tokens),
                "iterations": int(r.engine.metrics["iterations"]),
                "point": None if r.point is None else {
                    "tokens_per_s": _r6(r.point.qos.tokens_per_s),
                    "device_gib": _r6(r.point.qos.device_bytes / GIB),
                    "quality_proxy": _r6(r.point.qos.quality_proxy),
                },
            } for r in reps],
            "events": self.events,
            "tenants": led.tenant_rows(self.cls),
        }

    def report_bytes(self) -> bytes:
        """The canonical serialization — byte-identical across replays
        of the same scenario+seed (sorted keys, fixed separators, 6-dp
        rounding, trailing newline)."""
        return (json.dumps(self.report(), sort_keys=True,
                           separators=(",", ":")) + "\n").encode()


def run_scenario(scenario: Scenario, *,
                 frontier: Optional[ParetoFrontier] = None,
                 classes: Sequence[SLOClass] = DEFAULT_SLO_CLASSES
                 ) -> ControlPlane:
    """Build, run and return the (finished) plane for a scenario."""
    plane = ControlPlane(scenario, classes=classes, frontier=frontier)
    plane.run()
    return plane
