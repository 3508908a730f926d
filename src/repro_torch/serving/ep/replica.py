"""DP replica group: N engines behind one serving surface
(``repro.serving.ep.replica``, DESIGN.md §16.3).

Data parallelism is deliberately NOT an in-mesh axis here (a size>1
"data" axis would activate the fsdp/token-gather path and break decode
bit-identity): a replica is a WHOLE engine on its own (1, ep) device
slice, and :class:`DPReplicaGroup` fans requests across replicas with
least-loaded routing while presenting the single-engine control surface
— ``submit_request`` / ``run_iteration`` / ``result`` / ``apply_target``
/ ``metrics`` — so existing schedulers and QoS callers work unchanged.

The group is also where the control plane's replica decisions land on
real engines: ``autoscale_step`` feeds the group's demand utilization
(active + queued claims over aggregate slot capacity) to a
:class:`~repro_torch.serving.control_plane.autoscale.ReplicaAutoscaler`
and applies the ±1 decision. Scale-down drains: the victim replica stops
receiving new requests and is closed once its in-flight work retires,
so no request is ever dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["DPReplicaGroup", "make_dp_group"]


class DPReplicaGroup:
    """Fan a request stream across N engine replicas.

    ``factory(replica_index)`` builds one engine on the device slice of
    that replica index (see ``make_dp_group``); indices of removed
    replicas are recycled so a later scale-up reuses their devices.
    Request ids returned by the group are GLOBAL: the group keeps the
    global↔(engine, local rid) mapping and harvests every retired
    request's :class:`~repro_torch.serving.api.ServeResult` eagerly, so
    results survive their replica being drained away.
    """

    def __init__(self, factory: Callable[[int], object], *,
                 replicas: int = 1, max_replicas: int = 8):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_replicas < replicas:
            raise ValueError(
                f"max_replicas={max_replicas} < initial replicas="
                f"{replicas}")
        self._factory = factory
        self.max_replicas = max_replicas
        self.engines: List[object] = []
        self._slot_of: Dict[int, int] = {}      # id(engine) -> replica idx
        self._free_slots: List[int] = list(range(max_replicas))
        self._draining: set = set()             # id(engine)
        self._rid_map: Dict[int, Tuple[object, int]] = {}
        self._local2g: Dict[int, Dict[int, int]] = {}  # id(eng)->{loc: g}
        self._done: Dict[int, object] = {}      # global rid -> ServeResult
        self._next_rid = 0
        self._target = None
        for _ in range(replicas):
            self._add_replica()

    # -- topology ------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        """Serving replicas (draining ones no longer count as capacity)."""
        return len(self.engines) - len(self._draining)

    def _serving(self) -> List[object]:
        return [e for e in self.engines if id(e) not in self._draining]

    def _add_replica(self):
        if not self._free_slots:
            raise RuntimeError(
                f"replica group is at max_replicas={self.max_replicas}")
        slot = min(self._free_slots)
        engine = self._factory(slot)
        self._free_slots.remove(slot)
        self.engines.append(engine)
        self._slot_of[id(engine)] = slot
        self._local2g[id(engine)] = {}
        if self._target is not None:
            engine.apply_target(self._target)
        return engine

    def _drop_replica(self, engine):
        """Close and forget an IDLE engine."""
        key = id(engine)
        self.engines.remove(engine)
        self._draining.discard(key)
        self._free_slots.append(self._slot_of.pop(key))
        self._local2g.pop(key, None)
        engine.close()

    def scale_to(self, n: int) -> int:
        """Grow/shrink toward ``n`` serving replicas; shrink picks the
        least-loaded replica and drains it (removal completes inside
        ``run_iteration`` once its slots empty). Returns the number of
        serving replicas after the call."""
        if n < 1:
            raise ValueError(f"cannot scale below 1 replica (asked {n})")
        if n > self.max_replicas:
            raise ValueError(
                f"asked {n} replicas, max_replicas={self.max_replicas}")
        while self.n_replicas < n:
            self._add_replica()
        while self.n_replicas > n:
            victim = min(self._serving(), key=self._load)
            if victim.has_work():
                self._draining.add(id(victim))
            else:
                self._drop_replica(victim)
        return self.n_replicas

    # -- routing -------------------------------------------------------
    @staticmethod
    def _load(engine) -> int:
        sched = engine.scheduler
        return len(sched.queue) + sched.num_active

    def submit_request(self, request) -> int:
        """Route to the least-loaded serving replica; returns a GLOBAL
        request id valid for ``result``."""
        engine = min(self._serving(), key=self._load)
        local = engine.submit_request(request)
        rid = self._next_rid
        self._next_rid += 1
        self._rid_map[rid] = (engine, local)
        self._local2g[id(engine)][local] = rid
        return rid

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16, *,
               sampling=None, slo=None) -> int:
        from repro_torch.serving.api import RequestSLO, ServeRequest
        return self.submit_request(ServeRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            sampling=sampling, slo=slo or RequestSLO()))

    # -- serving loop --------------------------------------------------
    def run_iteration(self, **kw) -> List[int]:
        """One iteration on EVERY replica (draining ones included — they
        must finish their in-flight work). Returns the GLOBAL rids
        retired this call; drained-empty replicas are closed here."""
        retired: List[int] = []
        for engine in list(self.engines):
            if not engine.has_work():
                continue
            for local in engine.run_iteration(**kw):
                rid = self._local2g[id(engine)].pop(local)
                # re-stamp with the GLOBAL rid: local rids collide
                # across replicas
                self._done[rid] = dataclasses.replace(
                    engine.result(local), rid=rid)
                retired.append(rid)
        for engine in [e for e in self.engines
                       if id(e) in self._draining and not e.has_work()]:
            self._drop_replica(engine)
        return retired

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def result(self, rid: int):
        """ServeResult of a completed request (KeyError in flight —
        same contract as the single engine)."""
        return self._done[rid]

    # -- control surface ----------------------------------------------
    def apply_target(self, target):
        """Apply one QoSTarget to every replica (remembered, so replicas
        added by a later scale-up inherit it)."""
        self._target = target
        return [e.apply_target(target) for e in self.engines]

    @property
    def metrics(self) -> Dict[str, float]:
        """Numeric engine counters summed across replicas, plus the
        group's own ``replicas`` / ``draining`` gauges."""
        agg: Dict[str, float] = {}
        for engine in self.engines:
            for k, v in engine.metrics.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    agg[k] = agg.get(k, 0) + v
        agg["replicas"] = self.n_replicas
        agg["draining"] = len(self._draining)
        return agg

    def throughput_tokens_per_s(self, include_transfer: bool = True
                                ) -> float:
        """Aggregate decode throughput: replicas run concurrently in
        wall-clock, so group throughput is the SUM of per-replica
        rates."""
        return sum(e.throughput_tokens_per_s(include_transfer)
                   for e in self.engines)

    # -- autoscaling (control plane → real engines) --------------------
    def demand_util(self) -> float:
        """Demand over aggregate capacity: active + queued requests per
        decode slot across serving replicas, clamped to [0, 1]."""
        serving = self._serving()
        cap = sum(e.max_slots for e in serving)
        demand = sum(self._load(e) for e in serving)
        return min(1.0, demand / max(cap, 1))

    def autoscale_step(self, now: float, autoscaler=None) -> int:
        """One control-plane tick: feed the group's demand utilization
        to ``autoscaler`` (a fresh §14.3 ReplicaAutoscaler bounded by
        ``max_replicas`` when None) and APPLY its ±1 decision to real
        engines. Returns the decision."""
        if autoscaler is None:
            if not hasattr(self, "_autoscaler"):
                from repro_torch.serving.control_plane.autoscale import \
                    ReplicaAutoscaler
                self._autoscaler = ReplicaAutoscaler(
                    max_replicas=self.max_replicas)
            autoscaler = self._autoscaler
        n = self.n_replicas
        decision = autoscaler.step(
            now, self.demand_util(), n,
            can_add=n < self.max_replicas, can_remove=n > 1)
        if decision:
            self.scale_to(n + decision)
        return decision

    def close(self):
        for engine in list(self.engines):
            self._drop_replica(engine)


def make_dp_group(cfg, params, config=None, *, ep: int = 1, dp: int = 1,
                  max_replicas: Optional[int] = None,
                  devices=None) -> DPReplicaGroup:
    """A DPReplicaGroup of ``dp`` EP engines: replica ``i`` decodes over
    the (1, ep) mesh on the device slice ``[i*ep, (i+1)*ep)`` of
    ``devices`` (default: the visible cards; a list may repeat a device),
    all sharing ``params`` (one master copy; each replica builds its own
    bank shards on its devices)."""
    from repro_torch.serving.ep.mesh_engine import build_ep_engine

    def factory(slot: int):
        return build_ep_engine(cfg, params, config, ep=ep, replica=slot,
                               devices=devices)

    return DPReplicaGroup(factory, replicas=dp,
                          max_replicas=max_replicas or max(dp, 1))
