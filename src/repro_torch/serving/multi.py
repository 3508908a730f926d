"""Multi-tenant MoE serving under ONE memory envelope
(``repro.serving.multi``, DESIGN.md §10).

The paper's pitch is adaptive serving in multi-tenant environments where
available resources change over time; PR 2 gave one model a declarative
QoS surface, this module arbitrates that surface across N co-hosted
models. Following "QoS-Efficient Serving of Multiple MoE LLMs Using
Partial Runtime Reconfiguration" (Imani et al., 2025) and MoE-Prism's
elastic per-tenant quality/throughput framing (Xia et al., 2025):

* :class:`MultiTenantEngine` hosts N per-tenant engines — each with its
  OWN :class:`~repro_torch.core.pareto.ParetoFrontier`, scheduler and KV slots
  — under a single global byte budget, with one shared expert swap space
  (tenant-namespaced :class:`~repro_torch.core.expert_cache.ExpertCache` views,
  so identical ``(layer, expert)`` keys never collide across tenants).
* :class:`ResourceArbiter` jointly selects one frontier point per tenant
  by **water-filling marginal utility per byte**: every tenant starts at
  its cheapest feasible point, then the globally best upgrade (largest
  weighted utility gain per additional byte) is applied repeatedly until
  the shared budget is exhausted. Utility saturates once a tenant's
  tokens/s floor is met, so spare bytes flow to quality upgrades —
  "marginal quality-per-byte" water-filling. Analytic tokens/s are
  DERATED by each tenant's observed model error (measured/analytic from
  its :class:`~repro_torch.serving.qos.QoSController`), so re-arbitration
  responds to the throughput tenants actually get. The measured side
  charges only EXPOSED transfer time (``transfer_exposed_s``, DESIGN.md
  §12) — under async overlapped streaming a tenant's hidden transfers
  must not deflate its derate and siphon bytes it does not need.
* Reconfiguration is PARTIAL: the old and new precision-and-placement
  plans are diffed per tenant
  (:func:`~repro_torch.core.precision_plan.reconfig_delta`) and only the
  changed experts migrate; every replan emits a :class:`ReplanReport`
  with migrated-expert count, migrated bytes and estimated downtime.

Re-arbitration triggers: a global budget shift (``set_budget`` — exactly
one joint re-arbitration, tested) and a tenant QoS miss (the
controller's ``on_violation`` hook; applied only when the fresh joint
selection actually differs, after a cooldown — no storms).

The engines may be real
:class:`~repro_torch.serving.engine.AdaptiveServingEngine` instances
(``launch/serve.py --tenants``) or the deterministic
:class:`~repro_torch.serving.simulator.SimulatedEngine` (the test
harness) — the arbiter only consumes the engine-shaped control
interface.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.expert_cache import ExpertCache, ScopedExpertCache
from repro_torch.core.pareto import (FrontierPoint, InfeasibleTarget,
                                     ParetoFrontier, QoSTarget, _fmt_bytes)
from repro_torch.core.precision_plan import (migrated_expert_keys,
                                             reconfig_delta)
from repro_torch.serving.qos import QoSController, QoSControllerConfig

__all__ = [
    "TenantSpec", "ReplanReport", "ResourceArbiter", "MultiTenantEngine",
    "GlobalBudgetInfeasible", "UtilityPolicy", "FloorSaturationUtility",
]


class GlobalBudgetInfeasible(ValueError):
    """Even the cheapest feasible point per tenant overflows the shared
    budget — no joint configuration exists."""


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's declarative contract with the arbiter.

    ``target`` is the tenant's own :class:`QoSTarget`; its
    ``mem_budget_bytes`` (if set) is a per-tenant CAP on top of the
    shared global budget. ``weight`` scales the tenant's claim on
    marginal bytes during water-filling (2.0 = upgrades count double)."""
    name: str
    target: QoSTarget
    weight: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")


@dataclasses.dataclass(frozen=True)
class ReplanReport:
    """What one tenant's partial reconfiguration actually moved."""
    tenant: str
    migrated_experts: int     # experts that streamed (upload/format flip)
    evicted_experts: int      # device -> host demotions (no traffic)
    migrated_bytes: int
    downtime_s: float         # migrated_bytes / host link bw (estimate)
    placement_only: bool      # same bank split: applies with zero drain

    def summary(self) -> str:
        kind = "placement-only" if self.placement_only else "bank-split"
        return (f"[{self.tenant}] {kind} replan: {self.migrated_experts} "
                f"experts migrated ({self.migrated_bytes / 2**20:.2f} MiB, "
                f"~{self.downtime_s * 1e3:.1f} ms), "
                f"{self.evicted_experts} evicted")


class _Tenant:
    """Arbiter-side runtime state of one hosted tenant."""

    def __init__(self, spec: TenantSpec, engine, frontier: ParetoFrontier,
                 controller: QoSController,
                 cache_view: Optional[ScopedExpertCache]):
        self.spec = spec
        self.engine = engine
        self.frontier = frontier
        self.controller = controller
        self.cache_view = cache_view
        #: measured/analytic tokens-per-s ratio (1.0 = perfectly calibrated)
        self.derate = 1.0
        self.allocated_bytes = 0.0
        self.pending_violation = False
        self.reports: List[ReplanReport] = []
        #: optional DynamicPrecisionController (DESIGN.md §15)
        self.dynamic = None

    @property
    def point(self) -> Optional[FrontierPoint]:
        return self.controller.point


class UtilityPolicy:
    """Pluggable per-tenant utility model for the water-filling arbiter
    (DESIGN.md §14.4): ``build`` returns the scalar utility function the
    arbiter maximizes per marginal byte, given the tenant's feasible
    points, its target and its observed derate. Swapping the policy
    changes WHAT bytes buy (SLO floors, latency, fairness experiments)
    without touching the water-filling mechanics."""

    def build(self, feas: Sequence[FrontierPoint], target: QoSTarget,
              derate: float) -> Callable[[FrontierPoint], float]:
        raise NotImplementedError


class FloorSaturationUtility(UtilityPolicy):
    """The default §10.2 utility: ``floor_weight * saturation(tokens/s)
    - (quality_proxy - 1)`` where saturation is ``min(eff_tps / floor,
    1)`` for a finite tokens/s floor, the normalized ``tps / tps_max``
    for the ``inf`` ("as fast as possible") floor, and ``1`` when no
    floor (or a degenerate ``<= 0`` floor) is declared. ``floor_weight``
    makes meeting declared floors dominate quality polish — bytes first
    buy SLO feasibility, then quality."""

    def __init__(self, floor_weight: float = 1000.0):
        self.floor_weight = floor_weight

    def build(self, feas: Sequence[FrontierPoint], target: QoSTarget,
              derate: float) -> Callable[[FrontierPoint], float]:
        tps_max = max(p.qos.tokens_per_s for p in feas)
        floor = target.min_tokens_per_s

        def u(p: FrontierPoint) -> float:
            if floor is None or floor <= 0:
                sat = 1.0
            elif math.isinf(floor):
                sat = p.qos.tokens_per_s / max(tps_max, 1e-12)
            else:
                sat = min(p.qos.tokens_per_s * derate / floor, 1.0)
            return self.floor_weight * sat - (p.qos.quality_proxy - 1.0)

        return u


class ResourceArbiter:
    """Joint frontier-point selection by water-filling marginal utility
    per byte (DESIGN.md §10.2).

    The utility of a point is delegated to a pluggable
    :class:`UtilityPolicy` (default :class:`FloorSaturationUtility`,
    weighting declared SLO floors above quality polish); the arbiter
    itself owns only the water-filling: every tenant starts at its
    cheapest feasible point and the globally best upgrade per marginal
    byte is applied until the budget is exhausted."""

    def __init__(self, floor_weight: float = 1000.0, *,
                 utility: Optional[UtilityPolicy] = None):
        self.floor_weight = floor_weight
        self.utility = utility if utility is not None \
            else FloorSaturationUtility(floor_weight)

    # -- per-tenant upgrade chain -------------------------------------------
    def chain(self, frontier: ParetoFrontier, target: QoSTarget,
              derate: float = 1.0
              ) -> Tuple[List[FrontierPoint], Callable[[FrontierPoint], float]]:
        """(bytes-ascending, strictly utility-increasing) upgrade chain of
        the tenant's feasible frontier points, plus its utility function."""
        feas = [p for p in frontier.points if p.feasible_under(target)]
        if not feas:
            raise InfeasibleTarget(
                f"no frontier point satisfies [{target.describe()}]")
        u = self.utility.build(feas, target, derate)
        feas.sort(key=lambda p: (p.qos.device_bytes, -u(p),
                                 p.num_q_experts, p.resident_experts))
        chain: List[FrontierPoint] = []
        for p in feas:
            if not chain or u(p) > u(chain[-1]) + 1e-12:
                chain.append(p)
        return chain, u

    # -- joint selection ----------------------------------------------------
    def arbitrate(self, entries: Sequence[Tuple[TenantSpec, ParetoFrontier,
                                                float]],
                  budget_bytes: float
                  ) -> Tuple[Dict[str, FrontierPoint], float]:
        """Water-fill ``budget_bytes`` across tenants; returns
        ({tenant: point}, used_bytes). Deterministic: ties go to the
        earlier tenant in ``entries`` order."""
        chains, utils = [], []
        for spec, frontier, derate in entries:
            try:
                c, u = self.chain(frontier, spec.target, derate)
            except InfeasibleTarget as e:
                raise InfeasibleTarget(f"tenant {spec.name!r}: {e}") from e
            chains.append(c)
            utils.append(u)
        idx = [0] * len(chains)
        used = float(sum(c[0].qos.device_bytes for c in chains))
        if used > budget_bytes:
            need = ", ".join(
                f"{spec.name}>={_fmt_bytes(c[0].qos.device_bytes)}"
                for (spec, _, _), c in zip(entries, chains))
            raise GlobalBudgetInfeasible(
                f"minimal joint footprint {_fmt_bytes(used)} exceeds the "
                f"shared budget {_fmt_bytes(max(budget_bytes, 0.0))} "
                f"({need})")
        while True:
            best_rate, best_ti = None, None
            for ti, (spec, _, _) in enumerate(entries):
                c, i = chains[ti], idx[ti]
                if i + 1 >= len(c):
                    continue
                db = float(c[i + 1].qos.device_bytes
                           - c[i].qos.device_bytes)
                if used + db > budget_bytes:
                    continue
                du = utils[ti](c[i + 1]) - utils[ti](c[i])
                rate = math.inf if db <= 0 else spec.weight * du / db
                if best_rate is None or rate > best_rate:
                    best_rate, best_ti = rate, ti
            if best_ti is None:
                break
            used += float(chains[best_ti][idx[best_ti] + 1].qos.device_bytes
                          - chains[best_ti][idx[best_ti]].qos.device_bytes)
            idx[best_ti] += 1
        sel = {spec.name: chains[ti][idx[ti]]
               for ti, (spec, _, _) in enumerate(entries)}
        return sel, used


class MultiTenantEngine:
    """N per-tenant serving engines under one byte budget (DESIGN.md §10).

    Wiring::

        shared = ExpertCache(capacity_bytes=swap)
        mt = MultiTenantEngine(budget_bytes, expert_cache=shared)
        mt.add_tenant(TenantSpec("chat", QoSTarget(min_tokens_per_s=8)),
                      engine_a)
        mt.add_tenant(TenantSpec("batch", QoSTarget(max_quality_loss=0.0)),
                      engine_b)
        mt.arbitrate()                  # initial joint selection
        ...
        mt.run_iteration()              # decode + per-tenant QoS control
        mt.set_budget(smaller)          # exactly one joint re-arbitration
    """

    def __init__(self, budget_bytes: float, *,
                 expert_cache: Optional[ExpertCache] = None,
                 swap_capacity_bytes: int = 64 << 20,
                 arbiter: Optional[ResourceArbiter] = None,
                 controller_config: Optional[QoSControllerConfig] = None,
                 cooldown_iterations: int = 8, device=None):
        self.budget_bytes = float(budget_bytes)
        # the default shared swap space lives on ``device`` (the card
        # unless the caller asks for the CPU)
        self.cache = expert_cache if expert_cache is not None \
            else ExpertCache(capacity_bytes=swap_capacity_bytes,
                             device=device)
        self.arbiter = arbiter or ResourceArbiter()
        self.controller_config = controller_config or QoSControllerConfig()
        #: iterations (summed over tenants) between violation-driven
        #: re-arbitration attempts — the joint analogue of controller dwell
        self.cooldown_iterations = cooldown_iterations
        self._tenants: Dict[str, _Tenant] = {}
        self.reports: List[ReplanReport] = []
        self.metrics: Dict[str, float] = {
            "arbitrations": 0, "arbitrations_noop": 0, "replans": 0,
            "migrated_experts": 0, "migrated_bytes": 0, "downtime_s": 0.0,
            "used_bytes": 0.0,
        }
        self._last_arb_iter = 0.0

    # -- tenant management --------------------------------------------------
    @property
    def tenants(self) -> Dict[str, _Tenant]:
        return dict(self._tenants)

    def add_tenant(self, spec: TenantSpec, engine,
                   frontier: Optional[ParetoFrontier] = None,
                   dynamic=None) -> _Tenant:
        """Register a tenant. ``frontier`` defaults to ``engine.frontier``
        (real engines build one lazily; simulated engines need it passed).
        If the engine already streams through a scoped view of THIS
        shared cache it is reused, otherwise a namespace is opened for
        the tenant. ``dynamic`` (a
        :class:`~repro_torch.core.dynamic_precision.DynamicPrecisionController`,
        DESIGN.md §15) rides the tenant's QoSController: its byte-neutral
        rung swaps step with the per-tenant control loop and its
        placement-only :class:`ReplanReport`\\ s land in the shared
        ``reports`` trace."""
        if spec.name in self._tenants:
            raise ValueError(f"tenant {spec.name!r} already hosted")
        if frontier is None:
            frontier = engine.frontier
        view = getattr(engine, "expert_cache", None)
        if not (isinstance(view, ScopedExpertCache)
                and view.parent is self.cache):
            view = self.cache.scoped(
                spec.name, getattr(engine, "_fetch_expert", None))
        controller = QoSController(
            engine, frontier, self.controller_config,
            on_violation=lambda name=spec.name: self._note_violation(name),
            dynamic=dynamic)
        t = _Tenant(spec, engine, frontier, controller, view)
        if dynamic is not None:
            dynamic.tenant = spec.name
            dynamic.on_report = lambda rr, name=spec.name: \
                self._note_dynamic_report(name, rr)
        t.dynamic = dynamic
        self._tenants[spec.name] = t
        return t

    def _note_dynamic_report(self, name: str, report: ReplanReport):
        """Fold a dynamic-precision swap report into the shared replan
        trace — placement-only by construction (byte-neutral swaps)."""
        t = self._tenants[name]
        t.reports.append(report)
        self.reports.append(report)
        self.metrics["migrated_experts"] += report.migrated_experts
        self.metrics["migrated_bytes"] += report.migrated_bytes

    def _note_violation(self, name: str):
        self._tenants[name].pending_violation = True

    # -- joint arbitration --------------------------------------------------
    def _entries(self) -> List[Tuple[TenantSpec, ParetoFrontier, float]]:
        return [(t.spec, t.frontier, t.derate)
                for t in self._tenants.values()]

    def _select(self) -> Tuple[Dict[str, FrontierPoint], float]:
        if not self._tenants:
            raise RuntimeError("no tenants hosted")
        return self.arbiter.arbitrate(self._entries(), self.budget_bytes)

    def arbitrate(self, _selection: Optional[Tuple[Dict[str, FrontierPoint],
                                                   float]] = None
                  ) -> Dict[str, FrontierPoint]:
        """Joint (re)selection + partial migration + allocation of slack.

        Each tenant's controller target becomes its spec target with
        ``mem_budget_bytes`` = its selected point's footprint plus a
        weight-proportional share of the leftover budget — the headroom
        inside which its own QoSController may keep walking locally."""
        sel, used = self._select() if _selection is None else _selection
        self.metrics["used_bytes"] = used
        slack = max(self.budget_bytes - used, 0.0)
        wsum = sum(t.spec.weight for t in self._tenants.values())
        for name, t in self._tenants.items():
            alloc = float(sel[name].qos.device_bytes) \
                + slack * t.spec.weight / wsum
            if t.spec.target.mem_budget_bytes is not None:
                alloc = min(alloc, t.spec.target.mem_budget_bytes)
            t.allocated_bytes = alloc
            self._apply(t, sel[name], dataclasses.replace(
                t.spec.target, mem_budget_bytes=alloc))
            t.pending_violation = False
        self.metrics["arbitrations"] += 1
        self._last_arb_iter = self._total_iterations()
        return sel

    def _maybe_rearbitrate(self) -> bool:
        """Violation-driven path: re-arbitrate only when the fresh joint
        selection differs from what tenants already run (otherwise the
        miss is a model-error the local controllers keep chasing)."""
        sel, used = self._select()
        if all(sel[name] is t.point for name, t in self._tenants.items()):
            self.metrics["arbitrations_noop"] += 1
            for t in self._tenants.values():
                t.pending_violation = False
            self._last_arb_iter = self._total_iterations()
            return False
        self.arbitrate(_selection=(sel, used))
        return True

    def set_budget(self, budget_bytes: float) -> bool:
        """The job manager resizes the global envelope: one joint
        re-arbitration (shrink AND grow), partial migrations only."""
        if float(budget_bytes) == self.budget_bytes:
            return False
        self.budget_bytes = float(budget_bytes)
        self.arbitrate()
        return True

    # -- partial reconfiguration (DESIGN.md §10.3) --------------------------
    def _apply(self, t: _Tenant, point: FrontierPoint, target: QoSTarget):
        old = t.point
        if old is point:
            # allocation changed but the point did not: refresh the
            # target, no migration, no replan
            t.controller.target = target
            return
        if old is not None:
            delta = reconfig_delta(old.plan, point.plan)
            keys = migrated_expert_keys(delta, point.plan)
            cfg = t.frontier.cfg
            # each migrated expert streams once, in its NEW ladder rung's
            # format (a 4->8 promotion charges the 8-bit size)
            mbytes = sum(cfg.expert_param_bytes(int(point.plan.bits[l, e]))
                         for (l, e) in keys)
            placement_only = (
                old.plan.bank_sizes() == point.plan.bank_sizes()
                and old.plan.seed == point.plan.seed)
            # shared-swap hygiene: migrated experts are stale in THIS
            # tenant's namespace (now device-resident or format-flipped)
            if t.cache_view is not None:
                resident = set(t.cache_view.resident_keys())
                t.cache_view.invalidate(
                    [k for k in keys if k in resident])
            report = ReplanReport(
                tenant=t.spec.name, migrated_experts=len(keys),
                evicted_experts=len(delta["to_evict"]),
                migrated_bytes=int(mbytes),
                downtime_s=mbytes / t.frontier.hw.host_link_bw,
                placement_only=placement_only)
            t.reports.append(report)
            self.reports.append(report)
            self.metrics["replans"] += 1
            self.metrics["migrated_experts"] += report.migrated_experts
            self.metrics["migrated_bytes"] += report.migrated_bytes
            self.metrics["downtime_s"] += report.downtime_s
        t.controller.adopt(target, point)

    # -- runtime loop -------------------------------------------------------
    def _total_iterations(self) -> float:
        return sum(float(t.engine.metrics.get("iterations", 0))
                   for t in self._tenants.values())

    def step(self) -> bool:
        """Per-tenant QoS control + violation-driven joint re-arbitration;
        call between decode iterations (the serving loop's ``on_iteration``
        slot). Returns True iff a joint re-arbitration was applied."""
        for t in self._tenants.values():
            t.controller.step()
            m = t.controller.metrics["last_measured_tps"]
            if t.point is not None and m > 0:
                t.derate = m / max(t.point.qos.tokens_per_s, 1e-12)
        if any(t.pending_violation for t in self._tenants.values()) \
                and (self._total_iterations() - self._last_arb_iter
                     >= self.cooldown_iterations):
            return self._maybe_rearbitrate()
        return False

    def run_iteration(self, **kw) -> bool:
        """Advance every tenant engine that has work by one decode
        iteration (real engines; the simulator is driven externally),
        then run the joint control step."""
        for t in self._tenants.values():
            if getattr(t.engine, "has_work", lambda: False)():
                t.engine.run_iteration(**kw)
        return self.step()

    def has_work(self) -> bool:
        return any(getattr(t.engine, "has_work", lambda: False)()
                   for t in self._tenants.values())

    def close(self):
        """Release every tenant's transfer pipeline, then close the
        SHARED swap space (joins its async workers when the deployment
        streams through an ``AsyncExpertCache`` — DESIGN.md §12)."""
        for t in self._tenants.values():
            close = getattr(t.engine, "close", None)
            if close is not None:
                close()
        self.cache.close()

    def summary(self) -> str:
        m = self.metrics
        lines = [
            f"multi-tenant: {len(self._tenants)} tenants, budget "
            f"{_fmt_bytes(self.budget_bytes)} "
            f"(used {_fmt_bytes(m['used_bytes'])}), "
            f"{m['arbitrations']:.0f} arbitrations, "
            f"{m['replans']:.0f} replans migrating "
            f"{m['migrated_experts']:.0f} experts "
            f"({m['migrated_bytes'] / 2**20:.1f} MiB, "
            f"~{m['downtime_s'] * 1e3:.1f} ms downtime)"]
        for name, t in self._tenants.items():
            p = t.point.summary() if t.point else "unassigned"
            lines.append(f"  [{name}] w={t.spec.weight:g} "
                         f"alloc={_fmt_bytes(t.allocated_bytes)} "
                         f"derate={t.derate:.2f} @ {p}")
        return "\n".join(lines)
