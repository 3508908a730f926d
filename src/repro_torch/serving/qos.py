"""QoS feedback controller (``repro.serving.qos``) — keeps a serving
engine on its declarative target at runtime (DESIGN.md §9).

The cost model picks the *initial* frontier point for a
:class:`~repro_torch.core.pareto.QoSTarget`, but analytic tokens/s and the
wall-clock tokens/s of a live deployment drift apart (interference from
co-tenants, cache temperature, real link bandwidth, batch occupancy). The
controller closes the loop: ``step()`` runs BETWEEN decode iterations,
compares the measured throughput (and, when targeted, p95 latency)
against the active target, and when the measurement leaves the tolerance
band walks the :class:`~repro_torch.core.pareto.ParetoFrontier` to the
*adjacent* point — one step at a time, through the engine's ordinary
mid-flight replan path, so a placement-only move applies with zero drain
and a bank-split move drains gracefully. On a multi-rung precision
ladder (DESIGN.md §11) an adjacent point may PROMOTE or DEMOTE experts
between rungs (e.g. 4->8 bit) instead of only swapping counts or
residency; the ``rung_promotions``/``rung_demotions`` metrics count
those steps.

Stability comes from two guards:

* **hysteresis** — after any replan the controller dwells for
  ``min_dwell_iterations`` before moving again, so a bank-split drain
  can't be immediately followed by the opposite move (no thrash);
* **windowed measurement** — decisions use the throughput of the last
  measurement window only (not lifetime averages), and the window resets
  on every replan so stale pre-replan samples never vote.

A *budget drop* (new target with a smaller ``mem_budget_bytes``) is a
feasibility violation, not a drift: it bypasses hysteresis and jumps
straight to ``frontier.select(target)`` — exactly one replan, after which
ordinary banded control resumes.

The controller only needs an engine-shaped object (``metrics`` dict,
``apply_frontier_point``, optionally ``latency_percentiles``); the sim
test drives it with a fake engine whose "measured" throughput is the
analytic estimate times a model-error factor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

from repro_torch.core.pareto import FrontierPoint, ParetoFrontier, QoSTarget

__all__ = ["QoSController", "QoSControllerConfig", "WalkPolicy",
           "BandedWalkPolicy"]


@dataclasses.dataclass(frozen=True)
class QoSControllerConfig:
    #: relative band around min_tokens_per_s inside which no action is
    #: taken: measured in [target*(1-tol), target*(1+tol)] is "on target".
    tolerance: float = 0.10
    #: hysteresis: iterations to dwell after a replan before moving again
    #: (a bank-split drain must not be followed by the opposite move).
    min_dwell_iterations: int = 16
    #: decisions are taken at most once per this many iterations, on the
    #: throughput measured within the window.
    window_iterations: int = 4
    #: the p95-latency check looks at the most recent completions only
    #: (lifetime percentiles would let cold-start samples vote forever).
    p95_window_requests: int = 16
    #: speculative-decode fallback (DESIGN.md §17): when the WINDOWED
    #: measured acceptance rate drops below this, the draft pass costs
    #: more than the accepted tokens save (the analytic break-even at
    #: k * t_draft ~= t_verify / 2) and the controller turns speculation
    #: off via ``engine.set_speculation(0)``.
    spec_min_acceptance: float = 0.35
    #: drafts that must have been proposed inside the window before the
    #: acceptance fallback may fire — tiny windows are routing noise,
    #: not a regime change.
    spec_min_proposed: int = 64


class WalkPolicy:
    """Pluggable decision strategy for the QoS control loop (DESIGN.md
    §14.4): given the controller (target, active point, frontier,
    config, measured-p95 access) and the windowed measured throughput,
    return the frontier point to move to — or None to hold. The
    controller owns everything around the decision (measurement windows,
    hysteresis dwell, the replan plumbing); the policy owns only the
    judgement, so control-plane experiments can swap it per scenario
    without forking the loop."""

    def decide(self, ctl: "QoSController",
               measured: float) -> Optional[FrontierPoint]:
        raise NotImplementedError


class BandedWalkPolicy(WalkPolicy):
    """The default §9 policy: tolerance-banded walks to the adjacent
    frontier point — faster on a throughput shortfall or a p95 breach,
    back toward quality when the measured headroom (derated by the
    observed model error) predicts the slower point still meets the
    target."""

    def decide(self, ctl: "QoSController",
               measured: float) -> Optional[FrontierPoint]:
        tgt = ctl.target.min_tokens_per_s
        tol = ctl.config.tolerance
        slower, faster = ctl.frontier.neighbors(ctl.point, ctl.target)
        # p95 latency ceiling: only the runtime can see it; treat a
        # violation like a throughput shortfall (walk faster).
        if ctl.target.max_p95_latency_s is not None and faster is not None:
            p95 = ctl._measured_p95()
            if p95 is not None and p95 > ctl.target.max_p95_latency_s:
                ctl._violation()
                return faster
        if tgt is None:
            return None
        if measured < tgt * (1 - tol):
            # an infinite target is "as fast as possible" (best effort),
            # not an SLO that can be violated
            if math.isfinite(tgt):
                ctl._violation()
            # already at the fast end: best effort, keep serving
            return faster
        if measured > tgt * (1 + tol) and slower is not None:
            # headroom: walk back toward quality, but only when (a) the
            # slower point does not DEGRADE quality (adjacent-in-tps
            # points are not always adjacent-in-quality) and (b) it is
            # PREDICTED to still meet the target after derating the
            # analytic estimate by the observed model error.
            derate = measured / max(ctl.point.qos.tokens_per_s, 1e-12)
            if slower.qos.quality_proxy <= ctl.point.qos.quality_proxy \
                    and slower.qos.tokens_per_s * derate >= tgt:
                return slower
        return None


class QoSController:
    """Feedback loop from measured QoS to frontier walks (DESIGN.md §9)."""

    def __init__(self, engine, frontier: Optional[ParetoFrontier] = None,
                 config: QoSControllerConfig = QoSControllerConfig(),
                 on_violation: Optional[Callable[[], None]] = None,
                 policy: Optional[WalkPolicy] = None,
                 dynamic=None):
        self.engine = engine
        self.frontier = frontier if frontier is not None \
            else engine.frontier
        self.config = config
        #: fired whenever a target violation is recorded — the
        #: multi-tenant arbiter's re-arbitration trigger (DESIGN.md §10).
        self.on_violation = on_violation
        #: the pluggable decision strategy (DESIGN.md §14.4)
        self.policy = policy if policy is not None else BandedWalkPolicy()
        #: optional DynamicPrecisionController (DESIGN.md §15): stepped
        #: inside every ``step()`` so hotness-driven rung swaps ride the
        #: same between-iterations cadence as the frontier walks; its
        #: promotions/demotions land in THIS controller's
        #: ``rung_promotions``/``rung_demotions`` via the metrics sink
        #: (bound below, after the metrics dict exists).
        self.dynamic = dynamic
        self.target: Optional[QoSTarget] = None
        self.point: Optional[FrontierPoint] = None
        self._win_iter = 0
        self._win_tokens = 0
        self._win_time = 0.0
        self._win_spec = (0, 0)     # (proposed, accepted) at window start
        self._applied_iter = 0
        self.metrics: Dict[str, float] = {
            "replans": 0, "decisions": 0, "violations": 0,
            "last_measured_tps": 0.0,
            # ladder telemetry (DESIGN.md §11): a walk step whose plan
            # raises the mean expert bit-width is a rung PROMOTION
            # (quality up), lowering it is a DEMOTION — the controller
            # can now trade precision, not only counts/residency.
            "rung_promotions": 0, "rung_demotions": 0,
            # speculative decode (DESIGN.md §17): windowed measured
            # acceptance + times the controller disabled speculation.
            "last_acceptance_rate": 0.0, "spec_fallbacks": 0,
        }
        if self.dynamic is not None and self.dynamic.sink is None:
            self.dynamic.sink = self.metrics

    # -- target management -------------------------------------------------
    def set_target(self, target: QoSTarget) -> FrontierPoint:
        """Activate a target: select + apply its frontier point (one
        replan). Called on tenant (re)negotiation or a budget change
        from the job manager."""
        point = self.frontier.select(target)
        self.target = target
        self._apply(point)
        return point

    def adopt(self, target: QoSTarget, point: FrontierPoint) -> None:
        """Activate an EXTERNALLY selected (target, point) pair — the
        multi-tenant :class:`~repro_torch.serving.multi.ResourceArbiter` picks
        points jointly across tenants, so the local ``select()`` is
        bypassed; ordinary banded control resumes from the adopted
        point (with the usual post-replan dwell)."""
        self.target = target
        self._apply(point)

    # -- the loop ----------------------------------------------------------
    def step(self) -> bool:
        """Run one control decision between decode iterations; returns
        True iff a replan was applied."""
        if self.target is None or self.point is None:
            return False
        if self.dynamic is not None:
            # hotness-driven rung swaps (DESIGN.md §15) are in-place and
            # byte-neutral, so they ride every step OUTSIDE the frontier
            # walk's hysteresis (the dynamic controller has its own
            # EMA/margin/dwell guards)
            self.dynamic.step()
        # feasibility violation (e.g. the active point predates a budget
        # drop): fix immediately, bypassing hysteresis — but only once,
        # select() lands on a feasible point.
        if not self.point.feasible_under(self.target):
            self._apply(self.frontier.select(self.target))
            return True
        m = self.engine.metrics
        it = int(m["iterations"])
        if it - self._win_iter < self.config.window_iterations:
            return False
        dt = self._elapsed(m) - self._win_time
        dtok = m["tokens_generated"] - self._win_tokens
        d_prop = int(m.get("spec_proposed", 0)) - self._win_spec[0]
        d_acc = int(m.get("spec_accepted", 0)) - self._win_spec[1]
        self._snapshot(it)
        self._check_speculation(d_prop, d_acc)
        if dtok <= 0 or dt <= 0:
            return False
        measured = dtok / dt
        self.metrics["decisions"] += 1
        self.metrics["last_measured_tps"] = measured
        if it - self._applied_iter < self.config.min_dwell_iterations:
            return False                    # hysteresis: dwell
        return self._decide(measured)

    def _decide(self, measured: float) -> bool:
        point = self.policy.decide(self, measured)
        if point is None or point is self.point:
            return False
        self._apply(point)
        return True

    # -- internals ---------------------------------------------------------
    def _violation(self):
        self.metrics["violations"] += 1
        if self.on_violation is not None:
            self.on_violation()

    def _measured_p95(self) -> Optional[float]:
        fn = getattr(self.engine, "latency_percentiles", None)
        if fn is None:
            return None
        try:
            pct = fn((95,), last_n=self.config.p95_window_requests)
        except TypeError:       # engine-shaped stub without the kwarg
            pct = fn((95,))
        p95 = pct.get("p95", 0.0)
        return p95 if p95 > 0 else None

    def _check_speculation(self, proposed: int, accepted: int) -> None:
        """Measured acceptance-rate feedback (DESIGN.md §17): per-window
        acceptance below ``spec_min_acceptance`` means the workload's
        draft (lowest-rung) and serve distributions have diverged enough
        that drafting costs more than it saves — fall back to plain
        decode via the engine's ``set_speculation(0)``. Effectively
        one-shot: once off, no window proposes ``spec_min_proposed``
        drafts so the guard cannot re-fire. Engine-shaped objects
        without speculation (no ``set_speculation``) are left alone."""
        if proposed < self.config.spec_min_proposed:
            return
        rate = accepted / proposed
        self.metrics["last_acceptance_rate"] = rate
        if rate >= self.config.spec_min_acceptance:
            return
        fn = getattr(self.engine, "set_speculation", None)
        if fn is None:
            return
        fn(0)
        self.metrics["spec_fallbacks"] += 1

    def _apply(self, point: FrontierPoint):
        if self.point is not None:
            old_bits = float(self.point.plan.bits.mean())
            new_bits = float(point.plan.bits.mean())
            if new_bits > old_bits:
                self.metrics["rung_promotions"] += 1
            elif new_bits < old_bits:
                self.metrics["rung_demotions"] += 1
        self.engine.apply_frontier_point(point)
        self.point = point
        self.metrics["replans"] += 1
        it = int(self.engine.metrics["iterations"])
        self._applied_iter = it
        self._snapshot(it)

    @staticmethod
    def _elapsed(m) -> float:
        """Serving wall-time the window measures throughput over: decode
        plus the EXPOSED transfer time (DESIGN.md §12) — overlapped
        transfers already hide under decode and must not be
        double-counted. Engines without the async pipeline report
        ``transfer_exposed_s == transfer_s`` (or lack the key entirely:
        engine-shaped stubs fall back to total transfer time)."""
        return m["decode_s"] + m.get("transfer_exposed_s", m["transfer_s"])

    def _snapshot(self, it: int):
        m = self.engine.metrics
        self._win_iter = it
        self._win_tokens = m["tokens_generated"]
        self._win_time = self._elapsed(m)
        self._win_spec = (int(m.get("spec_proposed", 0)),
                          int(m.get("spec_accepted", 0)))

    def summary(self) -> str:
        t = self.target.describe() if self.target else "no target"
        p = self.point.summary() if self.point else "no point"
        return (f"QoS[{t}] @ [{p}] measured="
                f"{self.metrics['last_measured_tps']:.2f} tok/s "
                f"replans={self.metrics['replans']:.0f} "
                f"violations={self.metrics['violations']:.0f}")
