"""Deterministic serving simulator (``repro.serving.simulator``, numpy
only) — the harness behind the QoS, multi-tenant and dynamic-precision
control loops (DESIGN.md §10.4).

The QoS controller and the multi-tenant arbiter are CONTROL loops: what
they need from "an engine" is a metrics dict, ``apply_frontier_point``
and (optionally) ``latency_percentiles``. Driving the real engine
through every controller scenario would be slow and, worse,
non-deterministic (wall-clock throughput noise would flake the
convergence assertions). This module is the shared stand-in:

* :class:`VirtualClock` — simulated time; nothing here reads
  ``time.perf_counter``, so a scenario replays bit-identically.
* :class:`SimulatedEngine` — engine-shaped object whose *measured*
  throughput is scriptable per frontier point: by default the analytic
  estimate times a constant ``model_error`` (the controller must close
  exactly that gap, as it would close wall-clock drift in production), or
  an arbitrary ``throughput_fn(point, iteration)`` for time-varying
  interference. Per-request latency is scriptable the same way
  (``latency_fn``) for p95-target scenarios.
* :func:`run_scripted` — drives N decode iterations with a controller
  stepping between them, firing scheduled events (budget shocks, target
  renegotiations, interference onsets) at exact iteration indices.
* :func:`budget_shock` — the canonical event: the job manager grows or
  shrinks the active target's memory budget mid-run.

The port's parity tests replay the reference's controller scenarios
through both packages' simulators (``tests/test_torch_qos.py``,
``tests/test_torch_multi.py``, ``tests/test_torch_dynamic_precision.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pareto import FrontierPoint
from repro_torch.serving.metrics import base_metrics

__all__ = ["VirtualClock", "SimulatedEngine", "run_scripted",
           "budget_shock", "zipf_route_fn"]


class VirtualClock:
    """Deterministic simulated time (seconds) plus an event heap.

    Engines sharing one clock advance it cooperatively; tests and the
    control plane (DESIGN.md §14) read/advance it explicitly. Time is
    guarded monotone: a negative ``advance`` delta, an ``advance_to``
    into the past, and NaN deltas all raise instead of silently
    rewinding — a rewound clock would corrupt every accumulated
    ``*_s`` metric downstream.

    The event heap is the trace layer's scheduling surface:
    ``schedule_at(t, event)`` enqueues, ``peek()`` inspects the next due
    time, and ``pop_due()`` drains (deterministically: FIFO among equal
    timestamps) everything scheduled at or before *now*. Events are
    opaque payloads — callables by convention, fired by the caller, so
    the clock stays replay-neutral.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = 0

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if not (dt >= 0):        # rejects negatives AND NaN
            raise ValueError(f"time only moves forward (dt={dt})")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        """Jump to an absolute time >= now (monotonicity guard)."""
        t = float(t)
        if math.isnan(t) or t < self._t:
            raise ValueError(
                f"time only moves forward (now={self._t}, target={t})")
        self._t = t
        return self._t

    # -- event heap ---------------------------------------------------------
    def schedule_at(self, t: float, event: Any) -> int:
        """Enqueue ``event`` to come due at absolute time ``t`` (>= now);
        returns a sequence id (also the FIFO tie-break among events
        scheduled at the same instant)."""
        t = float(t)
        if math.isnan(t) or t < self._t:
            raise ValueError(
                f"cannot schedule into the past (now={self._t}, t={t})")
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, event))
        return self._seq

    def peek(self) -> Optional[float]:
        """Due time of the earliest scheduled event (None when empty)."""
        return self._heap[0][0] if self._heap else None

    def pop_due(self, until: Optional[float] = None) -> List[Any]:
        """Remove and return every event scheduled at or before ``until``
        (default: now), in (time, insertion) order."""
        limit = self._t if until is None else min(float(until), self._t)
        out: List[Any] = []
        while self._heap and self._heap[0][0] <= limit:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def pending(self) -> int:
        return len(self._heap)


ThroughputFn = Callable[[FrontierPoint, int], float]
LatencyFn = Callable[[FrontierPoint, int], float]
TransferFn = Callable[[FrontierPoint, int], float]
#: scripted per-iteration routed-access counts [L, E] (DESIGN.md §15)
RouteFn = Callable[[FrontierPoint, int], np.ndarray]


def zipf_route_fn(num_layers: int, num_experts: int, *,
                  alpha: float = 1.2, tokens_per_iter: int = 64,
                  top_k: int = 2, seed: int = 0,
                  hot_rotation: int = 0) -> RouteFn:
    """Deterministic Zipf-skewed routing schedule: iteration ``it``
    draws ``tokens_per_iter * top_k`` accesses per layer from a Zipf
    law over expert ranks (expert 0 hottest), rng seeded ``seed + it``
    so the whole trace replays bit-identically. ``hot_rotation > 0``
    rotates the hot set by ``num_experts // 2`` every that many
    iterations — the alternating-hotness adversary the hysteresis test
    throws at the dynamic controller."""
    ranks = np.arange(1, num_experts + 1, dtype=np.float64)
    p = ranks ** -float(alpha)
    p /= p.sum()

    def fn(point: FrontierPoint, it: int) -> np.ndarray:
        rng = np.random.default_rng(seed + it)
        probs = p
        if hot_rotation and (it // hot_rotation) % 2:
            probs = np.roll(p, num_experts // 2)
        counts = np.stack([
            rng.multinomial(tokens_per_iter * top_k, probs)
            for _ in range(num_layers)])
        return counts.astype(np.int64)

    return fn


class SimulatedEngine:
    """Engine-shaped deterministic stand-in for control-loop tests.

    Interface (the subset of ``AdaptiveServingEngine`` the QoSController
    and the MultiTenantEngine consume):

    * ``metrics`` — iterations / tokens_generated / decode_s /
      transfer_s / transfer_exposed_s;
    * ``apply_frontier_point(point)`` — records the replan (count +
      full history in ``applied``) and switches the simulated speed;
    * ``latency_percentiles(qs, last_n=None)`` — over scripted latencies.

    Scripting knobs:

    * ``model_error`` — measured tokens/s = analytic estimate × this
      factor (constant miscalibration);
    * ``throughput_fn(point, iteration)`` — overrides ``model_error``
      with an arbitrary schedule (time-varying co-tenant interference);
      with a scripted ``transfer_fn`` this is the COMPUTE-only rate;
    * ``transfer_fn(point, iteration)`` — scripted expert-transfer
      seconds per iteration (DESIGN.md §12). With ``overlap=False`` all
      of it lands on the critical path (serial staging); with
      ``overlap=True`` only ``max(0, transfer - overlap_efficiency *
      decode_dt)`` is exposed — the async pipeline's A/B switch, exactly
      reproducible;
    * ``latency_fn(point, iteration)`` — one completed-request latency
      recorded per iteration (drives p95 targets);
    * ``clock`` — a shared :class:`VirtualClock`; each iteration advances
      it by the simulated decode time plus the exposed transfer time;
    * ``spec_k`` / ``acceptance`` — speculative decode (DESIGN.md §17):
      each iteration proposes ``batch * spec_k`` drafts of which a
      deterministic ``acceptance`` fraction is accepted (extra tokens on
      top of the guaranteed one per slot), while decode time stretches
      by ``spec_k * spec_draft_cost`` (the draft pass's share of a plain
      iteration). Counters land in the SAME schema keys as the real
      engine (``spec_proposed``/``spec_accepted``/``acceptance_rate``)
      so the QoSController's acceptance fallback is testable here;
      ``set_speculation(0)`` is the fallback's entry point, as on the
      real engine.
    """

    def __init__(self, *, model_error: float = 1.0,
                 throughput_fn: Optional[ThroughputFn] = None,
                 latency_fn: Optional[LatencyFn] = None,
                 transfer_fn: Optional[TransferFn] = None,
                 route_fn: Optional[RouteFn] = None,
                 overlap: bool = False,
                 overlap_efficiency: float = 1.0,
                 clock: Optional[VirtualClock] = None,
                 batch: int = 4,
                 spec_k: int = 0,
                 acceptance: float = 0.0,
                 spec_draft_cost: float = 0.25):
        self.model_error = model_error
        self.clock = clock if clock is not None else VirtualClock()
        self.batch = batch
        self._throughput_fn = throughput_fn
        self._latency_fn = latency_fn
        self._transfer_fn = transfer_fn
        self._route_fn = route_fn
        self.overlap = overlap
        self.overlap_efficiency = overlap_efficiency
        self.spec_k = max(0, int(spec_k))
        self.acceptance = min(max(float(acceptance), 0.0), 1.0)
        self.spec_draft_cost = float(spec_draft_cost)
        self.point: Optional[FrontierPoint] = None
        self.replans = 0
        #: full replan history, oldest first (assertable trace)
        self.applied: List[FrontierPoint] = []
        # the FULL shared schema (DESIGN.md §14.2): controllers written
        # against the real engine's dict shape see the same keys here —
        # sim-irrelevant ones simply stay zero.
        self.metrics: Dict[str, float] = base_metrics()
        self._latencies: List[float] = []
        #: accumulated routed-access histogram [L, E] — fed by
        #: ``route_fn`` each iteration; like the real engine's, it
        #: SURVIVES ``apply_frontier_point`` (same plan shape), the
        #: regression the dynamic controller depends on (DESIGN.md §15).
        self.route_counts: Optional[np.ndarray] = None

    # -- engine interface ---------------------------------------------------
    def apply_frontier_point(self, point: FrontierPoint):
        self.point = point
        self.replans += 1
        self.applied.append(point)
        shape = point.plan.bits.shape
        if self.route_counts is None or self.route_counts.shape != shape:
            self.route_counts = np.zeros(shape, np.int64)

    def measured_tps(self) -> float:
        """The tokens/s the NEXT iteration will run at (the COMPUTE-only
        rate when a ``transfer_fn`` is scripted — exposed transfer time
        is added on top per iteration)."""
        if self.point is None:
            raise RuntimeError("no frontier point applied")
        if self._throughput_fn is not None:
            return float(self._throughput_fn(self.point,
                                             int(self.metrics["iterations"])))
        tps = self.point.qos.tokens_per_s * self.model_error
        if self._transfer_fn is not None:
            # the analytic rate already charges exposed transfer; with a
            # scripted transfer_fn that time is added separately per
            # iteration, so strip it back to the compute-only rate (no
            # double count)
            q = self.point.qos
            if q.t_compute_ms > 0:
                tps *= (q.t_compute_ms + q.t_exposed_ms) / q.t_compute_ms
        return tps

    def run_iteration(self, batch: Optional[int] = None) -> None:
        """One decode iteration at the active point's simulated speed.
        Both scripting hooks see the SAME (pre-increment) iteration
        index, so a schedule keyed on one iteration switches throughput
        and latency together."""
        b = self.batch if batch is None else batch
        it = int(self.metrics["iterations"])
        tps = self.measured_tps()
        dt = b / max(tps, 1e-12)
        transfer = float(self._transfer_fn(self.point, it)) \
            if self._transfer_fn is not None else 0.0
        # DESIGN.md §12: serial staging exposes every transferred second;
        # the async pipeline hides up to overlap_efficiency * decode_dt
        exposed = max(0.0, transfer - self.overlap_efficiency * dt) \
            if self.overlap else transfer
        # speculative decode (DESIGN.md §17): per iteration every slot
        # proposes spec_k drafts; a deterministic ``acceptance`` fraction
        # is accepted as extra tokens, while decode time stretches by the
        # draft pass's cost share. spec_k=0 reproduces the plain
        # iteration bit-for-bit.
        proposed = accepted = 0
        if self.spec_k > 0:
            proposed = b * self.spec_k
            accepted = int(round(self.acceptance * proposed))
            dt *= 1.0 + self.spec_k * self.spec_draft_cost
        self.metrics["iterations"] += 1
        self.metrics["tokens_generated"] += b + accepted
        self.metrics["spec_proposed"] += proposed
        self.metrics["spec_accepted"] += accepted
        if self.metrics["spec_proposed"]:
            self.metrics["acceptance_rate"] = \
                self.metrics["spec_accepted"] / self.metrics["spec_proposed"]
        self.metrics["decode_s"] += dt
        self.metrics["transfer_s"] += transfer
        self.metrics["transfer_exposed_s"] += exposed
        self.metrics["transfer_overlapped_s"] += transfer - exposed
        self.clock.advance(dt + exposed)
        if self._route_fn is not None:
            self.route_counts += np.asarray(
                self._route_fn(self.point, it), np.int64)
        if self._latency_fn is not None:
            self._latencies.append(float(self._latency_fn(self.point, it)))

    def set_speculation(self, k: int) -> None:
        """Change the draft depth mid-run — the QoSController's
        acceptance-fallback entry point (``set_speculation(0)`` = plain
        decode from the next iteration on), same contract as the real
        engine's."""
        self.spec_k = max(0, int(k))

    # -- dynamic precision (DESIGN.md §15) ----------------------------------
    @property
    def current_plan(self):
        """The active point's precision plan (None before the first
        ``apply_frontier_point``) — possibly bits-updated in place."""
        return self.point.plan if self.point is not None else None

    def reset_route_counts(self) -> None:
        if self.route_counts is not None:
            self.route_counts[...] = 0

    def apply_bits_update(self, new_bits: np.ndarray) -> Dict[str, Any]:
        """The real engine's in-place rung-flip path, simulated: swaps
        the active point's plan for a bits-replaced copy under the same
        contract (locations and per-layer rung counts preserved). The
        sim has no expert cache, so ``cache_bytes_delta`` is 0 here;
        byte-conservation of the real re-staging path is tested against
        the real ``ExpertCache`` (tests/test_torch_dynamic_precision.py)."""
        assert self.point is not None, "no frontier point applied"
        import dataclasses as _dc

        old_plan = self.point.plan
        new_bits = np.asarray(new_bits, old_plan.bits.dtype)
        if new_bits.shape != old_plan.bits.shape:
            raise ValueError(f"bits shape {new_bits.shape} != "
                             f"{old_plan.bits.shape}")
        for li in range(new_bits.shape[0]):
            for b in old_plan.ladder:
                if int((new_bits[li] == b).sum()) \
                        != int((old_plan.bits[li] == b).sum()):
                    raise ValueError(
                        "apply_bits_update must preserve per-layer rung "
                        f"counts (layer {li}, rung {b})")
        flipped = new_bits != old_plan.bits
        new_plan = _dc.replace(old_plan, bits=new_bits)
        self.point = _dc.replace(self.point, plan=new_plan)
        self.metrics["bits_updates"] = \
            self.metrics.get("bits_updates", 0) + 1
        return {"flipped": int(flipped.sum()),
                "promotions": int((new_bits > old_plan.bits).sum()),
                "demotions": int((new_bits < old_plan.bits).sum()),
                "cache_bytes_delta": 0, "restaged": 0}

    def latency_percentiles(self, qs: Sequence[int] = (50, 95),
                            last_n: Optional[int] = None
                            ) -> Dict[str, float]:
        lats = self._latencies if last_n is None else self._latencies[-last_n:]
        if not lats:
            return {f"p{q}": 0.0 for q in qs}
        return {f"p{q}": float(np.percentile(lats, q)) for q in qs}

    def has_work(self) -> bool:
        """The simulator is driven open-loop (no request queue)."""
        return False

    def summary(self) -> str:
        p = self.point.summary() if self.point else "no point"
        spec = ""
        if self.metrics["spec_proposed"]:
            spec = (f" spec[k={self.spec_k} "
                    f"acc={self.metrics['acceptance_rate']:.0%} "
                    f"{self.metrics['spec_accepted']:.0f}/"
                    f"{self.metrics['spec_proposed']:.0f}]")
        return (f"sim[{p}] it={self.metrics['iterations']:.0f} "
                f"tok={self.metrics['tokens_generated']:.0f} "
                f"t={self.clock.now():.2f}s replans={self.replans}" + spec)


def run_scripted(engine, controller, iterations: int, *,
                 events: Optional[Dict[int, Callable[[], None]]] = None,
                 batch: Optional[int] = None) -> None:
    """Drive ``iterations`` decode iterations, stepping ``controller``
    between them (exactly where a live serving loop's ``on_iteration`` hook
    runs). ``events[i]`` fires BEFORE iteration ``i`` (0-based) — budget
    shocks, target renegotiations, interference onsets. ``controller``
    may be None (open-loop replay) or anything with a ``step()``."""
    events = events or {}
    for i in range(iterations):
        if i in events:
            events[i]()
        engine.run_iteration(batch)
        if controller is not None:
            controller.step()


def budget_shock(controller, mem_budget_bytes: float) -> Callable[[], None]:
    """Event factory for :func:`run_scripted`: the job manager resizes
    the active target's memory budget mid-run (the canonical shock of
    the paper's Fig. 1 multi-tenant scenario). The controller sees the
    new budget on its next ``step()`` — a shrink below the active point
    is a feasibility violation and bypasses hysteresis (DESIGN.md §9.3)."""
    def fire():
        if controller.target is None:
            raise RuntimeError("controller has no active target to shock")
        controller.target = dataclasses.replace(
            controller.target, mem_budget_bytes=mem_budget_bytes)
    return fire
