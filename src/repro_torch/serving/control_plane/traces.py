"""Seeded trace layer for the control plane (DESIGN.md §14.1).

Everything the simulator "experiences" — who the tenants are, when they
join and leave, how many tokens they offer each tick, when the job
manager shocks the shared budget — is generated here from ONE seed, so
a scenario replays byte-identically: the control plane draws from a
single ``numpy`` :class:`~numpy.random.Generator` in a fixed order (one
vectorized draw per tick over the FULL tenant population, active or
not, so churn never shifts the stream).

Three arrival processes cover the paper's shifting-resource regimes:

* :class:`PoissonArrivals` — stationary load (the null workload);
* :class:`DiurnalArrivals` — a sinusoidally modulated Poisson process
  with per-tenant phases (the classic day/night swing the autoscaler
  must track);
* :class:`MMPPArrivals` — a two-state Markov-modulated Poisson process
  (bursty on/off sources; the admission controller's queue caps and the
  preemption path earn their keep here).

The replayable :class:`TraceEvent` stream (tenant churn + budget
shocks) is scheduled on the
:class:`~repro_torch.serving.simulator.VirtualClock` event heap; the
scenario catalog at the bottom names the reference experiments
(``launch/simulate.py --list``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "TraceEvent", "TenantPopulation", "Scenario", "ArrivalModel",
    "PoissonArrivals", "DiurnalArrivals", "MMPPArrivals",
    "build_population", "trace_events", "make_arrival_model",
    "SCENARIOS", "get_scenario",
]

GIB = 2**30


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One replayable control-plane stimulus.

    ``kind``: ``"join"``/``"leave"`` (tenant churn, ``tenant`` set) or
    ``"budget"`` (global budget shock, ``value`` = multiple of the
    scenario's initial budget)."""
    t: float
    kind: str
    tenant: int = -1
    value: float = 0.0


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, fully-parameterized control-plane experiment. Immutable
    and hashable so a report can state exactly what produced it."""
    name: str
    seed: int = 0
    arch: str = "mixtral-8x7b"
    tenants: int = 64
    horizon_s: float = 4000.0
    tick_s: float = 20.0
    #: arrival process: "poisson" | "diurnal" | "bursty"
    arrival: str = "poisson"
    #: per-tenant mean offered load, drawn uniform from this range (tok/s)
    rate_range_tps: Tuple[float, float] = (0.3, 1.3)
    #: (SLO class name, fraction) — fractions should sum to 1
    class_mix: Tuple[Tuple[str, float], ...] = (
        ("gold", 0.2), ("silver", 0.3), ("bronze", 0.5))
    #: fraction of tenants that churn (half join late, half leave early)
    churn_fraction: float = 0.0
    #: (time_s, multiple-of-initial-budget) global budget shocks
    budget_shocks: Tuple[Tuple[float, float], ...] = ()
    budget_bytes: float = 400.0 * GIB
    #: decode slots per engine replica: replica capacity =
    #: point.tokens_per_s * slots (DESIGN.md §14.3)
    slots_per_replica: int = 16
    min_replicas: int = 2
    max_replicas: int = 8
    # diurnal knobs
    diurnal_period_s: float = 20000.0
    diurnal_amplitude: float = 0.7
    # MMPP knobs (per-tick state transition probabilities)
    burst_factor: float = 6.0
    p_on: float = 0.04
    p_off: float = 0.25
    # policy knobs (DESIGN.md §14.4)
    floor_weight: float = 1000.0
    admit_headroom: float = 0.90
    preempt_util: float = 0.999
    preempt_patience_ticks: int = 3
    preempt_drain_to: float = 0.85
    util_band: Tuple[float, float] = (0.40, 0.85)
    scale_patience_ticks: int = 3
    scale_cooldown_s: float = 120.0
    #: --smoke horizon (None: horizon_s / 10)
    smoke_horizon_s: Optional[float] = None
    #: reference-scenario acceptance ceiling on
    #: violation_s / active_tenant_s (asserted in CI)
    violation_ceiling: float = 0.15
    #: control-action event log cap in the report (dropped count kept)
    max_recorded_events: int = 512

    def smoke(self) -> "Scenario":
        h = self.smoke_horizon_s or max(self.horizon_s / 10, 10 * self.tick_s)
        return dataclasses.replace(
            self, name=f"{self.name}-smoke", horizon_s=h,
            budget_shocks=tuple((t, v) for t, v in self.budget_shocks
                                if t < h))


@dataclasses.dataclass(frozen=True)
class TenantPopulation:
    """Per-tenant static attributes, all drawn from the scenario seed."""
    join_t: np.ndarray        # float[n]; <= 0 means present from the start
    leave_t: np.ndarray       # float[n]; inf means never leaves
    base_rate: np.ndarray     # float[n] mean offered tokens/s
    cls: np.ndarray           # int[n] index into the SLO class table
    phase: np.ndarray         # float[n] diurnal phase offset (radians)

    @property
    def n(self) -> int:
        return self.join_t.shape[0]


def build_population(scn: Scenario, num_classes: int,
                     rng: np.random.Generator) -> TenantPopulation:
    """Draw the tenant population (rates, classes, churn times, phases)
    in a FIXED draw order — the first consumer of the scenario stream."""
    n = scn.tenants
    lo, hi = scn.rate_range_tps
    base_rate = rng.uniform(lo, hi, n)
    # class assignment: exact proportions, then a seeded permutation so
    # class membership is uncorrelated with tenant id
    counts = [int(round(f * n)) for _, f in scn.class_mix]
    while sum(counts) > n:
        counts[int(np.argmax(counts))] -= 1
    while sum(counts) < n:
        counts[int(np.argmin(counts))] += 1
    cls = np.repeat(np.arange(len(scn.class_mix)), counts)
    cls = rng.permutation(cls).astype(np.int64)
    if cls.max(initial=0) >= num_classes:
        raise ValueError(f"scenario {scn.name!r} names more classes than "
                         f"the control plane registered ({num_classes})")
    phase = rng.uniform(0.0, 2.0 * math.pi, n)
    join_t = np.zeros(n)
    leave_t = np.full(n, math.inf)
    k = int(round(scn.churn_fraction * n))
    if k:
        churners = rng.choice(n, size=k, replace=False)
        late = churners[: k // 2]
        early = churners[k // 2:]
        join_t[late] = rng.uniform(0.0, 0.5 * scn.horizon_s, late.size)
        leave_t[early] = rng.uniform(0.5 * scn.horizon_s,
                                     scn.horizon_s, early.size)
    return TenantPopulation(join_t=join_t, leave_t=leave_t,
                            base_rate=base_rate, cls=cls, phase=phase)


def trace_events(pop: TenantPopulation, scn: Scenario) -> list:
    """The replayable stimulus stream, time-ascending (ties: joins
    before leaves before budget shocks, then tenant id)."""
    evs = []
    for i in np.nonzero(pop.join_t > 0)[0]:
        evs.append(TraceEvent(float(pop.join_t[i]), "join", int(i)))
    for i in np.nonzero(np.isfinite(pop.leave_t))[0]:
        evs.append(TraceEvent(float(pop.leave_t[i]), "leave", int(i)))
    for t, frac in scn.budget_shocks:
        evs.append(TraceEvent(float(t), "budget", value=float(frac)))
    order = {"join": 0, "leave": 1, "budget": 2}
    evs.sort(key=lambda e: (e.t, order[e.kind], e.tenant))
    return evs


class ArrivalModel:
    """Vectorized seeded arrival process. ``counts`` draws the offered
    token counts for EVERY tenant each tick (inactive tenants get rate
    0 but still occupy the same position in the stream, so replay is
    churn-independent); ``mean_rate`` is the deterministic modulated
    mean the autoscaler smooths on (no sampling noise)."""

    def reset(self, n: int, rng: np.random.Generator) -> None:
        pass

    def mean_rate(self, t: float, base_rate: np.ndarray) -> np.ndarray:
        return base_rate

    def counts(self, t: float, dt: float, base_rate: np.ndarray,
               active: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        # draw at FULL rate for every tenant and only then mask: poisson
        # consumes a lambda-dependent number of underlying draws per
        # element, so zeroing lambdas (rather than results) would shift
        # the stream whenever the active set changes
        lam = self.mean_rate(t, base_rate) * dt
        draws = rng.poisson(lam).astype(np.float64)
        return np.where(active, draws, 0.0)


class PoissonArrivals(ArrivalModel):
    """Stationary Poisson arrivals at each tenant's base rate."""


class DiurnalArrivals(ArrivalModel):
    """Sinusoidally modulated Poisson: ``rate(t) = base * (1 + A *
    sin(2π t / period + phase))``, phases per tenant (a population whose
    peaks partially align — the aggregate still swings by ~A)."""

    def __init__(self, period_s: float, amplitude: float,
                 phase: np.ndarray):
        if not 0.0 <= amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1): {amplitude}")
        self.period_s = float(period_s)
        self.amplitude = float(amplitude)
        # concentrate phases so the population swings together (pure
        # per-tenant uniform phases would cancel in aggregate): keep a
        # third of each tenant's drawn phase
        self.phase = phase / 3.0

    def mean_rate(self, t: float, base_rate: np.ndarray) -> np.ndarray:
        mod = 1.0 + self.amplitude * np.sin(
            2.0 * math.pi * t / self.period_s + self.phase)
        return base_rate * mod


class MMPPArrivals(ArrivalModel):
    """Two-state Markov-modulated Poisson process per tenant: in the ON
    state the rate is ``burst_factor`` × base; state transitions are
    drawn per tick with probabilities ``p_on`` / ``p_off``."""

    def __init__(self, burst_factor: float, p_on: float, p_off: float):
        self.burst_factor = float(burst_factor)
        self.p_on = float(p_on)
        self.p_off = float(p_off)
        self.state: Optional[np.ndarray] = None

    def reset(self, n: int, rng: np.random.Generator) -> None:
        # start at the stationary distribution, seeded
        p_stat = self.p_on / max(self.p_on + self.p_off, 1e-12)
        self.state = rng.random(n) < p_stat

    def mean_rate(self, t: float, base_rate: np.ndarray) -> np.ndarray:
        if self.state is None:
            raise RuntimeError("MMPPArrivals.reset() not called")
        factor = np.where(self.state, self.burst_factor, 1.0)
        return base_rate * factor

    def counts(self, t: float, dt: float, base_rate: np.ndarray,
               active: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        # transition FIRST (one vectorized uniform draw per tick, fixed
        # stream position), then sample arrivals at the new state's rate
        u = rng.random(base_rate.shape[0])
        self.state = np.where(self.state, u >= self.p_off, u < self.p_on)
        return super().counts(t, dt, base_rate, active, rng)


def make_arrival_model(scn: Scenario, pop: TenantPopulation) -> ArrivalModel:
    if scn.arrival == "poisson":
        return PoissonArrivals()
    if scn.arrival == "diurnal":
        return DiurnalArrivals(scn.diurnal_period_s, scn.diurnal_amplitude,
                               pop.phase)
    if scn.arrival == "bursty":
        return MMPPArrivals(scn.burst_factor, scn.p_on, scn.p_off)
    raise ValueError(f"unknown arrival process {scn.arrival!r} "
                     f"(poisson|diurnal|bursty)")


#: The scenario catalog (DESIGN.md §14.6). ``diurnal-1k`` is the CI
#: reference: 1000 tenants over >= 100k virtual seconds with churn, a
#: mid-run budget crunch (forces preemption) and a diurnal swing (forces
#: autoscaling), asserted deterministic and under its violation ceiling.
SCENARIOS: Dict[str, Scenario] = {s.name: s for s in [
    Scenario(
        name="steady-64",
        tenants=64, horizon_s=4000.0, tick_s=20.0, arrival="poisson",
        rate_range_tps=(0.3, 1.3), budget_bytes=400.0 * GIB,
        slots_per_replica=16, min_replicas=2, max_replicas=4,
    ),
    Scenario(
        name="golden-32",
        tenants=32, horizon_s=1500.0, tick_s=25.0, arrival="poisson",
        rate_range_tps=(0.4, 1.6), churn_fraction=0.25,
        budget_shocks=((600.0, 0.08), (1050.0, 1.0)),
        budget_bytes=120.0 * GIB, slots_per_replica=4,
        min_replicas=2, max_replicas=4, scale_cooldown_s=100.0,
        violation_ceiling=0.35,
    ),
    Scenario(
        name="bursty-256",
        tenants=256, horizon_s=20000.0, tick_s=20.0, arrival="bursty",
        rate_range_tps=(0.1, 0.6), churn_fraction=0.1,
        burst_factor=6.0, p_on=0.04, p_off=0.25,
        budget_bytes=400.0 * GIB, slots_per_replica=16,
        min_replicas=2, max_replicas=8,
        violation_ceiling=0.30,
    ),
    Scenario(
        name="diurnal-1k",
        tenants=1000, horizon_s=100_000.0, tick_s=25.0, arrival="diurnal",
        rate_range_tps=(0.3, 1.3), churn_fraction=0.2,
        diurnal_period_s=20000.0, diurnal_amplitude=0.7,
        budget_shocks=((30_000.0, 0.10), (60_000.0, 1.0)),
        budget_bytes=360.0 * GIB, slots_per_replica=24,
        min_replicas=2, max_replicas=8,
        smoke_horizon_s=20_000.0,
        violation_ceiling=0.15,
    ),
]}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; catalog: "
                       f"{', '.join(sorted(SCENARIOS))}") from None
