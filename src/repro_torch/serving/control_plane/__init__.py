"""Trace-driven control plane over the deterministic simulator
(DESIGN.md §14): seeded traces, SLO-class admission with priority
preemption, replica autoscaling through the multi-tenant arbiter, and a
per-tenant SLO ledger. The simulation itself is pure numpy on a virtual
clock: nothing here runs on the card."""
from .admission import AdmissionController, DEFAULT_SLO_CLASSES, SLOClass
from .autoscale import ReplicaAutoscaler
from .ledger import LATENCY_BIN_EDGES_S, SLOLedger
from .plane import ControlPlane, Replica, run_scenario
from .traces import (ArrivalModel, DiurnalArrivals, MMPPArrivals,
                     PoissonArrivals, SCENARIOS, Scenario, TenantPopulation,
                     TraceEvent, build_population, get_scenario,
                     make_arrival_model, trace_events)

__all__ = [
    "AdmissionController", "DEFAULT_SLO_CLASSES", "SLOClass",
    "ReplicaAutoscaler", "LATENCY_BIN_EDGES_S", "SLOLedger",
    "ControlPlane", "Replica", "run_scenario",
    "ArrivalModel", "PoissonArrivals", "DiurnalArrivals", "MMPPArrivals",
    "Scenario", "TenantPopulation", "TraceEvent", "SCENARIOS",
    "build_population", "get_scenario", "make_arrival_model",
    "trace_events",
]
