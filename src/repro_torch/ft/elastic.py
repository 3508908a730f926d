"""Elastic scaling, failure handling, and straggler mitigation (a copy of
``repro.ft.elastic``: numpy only).

Large-scale runnability substrate (DESIGN.md §4). On a real cluster these
components consume the platform's health signals (GCE maintenance events,
ICI link errors); here the detector interface is driven by heartbeats so
the whole policy layer is unit-testable on CPU.

  * HeartbeatFailureDetector — per-worker deadline detector
  * StragglerMonitor        — per-step worker timings -> robust z-score ->
                              slow-worker quarantine recommendation
  * ElasticPlan             — given the healthy worker set, choose the
                              largest runnable mesh and the data-shard
                              remapping; restore goes through
                              ft.checkpoint's reshard-on-load
  * run_with_recovery       — the supervision loop: step -> on failure,
                              shrink mesh, restore latest checkpoint, replay
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class HeartbeatFailureDetector:
    def __init__(self, workers: Sequence[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last: Dict[str, float] = {w: clock() for w in workers}
        self.dead: set = set()

    def heartbeat(self, worker: str):
        if worker not in self.dead:
            self.last[worker] = self.clock()

    def mark_failed(self, worker: str):
        self.dead.add(worker)

    def failed(self) -> List[str]:
        now = self.clock()
        for w, t in self.last.items():
            if w not in self.dead and now - t > self.timeout:
                self.dead.add(w)
        return sorted(self.dead)

    def healthy(self) -> List[str]:
        self.failed()
        return sorted(set(self.last) - self.dead)


class StragglerMonitor:
    """Robust z-score on per-worker step times (median/MAD over a window).
    Workers slower than ``z_thresh`` for ``patience`` consecutive steps are
    recommended for quarantine (checkpoint-evict-rescale, not blocking)."""

    def __init__(self, workers: Sequence[str], window: int = 16,
                 z_thresh: float = 4.0, patience: int = 3):
        self.window, self.z, self.patience = window, z_thresh, patience
        self.times: Dict[str, List[float]] = {w: [] for w in workers}
        self.strikes: Dict[str, int] = {w: 0 for w in workers}

    def record_step(self, timings: Dict[str, float]):
        for w, t in timings.items():
            buf = self.times.setdefault(w, [])
            buf.append(t)
            del buf[:-self.window]
        med = np.median([b[-1] for b in self.times.values() if b])
        mad = np.median([abs(b[-1] - med)
                         for b in self.times.values() if b]) + 1e-9
        for w, b in self.times.items():
            if not b:
                continue
            if (b[-1] - med) / (1.4826 * mad) > self.z:
                self.strikes[w] = self.strikes.get(w, 0) + 1
            else:
                self.strikes[w] = 0

    def quarantine(self) -> List[str]:
        return sorted(w for w, s in self.strikes.items()
                      if s >= self.patience)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Mesh choice for a healthy-worker count. The model axis is fixed by
    the sharding rules (16); elasticity happens on (pod x data)."""
    n_workers: int
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    dropped_workers: int

    @property
    def degraded(self) -> bool:
        return self.dropped_workers > 0


def plan_mesh(n_healthy: int, model: int = 16,
              data_choices: Sequence[int] = (32, 16, 8, 4, 2, 1)
              ) -> ElasticPlan:
    """Largest (data, model) mesh that fits the healthy workers; data dim
    shrinks in powers of two (global batch is preserved by increasing
    grad-accumulation microbatches — see train driver)."""
    for d in data_choices:
        need = d * model
        if need <= n_healthy:
            if d > 16:
                shape, axes = (d // 16, 16, model), ("pod", "data", "model")
            else:
                shape, axes = (d, model), ("data", "model")
            return ElasticPlan(n_workers=need, mesh_shape=shape,
                               mesh_axes=axes,
                               dropped_workers=n_healthy - need)
    raise RuntimeError(f"cannot build any mesh from {n_healthy} workers")


def remap_data_shards(old_dp: int, new_dp: int, step: int
                      ) -> List[List[int]]:
    """Which old data shards each new rank takes over after a rescale —
    deterministic and gap-free so no documents are skipped or repeated."""
    return [[s for s in range(old_dp) if s % new_dp == r]
            for r in range(new_dp)]


def run_with_recovery(*, step_fn, save_fn, restore_fn, detector,
                      max_steps: int, checkpoint_every: int = 50,
                      on_rescale=None, max_failures: int = 8):
    """Supervision loop (simulation-grade): run step_fn(step); on raised
    WorkerFailure (or detector-reported deaths) -> restore from the last
    checkpoint onto the shrunken mesh and continue. Returns history."""
    history = {"completed": 0, "failures": 0, "rescales": []}
    step = 0
    while step < max_steps:
        try:
            dead = detector.failed()
            if dead and on_rescale is not None:
                plan = plan_mesh(len(detector.healthy()))
                on_rescale(plan, dead)
                history["rescales"].append((step, tuple(dead),
                                            plan.mesh_shape))
                step = restore_fn()
                detector.dead.clear()
                for w in dead:
                    detector.last.pop(w, None)
                continue
            step_fn(step)
            step += 1
            history["completed"] += 1
            if step % checkpoint_every == 0:
                save_fn(step)
        except WorkerFailure as e:
            history["failures"] += 1
            if history["failures"] > max_failures:
                raise
            detector.mark_failed(e.worker)
    return history


class WorkerFailure(RuntimeError):
    def __init__(self, worker: str, msg: str = ""):
        super().__init__(f"worker {worker} failed {msg}")
        self.worker = worker
