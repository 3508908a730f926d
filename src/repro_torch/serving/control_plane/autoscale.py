"""Engine-replica autoscaler with hysteresis (DESIGN.md §14.3).

The autoscaler watches DEMAND utilization — the deterministic modulated
offered load of every active tenant (admitted or pending) over the
fleet's aggregate capacity — rather than the sampled served/capacity
ratio, so Poisson noise cannot flap it. Decisions carry three guards:

* **patience** — the band must be breached for ``patience_ticks``
  consecutive ticks before any action;
* **cooldown** — at least ``cooldown_s`` of virtual time between
  actions (a scale-up's capacity change must be observed before the
  next decision);
* **projection** — scale-down only when the post-removal utilization
  ``util * R / (R - 1)`` would still sit below the high-water mark with
  margin, so an up move can never be immediately forced back.

The plane enforces the budget feasibility side (a replica is only
added when one more cheapest-point footprint fits the global budget).
"""
from __future__ import annotations

import math
from typing import Tuple

__all__ = ["ReplicaAutoscaler"]


class ReplicaAutoscaler:
    def __init__(self, *, band: Tuple[float, float] = (0.40, 0.85),
                 patience_ticks: int = 3, cooldown_s: float = 120.0,
                 min_replicas: int = 1, max_replicas: int = 8,
                 projection_margin: float = 0.95):
        lo, hi = band
        if not 0.0 < lo < hi:
            raise ValueError(f"utilization band must satisfy 0 < lo < hi "
                             f"({band})")
        self.lo, self.hi = float(lo), float(hi)
        self.patience_ticks = patience_ticks
        self.cooldown_s = cooldown_s
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.projection_margin = projection_margin
        self._above = 0
        self._below = 0
        self._last_action_t = -math.inf

    def step(self, now: float, demand_util: float, n_replicas: int, *,
             can_add: bool = True, can_remove: bool = True) -> int:
        """One decision: +1 (scale up), -1 (scale down) or 0 (hold)."""
        self._above = self._above + 1 if demand_util > self.hi else 0
        self._below = self._below + 1 if demand_util < self.lo else 0
        if now - self._last_action_t < self.cooldown_s:
            return 0
        if (self._above >= self.patience_ticks
                and n_replicas < self.max_replicas and can_add):
            self._record(now)
            return 1
        if (self._below >= self.patience_ticks
                and n_replicas > self.min_replicas and can_remove):
            projected = demand_util * n_replicas / max(n_replicas - 1, 1)
            if projected < self.hi * self.projection_margin:
                self._record(now)
                return -1
        return 0

    def _record(self, now: float) -> None:
        self._last_action_t = now
        self._above = 0
        self._below = 0
