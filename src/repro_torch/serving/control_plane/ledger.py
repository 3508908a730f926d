"""Per-tenant SLO accounting ledger (DESIGN.md §14.5).

Everything the control plane is judged on accrues here, vectorized over
the tenant population each tick:

* **violation seconds** — a tenant is in violation for a tick when it is
  active, has demand, and its achieved service rate falls short of
  ``min(class floor, demand rate)`` (a gold tenant offering 0.5 tok/s is
  not "violated" up to its 4 tok/s floor — only up to what it asked);
* **latency percentiles** — the per-tick queueing-delay proxy
  ``backlog / service_rate`` is accumulated into a per-tenant
  log-spaced histogram; p95/p99 are read from bin upper edges, so the
  report needs O(bins) memory per tenant instead of every sample, stays
  byte-deterministic, and still resolves sub-second to hour-scale waits;
* **goodput** — served tokens over active seconds;
* **preemption count / max unserved span** — the no-starvation
  evidence: the longest continuous stretch any tenant spent active but
  unserved (pending or preempted);
* **replan downtime** — seconds of replica unavailability attributed to
  each tenant hosted on a repointing replica (§10.3 ReplanReports).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["SLOLedger", "LATENCY_BIN_EDGES_S"]

#: log-spaced latency histogram bin upper edges (seconds): 10 ms .. 2 h.
LATENCY_BIN_EDGES_S = np.geomspace(1e-2, 7200.0, 48)


class SLOLedger:
    def __init__(self, n: int):
        self.n = n
        self.arrived = np.zeros(n)
        self.served = np.zeros(n)
        self.dropped = np.zeros(n)
        self.violation_s = np.zeros(n)
        self.active_s = np.zeros(n)
        self.admitted_s = np.zeros(n)
        self.downtime_s = np.zeros(n)
        self.preemptions = np.zeros(n, dtype=np.int64)
        self.max_unserved_span_s = np.zeros(n)
        # one overflow bin past the last edge
        self.lat_hist = np.zeros((n, LATENCY_BIN_EDGES_S.size + 1),
                                 dtype=np.int64)

    # -- per-tick accrual ---------------------------------------------------
    def record_tick(self, dt: float, active: np.ndarray,
                    admitted: np.ndarray, demand_rate: np.ndarray,
                    served_rate: np.ndarray, floor: np.ndarray,
                    backlog: np.ndarray) -> None:
        self.active_s[active] += dt
        self.admitted_s[active & admitted] += dt
        required = np.minimum(floor, demand_rate)
        viol = active & (required > 1e-12) \
            & (served_rate < required * (1.0 - 1e-9))
        self.violation_s[viol] += dt
        has_demand = active & ((demand_rate > 1e-12) | (backlog > 1e-9))
        if has_demand.any():
            lat = backlog[has_demand] / np.maximum(served_rate[has_demand],
                                                   1e-9)
            idx = np.searchsorted(LATENCY_BIN_EDGES_S,
                                  np.minimum(lat, 7200.0))
            np.add.at(self.lat_hist, (np.nonzero(has_demand)[0], idx), 1)

    def note_unserved_span(self, ids, span_s: float | np.ndarray) -> None:
        np.maximum.at(self.max_unserved_span_s, ids, span_s)

    def charge_downtime(self, mask: np.ndarray, seconds: float) -> None:
        self.downtime_s[mask] += seconds

    # -- readouts -----------------------------------------------------------
    def percentile(self, q: float, hist: np.ndarray = None) -> np.ndarray:
        """Per-row latency percentile (seconds) from the histogram(s):
        the upper edge of the first bin reaching the q-quantile of the
        row's samples; rows without samples read 0."""
        h = self.lat_hist if hist is None else hist
        h = np.atleast_2d(h)
        total = h.sum(axis=1)
        cum = np.cumsum(h, axis=1)
        # overflow bin reports the top edge
        edges = np.append(LATENCY_BIN_EDGES_S, LATENCY_BIN_EDGES_S[-1])
        idx = np.argmax(cum >= np.ceil(q * total)[:, None], axis=1)
        out = edges[idx]
        out[total == 0] = 0.0
        return out

    def goodput_tps(self) -> np.ndarray:
        return self.served / np.maximum(self.active_s, 1e-9)

    def class_rollup(self, cls: np.ndarray, names: Sequence[str]
                     ) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for c, name in enumerate(names):
            m = cls == c
            hist = self.lat_hist[m].sum(axis=0, keepdims=True)
            out[name] = {
                "tenants": int(m.sum()),
                "arrived_tokens": float(self.arrived[m].sum()),
                "served_tokens": float(self.served[m].sum()),
                "dropped_tokens": float(self.dropped[m].sum()),
                "violation_s": float(self.violation_s[m].sum()),
                "violation_rate": float(
                    self.violation_s[m].sum()
                    / max(self.active_s[m].sum(), 1e-9)),
                "p95_latency_s": float(self.percentile(0.95, hist)[0]),
                "p99_latency_s": float(self.percentile(0.99, hist)[0]),
                "goodput_tps": float(
                    self.served[m].sum()
                    / max(self.active_s[m].sum(), 1e-9)),
                "preemptions": int(self.preemptions[m].sum()),
                "downtime_s": float(self.downtime_s[m].sum()),
                "max_unserved_span_s": float(
                    self.max_unserved_span_s[m].max(initial=0.0)),
            }
        return out

    def tenant_rows(self, cls: np.ndarray) -> List[list]:
        """Compact per-tenant table: [id, class, violation_s, p95_s,
        p99_s, goodput_tps, preemptions, downtime_s, served, dropped]."""
        p95 = self.percentile(0.95)
        p99 = self.percentile(0.99)
        good = self.goodput_tps()
        return [[i, int(cls[i]),
                 round(float(self.violation_s[i]), 6),
                 round(float(p95[i]), 6), round(float(p99[i]), 6),
                 round(float(good[i]), 6), int(self.preemptions[i]),
                 round(float(self.downtime_s[i]), 6),
                 round(float(self.served[i]), 6),
                 round(float(self.dropped[i]), 6)]
                for i in range(self.n)]
