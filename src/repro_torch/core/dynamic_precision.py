"""Online hotness-driven rung promotion/demotion
(``repro.core.dynamic_precision``, DESIGN.md §15).

The offline :class:`~repro_torch.core.sensitivity.SensitivityProfile` prices
quality per (layer, expert); the engine's routing histogram says where
traffic actually lands. This controller closes the loop between decode
iterations (Dynamic Expert Quantization, arXiv 2511.15015):

1. **window** — diff the engine's accumulated ``route_counts`` against
   the last snapshot; an empty window is a no-op;
2. **EMA fold** — ``ema = decay * ema + (1 - decay) * window_freq``,
   then ``profile = profile.with_freq(ema)`` so the quality objective
   re-weights toward measured traffic while old evidence ages out;
3. **swap search** — per layer, consider swapping the rungs of an
   expert pair at DIFFERENT rungs but the SAME placement (both
   device-resident or both offloaded): a swap keeps every per-layer
   rung count, every location, and hence the exact byte budget — it
   only moves WHICH expert pays the quantization tax. The gain of
   giving hot-and-sensitive expert *i* (low rung) cold expert *j*'s
   high rung is

       gain = (freq_i * sens[b_lo][i] + freq_j * sens[b_hi][j])
            - (freq_i * sens[b_hi][i] + freq_j * sens[b_lo][j])

   i.e. the measured quality-cost reduction under the traffic-weighted
   objective;
4. **hysteresis** — a swap only applies when its gain clears
   ``margin`` × the plan's current quality cost, and neither expert
   flipped within the last ``min_dwell_steps`` controller steps; at
   most ``max_swaps_per_step`` swaps apply per step. Under alternating
   hotness the EMA + margin + dwell guards keep the plan still
   (no flip-flapping — tested);
5. **apply** — ``engine.apply_bits_update()`` (diff-only: banks rebuilt
   in place, flipped cache entries re-staged through
   ``ExpertCache.update()`` at the exact byte delta), promotions/
   demotions mirrored into the QoS controller's
   ``rung_promotions``/``rung_demotions`` metrics, and a placement-only
   :class:`~repro_torch.serving.multi.ReplanReport` emitted via
   ``on_report``.

Works unchanged against the real ``AdaptiveServingEngine`` and the
deterministic ``SimulatedEngine`` — both expose ``route_counts``,
``current_plan`` and ``apply_bits_update``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.sensitivity import SensitivityProfile

__all__ = ["DynamicPrecisionConfig", "DynamicPrecisionController"]


@dataclasses.dataclass(frozen=True)
class DynamicPrecisionConfig:
    #: routing-frequency EMA decay per controller step: higher = slower
    #: to chase traffic shifts, stiffer against oscillation.
    ema_decay: float = 0.8
    #: an expert that just flipped may not flip again for this many
    #: controller steps (per-expert dwell — the anti-flap guard).
    min_dwell_steps: int = 4
    #: a swap must improve the measured quality cost by at least this
    #: fraction of the plan's current cost to apply.
    margin: float = 0.10
    #: rung swaps applied per controller step, best-gain first.
    max_swaps_per_step: int = 4


class DynamicPrecisionController:
    """Fold measured routing traffic into the sensitivity profile and
    issue hysteresis-guarded in-place rung swaps (DESIGN.md §15)."""

    def __init__(self, engine, profile: SensitivityProfile,
                 config: DynamicPrecisionConfig = DynamicPrecisionConfig(),
                 metrics: Optional[Dict[str, Any]] = None,
                 tenant: str = "default",
                 on_report: Optional[Callable[[Any], None]] = None):
        self.engine = engine
        self.profile = profile
        self.config = config
        #: external metrics sink — pass ``QoSController.metrics`` to
        #: count swap promotions/demotions in the existing
        #: ``rung_promotions``/``rung_demotions`` keys.
        self.sink = metrics
        self.tenant = tenant
        self.on_report = on_report
        self.metrics: Dict[str, float] = {
            "steps": 0, "updates": 0, "swaps": 0,
            "rung_promotions": 0, "rung_demotions": 0,
            "cache_bytes_delta": 0,
        }
        self._ema: Optional[np.ndarray] = None
        self._snapshot: Optional[np.ndarray] = None
        self._step = 0
        #: controller step at which each (l, e) last flipped
        self._last_flip: Dict[Tuple[int, int], int] = {}
        #: replan reports emitted (newest last) — assertable trace
        self.reports: List[Any] = []

    # -- observability ------------------------------------------------------
    def measured_freq(self) -> Optional[np.ndarray]:
        """The EMA-folded routing frequency (None before any traffic)."""
        return self._ema

    def quality_cost_measured(self, plan=None) -> float:
        """The active plan's quality cost under the traffic-folded
        profile — the objective the swap search descends."""
        plan = plan if plan is not None else self.engine.current_plan
        return self.profile.quality_cost(plan)

    # -- the loop -----------------------------------------------------------
    def step(self) -> bool:
        """One control decision; returns True iff a bits update was
        applied. Call between decode iterations (the QoSController's
        ``dynamic=`` hook does this automatically)."""
        self._step += 1
        self.metrics["steps"] += 1
        counts = getattr(self.engine, "route_counts", None)
        plan = self.engine.current_plan
        if counts is None or plan is None:
            return False
        counts = np.asarray(counts, np.float64)
        if counts.shape != self.profile.shape:
            return False
        window = counts if self._snapshot is None \
            else counts - self._snapshot
        self._snapshot = counts.copy()
        total = float(window.sum())
        if total <= 0:
            return False
        wf = window / total
        d = float(self.config.ema_decay)
        self._ema = wf if self._ema is None else d * self._ema + (1 - d) * wf
        self.profile = self.profile.with_freq(self._ema)

        swaps = self._select_swaps(plan)
        if not swaps:
            return False
        new_bits = plan.bits.copy()
        for gain, li, i, j in swaps:
            new_bits[li, i], new_bits[li, j] = \
                new_bits[li, j], new_bits[li, i]
            self._last_flip[(li, i)] = self._step
            self._last_flip[(li, j)] = self._step
        report = self.engine.apply_bits_update(new_bits)
        self.metrics["updates"] += 1
        self.metrics["swaps"] += len(swaps)
        # each swap promotes exactly one expert and demotes one
        self.metrics["rung_promotions"] += report["promotions"]
        self.metrics["rung_demotions"] += report["demotions"]
        self.metrics["cache_bytes_delta"] += report["cache_bytes_delta"]
        if self.sink is not None:
            self.sink["rung_promotions"] = \
                self.sink.get("rung_promotions", 0) + report["promotions"]
            self.sink["rung_demotions"] = \
                self.sink.get("rung_demotions", 0) + report["demotions"]
        self._emit_report(report, swaps)
        return True

    # -- internals ----------------------------------------------------------
    def _select_swaps(self, plan) -> List[Tuple[float, int, int, int]]:
        """Best same-layer same-location rung swaps clearing the margin
        and dwell guards, greedy by gain, at most one flip per expert
        per step."""
        cfg = self.config
        sens = self.profile.sens
        freq = self.profile.freq
        floor = cfg.margin * max(self.profile.quality_cost(plan), 1e-12)
        num_layers = plan.bits.shape[0]
        candidates: List[Tuple[float, int, int, int]] = []
        for li in range(num_layers):
            bits_l = plan.bits[li]
            loc_l = plan.location[li]
            for bi, bj in _rung_pairs(plan.ladder, bits_l):
                lo = np.flatnonzero(bits_l == bi)
                hi = np.flatnonzero(bits_l == bj)
                for i in lo:
                    for j in hi:
                        if loc_l[i] != loc_l[j]:
                            continue   # swap would move device bytes
                        gain = self._swap_gain(sens, freq, li,
                                               int(i), int(j),
                                               int(bi), int(bj))
                        if gain > floor:
                            candidates.append((gain, li, int(i), int(j)))
        candidates.sort(key=lambda c: (-c[0], c[1], c[2], c[3]))
        chosen: List[Tuple[float, int, int, int]] = []
        touched: set = set()
        for gain, li, i, j in candidates:
            if len(chosen) >= cfg.max_swaps_per_step:
                break
            ki, kj = (li, i), (li, j)
            if ki in touched or kj in touched:
                continue
            if self._step - self._last_flip.get(ki, -10**9) \
                    < cfg.min_dwell_steps:
                continue
            if self._step - self._last_flip.get(kj, -10**9) \
                    < cfg.min_dwell_steps:
                continue
            chosen.append((gain, li, i, j))
            touched.update((ki, kj))
        return chosen

    @staticmethod
    def _swap_gain(sens, freq, li: int, i: int, j: int,
                   b_lo: int, b_hi: int) -> float:
        """Quality-cost reduction of giving expert ``i`` (at low rung
        ``b_lo``) expert ``j``'s high rung ``b_hi``. A 16-bit rung
        prices 0 (not stored in ``sens``)."""
        def price(b: int, e: int) -> float:
            s = sens.get(b)
            return float(freq[li, e] * s[li, e]) if s is not None else 0.0

        before = price(b_lo, i) + price(b_hi, j)
        after = price(b_hi, i) + price(b_lo, j)
        return before - after

    def _emit_report(self, report: Dict[str, Any], swaps) -> None:
        from repro_torch.serving.multi import ReplanReport   # lazy: layering

        rr = ReplanReport(
            tenant=self.tenant,
            migrated_experts=int(report["restaged"]),
            evicted_experts=0,
            migrated_bytes=int(abs(report["cache_bytes_delta"])),
            downtime_s=0.0,
            placement_only=True,
        )
        self.reports.append(rr)
        if self.on_report is not None:
            self.on_report(rr)


def _rung_pairs(ladder, bits_l: np.ndarray):
    """(low, high) rung pairs both PRESENT in this layer's assignment,
    low < high — the swap search space."""
    present = sorted({int(b) for b in np.unique(bits_l)})
    for a in range(len(present)):
        for b in range(a + 1, len(present)):
            yield present[a], present[b]
