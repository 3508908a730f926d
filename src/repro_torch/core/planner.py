"""Adaptive Inference Partitioner & Planner (paper §3, Fig. 1).

Given a memory budget and a task preference ("throughput" | "quality"),
produce a :class:`PrecisionPlan`:

* throughput preference — bring as many experts on-device as possible.
  If the budget exceeds non-expert + all-quantized experts (at the
  ladder's LOWEST rung), eq. (1) converts the surplus into 16-bit
  experts:

      Num_E16 = floor((Mem - Size_NE - Num_E*Size_E4) / (3*Size_E4))

  (3*Size_E4 = Size_E16 - Size_E4 when Size_E16 = 4*Size_E4). Otherwise all
  experts are quantized and only a budget-sized subset is resident.

* quality preference — the caller picks the quantized counts directly:
  either the legacy ``num_q_experts`` scalar (all at the lowest rung)
  or ``counts`` — a {rung: global count} mapping over the ladder's
  quantized rungs (DESIGN.md §11); the planner derives residency from
  the leftover budget, cheapest rung first.

Reconfiguration between plans is incremental (precision_plan.reconfig_delta).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Mapping, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model
from repro_torch.core.precision_plan import (PrecisionPlan,
                                             balanced_ladder_plan,
                                             quantized_rungs, validate_ladder)

Preference = Literal["throughput", "quality"]

if False:  # typing-only, avoids a runtime cycle (pareto imports planner)
    from repro_torch.core.pareto import ParetoFrontier  # noqa: F401


def num_e16_eq1(mem_bytes: float, size_ne: int, num_e: int,
                size_e4: int, size_e16: Optional[int] = None) -> int:
    """Paper equation (1), generalized to measured expert sizes (our int4
    expert carries group scales, so Size_E16 != exactly 4*Size_E4)."""
    if size_e16 is None:
        size_e16 = 4 * size_e4
    surplus = mem_bytes - size_ne - num_e * size_e4
    if surplus <= 0:
        return 0
    return min(num_e, int(surplus // (size_e16 - size_e4)))


@dataclasses.dataclass(frozen=True)
class PlanResult:
    plan: PrecisionPlan
    qos: cost_model.QoSEstimate
    preference: str
    mem_budget_bytes: float

    def summary(self) -> str:
        p, q = self.plan, self.qos
        return (f"[{self.preference}] E4={p.num_q_experts}/{p.bits.size} "
                f"resident={p.resident_fraction():.0%} "
                f"dev={q.device_bytes/2**30:.2f}GiB "
                f"tok/s={q.tokens_per_s:.2f} "
                f"ppl_proxy=x{q.quality_proxy:.3f}")


class AdaptivePlanner:
    """Stateful planner: re-plan on constraint change, emit reconfig deltas."""

    def __init__(self, cfg: ModelConfig,
                 hw: cost_model.HardwareModel = cost_model.HardwareModel(),
                 seed: int = 0, profile=None, ep: int = 1):
        if cfg.moe is None:
            raise ValueError(
                f"{cfg.arch_id}: MoP planning needs routed experts "
                "(DESIGN.md §5 Arch-applicability)")
        ep = int(ep)
        if ep < 1:
            raise ValueError(f"ep must be >= 1, got {ep}")
        if ep > 1 and cfg.moe.num_experts % ep:
            raise ValueError(
                f"{cfg.arch_id}: {cfg.moe.num_experts} experts do not "
                f"split over ep={ep} devices (num_experts %% ep must "
                "be 0)")
        self.cfg = cfg
        self.hw = hw
        self.seed = seed
        #: EP shard count (DESIGN.md §16): counts round to multiples of
        #: ep (bank shards must split evenly over the mesh) and the
        #: residency budget buys LOCAL experts — the other ep-1 shards
        #: mirror the purchase, so up to ep x the local capacity is
        #: accelerator-resident (the surplus rides the PEER tier). ep=1
        #: is the historical single-device planner bit-for-bit.
        self.ep = ep
        #: optional SensitivityProfile (DESIGN.md §15): data-driven
        #: quality pricing for plan()/frontier(). None = legacy flat cost.
        self.profile = profile
        self.ladder = validate_ladder(cfg.mop.precision_ladder)
        self.current: Optional[PlanResult] = None
        self._frontiers: dict = {}   # batch_size -> ParetoFrontier

    # -- sizes ------------------------------------------------------------
    def expert_bytes(self, rung: int) -> int:
        """One expert's byte size at ``rung`` (paper Size_E*)."""
        return self.cfg.expert_param_bytes(rung)

    @property
    def size_e4(self) -> int:
        """Size of the ladder's CHEAPEST rung (legacy name: with the
        default ladder the lowest rung is 4-bit)."""
        return self.cfg.expert_param_bytes(quantized_rungs(self.ladder)[0])

    @property
    def size_e16(self) -> int:
        return self.cfg.expert_param_bytes(16)

    @property
    def size_ne(self) -> int:
        return self.cfg.non_expert_bytes()

    @property
    def num_experts_total(self) -> int:
        return self.cfg.num_layers * self.cfg.moe.num_experts

    # -- planning ---------------------------------------------------------
    def plan(self, mem_budget_bytes: float, preference: Preference,
             num_q_experts: Optional[int] = None,
             batch_size: int = 1,
             counts: Optional[Mapping[int, int]] = None,
             resident_experts: Optional[int] = None,
             peer_experts: Optional[int] = None) -> PlanResult:
        """``resident_experts``/``peer_experts`` (EP apply path,
        DESIGN.md §16) pin the placement split directly — the engine
        passes a frontier point's exact (total resident, peer) pair so
        the applied plan is the point's plan bit-for-bit; ``None``
        (every single-device caller) derives residency from the budget
        as always."""
        if mem_budget_bytes < self.size_ne:
            # paper §3: non-expert layers always live on the accelerator in
            # 16-bit — below that floor no plan exists.
            raise ValueError(
                f"infeasible budget {mem_budget_bytes/2**20:.1f} MiB < "
                f"non-expert floor {self.size_ne/2**20:.1f} MiB")
        total = self.num_experts_total
        layers = self.cfg.num_layers
        low = quantized_rungs(self.ladder)[0]
        if preference == "throughput":
            if counts is not None:
                raise ValueError("throughput preference derives its own "
                                 "counts (eq. 1); pass counts with the "
                                 "quality preference")
            n16 = num_e16_eq1(mem_budget_bytes, self.size_ne, total,
                              self.size_e4, self.size_e16)
            # balanced split: floor per layer keeps the footprint <= budget
            # (each skipped promotion only frees memory)
            n16 = (n16 // layers) * layers
            counts = {low: total - n16}
        elif preference == "quality":
            if counts is None:
                if num_q_experts is None:
                    raise ValueError(
                        "quality preference needs num_q_experts or a "
                        "per-rung counts mapping (paper: user-provided "
                        "range; DESIGN.md §11)")
                counts = {low: int(num_q_experts)}
        else:
            raise ValueError(preference)
        # residency from the ACTUAL balanced counts
        counts = self._balance_counts(counts)
        if resident_experts is not None:
            # pinned placement (frontier apply path): total resident =
            # local + peer; balanced_ladder_plan takes the LOCAL count
            total_res = int(np.clip(resident_experts, 0, total))
            peer = int(np.clip(peer_experts or 0, 0, total_res))
            resident, peer = total_res - peer, peer
        elif self.ep > 1:
            # budget buys LOCAL residency; the other ep-1 shards hold
            # the same per-device share, reached via the PEER tier
            n_local = self._resident_budget(mem_budget_bytes, counts)
            total_res = min(total, n_local * self.ep)
            resident = -(-total_res // self.ep) if total_res else 0
            peer = total_res - resident
        else:
            resident = self._resident_budget(mem_budget_bytes, counts)
            peer = 0

        plan = balanced_ladder_plan(
            self.cfg.num_layers, self.cfg.moe.num_experts, counts,
            ladder=self.ladder, group_size=self.cfg.mop.group_size,
            seed=self.seed, resident_experts=resident,
            peer_experts=peer)
        qos = cost_model.estimate_qos(self.cfg, plan, self.hw, batch_size,
                                      self.profile)
        if qos.device_bytes > mem_budget_bytes * 1.001:
            raise RuntimeError(
                f"planner bug: footprint {qos.device_bytes} > budget")
        result = PlanResult(plan=plan, qos=qos, preference=preference,
                            mem_budget_bytes=mem_budget_bytes)
        return result

    def _balance_counts(self, counts: Mapping[int, int]) -> Dict[int, int]:
        """Round each rung's global count to a balanced per-layer multiple
        and clip the joint total to the expert grid (cheapest rung keeps
        priority on clipping, matching the assignment order). Under EP
        per-layer counts additionally round DOWN to multiples of
        ``self.ep`` so every rung bank splits evenly over the mesh
        (mixed_moe's dispatch invariant — DESIGN.md §16)."""
        layers = self.cfg.num_layers
        e = self.cfg.moe.num_experts
        out: Dict[int, int] = {}
        room = e
        for b in quantized_rungs(self.ladder):
            per_layer = int(round(int(counts.get(b, 0)) / layers))
            per_layer = min(max(per_layer, 0), room)
            per_layer -= per_layer % self.ep
            out[b] = per_layer * layers
            room -= per_layer
        return out

    def _resident_budget(self, mem_bytes: float,
                         counts: Mapping[int, int]) -> int:
        """How many experts fit on-device: cheapest rung first (the
        paper's priority rule generalized over the ladder)."""
        total = self.num_experts_total
        left = mem_bytes - self.size_ne
        if left <= 0:
            return 0
        resident = 0
        remaining = total
        for b in quantized_rungs(self.ladder):
            have = int(counts.get(b, 0))
            n = min(have, int(left // self.expert_bytes(b)))
            n = max(n, 0)
            resident += n
            left -= n * self.expert_bytes(b)
            remaining -= have
        n16 = min(remaining, max(0, int(left // self.size_e16)))
        return resident + n16

    def replan(self, mem_budget_bytes: float, preference: Preference,
               num_q_experts: Optional[int] = None, batch_size: int = 1,
               counts: Optional[Mapping[int, int]] = None,
               resident_experts: Optional[int] = None,
               peer_experts: Optional[int] = None):
        """Returns (PlanResult, delta|None). Keeps planner state."""
        from repro_torch.core.precision_plan import (delta_cost_bytes,
                                                     migrated_expert_keys,
                                                     reconfig_delta)
        new = self.plan(mem_budget_bytes, preference, num_q_experts,
                        batch_size, counts=counts,
                        resident_experts=resident_experts,
                        peer_experts=peer_experts)
        delta = None
        if self.current is not None:
            delta = reconfig_delta(self.current.plan, new.plan)
            # the partial-reconfiguration working set: experts that
            # actually stream (each once), and the traffic they cost
            delta["migrated"] = migrated_expert_keys(delta, new.plan)
            delta["traffic_bytes"] = delta_cost_bytes(
                delta, self.cfg.expert_param_bytes, new.plan)
        self.current = new
        return new, delta

    def recalibrate(self, hw: cost_model.HardwareModel) -> None:
        """Swap the hardware model — e.g. after the serving engine
        measures its actual overlap efficiency (DESIGN.md §12) — and
        drop every cached frontier so future ``plan()``/``frontier()``
        calls rank under the new constants. The active plan is kept:
        recalibration changes predictions, not placements."""
        self.hw = hw
        self._frontiers.clear()

    def set_profile(self, profile) -> None:
        """Swap the sensitivity profile (DESIGN.md §15) — e.g. after an
        offline calibration pass or when the dynamic controller folds in
        fresh traffic stats — and drop cached frontiers so future
        rankings price quality per expert. The active plan is kept."""
        self.profile = profile
        self._frontiers.clear()

    def frontier(self, batch_size: int = 1) -> "ParetoFrontier":
        """The ParetoFrontier for this planner's (cfg, hw, seed) — built
        once per batch size and cached (DESIGN.md §9). Frontier plans are
        bit-identical to ``plan()`` output for the same knob values."""
        if batch_size not in self._frontiers:
            from repro_torch.core.pareto import ParetoFrontier
            self._frontiers[batch_size] = ParetoFrontier(
                self.cfg, self.hw, batch_size=batch_size, seed=self.seed,
                profile=self.profile, ep=self.ep)
        return self._frontiers[batch_size]

    def sweep(self, mem_budget_bytes: float, batch_size: int = 1,
              points: Optional[int] = None):
        """Quality-mode sweep over the quantized-count levels — the
        paper's config space (Fig. 2/3 x-axes); returns list of
        PlanResult + Pareto indices.

        Rebased on :meth:`frontier`: one point per balanced quantized
        level, each at the max residency fitting the budget. ``points``
        is kept for backward compatibility and ignored (the balanced
        levels ARE the distinct plans the old dense sampling collapsed
        to)."""
        del points
        results = [
            PlanResult(plan=p.plan, qos=p.qos, preference="quality",
                       mem_budget_bytes=mem_budget_bytes)
            for p in self.frontier(batch_size)
            .best_per_quality_level(mem_budget_bytes)
        ]
        pts = [(r.qos.tokens_per_s, r.qos.quality_proxy) for r in results]
        return results, cost_model.pareto_frontier(pts)
