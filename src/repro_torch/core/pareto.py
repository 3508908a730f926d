"""Pareto frontier over the MoP configuration space (DESIGN.md §9, §11).

The paper's planner exposes the *mechanism* — (Num_E4, residency) knobs —
but a serving deployment declares *targets*: "at least X tokens/s, at most
Y% perplexity loss, inside Z bytes of HBM". This module is the bridge:

* :class:`ParetoFrontier` enumerates the (counts-per-ladder-rung ×
  residency split) configuration space through the analytic cost model
  ONCE per (model, hardware, batch) — the enumeration is what the paper
  calls the fine-grained configuration space of Figs. 2+3, generalized
  from the boolean Num_E4 axis to one count axis per quantized ladder
  rung — and keeps the dominant set in the three QoS axes (tokens/s ↑,
  quality_proxy ↓, device bytes ↓). Binary ladders enumerate the full
  per-layer grid (bit-identical to the legacy (Num_E4 × residency)
  space); multi-rung ladders prune the count grid to a stride lattice
  (always containing 0 and E per rung) sized so the enumeration stays
  under ``max_enum_points`` — the §11 tractability rule.
* :class:`QoSTarget` is the declarative constraint a caller states instead
  of knob values; :meth:`ParetoFrontier.select` resolves it to one
  :class:`FrontierPoint` with deterministic tie-breaking: among points
  meeting the target, prefer quality, then the lowest device footprint.
* the runtime :class:`~repro.serving.qos.QoSController` walks *adjacent*
  frontier points when the measured QoS drifts outside the target band.

Every ``FrontierPoint`` carries the concrete ``PrecisionPlan`` so applying
a point is exactly the planner's ``plan(device_bytes, "quality", nq)``
result — the frontier and the imperative path can never disagree.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model
from repro_torch.core.cost_model import HardwareModel, QoSEstimate
from repro_torch.core.precision_plan import (PrecisionPlan,
                                             balanced_ladder_plan,
                                             quantized_rungs, validate_ladder)

__all__ = [
    "QoSTarget", "FrontierPoint", "ParetoFrontier", "InfeasibleTarget",
]


class InfeasibleTarget(ValueError):
    """No enumerated configuration satisfies the target's hard constraints."""


def _fmt_bytes(n: float) -> str:
    return (f"{n / 2**30:.2f}GiB" if n >= 2**30
            else f"{n / 2**20:.2f}MiB")


@dataclasses.dataclass(frozen=True)
class QoSTarget:
    """Declarative service-level objective for one serving deployment.

    All fields are optional; unset means unconstrained. ``min_tokens_per_s``
    is a *soft* objective (the controller chases it; ``select`` falls back
    to the fastest feasible point when nothing meets it — best effort),
    while ``mem_budget_bytes`` and ``max_quality_loss`` are *hard*
    constraints (a point violating them is never selected).

    ``min_tokens_per_s=math.inf`` is the idiom for "as fast as possible
    under the constraints" (the old ``preference="throughput"``).
    """
    min_tokens_per_s: Optional[float] = None
    # max tolerated perplexity increase vs all-16-bit, fractional:
    # 0.05 == "at most +5% perplexity" (quality_proxy <= 1.05).
    max_quality_loss: Optional[float] = None
    mem_budget_bytes: Optional[float] = None
    # p95 per-request latency ceiling; no analytic predictor exists for it,
    # so only the runtime QoSController acts on this field.
    max_p95_latency_s: Optional[float] = None

    def describe(self) -> str:
        parts = []
        if self.min_tokens_per_s is not None:
            parts.append("tok/s>=inf" if math.isinf(self.min_tokens_per_s)
                         else f"tok/s>={self.min_tokens_per_s:g}")
        if self.max_quality_loss is not None:
            parts.append(f"ppl<=x{1.0 + self.max_quality_loss:.3f}")
        if self.mem_budget_bytes is not None:
            parts.append(f"mem<={_fmt_bytes(self.mem_budget_bytes)}")
        if self.max_p95_latency_s is not None:
            parts.append(f"p95<={self.max_p95_latency_s * 1e3:.0f}ms")
        return " ".join(parts) or "unconstrained"

    def with_kv_reclaimed(self, reclaimed_bytes: float) -> "QoSTarget":
        """The same target with KV savings credited to the expert-
        residency budget (DESIGN.md §13): the paged cache prices KV per
        mapped page, so HBM the slot cache would have stranded as bucket
        padding widens ``mem_budget_bytes`` instead. No-op when no budget
        is declared (unconstrained stays unconstrained) or nothing was
        reclaimed."""
        if not reclaimed_bytes or self.mem_budget_bytes is None \
                or not math.isfinite(self.mem_budget_bytes):
            return self
        return dataclasses.replace(
            self, mem_budget_bytes=self.mem_budget_bytes
            + float(reclaimed_bytes))


# eq=False: the embedded PrecisionPlan holds ndarrays, so generated
# dataclass equality would be ambiguous — identity semantics are correct
# here (frontier points are interned singletons of their frontier).
@dataclasses.dataclass(frozen=True, eq=False)
class FrontierPoint:
    """One dominant configuration: the knob values, the concrete plan they
    expand to, and the cost model's QoS estimate for it.

    ``counts_per_rung`` are the GLOBAL expert counts aligned with the
    plan's ladder (descending, 16-bit rung first); ``num_q_experts`` is
    their sub-16-bit sum — the paper's Num_E4 for a binary ladder."""
    num_q_experts: int        # global quantized count (multiple of L)
    resident_experts: int     # global ACCELERATOR-resident expert count
    #                           (local + peer under EP; == local at ep=1)
    plan: PrecisionPlan
    qos: QoSEstimate
    counts_per_rung: Tuple[int, ...] = ()
    #: of ``resident_experts``, how many live on PEER devices (EP
    #: placement tier, DESIGN.md §16); always 0 at ep=1.
    peer_experts: int = 0

    def quantized_counts(self) -> Dict[int, int]:
        """{rung: global count} over the plan's quantized rungs — the
        planner's ``counts`` argument (engine apply path)."""
        return {b: c for b, c in zip(self.plan.ladder, self.counts_per_rung)
                if b < 16}

    def meets(self, target: QoSTarget) -> bool:
        """Hard constraints AND the throughput objective (analytically)."""
        return (self.feasible_under(target)
                and (target.min_tokens_per_s is None
                     or self.qos.tokens_per_s >= target.min_tokens_per_s))

    def feasible_under(self, target: QoSTarget) -> bool:
        """Hard constraints only (budget + quality ceiling)."""
        if target.mem_budget_bytes is not None \
                and self.qos.device_bytes > target.mem_budget_bytes:
            return False
        if target.max_quality_loss is not None \
                and self.qos.quality_proxy > 1.0 + target.max_quality_loss \
                + 1e-12:
            return False
        return True

    def summary(self) -> str:
        q = self.qos
        rungs = [b for b in self.plan.ladder if b < 16]
        if len(rungs) <= 1:
            knobs = f"E{rungs[0] if rungs else 4}={self.num_q_experts}"
        else:
            counts = self.quantized_counts()
            knobs = "E[" + ",".join(f"{b}b={counts[b]}"
                                    for b in self.plan.ladder
                                    if b < 16) + "]"
        return (f"{knobs} res={self.resident_experts} "
                f"dev={_fmt_bytes(q.device_bytes)} "
                f"tok/s={q.tokens_per_s:.2f} ppl=x{q.quality_proxy:.3f}")


def _dominates(a: FrontierPoint, b: FrontierPoint) -> bool:
    """a dominates b in (tokens/s ↑, quality ↓, device bytes ↓)."""
    ge = (a.qos.tokens_per_s >= b.qos.tokens_per_s
          and a.qos.quality_proxy <= b.qos.quality_proxy
          and a.qos.device_bytes <= b.qos.device_bytes)
    gt = (a.qos.tokens_per_s > b.qos.tokens_per_s
          or a.qos.quality_proxy < b.qos.quality_proxy
          or a.qos.device_bytes < b.qos.device_bytes)
    return ge and gt


class ParetoFrontier:
    """The dominant set of the (counts-per-rung × residency) space.

    Built once per (model config, hardware model, batch size, seed) — i.e.
    once per hardware/budget regime change, NOT per request. Budgets are
    query-time filters (``QoSTarget.mem_budget_bytes``) so one frontier
    serves every tenant budget.

    The precision ladder comes from ``cfg.mop.precision_ladder``. A
    binary ladder enumerates each per-layer quantized count 0..E (the
    legacy ``(E+1)²`` space, bit-identical plans). A K-rung ladder
    enumerates one count axis per quantized rung; the grid is pruned to
    per-rung stride lattices (§11 rule: the per-rung level count is the
    largest uniform choice keeping the whole enumeration under
    ``max_enum_points``; 0 and E always enumerate, so pure-rung corners
    and the legacy axis endpoints are never pruned away).

    ``residency_step`` controls enumeration granularity for the residency
    axis; the default (``num_layers``) matches the balanced per-layer
    placement the N-bank MoE needs.
    """

    def __init__(self, cfg: ModelConfig,
                 hw: HardwareModel = HardwareModel(), *,
                 batch_size: int = 1, seed: int = 0,
                 residency_step: Optional[int] = None,
                 max_enum_points: int = 8192,
                 profile=None, ep: int = 1):
        if cfg.moe is None:
            raise ValueError(f"{cfg.arch_id}: the MoP frontier needs routed "
                             "experts (DESIGN.md §5)")
        ep = int(ep)
        if ep < 1:
            raise ValueError(f"ep must be >= 1, got {ep}")
        if ep > 1 and cfg.moe.num_experts % ep:
            raise ValueError(
                f"{cfg.arch_id}: {cfg.moe.num_experts} experts do not "
                f"split over ep={ep} devices (num_experts %% ep must be "
                "0 — pick an ep dividing the expert count)")
        self.cfg = cfg
        self.hw = hw
        self.batch_size = batch_size
        self.seed = seed
        self.residency_step = residency_step
        self.max_enum_points = max_enum_points
        #: EP shard count (DESIGN.md §16). ep=1 reproduces the
        #: single-device enumeration bit-for-bit (golden-fixture
        #: pinned); ep>1 rounds per-rung count levels to multiples of
        #: ep (bank shards must split evenly) and splits each residency
        #: level into a local slice (this device's HBM, budget-checked)
        #: and a PEER remainder priced at interconnect bandwidth.
        self.ep = ep
        #: optional SensitivityProfile (DESIGN.md §15): re-prices every
        #: enumerated plan's quality_proxy with the traffic-weighted
        #: per-expert objective, re-ranking the dominant set. None (or a
        #: uniform profile) keeps the legacy flat pricing bit-for-bit.
        self.profile = profile
        self.ladder = validate_ladder(cfg.mop.precision_ladder)
        layers = cfg.num_layers
        e = cfg.moe.num_experts
        total = layers * e
        step = residency_step or layers
        res_levels = sorted({*range(0, total, step), total})
        count_grids = self._count_grids(e, len(res_levels), max_enum_points)
        #: per-rung per-layer count levels actually enumerated (ascending
        #: rung order) — exposes the §11 pruning decision for inspection.
        self.count_levels: Dict[int, List[int]] = count_grids
        pts: List[FrontierPoint] = []
        for combo in self._count_combos(e, count_grids):
            counts = {b: c * layers
                      for b, c in zip(sorted(count_grids), combo)}
            nq = sum(counts.values())
            for r in res_levels:
                # EP residency split (DESIGN.md §16): a level of r
                # accelerator-resident experts shards ~evenly over ep
                # devices; this device holds ceil(r/ep) locally (the
                # max across ranks — conservative for the budget
                # check), the rest are PEER. ep=1: local=r, peer=0 —
                # the historical plan bit-for-bit.
                local = -(-r // ep) if r else 0
                peer = r - local
                plan = balanced_ladder_plan(
                    layers, e, counts, ladder=self.ladder,
                    group_size=cfg.mop.group_size,
                    seed=seed, resident_experts=local,
                    peer_experts=peer)
                qos = cost_model.estimate_qos(cfg, plan, hw, batch_size,
                                              profile)
                per_rung = tuple(total - nq if b >= 16 else counts[b]
                                 for b in self.ladder)
                pts.append(FrontierPoint(num_q_experts=nq,
                                         resident_experts=r,
                                         plan=plan, qos=qos,
                                         counts_per_rung=per_rung,
                                         peer_experts=peer))
        #: the full enumeration (kept for sweeps/plots); dominated points
        #: included.
        self.all_points: List[FrontierPoint] = pts
        #: the dominant set, ascending in predicted tokens/s — "adjacent"
        #: for the QoSController means neighbouring indices in this list.
        self.points: List[FrontierPoint] = sorted(
            self._prune(pts),
            key=lambda p: (p.qos.tokens_per_s, p.qos.quality_proxy,
                           p.qos.device_bytes, p.num_q_experts,
                           p.resident_experts))

    def _count_grids(self, e: int, n_res: int, max_enum_points: int
                     ) -> Dict[int, List[int]]:
        """Per-layer count levels per quantized rung (§11 pruning rule).

        One rung (binary ladder): the full 0..E axis — the legacy
        enumeration, never pruned. K >= 2 rungs: a uniform stride grid
        per rung, levels chosen as the largest count whose K-fold product
        times the residency levels stays under ``max_enum_points`` (the
        count-combo constraint ``sum <= E`` only shrinks it further);
        0 and E are always included.

        Under EP (DESIGN.md §16) every level must be a multiple of
        ``self.ep`` — mixed_moe shards each rung bank contiguously over
        the EP axis, so per-layer bank sizes that do not split evenly
        cannot dispatch. ep=1 keeps every grid unchanged."""
        qr = quantized_rungs(self.ladder)
        ep = self.ep
        if len(qr) == 1:
            return {qr[0]: list(range(0, e + 1, ep))}
        budget = max(max_enum_points // max(n_res, 1), 1)
        per_rung = max(2, int(budget ** (1.0 / len(qr))))
        if per_rung >= e + 1:
            levels = list(range(e + 1))
        else:
            stride = -(-e // (per_rung - 1))        # ceil
            levels = sorted({*range(0, e + 1, stride), e})
        if ep > 1:
            levels = sorted({lv - lv % ep for lv in levels} | {e})
        return {b: list(levels) for b in qr}

    @staticmethod
    def _count_combos(e: int, grids: Dict[int, List[int]]):
        """Jointly-feasible per-layer count vectors (sum <= E), iterated
        lexicographically in ascending-rung order — the binary ladder
        yields the legacy ascending-Num_E4 sequence."""
        rungs = sorted(grids)
        for combo in itertools.product(*(grids[b] for b in rungs)):
            if sum(combo) <= e:
                yield combo

    @staticmethod
    def _prune(pts: Sequence[FrontierPoint]) -> List[FrontierPoint]:
        out: List[FrontierPoint] = []
        for p in pts:
            if any(_dominates(q, p) for q in pts):
                continue
            # drop exact QoS duplicates (balanced rounding maps nearby
            # knob values to one plan) deterministically: keep the first
            # in (nq, resident) order.
            key = (p.qos.tokens_per_s, p.qos.quality_proxy,
                   p.qos.device_bytes)
            if any((q.qos.tokens_per_s, q.qos.quality_proxy,
                    q.qos.device_bytes) == key for q in out):
                continue
            out.append(p)
        return out

    def overlap_variant(self, efficiency: float) -> "ParetoFrontier":
        """Re-enumerate and re-rank THIS frontier's configuration space
        under the overlap-aware token time (DESIGN.md §12): identical
        axes/plans, the hardware model's ``overlap_efficiency`` replaced.
        Transfer-dominated points whose transfers hide under compute gain
        tokens/s, so membership of the dominant set can flip — points
        dominated under the additive model may become dominant (tested).
        ``efficiency=0.0`` returns a frontier bit-identical to the
        additive ranking."""
        hw = dataclasses.replace(self.hw,
                                 overlap_efficiency=float(efficiency))
        return ParetoFrontier(self.cfg, hw, batch_size=self.batch_size,
                              seed=self.seed,
                              residency_step=self.residency_step,
                              max_enum_points=self.max_enum_points,
                              profile=self.profile, ep=self.ep)

    def spec_variant(self, k: int, acceptance: float) -> "ParetoFrontier":
        """Re-enumerate and re-rank under the speculative token time
        (DESIGN.md §17): identical axes/plans, the hardware model's
        ``spec_k`` / ``spec_acceptance`` replaced. Every point's cycle
        becomes ``k * t_draft + t_token`` emitting ``(1 - a^(k+1)) /
        (1 - a)`` expected tokens, with ``t_draft`` the compute-only
        all-lowest-rung time — so plans whose serving rungs are far
        above the draft rung gain the most and the ranking can flip.
        ``acceptance`` should be a MEASURED rate (the engine's
        ``acceptance_rate`` metric feeding back through the
        QoSController). ``k=0`` returns a frontier bit-identical to the
        plain-decode ranking."""
        hw = dataclasses.replace(self.hw, spec_k=int(k),
                                 spec_acceptance=float(acceptance))
        return ParetoFrontier(self.cfg, hw, batch_size=self.batch_size,
                              seed=self.seed,
                              residency_step=self.residency_step,
                              max_enum_points=self.max_enum_points,
                              profile=self.profile, ep=self.ep)

    def profile_variant(self, profile) -> "ParetoFrontier":
        """Re-enumerate and re-rank under a (new) sensitivity profile
        (DESIGN.md §15): identical axes/plans, only the quality pricing
        changes. ``profile=None`` (or a uniform profile) returns a
        frontier bit-identical to the legacy flat-cost ranking."""
        return ParetoFrontier(self.cfg, self.hw,
                              batch_size=self.batch_size, seed=self.seed,
                              residency_step=self.residency_step,
                              max_enum_points=self.max_enum_points,
                              profile=profile, ep=self.ep)

    # -- queries -----------------------------------------------------------
    def feasible(self, target: QoSTarget) -> List[FrontierPoint]:
        """Frontier points satisfying the target's hard constraints,
        ascending in predicted tokens/s."""
        return [p for p in self.points if p.feasible_under(target)]

    def select(self, target: QoSTarget) -> FrontierPoint:
        """Resolve a declarative target to one frontier point.

        Among feasible points meeting ``min_tokens_per_s``: prefer quality
        (lowest quality_proxy), then the lowest device footprint — the
        deterministic tie-break of DESIGN.md §9. When no feasible point
        meets the throughput objective, fall back to the fastest feasible
        point (best effort — the controller keeps chasing from there).
        Raises :class:`InfeasibleTarget` when the hard constraints admit
        no point at all (e.g. budget below the non-expert floor).
        """
        cand = self.feasible(target)
        if not cand:
            floor = min(p.qos.device_bytes for p in self.points)
            raise InfeasibleTarget(
                f"no MoP configuration satisfies [{target.describe()}]: "
                f"smallest feasible footprint is {_fmt_bytes(floor)}")
        meeting = [p for p in cand
                   if target.min_tokens_per_s is None
                   or p.qos.tokens_per_s >= target.min_tokens_per_s]
        if meeting:
            return min(meeting, key=lambda p: (
                p.qos.quality_proxy, p.qos.device_bytes,
                -p.qos.tokens_per_s, p.num_q_experts, p.resident_experts))
        return min(cand, key=lambda p: (
            -p.qos.tokens_per_s, p.qos.quality_proxy, p.qos.device_bytes,
            p.num_q_experts, p.resident_experts))

    def neighbors(self, point: FrontierPoint, target: QoSTarget
                  ) -> tuple:
        """(slower, faster) adjacent feasible points (None at the ends) —
        the QoSController's walk steps."""
        feas = self.feasible(target)
        try:
            i = feas.index(point)
        except ValueError:
            return None, None
        slower = feas[i - 1] if i > 0 else None
        faster = feas[i + 1] if i + 1 < len(feas) else None
        return slower, faster

    def records(self) -> List[Dict]:
        """Bit-exact serialization of the dominant set, in frontier
        order — the golden-regression fixture format
        (tests/fixtures/, DESIGN.md §10.4). Floats are serialized as
        ``float.hex()`` so equality is BITWISE (a silent cost-model
        drift of one ulp fails the fixture), and each point carries a
        digest of its concrete plan arrays (quant + location + format),
        so precision/placement changes are caught even when the QoS
        estimate happens to coincide."""
        binary = len(quantized_rungs(self.ladder)) == 1
        out = []
        for p in self.points:
            h = hashlib.sha256()
            h.update(p.plan.quant.tobytes())
            h.update(p.plan.location.tobytes())
            if binary:
                # historical digest: the boolean mask + the scalar rung —
                # byte-identical to the pre-ladder fixture format.
                h.update(f"{p.plan.q_bits}:{p.plan.group_size}"
                         f":{p.plan.seed}".encode())
            else:
                h.update(p.plan.bits.tobytes())
                h.update(f"{p.plan.ladder}:{p.plan.group_size}"
                         f":{p.plan.seed}".encode())
            rec = {
                "num_q_experts": int(p.num_q_experts),
                "resident_experts": int(p.resident_experts),
                "tokens_per_s": float(p.qos.tokens_per_s).hex(),
                "quality_proxy": float(p.qos.quality_proxy).hex(),
                "device_bytes": int(p.qos.device_bytes),
                "plan_sha256": h.hexdigest(),
            }
            if not binary:
                rec["counts_per_rung"] = [int(c) for c in p.counts_per_rung]
                rec["ladder"] = list(self.ladder)
            if self.ep > 1:
                # EP-only keys (DESIGN.md §16): ep=1 records stay
                # byte-identical to the checked-in golden fixture.
                rec["ep"] = self.ep
                rec["peer_experts"] = int(p.peer_experts)
            out.append(rec)
        return out

    def best_per_quality_level(self, mem_budget_bytes: float
                               ) -> List[FrontierPoint]:
        """For each Num_E4 level, the max-residency point fitting the
        budget — the paper's Fig. 2/3 sweep axis (used by
        ``AdaptivePlanner.sweep`` and ``examples/pareto_explorer.py``)."""
        best = {}
        for p in self.all_points:
            if p.qos.device_bytes > mem_budget_bytes:
                continue
            cur = best.get(p.num_q_experts)
            if cur is None or p.resident_experts > cur.resident_experts:
                best[p.num_q_experts] = p
        return [best[k] for k in sorted(best)]
