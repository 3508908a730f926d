"""Per-expert precision & placement table (the paper's Fig. 1 state),
generalized to a PRECISION LADDER (DESIGN.md §11).

The paper keeps, for every expert, two attributes:
  * precision — originally boolean (4-bit vs 16-bit); here an explicit
    per-expert bit-width drawn from a declared *ladder* (descending tuple
    of rungs, default ``(16, 4)``; extended deployments use ``(16, 8, 4)``
    — MxMoE-style per-expert mixed precision as a serving knob);
  * location — on accelerator vs host.

Assignment of the precision attribute is random — the paper argues MoE
experts have uniform access frequency, so the choice of *which* experts
land on a rung does not matter. We use **balanced-random** (same per-rung
count per layer, random within a layer) so a scanned layer stack keeps
static bank shapes.

Backward compatibility is part of the API contract: with the binary
ladder ``(16, 4)`` every plan is bit-identical to the historical boolean
encoding — ``quant``/``num_q_experts``/``bank_sizes()`` survive as
derived views over ``bits == 4`` and the rng consumption of
:func:`balanced_ladder_plan` exactly reproduces the legacy
:func:`balanced_random_plan` stream (tests/test_ladder.py pins this
against the checked-in frontier golden fixture).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

#: placement tiers (DESIGN.md §16): LOCAL accelerator HBM, host DRAM
#: behind the PCIe link, or a PEER device's HBM reached via the EP
#: all2all at inter-device bandwidth. Single-device plans never contain
#: PEER, so the historical two-tier encoding is preserved byte-for-byte.
DEVICE, HOST, PEER = 0, 1, 2

#: rungs the quantization substrate implements (DESIGN.md §2): packed
#: int4 / int8 group-wise symmetric, plus the bf16 identity rung.
SUPPORTED_RUNGS = (4, 8, 16)
DEFAULT_LADDER = (16, 4)


def validate_ladder(ladder: Sequence[int]) -> Tuple[int, ...]:
    """A ladder is a strictly DESCENDING tuple of supported rungs that
    contains the 16-bit rung (non-expert weights and the f16 bank are
    bf16; an all-quantized plan is expressed through the counts, not by
    removing the rung)."""
    lad = tuple(int(b) for b in ladder)
    if len(lad) < 2:
        raise ValueError(f"ladder needs >= 2 rungs, got {lad}")
    if any(b not in SUPPORTED_RUNGS for b in lad):
        raise ValueError(f"ladder {lad}: rungs must be in {SUPPORTED_RUNGS}")
    if list(lad) != sorted(set(lad), reverse=True):
        raise ValueError(f"ladder {lad} must be strictly descending")
    if lad[0] != 16:
        raise ValueError(f"ladder {lad} must contain the 16-bit rung")
    return lad


def quantized_rungs(ladder: Sequence[int]) -> Tuple[int, ...]:
    """The ladder's sub-16-bit rungs, ascending (cheapest first — the
    bank order and the residency-priority order)."""
    return tuple(sorted(b for b in ladder if b < 16))


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """``bits[L, E]``: per-expert bit-width (a ladder rung).
    ``location[L, E]``: DEVICE or HOST."""
    bits: np.ndarray
    location: np.ndarray
    ladder: Tuple[int, ...] = DEFAULT_LADDER
    group_size: int = 64
    seed: int = 0

    @property
    def num_layers(self) -> int:
        return self.bits.shape[0]

    @property
    def num_experts(self) -> int:
        return self.bits.shape[1]

    # -- legacy boolean views (binary-ladder compatible) -------------------
    @property
    def quant(self) -> np.ndarray:
        """[L, E] bool: True = quantized (any sub-16-bit rung). With the
        binary ladder this IS the historical ``quant`` array bit-for-bit."""
        return self.bits < 16

    @property
    def num_q_experts(self) -> int:
        """Global count of quantized experts (the paper's Num_E4 for the
        binary ladder)."""
        return int((self.bits < 16).sum())

    @property
    def num_q_per_layer(self) -> int:
        return int((self.bits[0] < 16).sum())

    @property
    def q_bits(self) -> int:
        """The single quantized rung of a binary ladder (legacy scalar
        ``plan.bits``); raises on multi-rung ladders — callers that can
        see those must consult ``bits[l, e]`` per expert."""
        rungs = quantized_rungs(self.ladder)
        if len(rungs) != 1:
            raise ValueError(
                f"plan has a multi-rung ladder {self.ladder}; per-expert "
                "bit-widths live in plan.bits[l, e]")
        return rungs[0]

    # -- rung-indexed views -------------------------------------------------
    def rung_counts(self) -> Dict[int, int]:
        """{rung: global expert count} over the full ladder."""
        return {b: int((self.bits == b).sum()) for b in self.ladder}

    def rung_counts_per_layer(self) -> Dict[int, int]:
        """{rung: per-layer count} (equal across layers by construction)."""
        return {b: int((self.bits[0] == b).sum()) for b in self.ladder}

    def resident_fraction(self) -> float:
        return float((self.location == DEVICE).mean())

    def peer_fraction(self) -> float:
        """Fraction of experts resident on PEER devices (EP shards
        reached via all2all — DESIGN.md §16). 0.0 for single-device
        plans."""
        return float((self.location == PEER).mean())

    def placement_counts(self) -> Dict[str, int]:
        """{tier name: expert count} over the three placement tiers."""
        return {"device": int((self.location == DEVICE).sum()),
                "peer": int((self.location == PEER).sum()),
                "host": int((self.location == HOST).sum())}

    def device_assignment(self, ep: int) -> np.ndarray:
        """[L, E] owning EP rank of every expert under ``ep``-way expert
        parallelism — derived, not stored: mixed_moe shards each rung
        bank contiguously over the EP axis (``_local_slot``: within bank
        b of per-layer total tot_b, rank r owns bank slots
        [r*tot_b/ep, (r+1)*tot_b/ep)), so the assignment is a pure
        function of (bits, ep). Raises when a bank does not split
        evenly — the same constraint ``moe_apply`` enforces at dispatch
        time (the planner rounds per-layer counts to multiples of ep)."""
        ep = int(ep)
        if ep < 1:
            raise ValueError(f"ep must be >= 1, got {ep}")
        sizes = self.bank_sizes()
        if any(tot % ep for tot in sizes):
            raise ValueError(
                f"EP banks must split evenly: per-layer bank sizes "
                f"{sizes} over {ep} shards (planner rounds per-layer "
                "counts)")
        ranks = np.empty(self.bits.shape, dtype=np.int32)
        order = self.expert_order()
        for l in range(self.num_layers):
            slot_rank = np.concatenate([
                np.repeat(np.arange(ep, dtype=np.int32), tot // ep)
                for tot in sizes if tot])
            ranks[l, order[l]] = slot_rank
        return ranks

    def bank_sizes(self) -> Tuple[int, ...]:
        """Per-layer bank sizes in ASCENDING-bits bank order — static
        shapes for the N-bank MoE. Binary ladder: ``(E4, E16)``."""
        row = self.bits[0]
        return tuple(int((row == b).sum()) for b in sorted(self.ladder))

    def expert_order(self) -> np.ndarray:
        """[L, E] permutation: lowest-precision experts first, ascending
        through the ladder (binary: 4-bit first, then 16-bit — unchanged).

        The N-bank MoE stores experts in this order; the router output is
        permuted accordingly so routing semantics are unchanged."""
        order = np.empty(self.bits.shape, dtype=np.int32)
        rungs = sorted(self.ladder)
        for l in range(self.num_layers):
            order[l] = np.concatenate(
                [np.where(self.bits[l] == b)[0] for b in rungs])
        return order


def _normalize_counts(counts: Mapping[int, int],
                      ladder: Tuple[int, ...]) -> Dict[int, int]:
    """Counts for the QUANTIZED rungs only; unknown rungs rejected."""
    out = {}
    qr = quantized_rungs(ladder)
    for b, c in counts.items():
        b = int(b)
        if b >= 16:
            continue                     # 16 is the remainder, never counted
        if b not in qr:
            raise ValueError(f"count for rung {b} not in ladder {ladder}")
        out[b] = int(c)
    return {b: out.get(b, 0) for b in qr}


def balanced_ladder_plan(num_layers: int, num_experts: int,
                         counts: Mapping[int, int], *,
                         ladder: Sequence[int] = DEFAULT_LADDER,
                         group_size: int = 64, seed: int = 0,
                         resident_experts: Optional[int] = None,
                         peer_experts: int = 0
                         ) -> PrecisionPlan:
    """Paper §3 assignment generalized to the ladder, balanced per layer.

    ``counts`` maps each quantized rung to its GLOBAL expert count (each
    in [0, L*E], jointly at most L*E); every layer gets
    ``round(count / L)`` experts of that rung (clipped so a balanced
    split exists), assigned from ONE random permutation per layer —
    lowest rung takes the first slice, and so on ascending; the
    remainder stays 16-bit. With the binary ladder this consumes the rng
    exactly like the legacy boolean assignment (bit-identical plans).

    ``resident_experts`` (global count) fills the location attribute with
    the paper's priority rule generalized to the ladder: cheapest rung
    first (lower bits = cheaper to keep resident -> higher hit rate),
    round-robin over layers so every layer keeps a similar hit rate.

    ``peer_experts`` (global count, EP deployments — DESIGN.md §16)
    extends the same priority order past the local-resident slice: the
    next ``peer_experts`` entries land on PEER devices (accelerator HBM
    reached via all2all) before the remainder falls to HOST. The rng
    stream is untouched (the priority order is built either way), so
    ``peer_experts=0`` plans are bit-identical to the historical
    two-tier encoding.
    """
    lad = validate_ladder(ladder)
    qr = quantized_rungs(lad)
    counts = _normalize_counts(counts, lad)
    total = num_layers * num_experts
    gsum = sum(counts.values())
    if any(c < 0 for c in counts.values()) or gsum > total:
        raise ValueError(f"counts {counts} not in [0,{total}] jointly")
    rng = np.random.default_rng(seed)
    per_layer: Dict[int, int] = {}
    room = num_experts
    for b in qr:
        c = int(round(counts[b] / num_layers))
        c = min(c, room)
        per_layer[b] = c
        room -= c
    bits = np.full((num_layers, num_experts), 16, dtype=np.int16)
    for l in range(num_layers):
        perm = rng.permutation(num_experts)
        off = 0
        for b in qr:
            bits[l, perm[off:off + per_layer[b]]] = b
            off += per_layer[b]

    location = np.full((num_layers, num_experts), DEVICE, dtype=np.int8)
    if peer_experts and resident_experts is None:
        raise ValueError("peer_experts needs an explicit resident_experts "
                         "count (the priority order assigns LOCAL first)")
    if resident_experts is not None:
        resident_experts = int(np.clip(resident_experts, 0, total))
        peer_experts = int(np.clip(peer_experts, 0,
                                   total - resident_experts))
        location[:] = HOST
        # priority: cheapest rung first (paper §3 generalized), round-robin
        # over layers so every layer keeps a similar hit rate.
        order: List[Tuple[int, int]] = []
        for phase in (*qr, 16):
            cols: List[List[Tuple[int, int]]] = []
            for l in range(num_layers):
                es = [(l, e) for e in np.where(bits[l] == phase)[0]]
                rng.shuffle(es)
                cols.append(es)
            for i in range(max((len(c) for c in cols), default=0)):
                for c in cols:
                    if i < len(c):
                        order.append(c[i])
        for (l, e) in order[:resident_experts]:
            location[l, e] = DEVICE
        for (l, e) in order[resident_experts:resident_experts
                            + peer_experts]:
            location[l, e] = PEER
    return PrecisionPlan(bits=bits, location=location, ladder=lad,
                         group_size=group_size, seed=seed)


def balanced_random_plan(num_layers: int, num_experts: int,
                         num_q_experts: int, *, bits: int = 4,
                         group_size: int = 64, seed: int = 0,
                         resident_experts: Optional[int] = None
                         ) -> PrecisionPlan:
    """Legacy binary spelling: ``num_q_experts`` experts at the single
    quantized rung ``bits``, the rest 16-bit (paper §3). Thin wrapper
    over :func:`balanced_ladder_plan` with the ladder ``(16, bits)`` —
    plans are bit-identical to the pre-ladder encoding."""
    total = num_layers * num_experts
    if not 0 <= num_q_experts <= total:
        raise ValueError(f"num_q_experts {num_q_experts} not in [0,{total}]")
    return balanced_ladder_plan(
        num_layers, num_experts, {bits: num_q_experts},
        ladder=(16, int(bits)), group_size=group_size, seed=seed,
        resident_experts=resident_experts)


def reconfig_delta(old: PrecisionPlan, new: PrecisionPlan):
    """Minimal reconfiguration ops between two plans (paper §3: partial
    reconfiguration instead of a full reload).

    Returns dict with index arrays of experts to (re)quantize (bit-width
    DROPS, incl. 8->4 demotions), dequantize/promote (bit-width RISES,
    incl. 4->8 promotions), upload (host->accelerator: DEVICE or PEER),
    evict (accelerator->host) and rebalance (DEVICE<->PEER moves — the
    expert stays in accelerator HBM and travels over the interconnect,
    never the host link; single-device plans never produce any)."""
    if old.bits.shape != new.bits.shape:
        raise ValueError("plans must describe the same model")
    old_acc = old.location != HOST
    new_acc = new.location != HOST
    return {
        "to_quantize": np.argwhere(old.bits > new.bits),
        "to_dequantize": np.argwhere(old.bits < new.bits),
        "to_upload": np.argwhere(~old_acc & new_acc),
        "to_evict": np.argwhere(old_acc & ~new_acc),
        "to_rebalance": np.argwhere(old_acc & new_acc
                                    & (old.location != new.location)),
    }


def migrated_expert_keys(delta, new: PrecisionPlan) -> List[Tuple[int, int]]:
    """The (layer, expert) set a PARTIAL reconfiguration actually touches
    with host<->device traffic: uploads plus format flips (any rung
    change) of device-resident experts — each expert counted ONCE even
    when it both moves and flips format. Everything else stays in place
    (the paper's partial-reconfiguration claim; the multi-tenant
    migration report asserts against exactly this set, DESIGN.md §10.3)."""
    keys = {(int(l), int(e)) for (l, e) in delta["to_upload"]}
    for field in ("to_quantize", "to_dequantize"):
        for (l, e) in delta[field]:
            if new.location[l, e] != HOST:
                keys.add((int(l), int(e)))
    return sorted(keys)


def delta_cost_bytes(delta, expert_bytes, new: PrecisionPlan):
    """Host->device traffic a reconfig needs (downtime estimator): each
    migrated expert streams once, in its NEW format.

    ``expert_bytes`` maps a rung (bit-width) to one expert's byte size —
    usually ``cfg.expert_param_bytes``."""
    up = 0
    for (l, e) in migrated_expert_keys(delta, new):
        up += expert_bytes(int(new.bits[l, e]))
    return int(up)
