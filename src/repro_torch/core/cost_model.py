"""Analytic throughput/quality model behind the planner (paper Fig. 3),
rung-indexed over the precision ladder (DESIGN.md §11).

Token-generation time for an offloading MoE server decomposes as

    t_token = t_compute + max(0, t_transfer - overlap_window)
    overlap_window = overlap_efficiency * t_compute

with ``t_transfer = E[misses per token] * t_expert_transfer``,
``E[misses] = L * top_k * (1 - hit_rate)`` under the paper's
uniform-expert-access assumption, where the hit rate equals the fraction of
(access-weighted) experts resident on the accelerator.
``overlap_efficiency`` models the async transfer pipeline (DESIGN.md §12):
the fraction of the compute window under which transfers hide. At the
default ``0.0`` the expression collapses BIT-FOR-BIT to the paper's serial
additive model ``t_compute + t_transfer`` (the frontier golden fixture
pins this); a calibrated ``> 0`` value re-ranks transfer-dominated
configurations, whose exposed transfer shrinks. In the all-resident
region the model reproduces Fig. 3's plateau (max throughput, slight 4-bit
matmul penalty, which a fused dequant kernel can turn into a gain); in
the offloading region throughput decays hyperbolically with the miss
volume, as in the paper.

Every term is a sum over the plan's ladder rungs: per-rung byte sizes,
per-rung decode speedups (int4 and int8 read 4x/2x fewer HBM bytes) and a
per-rung quality cost. The binary ladder reproduces the historical
two-term expressions bit-for-bit (the frontier golden fixture pins this).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision_plan import (DEVICE, HOST, PEER,
                                             PrecisionPlan, quantized_rungs)

#: perplexity-multiplier cost per fully-quantized model at each rung,
#: calibrated on the paper's Table 1 (all-4-bit ~= +7% ppl on WikiText2)
#: and the int8 rows (~+2%); 16-bit costs nothing by definition.
RUNG_QUALITY_COST: Dict[int, float] = {4: 0.07, 8: 0.02, 16: 0.0}


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Defaults: one NVIDIA H100 SXM (80 GB) from NVIDIA's data sheet —
    989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB — plus a host link whose
    default is a model input (the serving engine measures it on the card
    when no hardware model is given)."""
    peak_flops: float = 989e12          # bf16 FLOP/s, dense
    hbm_bw: float = 3.35e12             # B/s
    host_link_bw: float = 24e9          # B/s effective host->HBM
    hbm_bytes: float = 80e9
    # Serving decode is memory-bound; effective MBU for weight streaming.
    mbu: float = 0.6
    mfu: float = 0.4
    # Quantized matmul throughput relative to bf16, per rung. These are
    # model inputs that nobody has measured on this card yet: a dequant
    # kernel reads bits/16 of the weight bytes, so in the memory-bound
    # decode regime a fast kernel could beat bf16 by up to 16/bits.
    q4_speedup_decode: float = 2.8
    q4_speedup_prefill: float = 0.95
    q8_speedup_decode: float = 1.6
    q8_speedup_prefill: float = 0.98
    # Async transfer pipeline (DESIGN.md §12): fraction of t_compute
    # usable as the overlap window that hides expert transfers. 0.0 =
    # serial staging — the paper's additive token time, bit-for-bit
    # (golden-fixture pinned). The engine calibrates a measured value via
    # AdaptiveServingEngine.calibrate_overlap().
    overlap_efficiency: float = 0.0
    # Per-kernel dispatch overhead of the expert FFN (DESIGN.md §13).
    # 0.0 (default) keeps the historical model bit-for-bit (golden-fixture
    # pinned). With a calibrated value, grouped_ffn=True charges one
    # launch per ladder rung PRESENT per layer (the grouped multi-expert
    # kernel), grouped_ffn=False one per resident expert (the per-expert
    # loop) — the term the grouped kernel collapses from E_resident to
    # n_rungs.
    kernel_launch_s: float = 0.0
    grouped_ffn: bool = True
    # EP peer tier (DESIGN.md §16). Experts on PEER devices stay in
    # accelerator HBM; only the token ACTIVATIONS travel (all2all), so
    # the peer tier is charged activation bytes at the inter-device
    # bandwidth plus a per-sharded-layer all2all launch latency — never
    # weight streaming. Both terms multiply by the plan's peer
    # occupancy, so any plan without PEER experts (every single-device
    # plan, every ep=1 frontier) contributes exactly +0.0 and the
    # historical model — and the frontier golden fixture — is untouched
    # bit-for-bit, regardless of these defaults. Defaults: NVLink 4 at
    # 450 GB/s each way (H100 data sheet) + a few-microsecond collective
    # launch.
    interconnect_bw: float = 450e9
    all2all_latency_s: float = 2e-6
    # Ladder-draft self-speculative decoding (DESIGN.md §17). ``spec_k``
    # draft tokens per cycle run with EVERY expert forced to the lowest
    # ladder rung (banks already resident — zero extra weight bytes,
    # zero host transfers), then one verify forward at the serving plan
    # scores all k+1 positions. Expected emitted tokens per cycle is the
    # geometric partial sum (1 - a^(k+1)) / (1 - a) at acceptance rate
    # ``a`` — the ``t_token / (1 + E[accepted])`` pricing. ``spec_k=0``
    # (default) prices plain decode bit-for-bit (golden-fixture pinned);
    # ``spec_acceptance`` comes from measurement (the engine's
    # ``acceptance_rate`` metric), not from an analytic guess.
    spec_k: int = 0
    spec_acceptance: float = 0.0

    def q_speedup_decode(self, bits: int) -> float:
        """Decode-regime matmul speedup of rung ``bits`` vs bf16."""
        if bits >= 16:
            return 1.0
        return {4: self.q4_speedup_decode, 8: self.q8_speedup_decode}[bits]


@dataclasses.dataclass(frozen=True)
class QoSEstimate:
    tokens_per_s: float
    t_compute_ms: float
    t_transfer_ms: float    # TOTAL transfer time (demand volume / link bw)
    hit_rate: float
    device_bytes: int
    quality_proxy: float    # predicted perplexity multiplier vs all-16bit
    #: transfer time left EXPOSED on the token critical path after the
    #: overlap window (== t_transfer_ms when overlap_efficiency is 0).
    t_exposed_ms: float = 0.0
    #: all2all time for PEER-resident expert accesses (activation bytes
    #: over the inter-device link + per-sharded-layer collective
    #: latency — DESIGN.md §16). Exactly 0.0 when the plan has no PEER
    #: experts (every single-device plan).
    t_peer_ms: float = 0.0
    #: speculative decode (DESIGN.md §17): compute-only token time of the
    #: all-lowest-rung draft pass, and expected emitted tokens per
    #: draft+verify cycle. ``spec_k=0``: 0.0 / 1.0 (plain decode).
    t_draft_ms: float = 0.0
    spec_tokens_per_cycle: float = 1.0


def expert_access_stats(cfg: ModelConfig, plan: PrecisionPlan
                        ) -> Tuple[float, float]:
    """(hit_rate, expected transfer bytes per token)."""
    e = cfg.moe
    assert e is not None
    ne = plan.bits.shape[1]
    # a "hit" is any access that does NOT stream over the host link:
    # LOCAL- and PEER-resident experts both live in accelerator HBM
    # (PEER costs all2all activation bytes instead — peer_access_stats).
    # Single-device plans have no PEER experts, so this is the
    # historical ``location == DEVICE`` mask bit-for-bit.
    on_dev = plan.location != HOST
    # uniform routing: each of top_k accesses per layer hits a uniformly
    # random expert
    hit = float(on_dev.mean())
    # exact rational accumulation: every off-device expert contributes
    # size/ne; summing the integer numerators first and dividing once is
    # the correctly-rounded value of the rational sum, which coincides
    # with the historical per-element float loop whenever the per-expert
    # terms are exactly representable (ne a power of two — every config
    # the golden fixture pins), while running as a few numpy reductions
    # instead of an O(L*E) Python loop per enumerated frontier point.
    off = ~on_dev
    numerator = 0
    for b in plan.ladder:
        numerator += int((off & (plan.bits == b)).sum()) \
            * cfg.expert_param_bytes(b)
    miss_bytes = numerator / ne
    # per token: top_k accesses per layer
    per_token = miss_bytes * e.top_k
    return hit, per_token


def peer_access_stats(cfg: ModelConfig, plan: PrecisionPlan
                      ) -> Tuple[float, float, int]:
    """(peer_fraction, all2all activation bytes per token, # layers with
    any PEER expert) — the EP peer tier's demand volume (DESIGN.md §16).

    A PEER access ships the token activation to the owning device and
    the weighted expert output back: ``2 * d_model`` elements at the
    activation itemsize, per routed access, scaled by the layer's peer
    occupancy under uniform routing. Integer-numerator accumulation
    mirrors :func:`expert_access_stats` (exactly-rounded rational sum).
    All three results are exactly zero for plans without PEER experts.
    """
    e = cfg.moe
    assert e is not None
    ne = plan.bits.shape[1]
    on_peer = plan.location == PEER
    itemsize = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    per_access = 2 * cfg.d_model * itemsize
    numerator = int(on_peer.sum()) * per_access * e.top_k
    peer_layers = int(on_peer.any(axis=1).sum())
    return float(on_peer.mean()), numerator / ne, peer_layers


def device_bytes(cfg: ModelConfig, plan: PrecisionPlan) -> int:
    """LOCAL HBM footprint of the plan (non-expert 16-bit + DEVICE-
    resident experts, each at its own rung's size). PEER experts consume
    a peer device's HBM, not this one's — the per-device budget is what
    frontier feasibility checks against, which is exactly why EP widens
    the residency axis (DESIGN.md §16)."""
    on_dev = plan.location == DEVICE
    total = cfg.non_expert_bytes()
    for b in sorted(plan.ladder):
        total += int((on_dev & (plan.bits == b)).sum()) \
            * cfg.expert_param_bytes(b)
    return total


def quality_proxy(cfg: ModelConfig, plan: PrecisionPlan,
                  profile=None) -> float:
    """Monotone perplexity-ratio proxy, calibrated on the paper's Table 1
    (all experts 4-bit ~= +7% ppl, 2.62->2.80 WikiText2; int8 ~= +2%);
    linear per rung in the rung's expert fraction (Fig. 2 is ~linear with
    noise), summed over the ladder's quantized rungs ascending.

    With a calibrated :class:`~repro.core.sensitivity.SensitivityProfile`
    the flat per-rung price becomes the traffic-weighted per-expert sum
    ``1 + sum freq[l,e] * sens[l,e,bits]`` (DESIGN.md §15). A ``None`` or
    *uniform* profile executes the historical code path verbatim — the
    frontier golden fixture pins this bit-for-bit."""
    if profile is not None and not profile.is_uniform():
        return 1.0 + profile.quality_cost(plan)
    proxy = 1.0
    for b in quantized_rungs(plan.ladder):
        frac = float((plan.bits == b).mean())
        proxy += RUNG_QUALITY_COST[b] * frac
    return proxy


def ffn_kernel_launches(plan: PrecisionPlan, grouped: bool = True) -> int:
    """Expert-FFN kernel dispatches per decode token. Grouped (DESIGN.md
    §13): one launch per ladder rung present in each layer's bank, so the
    count is bounded by L x n_rungs regardless of expert count. Looped:
    one per device-resident expert (the legacy vmap spelling)."""
    if not grouped:
        return int((plan.location == DEVICE).sum())
    launches = 0
    for b in plan.ladder:
        launches += int((plan.bits == b).any(axis=1).sum())
    return launches


def speculative_tokens_per_cycle(k: int, acceptance: float) -> float:
    """Expected tokens emitted per draft+verify cycle (DESIGN.md §17).

    Under the i.i.d.-acceptance model (each draft token independently
    matches the verify target with probability ``acceptance``) the
    longest accepted prefix plus the guaranteed corrected/bonus token
    gives the geometric partial sum ``(1 - a^(k+1)) / (1 - a)`` —
    Leviathan et al.'s E[#generated]. ``k=0`` returns exactly 1.0 (plain
    decode emits one token per cycle); ``a=1`` returns ``k + 1``."""
    if k <= 0:
        return 1.0
    a = min(max(float(acceptance), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def draft_token_time(cfg: ModelConfig, plan: PrecisionPlan,
                     hw: HardwareModel = HardwareModel()) -> float:
    """Compute-only token time of the ladder-draft pass (DESIGN.md §17):
    every expert forced to the LOWEST ladder rung. The rung banks are
    already resident for the serving plan, so the draft streams zero
    bytes over the host link and pays zero peer all2all — it reads the
    non-expert weights plus ``L * top_k`` lowest-rung experts from HBM,
    at the rung's fused-kernel decode speedup."""
    e = cfg.moe
    assert e is not None
    qr = quantized_rungs(plan.ladder)
    low = qr[0] if qr else 16
    per_active = cfg.expert_param_bytes(low) \
        / hw.q_speedup_decode(low) * (16 / low) if low < 16 \
        else float(cfg.expert_param_bytes(16))
    weight_bytes = cfg.non_expert_bytes() \
        + cfg.num_layers * e.top_k * per_active
    t = weight_bytes / (hw.hbm_bw * hw.mbu)
    if hw.kernel_launch_s > 0.0:
        # all experts on one rung: one grouped launch per layer.
        launches = cfg.num_layers if hw.grouped_ffn \
            else int((plan.location == DEVICE).sum())
        t += launches * hw.kernel_launch_s
    return t


def kv_token_bytes(cfg: ModelConfig) -> int:
    """KV bytes one cached token costs across the stack (k + v)."""
    a = cfg.attention
    itemsize = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    return cfg.num_layers * 2 * a.num_kv_heads * a.head_dim * itemsize


def kv_bytes_bucketed(cfg: ModelConfig, slots: int, window: int) -> int:
    """Slot-cache KV footprint: every slot holds its full window whether
    used or not — the padding waste the paged cache eliminates."""
    return slots * window * kv_token_bytes(cfg)


def kv_bytes_paged(cfg: ModelConfig, pages: int, page_size: int) -> int:
    """Paged KV footprint priced per page (DESIGN.md §13): ``pages``
    mapped pages of ``page_size`` tokens (the reserved null page is
    shared and free)."""
    return pages * page_size * kv_token_bytes(cfg)


def estimate_qos(cfg: ModelConfig, plan: PrecisionPlan,
                 hw: HardwareModel = HardwareModel(),
                 batch_size: int = 1, profile=None) -> QoSEstimate:
    """Decode-regime tokens/s for one replica under the plan."""
    e = cfg.moe
    assert e is not None, "QoS planner applies to MoE archs (DESIGN.md §5)"
    hit, miss_bytes = expert_access_stats(cfg, plan)

    # compute: read every active weight byte once per token (memory-bound
    # decode); a rung-``b`` expert reads b/16 of the bytes, sped up by the
    # fused kernel's rung speedup. The 16-bit fraction is the REMAINDER
    # (1 - sum of quantized fractions) so the binary ladder reproduces the
    # historical ``(1 - frac4) * s16`` term bit-for-bit.
    s16 = cfg.expert_param_bytes(16)
    per_active = 0.0
    frac_q_sum = 0.0
    for b in quantized_rungs(plan.ladder):
        frac = float((plan.bits == b).mean())
        per_active += frac * cfg.expert_param_bytes(b) \
            / hw.q_speedup_decode(b) * (16 / b)
        frac_q_sum += frac
    per_active += (1 - frac_q_sum) * s16
    active_expert_bytes = cfg.num_layers * e.top_k * per_active
    weight_bytes = cfg.non_expert_bytes() + active_expert_bytes
    t_compute = weight_bytes / (hw.hbm_bw * hw.mbu)
    if hw.kernel_launch_s > 0.0:
        # dispatch overhead (DESIGN.md §13): n_rungs launches per layer
        # under the grouped kernel vs one per resident expert looped.
        # Gated on the default 0.0 so the historical model (and the
        # frontier golden fixture) is untouched bit-for-bit.
        t_compute += ffn_kernel_launches(plan, hw.grouped_ffn) \
            * hw.kernel_launch_s

    t_transfer = miss_bytes / hw.host_link_bw
    # EP peer tier (DESIGN.md §16): PEER accesses move token activations
    # over the inter-device link (all2all), synchronous on the decode
    # critical path — never hidden by the host-transfer overlap window.
    # Both terms are exactly 0.0 when the plan has no PEER experts, so
    # t_token below reproduces the historical sum bit-for-bit (golden
    # fixture pinned).
    _, peer_bytes, peer_layers = peer_access_stats(cfg, plan)
    t_peer = peer_bytes / hw.interconnect_bw \
        + peer_layers * hw.all2all_latency_s
    # async overlap (DESIGN.md §12): only the transfer time the pipeline
    # cannot hide under compute reaches the token critical path; at
    # overlap_efficiency == 0 this is exactly the additive paper model.
    t_exposed = max(0.0, t_transfer - hw.overlap_efficiency * t_compute)
    t_token = t_compute + t_peer + t_exposed
    # speculative decode (DESIGN.md §17): a cycle of spec_k all-lowest-
    # rung draft steps plus ONE verify forward at the serving plan
    # (t_token — the verify is the plain decode step batched over k+1
    # positions; decode is weight-bound, so scoring extra positions is
    # ~free) emits E = (1 - a^(k+1)) / (1 - a) tokens in expectation.
    # Gated on the spec_k=0 default so the historical token time — and
    # the frontier golden fixture — is untouched bit-for-bit.
    t_draft = 0.0
    spec_tokens = 1.0
    if hw.spec_k > 0:
        t_draft = draft_token_time(cfg, plan, hw)
        spec_tokens = speculative_tokens_per_cycle(hw.spec_k,
                                                   hw.spec_acceptance)
        t_token = (hw.spec_k * t_draft + t_token) / spec_tokens
    return QoSEstimate(
        tokens_per_s=batch_size / t_token,
        t_compute_ms=t_compute * 1e3,
        t_transfer_ms=t_transfer * 1e3,
        t_exposed_ms=t_exposed * 1e3,
        t_peer_ms=t_peer * 1e3,
        t_draft_ms=t_draft * 1e3,
        spec_tokens_per_cycle=spec_tokens,
        hit_rate=hit,
        device_bytes=device_bytes(cfg, plan),
        quality_proxy=quality_proxy(cfg, plan, profile),
    )


def pareto_frontier(points: Sequence[Tuple[float, float]]) -> List[int]:
    """Indices of the Pareto-optimal (throughput UP, quality_proxy DOWN)."""
    idx = sorted(range(len(points)), key=lambda i: (-points[i][0], points[i][1]))
    out, best_q = [], float("inf")
    for i in idx:
        if points[i][1] < best_q - 1e-12:
            out.append(i)
            best_q = points[i][1]
    return sorted(out)
