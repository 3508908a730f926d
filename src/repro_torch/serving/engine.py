"""Adaptive MoE serving engine — continuous batching over fixed decode
slots (``repro.serving.engine``), on one device or over an
expert-parallel (1, ep) mesh.

  * ``ContinuousScheduler`` (serving/scheduler.py) owns requests: the
    admission queue, per-slot request state, join/retire at EVERY decode
    iteration.
  * this engine owns the model side: the KV cache — paged by default
    (fixed-size pages + a per-slot page table, DESIGN.md §13), or one
    slot row of ``max_len`` per slot (``paged_kv=False``), bit-identical
    to each other — a decode step over the full slot count (idle slots
    ride along masked by position=-1) and prefill-into-slot, so a new
    request joins a live batch without re-padding it.
  * the runtime expert path: non-resident experts under the active
    ``PrecisionPlan`` are fetched through the ``ExpertCache``
    (core/expert_cache.py) from the routed expert ids of every decode
    iteration; ``metrics`` reports the MEASURED ``transfer_s`` /
    ``miss_rate_measured`` next to the analytical ``transfer_s_est`` /
    ``miss_rate``. ``prefetch=True`` hints the previous iteration's
    experts to a ``PrefetchingExpertCache`` before each demand.
  * ASYNC OVERLAP (``overlap=True``, DESIGN.md §12): staging moves to an
    ``AsyncExpertCache`` whose workers copy on CUDA streams of their own,
    and decode runs the per-layer lookahead pipeline — while layer L
    computes, layer L+1's predicted experts (the previous iteration's
    routes) stage in the background; each layer's ACTUAL demand is then
    awaited, exposing only what prediction could not hide
    (``transfer_exposed_s`` vs ``transfer_overlapped_s``; throughput
    charges the exposed part). ``close()`` joins the workers.
  * ladder-draft SPECULATION (``speculate=K``, DESIGN.md §17): K draft
    steps with every expert at the lowest rung, one verify forward at the
    serving plan, longest-prefix acceptance, KV rollback.

The train-layout master copy of the weights stays where the caller put it
(on the card in a real deployment). ``_fetch_expert`` quantizes an expert
there, at the rung the plan assigns it, and keeps the result as a pinned
host blob that the expert cache copies back to the card; as in the
reference on one device, the serve-layout banks stay resident, so the
transfers are measured but not consumed by the matmuls.

Reconfiguration is safe mid-flight: placement-only replans apply between
decode iterations; a bank-split change first DRAINS the active slots, then
rebuilds the serve-layout banks (``metrics["reconfig_s"]``). The old banks
are released before the new ones are built, so a replan's peak holds one
set of banks. ``apply_bits_update`` is the dynamic-precision path
(DESIGN.md §15): in-place rung swaps at fixed bank shapes, with flipped
swap-cache entries re-staged at their new rung. A multi-tenant deployment
passes ``expert_cache=`` (a scoped view of one shared swap space,
``serving/multi.py``).

Expert parallelism (``mesh=``, DESIGN.md §16): the decode FFN runs
through ``mixed_moe.moe_apply``'s sharded path — each rung bank's rank
shards live on their mesh devices, built there by ``apply_precision_plan``
at every bank rebuild, so a replan that changes bank membership migrates
experts between ranks — and the planner rounds every bank to a multiple
of ``ep`` (the mesh's model size) and gains the PEER placement tier. On
the pure-EP (1, ep) mesh attention, the KV cache, the router and sampling
run on ``mesh.devices[0]`` (the engine's device). On a (data, model) mesh
that splits the dense compute (``dist.sharding.splits_dense``), the model
hooks run it split: the slots' rows over the data ranks, heads and vocab
slices over model; the slot cache and the page pool are placed per data
rank (each position holds its data rank's slot rows or page range, with
the admission cap held per rank), a slot prefill runs at the slot's data
rank, and only the logits (sampled on the engine's device) and the route
ids (the expert cache's feed, the data ranks' rows in rank order) are
gathered. The expert swap cache's copies run on the engine's device; the
host store keeps one blob per (layer, expert) at the plan's rung, dropped
with the banks. Greedy tokens are the single-device engine's.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import (RUNG_QUALITY_COST, HardwareModel,
                                         estimate_qos, expert_access_stats,
                                         kv_bytes_bucketed, kv_token_bytes)
from repro_torch.core.expert_cache import (AsyncExpertCache, ExpertCache,
                                           PrefetchingExpertCache)
from repro_torch.core.pareto import FrontierPoint, ParetoFrontier, QoSTarget
from repro_torch.core.planner import AdaptivePlanner, PlanResult
from repro_torch.core.precision_plan import (DEVICE, HOST, PrecisionPlan,
                                             quantized_rungs)
from repro_torch.core.quantization import quantize
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import Sharded
from repro_torch.models.model import Model, apply_precision_plan, build_model
from repro_torch.serving.api import EngineConfig, ServeRequest, ServeResult
from repro_torch.serving.metrics import base_metrics
from repro_torch.serving.paged_kv import PageAllocator
from repro_torch.serving.sampler import sample, speculative_verify
from repro_torch.serving.scheduler import (ContinuousScheduler, Request,
                                           RequestSLO, SamplingParams,
                                           SchedulerConfig)

__all__ = ["AdaptiveServingEngine", "Request", "RequestSLO",
           "SamplingParams", "measure_host_link_bw"]

_HOST_LINK_BW_CACHE: Dict[Tuple[str, int], float] = {}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, pinned when ``t`` lies on a CUDA device (so
    the expert cache's copy back runs from page-locked memory)."""
    pin = t.device.type == "cuda"
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=pin)
    out.copy_(t)
    return out


def measure_host_link_bw(device=None, nbytes: int = 1 << 24) -> float:
    """Measured host->device copy bandwidth from pinned memory, B/s.
    Cached per process and device."""
    dev = resolve_device(device)
    key = (str(dev), nbytes)
    if key in _HOST_LINK_BW_CACHE:
        return _HOST_LINK_BW_CACHE[key]
    buf = torch.ones(nbytes, dtype=torch.uint8,
                     pin_memory=dev.type == "cuda")
    buf[:1024].to(dev)                       # warm the path
    _sync(dev)
    t0 = time.perf_counter()
    buf.to(dev, non_blocking=True) if dev.type == "cuda" else buf.clone()
    _sync(dev)
    bw = nbytes / max(time.perf_counter() - t0, 1e-9)
    _HOST_LINK_BW_CACHE[key] = bw
    return bw


def _bucket(n: int, lo: int = 8, hi: Optional[int] = None) -> int:
    """Next power-of-two >= n (prefill lengths), clamped to the KV window."""
    b = lo
    while b < n:
        b *= 2
    return b if hi is None else min(b, hi)


class AdaptiveServingEngine:
    """Continuous-batching adaptive engine.

    Construct through :func:`repro_torch.serving.api.build_engine` or
    ``AdaptiveServingEngine(cfg, params, config=EngineConfig(...))``;
    ``device=None`` means the card, and ``mesh`` (a (data, model)
    ``launch.mesh.Mesh``: the pure-EP (1, ep) mesh, or one that splits
    the dense compute) serves over its devices, the first of them the
    engine's device. The flat keyword arguments
    (``max_batch`` — the number of decode slots —, ``max_len``, ...) are
    the reference's backward-compatible spelling and populate an
    ``EngineConfig`` when ``config`` is None. ``expert_cache`` attaches a
    tenant-scoped view of a shared swap space instead of the engine's own
    cache (DESIGN.md §10)."""

    def __init__(self, cfg: ModelConfig, params, *,
                 config: Optional[EngineConfig] = None, device=None,
                 mesh=None, hw: Optional[HardwareModel] = None,
                 max_batch: int = 8, max_len: int = 256,
                 use_kernel: bool = False,
                 max_active_tokens: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 swap_bytes: Optional[int] = None,
                 prefetch: bool = False,
                 expert_cache=None):
        if cfg.moe is None:
            raise ValueError("the adaptive engine serves MoE models")
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.devices[0]
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device={device} is not the mesh's first "
                                 f"device {self.device}")
        if config is None:
            config = EngineConfig(
                max_slots=max_batch, max_len=max_len,
                use_kernel=use_kernel,
                max_active_tokens=max_active_tokens, max_queue=max_queue,
                swap_bytes=swap_bytes, prefetch=prefetch, hw=hw)
        if mesh is not None:
            ep = mesh.sizes["model"]
            if config.ep not in (1, ep):
                raise ValueError(f"EngineConfig.ep={config.ep} conflicts "
                                 f"with the mesh's ep={ep}")
            config = dataclasses.replace(config, ep=ep)
        self.mesh = mesh
        if config.ladder is not None:
            cfg = cfg.replace(mop=dataclasses.replace(
                cfg.mop, ladder=tuple(config.ladder)))
        self.config = config
        self.cfg = cfg
        self.params_train = params        # train-layout master copy
        self.max_slots = config.max_slots
        self.max_len = config.max_len
        self.use_kernel = config.use_kernel
        if config.hw is not None:
            self.hw = config.hw
            if config.overlap_efficiency is not None:
                self.hw = dataclasses.replace(
                    self.hw,
                    overlap_efficiency=float(config.overlap_efficiency))
        else:
            # overlap mode seeds the analytic overlap window (refined at
            # run time by calibrate_overlap); sync keeps the additive model
            eff = config.overlap_efficiency
            if eff is None:
                eff = 0.85 if config.overlap else 0.0
            self.hw = HardwareModel(
                host_link_bw=measure_host_link_bw(self.device),
                overlap_efficiency=float(eff))
        self.planner = AdaptivePlanner(cfg, hw=self.hw, ep=config.ep)
        self.model: Model = build_model(cfg, mesh,
                                        use_kernel=self.use_kernel)
        if self.model.prefill_into_slot is None:
            raise ValueError(f"{cfg.arch_id}: family {cfg.family} has no "
                             "slot-cache decode path")
        self._kv_token_bytes = kv_token_bytes(cfg)
        # KV cache: paged by default (DESIGN.md §13), bit-identical to the
        # slot cache that paged_kv=False keeps as the A/B baseline
        self.paged = bool(config.paged_kv)
        max_active = config.max_active_tokens
        group_cap = None
        if self.paged:
            self.kv_pool, self.kv_meta = self.model.init_paged_cache(
                self.max_slots, self.max_len, page_size=config.page_size,
                num_pages=config.kv_pool_pages, device=self.device)
            self.window = self.kv_meta.window
            ranks = self.kv_meta.data_ranks
            self.kv_alloc = PageAllocator(
                self.max_slots, self.kv_meta.chunks_per_slot,
                self.kv_meta.num_pages, self.kv_meta.page_size, ranks)
            self.cache = None
            worst = self.max_slots * self.kv_meta.chunks_per_slot
            if self.kv_alloc.usable_pages < worst:
                # sub-worst-case pool: cap admitted tokens so ensure() can
                # never dead-end mid-flight (per-slot ceil rounding costs
                # at most one page each, hence the slots term); a pool
                # placed per data rank caps each rank's slots
                derived = (self.kv_meta.pages_per_rank - 1
                           - self.max_slots // ranks) \
                    * self.kv_meta.page_size
                if ranks == 1:
                    max_active = derived if max_active is None \
                        else min(max_active, derived)
                else:
                    group_cap = derived
        else:
            self.kv_pool = self.kv_meta = self.kv_alloc = None
            self.cache = self.model.init_cache(self.max_slots, self.max_len,
                                               device=self.device)
            self.window = int(self.cache["k"].shape[2])
        self.scheduler = ContinuousScheduler(SchedulerConfig(
            max_slots=self.max_slots, max_len=self.max_len,
            max_prompt_len=self.window,
            max_active_tokens=max_active,
            slot_groups=self.kv_meta.data_ranks if self.paged else 1,
            max_group_tokens=group_cap,
            max_queue=config.max_queue))
        # runtime expert streaming: the engine's own swap cache, or a
        # tenant-scoped VIEW of a shared swap space (same interface,
        # namespaced keys, jointly shared byte budget)
        self._owns_cache = expert_cache is None
        if expert_cache is not None:
            if config.prefetch and not hasattr(expert_cache, "hint"):
                raise ValueError(
                    "EngineConfig(prefetch=True) needs an expert cache "
                    "with hint() support; the provided shared view has "
                    "none")
            if config.overlap and not getattr(expert_cache, "is_async",
                                              False):
                raise ValueError(
                    "EngineConfig(overlap=True) needs an async expert "
                    "cache (AsyncExpertCache, or a scoped view of one — "
                    "DESIGN.md §12); the provided cache stages "
                    "synchronously")
            self.expert_cache = expert_cache
            if hasattr(expert_cache, "bind_fetch"):
                expert_cache.bind_fetch(self._fetch_expert)
        else:
            cache_cls = AsyncExpertCache if config.overlap \
                else (PrefetchingExpertCache if config.prefetch
                      else ExpertCache)
            self.expert_cache = cache_cls(
                self._fetch_expert,
                capacity_bytes=config.swap_bytes
                or 4 * max(cfg.expert_param_bytes(16), 1),
                device=self.device)
        self._prev_demanded: List[Tuple[int, int]] = []
        #: the pipeline's per-layer prediction: the previous iteration's
        #: demanded (non-resident) keys, layer-indexed
        self._prev_layer_keys: Optional[List[List[Tuple[int, int]]]] = None
        #: accumulated routed-access histogram [L, E] over TRUE expert ids
        self.route_counts: np.ndarray = np.zeros(
            (cfg.num_layers, cfg.moe.num_experts), np.int64)
        self._host_store: Dict[Tuple[int, int], Any] = {}
        self._resident: set = set()
        self._miss_bytes_per_tok = 0.0
        self._order: Optional[np.ndarray] = None   # bank slot -> expert id
        self._serve_params = None
        #: why the engine cannot serve (a failed bank rebuild), else None
        self._unusable: Optional[str] = None
        self._plan_result: Optional[PlanResult] = None
        self._frontier: Optional[ParetoFrontier] = None
        self._target: Optional[QoSTarget] = None
        self._active_point: Optional[FrontierPoint] = None
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        # speculative draft depth (0 = plain decode); the draft params
        # (every expert at the lowest rung) build on first use and survive
        # replans that keep the ladder
        self.speculate_k = max(0, int(config.speculate or 0))
        self._draft_params = None
        self._draft_sig: Optional[Tuple] = None
        # the async workers run _fetch_expert concurrently: its host-store
        # insert is per key, but the stage_s sum needs the lock
        self._stage_lock = threading.Lock()
        self.metrics: Dict[str, Any] = base_metrics()
        self.metrics["kv_capacity_bytes"] = (
            self.kv_alloc.usable_pages * self.kv_meta.page_size
            * self._kv_token_bytes if self.paged
            else kv_bytes_bucketed(cfg, self.max_slots, self.window))

    @property
    def queue(self):
        """The scheduler's admission queue."""
        return self.scheduler.queue

    @property
    def done(self) -> Dict[int, Request]:
        """Completed requests by rid."""
        return self.scheduler.done

    @property
    def max_batch(self) -> int:
        """The number of decode slots (the flat spelling's name)."""
        return self.max_slots

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # ------------------------------------------------------------------
    # Planner integration / mid-flight reconfiguration
    # ------------------------------------------------------------------
    @property
    def frontier(self) -> ParetoFrontier:
        """The engine's Pareto frontier over the MoP config space, built
        lazily once per (hardware model, slot count)."""
        if self._frontier is None:
            self._frontier = self.planner.frontier(
                batch_size=self.max_slots)
        return self._frontier

    @property
    def target(self) -> Optional[QoSTarget]:
        return self._target

    @property
    def active_point(self) -> Optional[FrontierPoint]:
        return self._active_point

    @property
    def current_plan(self) -> Optional[PrecisionPlan]:
        return self._plan_result.plan if self._plan_result is not None \
            else None

    def apply_target(self, target: QoSTarget) -> FrontierPoint:
        """Resolve ``target`` on the frontier and apply the selected point
        via the mid-flight replan path. Raises
        :class:`~repro_torch.core.pareto.InfeasibleTarget` when the hard
        constraints admit no configuration."""
        if self.config.kv_reserve:
            # HBM a sub-worst-case page pool reclaims vs the slot cache
            # widens the expert-residency budget the frontier resolves
            target = target.with_kv_reclaimed(self.kv_reclaimed_bytes())
        point = self.frontier.select(target)
        self._target = target
        self.apply_frontier_point(point)
        return point

    def kv_reclaimed_bytes(self) -> int:
        """HBM the paged pool reclaims vs the fully-windowed slot cache
        (0 for the slot cache or a worst-case-sized pool)."""
        if not self.paged:
            return 0
        bucketed = kv_bytes_bucketed(self.cfg, self.max_slots, self.window)
        return max(0, bucketed - int(self.metrics["kv_capacity_bytes"]))

    def apply_frontier_point(self, point: FrontierPoint) -> PlanResult:
        """Apply one frontier point: the point's exact device footprint is
        the budget and its per-rung counts are the quality knobs. Under EP
        (or for a point with PEER experts) the point's exact (total
        resident, peer) split is pinned, since the budget-derived
        residency cannot reconstruct a peer slice; single-device points
        keep the budget-derived path."""
        counts = point.quantized_counts() if point.counts_per_rung \
            else None
        pin = point.peer_experts > 0 or self.planner.ep > 1
        result = self._reconfigure(
            float(point.qos.device_bytes), "quality", point.num_q_experts,
            counts=counts,
            resident_experts=point.resident_experts if pin else None,
            peer_experts=point.peer_experts if pin else None)
        self._active_point = point
        return result

    def configure(self, mem_budget_bytes: float, preference: str,
                  num_q_experts: Optional[int] = None) -> PlanResult:
        """DEPRECATED imperative shim (use ``apply_target``)."""
        warnings.warn(
            "AdaptiveServingEngine.configure() is deprecated; declare a "
            "QoSTarget and use apply_target()",
            DeprecationWarning, stacklevel=2)
        if preference == "throughput":
            self._target = QoSTarget(mem_budget_bytes=mem_budget_bytes,
                                     min_tokens_per_s=math.inf)
        else:
            loss = None
            if num_q_experts is not None:
                frac = num_q_experts / max(self.planner.num_experts_total,
                                           1)
                low = quantized_rungs(self.planner.ladder)[0]
                per_bit = RUNG_QUALITY_COST.get(low, 0.07)
                loss = per_bit * min(max(frac, 0.0), 1.0)
            self._target = QoSTarget(mem_budget_bytes=mem_budget_bytes,
                                     max_quality_loss=loss)
        result = self._reconfigure(mem_budget_bytes, preference,
                                   num_q_experts)
        self._active_point = None
        return result

    def _reconfigure(self, mem_budget_bytes: float, preference: str,
                     num_q_experts: Optional[int] = None,
                     counts=None, resident_experts: Optional[int] = None,
                     peer_experts: Optional[int] = None) -> PlanResult:
        """Replan under new constraints; safe with requests in flight.
        Placement-only changes apply immediately; a bank-split change
        drains the active slots first. ``resident_experts``/
        ``peer_experts`` pin the placement split (the EP apply path)."""
        self._require_usable()
        t0 = time.perf_counter()
        # async staging barrier: every enqueued transfer lands BEFORE the
        # plan changes, so no stale-plan blob is admitted after the
        # invalidate below (no-op for the sync caches)
        self.expert_cache.drain()
        result, delta = self.planner.replan(
            mem_budget_bytes, preference, num_q_experts,
            batch_size=self.max_slots, counts=counts,
            resident_experts=resident_experts, peer_experts=peer_experts)
        plan = result.plan
        prev_plan = self._plan_result.plan \
            if self._plan_result is not None else None
        rebuild = (prev_plan is None
                   or prev_plan.bank_sizes() != plan.bank_sizes()
                   or prev_plan.seed != plan.seed)
        drain_s = 0.0
        if rebuild:
            if self.scheduler.num_active:
                self.metrics["drains"] += 1
                t_drain = time.perf_counter()
                while self.scheduler.num_active:
                    self.run_iteration(admit=False)
                drain_s = time.perf_counter() - t_drain
                self.metrics["drain_s"] += drain_s
                # the drain iterations enqueued async fetches on the OLD
                # plan: barrier again before invalidating
                self.expert_cache.drain()
            self._rebuild_banks(plan)
            self._host_store.clear()
            self.expert_cache.invalidate()
        self._plan_result = result
        self._order = plan.expert_order()
        # accelerator-resident = LOCAL + PEER: under EP the banks are
        # sharded over the mesh, so a PEER expert is served by its rank,
        # never streamed over the host link (single-device plans have no
        # PEER entries: the DEVICE mask)
        newly_resident = {(int(li), int(ei)) for li, ei
                          in np.argwhere(plan.location != HOST)}
        if not rebuild:
            # same bank shapes can still assign different rungs to experts
            rung_changed = set()
            if (prev_plan.bits != plan.bits).any():
                # an earlier apply_bits_update may have swapped rungs
                # between experts; the fresh plan carries the canonical
                # assignment, so the banks follow it
                self._rebuild_banks(plan)
                rung_changed = {
                    (int(l), int(e)) for l, e in
                    np.argwhere(prev_plan.bits != plan.bits)}
                for k in list(self._host_store):
                    if (k[0], k[1]) in rung_changed:
                        del self._host_store[k]
            self.expert_cache.invalidate(
                [k for k in self.expert_cache.resident_keys()
                 if k[:2] in newly_resident or k[:2] in rung_changed])
        self._resident = newly_resident
        self._prev_demanded = []     # stale-plan hints must not re-stage
        self._prev_layer_keys = None
        hit, self._miss_bytes_per_tok = expert_access_stats(self.cfg, plan)
        self.metrics["miss_rate"] = 1.0 - hit
        downtime = time.perf_counter() - t0 - drain_s
        self.metrics["reconfig_s"] += downtime
        self.metrics["reconfigs"] += 1
        if delta is not None:
            # partial-reconfiguration report (DESIGN.md §10.3): only the
            # diffed experts migrate
            self.metrics["last_delta_traffic_gib"] = \
                delta["traffic_bytes"] / 2**30
            self.metrics["last_migrated_experts"] = len(delta["migrated"])
            self.metrics["last_migrated_bytes"] = delta["traffic_bytes"]
            self.metrics["last_reconfig_downtime_s"] = downtime
            self.metrics["migrated_bytes_total"] = \
                self.metrics.get("migrated_bytes_total", 0) \
                + delta["traffic_bytes"]
        return result

    def _rebuild_banks(self, plan: PrecisionPlan) -> None:
        """Build ``plan``'s serve-layout banks (on a mesh: each rank's
        shards on its device). The old banks are released first, so the
        peak never holds both sets; a build that fails (out of memory at
        full width) therefore leaves no banks to serve on, and the engine
        refuses every later iteration and replan."""
        self._serve_params = None
        try:
            self._serve_params = apply_precision_plan(
                self.params_train, self.cfg, plan, mesh=self.mesh)
        except BaseException as e:
            self._unusable = (
                f"rebuilding the serve banks failed ({type(e).__name__}: "
                f"{e}); the old banks were released before the rebuild, "
                "so this engine cannot serve: build a new one")
            raise

    def _require_usable(self) -> None:
        if self._unusable is not None:
            raise RuntimeError(self._unusable)

    # ------------------------------------------------------------------
    # Dynamic precision (DESIGN.md §15)
    # ------------------------------------------------------------------
    def reset_route_counts(self) -> None:
        """Zero the accumulated routing histogram (callers that window
        it, like the dynamic controller, snapshot instead)."""
        self.route_counts[...] = 0

    def apply_bits_update(self, new_bits: np.ndarray) -> Dict[str, Any]:
        """In-place rung flips (DESIGN.md §15): same expert locations,
        same per-layer rung counts, only the bits[L, E] ASSIGNMENT
        changes — the :class:`DynamicPrecisionController`'s apply path.
        Diff-only: no planner replan, no drain; the bank shapes are
        unchanged, only the serve-layout banks and the router permutation
        rebuild (the old banks are released first), and flipped experts
        resident in the swap cache are re-staged at their new rung
        through ``ExpertCache.update()``, which charges exactly the byte
        delta. In-flight async copies land before anything changes.

        Returns a report dict: flipped/promotions/demotions counts, the
        summed cache byte delta, and the number of re-staged entries."""
        assert self._plan_result is not None, "no active plan"
        self._require_usable()
        old_plan = self._plan_result.plan
        new_bits = np.asarray(new_bits, old_plan.bits.dtype)
        if new_bits.shape != old_plan.bits.shape:
            raise ValueError(f"bits shape {new_bits.shape} != "
                             f"{old_plan.bits.shape}")
        for b in np.unique(new_bits).tolist():
            if int(b) not in old_plan.ladder:
                raise ValueError(f"rung {b} not on ladder "
                                 f"{old_plan.ladder}")
        for li in range(new_bits.shape[0]):
            for b in old_plan.ladder:
                if int((new_bits[li] == b).sum()) \
                        != int((old_plan.bits[li] == b).sum()):
                    raise ValueError(
                        "apply_bits_update must preserve per-layer rung "
                        f"counts (layer {li}, rung {b}): a count change "
                        "is a bank split — use apply_frontier_point")
        flipped = new_bits != old_plan.bits
        report: Dict[str, Any] = {
            "flipped": int(flipped.sum()),
            "promotions": int((new_bits > old_plan.bits).sum()),
            "demotions": int((new_bits < old_plan.bits).sum()),
            "cache_bytes_delta": 0, "restaged": 0,
        }
        if not report["flipped"]:
            return report
        t0 = time.perf_counter()
        # async staging barrier: in-flight transfers carry OLD-rung blobs
        self.expert_cache.drain()
        new_plan = dataclasses.replace(old_plan, bits=new_bits)
        self._rebuild_banks(new_plan)
        self._plan_result = dataclasses.replace(
            self._plan_result, plan=new_plan,
            qos=estimate_qos(self.cfg, new_plan, self.planner.hw,
                             self.max_slots, self.planner.profile))
        # keep the planner's replan diffing anchored on the live plan
        self.planner.current = self._plan_result
        self._order = new_plan.expert_order()
        flipped_keys = {(int(l), int(e)) for l, e in np.argwhere(flipped)}
        for k in list(self._host_store):
            if (k[0], k[1]) in flipped_keys:
                del self._host_store[k]     # re-quantize at the new rung
        for key in list(self.expert_cache.resident_keys()):
            if (key[0], key[1]) in flipped_keys:
                report["cache_bytes_delta"] += \
                    self.expert_cache.update(key, self._fetch_expert(key))
                report["restaged"] += 1
        hit, self._miss_bytes_per_tok = expert_access_stats(self.cfg,
                                                            new_plan)
        self.metrics["miss_rate"] = 1.0 - hit
        self.metrics["reconfig_s"] += time.perf_counter() - t0
        self.metrics["bits_updates"] = \
            self.metrics.get("bits_updates", 0) + 1
        self.metrics["rung_flips"] = \
            self.metrics.get("rung_flips", 0) + report["flipped"]
        return report

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16, *,
               sampling: Optional[SamplingParams] = None,
               slo: Optional[RequestSLO] = None,
               now: Optional[float] = None) -> int:
        return self.scheduler.submit(prompt, max_new_tokens, now,
                                     sampling=sampling, slo=slo)

    def submit_request(self, request: ServeRequest) -> int:
        """Typed-surface spelling of ``submit``."""
        return self.submit(request.prompt, request.max_new_tokens,
                           sampling=request.sampling, slo=request.slo)

    def result(self, rid: int) -> ServeResult:
        """The ServeResult of a completed request (KeyError while the
        request is queued or in flight)."""
        return ServeResult.from_request(self.scheduler.done[rid])

    # -- expert streaming ----------------------------------------------
    @torch.no_grad()
    def _fetch_expert(self, key):
        """Host loader for the expert swap cache: the expert's weights in
        the rung the active plan assigns it (packed int4/int8 + scales or
        bf16), quantized on the master copy's device and kept as a pinned
        host blob."""
        li, ei = key[0], key[1]
        blob = self._host_store.get((li, ei))
        if blob is None:
            t0 = time.perf_counter()
            moe_p = self.params_train["layers"]["moe"]
            w = {k: moe_p[k][li, ei] for k in ("w_gate", "w_up", "w_down")}
            bits = int(self._plan_result.plan.bits[li, ei])
            if bits < 16:
                gs = self._plan_result.plan.group_size
                blob = {}
                for k, v in w.items():
                    qt = quantize(v, bits, gs)
                    blob[k] = {"q": _to_host(qt.q),
                               "scales": _to_host(qt.scales)}
            else:
                blob = {k: _to_host(v) for k, v in w.items()}
            self._host_store[(li, ei)] = blob
            # locked: the async workers run this loader concurrently
            with self._stage_lock:
                self.metrics["stage_s"] += time.perf_counter() - t0
        return blob

    def _stream_experts(self, route_ids: np.ndarray, rows: List[int]):
        """Feed the routed (layer, expert) accesses of one decode
        iteration through the runtime cache; resident experts are HBM
        hits, the rest go through the LRU swap space. ``miss_rate``
        (analytic) assumes every non-resident access streams;
        ``miss_rate_measured`` counts accesses that actually transferred."""
        st = self.expert_cache.stats
        blocked0 = st.transfer_s + st.prefetch_s
        if self.config.prefetch and self._prev_demanded:
            # temporal-locality prefetch BEFORE this iteration's demand:
            # decode re-demands most of the previous iteration's experts,
            # so anything evicted since is staged speculatively
            self.expert_cache.hint(self._prev_demanded)
        order = self._order
        demanded = set()
        for li in range(route_ids.shape[0]):
            for b in rows:
                for slot_id in route_ids[li, b]:
                    ei = int(order[li, int(slot_id)])
                    demanded.add((li, ei))
                    self.route_counts[li, ei] += 1
        misses0 = st.misses
        for key in sorted(demanded):
            self.metrics["expert_accesses"] += 1
            if key in self._resident:
                continue
            self.expert_cache.get(key)
        self.metrics["expert_fetches"] += st.misses - misses0
        self._prev_demanded = [k for k in sorted(demanded)
                               if k not in self._resident]
        # serial staging blocks the critical path for every transferred
        # second (speculative hints included) — all of it is EXPOSED
        self.metrics["transfer_exposed_s"] += \
            st.transfer_s + st.prefetch_s - blocked0
        self._finish_stream_metrics()

    def _finish_stream_metrics(self):
        """Fold the cache's counters into the engine metrics:
        ``transfer_s`` is DEMAND transfer only (speculative staging is
        ``prefetch_s``); ``transfer_overlapped_s`` is the transferred time
        that did not block the critical path."""
        st = self.expert_cache.stats
        self.metrics["transfer_s"] = st.transfer_s
        self.metrics["prefetch_s"] = st.prefetch_s
        self.metrics["transfer_overlapped_s"] = max(
            st.transfer_s + st.prefetch_s
            - self.metrics["transfer_exposed_s"], 0.0)
        if self.metrics["expert_accesses"]:
            self.metrics["miss_rate_measured"] = \
                self.metrics["expert_fetches"] \
                / self.metrics["expert_accesses"]

    def _decode_pipelined(self, toks: np.ndarray, pos: np.ndarray,
                          rows: List[int]) -> torch.Tensor:
        """Per-layer lookahead pipeline (DESIGN.md §12): while layer L
        computes, layer L+1's PREDICTED experts (the previous iteration's
        routes for that layer) stage on the async cache's workers; each
        layer's ACTUAL demand is then awaited, so only the transfer time
        the prediction could not hide is exposed. Same bits as the
        whole-stack decode step. Returns the next-token logits (B, V).

        ``transfer_exposed_s`` is blocked wall-clock, so on a cold host
        store it also covers the demand fetch's quantization that the
        sync path books under ``stage_s``."""
        m, params = self.model, self._serve_params
        cache = self.expert_cache
        st = cache.stats
        pos_t = self._tensor(pos)
        pt = self._page_table() if self.paged else None
        n_layers = self.cfg.num_layers
        predicted = self._prev_layer_keys
        misses0 = st.misses
        exposed = 0.0
        t_loop0 = time.perf_counter()
        x = m.decode_embed(params, self._tensor(toks))
        if predicted is not None and n_layers:
            cache.prefetch(predicted[0])
        new_layer_keys: List[List[Tuple[int, int]]] = []
        for li in range(n_layers):
            if self.paged:
                x, self.kv_pool, ids = m.paged_decode_layer_routed(
                    params, self.kv_pool, pt, x, pos_t, li,
                    window=self.window)
            else:
                x, self.cache, ids = m.decode_layer_routed(
                    params, self.cache, x, pos_t, li)
            if predicted is not None and li + 1 < n_layers:
                # lookahead: enqueue layer li+1's predicted demand BEFORE
                # the host reads layer li's routes (that read waits for
                # layer li's compute)
                cache.prefetch(predicted[li + 1])
            ids_np = self._host(ids)
            order = self._order[li]
            np.add.at(self.route_counts[li],
                      order[ids_np[rows].astype(np.int64).ravel()], 1)
            demanded = sorted({(li, int(order[int(s)]))
                               for b in rows for s in ids_np[b]})
            self.metrics["expert_accesses"] += len(demanded)
            need = [k for k in demanded if k not in self._resident]
            t0 = time.perf_counter()
            cache.wait(need)
            exposed += time.perf_counter() - t0
            new_layer_keys.append(need)
        logits = self._gathered(m.decode_logits(params, x))
        _sync(self.device)
        t_loop = time.perf_counter() - t_loop0
        self.metrics["decode_s"] += max(t_loop - exposed, 0.0)
        self.metrics["transfer_exposed_s"] += exposed
        self.metrics["expert_fetches"] += st.misses - misses0
        self._prev_layer_keys = new_layer_keys
        self._finish_stream_metrics()
        return logits

    # -- iteration-level serving ----------------------------------------
    @staticmethod
    def _sampling_of(req: Request, default_temperature: float
                     ) -> Tuple[float, int]:
        if req.sampling is not None:
            return req.sampling.temperature, req.sampling.top_k
        return default_temperature, 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _gathered(self, t) -> torch.Tensor:
        """A hook's logits or route ids whole on the engine's device (a
        split mesh's :class:`dist.sharding.Sharded` gathered in rank
        order; never a cache or pool leaf)."""
        return t.full(self.device) if isinstance(t, Sharded) else t

    def _host(self, t) -> np.ndarray:
        return self._gathered(t).cpu().numpy()

    def _page_table(self, slot: Optional[int] = None):
        """The paged hooks' page table of the allocator's table, or of
        ``slot``'s row (the prefill's)."""
        return self.model.page_table(self.kv_alloc.table, self.device,
                                     meta=self.kv_meta, slot=slot)

    def _prefill_slot(self, slot: int, req: Request,
                      temperature: float) -> Optional[int]:
        """Join ``req`` into ``slot``; returns its rid if it already
        retired (max_new_tokens == 1), else None."""
        s = len(req.prompt)
        # one bucket rule for both layouts (the reference's paged engine
        # pads to whole pages to bound its jit compiles; eager torch has
        # none to bound, and one padded length keeps paged prefill
        # bit-identical to slot prefill)
        sb = _bucket(s, hi=self.window)
        toks = np.zeros((1, sb), np.int64)
        pos = np.full((1, sb), -1, np.int64)
        toks[0, :s] = req.prompt
        pos[0, :s] = np.arange(s)
        t0 = time.perf_counter()
        if self.paged:
            self.kv_alloc.ensure_prefix(slot, min(s, self.window))
            logits, self.kv_pool = self.model.paged_prefill_into_slot(
                self._serve_params, self.kv_pool, self._page_table(slot),
                self._tensor(toks), self._tensor(pos), s - 1,
                window=self.window)
        else:
            logits, self.cache = self.model.prefill_into_slot(
                self._serve_params, self.cache, self._tensor(toks),
                self._tensor(pos), slot, s - 1)
        logits = self._gathered(logits)
        _sync(self.device)
        self.metrics["prefill_s"] += time.perf_counter() - t0
        temp, top_k = self._sampling_of(req, temperature)
        tok = int(sample(logits, generator=self._generator,
                         temperature=temp, top_k=top_k,
                         vocab_size=self.cfg.vocab_size)[0])
        now = time.perf_counter()
        req.out_tokens.append(tok)
        req.t_first = now
        self.metrics["tokens_generated"] += 1
        st = self.scheduler.slots[slot]
        st.last_token = tok
        if req.done():                      # max_new_tokens == 1
            self.scheduler.retire(slot, now=now)
            self._release_slot_kv(slot)
            return req.rid
        return None

    def _release_slot_kv(self, slot: int):
        """Retire a slot's KV: paged -> free its pages (their tags are
        invalidated on the device before reuse); slot cache -> invalidate
        the row."""
        if self.paged:
            self.kv_pool = self.model.paged_reset_pages(
                self.kv_pool, self.kv_alloc.free_slot(slot))
        else:
            self.cache = self.model.reset_slot(self.cache, slot)

    def _update_kv_metrics(self, active):
        """Per-iteration KV padding accounting (DESIGN.md §13)."""
        tb = self._kv_token_bytes
        used = sum(min(st.position + 1, self.window)
                   for _, st in active) * tb
        if self.paged:
            alloc = self.kv_alloc.pages_in_use * self.kv_meta.page_size * tb
        else:
            alloc = self.max_slots * self.window * tb
        self.metrics["kv_used_bytes"] = used
        self.metrics["kv_allocated_bytes"] = alloc
        self.metrics["kv_used_byte_iters"] += used
        self.metrics["kv_alloc_byte_iters"] += alloc

    def kv_waste_fraction(self) -> float:
        alloc = self.metrics["kv_alloc_byte_iters"]
        if alloc <= 0:
            return 0.0
        return 1.0 - self.metrics["kv_used_byte_iters"] / alloc

    # -- self-speculative decoding (DESIGN.md §17) ----------------------
    def set_speculation(self, k: int) -> None:
        """Set the draft depth of ladder-draft speculation; ``0`` is plain
        decode. Takes effect from the next iteration, with no drain."""
        self.speculate_k = max(0, int(k))

    def _draft_serve_params(self):
        """Serve-layout params with EVERY expert at the lowest ladder rung
        — the all-quantized configuration, the free draft model. Cached
        across replans: it depends only on (ladder, group size), never on
        the serving rung assignment or placement."""
        plan = self._plan_result.plan
        low = quantized_rungs(plan.ladder)[0]
        sig = (tuple(plan.ladder), plan.group_size, low)
        if self._draft_params is None or self._draft_sig != sig:
            draft_plan = dataclasses.replace(
                plan, bits=np.full_like(plan.bits, low),
                location=np.full_like(plan.location, DEVICE))
            self._draft_params = None       # free the old draft first
            self._draft_params = apply_precision_plan(
                self.params_train, self.cfg, draft_plan, mesh=self.mesh)
            self._draft_sig = sig
        return self._draft_params

    def _greedy_np(self, row: np.ndarray) -> int:
        """Host-side greedy pick, the same as ``sampler.sample``'s
        temperature<=0 branch (same -1e30 vocab-pad mask, first maximum):
        the acceptance test must match what plain decode would emit."""
        v = self.cfg.vocab_size
        if v and row.shape[-1] > v:
            row = np.where(np.arange(row.shape[-1]) >= v, -1e30, row)
        return int(np.argmax(row))

    def _probs_np(self, row: np.ndarray, temp: float, top_k: int
                  ) -> np.ndarray:
        """Host-side f64 mirror of ``sampler.sample_probs``: the draft
        proposal q and the verify target p of rejection sampling."""
        x = np.asarray(row, np.float64).copy()
        v = self.cfg.vocab_size
        if v and x.shape[-1] > v:
            x[v:] = -1e30
        x = x / temp
        if top_k:
            thresh = np.partition(x, -top_k)[-top_k]
            x = np.where(x < thresh, -1e30, x)
        x -= x.max()
        e = np.exp(x)
        return e / e.sum()

    def _uniforms(self, shape) -> np.ndarray:
        return torch.rand(shape, generator=self._generator,
                          device=self.device).cpu().numpy()

    def _spec_iteration(self, active, temperature: float,
                        retired: List[int]) -> List[int]:
        """One speculative iteration (DESIGN.md §17): up to K draft tokens
        per slot at the lowest rung, ONE batched verify forward at the
        serving plan scoring all K+1 positions against the KV cache,
        longest-prefix acceptance (greedy) or chain rejection sampling
        (temperature > 0), then rollback of the rejected tail and paged
        truncation.

        Per-slot depth is ``min(K, remaining-1, window-1-position)``: the
        emitted count stays inside the request's claim, and speculative
        writes stay in the unwrapped ring, so a multi-token write never
        clobbers an entry a same-batch query still attends. Overlap mode
        uses this step too; its expert streaming runs through the async
        cache's synchronous interface."""
        K = self.speculate_k
        S = K + 1
        B = self.max_slots
        depth: Dict[int, int] = {}
        for i, st in active:
            rem = st.req.max_new_tokens - len(st.req.out_tokens)
            depth[i] = max(0, min(K, rem - 1,
                                  self.window - 1 - st.position))
        pt = None
        if self.paged:
            # map every chunk the draft and verify writes touch up front;
            # the admission claim already covers the full span
            for i, st in active:
                for j in range(depth[i] + 1):
                    self.kv_alloc.ensure_index(
                        i, (st.position + j) % self.window)
            pt = self._page_table()

        def run_step(params, toks, pos):
            # one step serves both shapes: draft (B,1), verify (B,S)
            if self.paged:
                logits, self.kv_pool, ids = self.model.paged_spec_step_routed(
                    params, self.kv_pool, pt, self._tensor(toks),
                    self._tensor(pos), window=self.window)
            else:
                logits, self.cache, ids = self.model.spec_step_routed(
                    params, self.cache, self._tensor(toks),
                    self._tensor(pos))
            return self._gathered(logits), ids

        u_draft = u_acc = u_res = None
        t0 = time.perf_counter()
        # -- draft pass: up to K single-token steps at the lowest rung --
        draft_params = self._draft_serve_params()
        drafts: Dict[int, List[int]] = {i: [] for i, _ in active}
        q_rows: Dict[int, List[np.ndarray]] = {i: [] for i, _ in active}
        prev_tok = {i: st.last_token for i, st in active}
        for t in range(max(depth.values(), default=0)):
            toks = np.zeros((B, 1), np.int64)
            pos = np.full((B, 1), -1, np.int64)
            rows = [i for i, _ in active if depth[i] > t]
            for i in rows:
                toks[i, 0] = prev_tok[i]
                pos[i, 0] = self.scheduler.slots[i].position + t
            logits, _ = run_step(draft_params, toks, pos)
            lg = logits[:, 0].cpu().numpy()
            for i in rows:
                temp, top_k = self._sampling_of(
                    self.scheduler.slots[i].req, temperature)
                if temp <= 0.0:
                    tok = self._greedy_np(lg[i])
                else:
                    if u_draft is None:
                        u_draft = self._uniforms((max(K, 1), B))
                    q = self._probs_np(lg[i], temp, top_k)
                    cdf = np.cumsum(q)
                    tok = int(min(np.searchsorted(
                        cdf, float(u_draft[t, i]), side="right"),
                        len(cdf) - 1))
                    q_rows[i].append(q)
                drafts[i].append(tok)
                prev_tok[i] = tok
        # -- batched verify at the serving plan (exact) -----------------
        toks = np.zeros((B, S), np.int64)
        pos = np.full((B, S), -1, np.int64)
        for i, st in active:
            toks[i, 0] = st.last_token
            pos[i, 0] = st.position
            for j, d in enumerate(drafts[i]):
                toks[i, j + 1] = d
                pos[i, j + 1] = st.position + j + 1
        logits, route_ids = run_step(self._serve_params, toks, pos)
        lg = logits.cpu().numpy()                     # (B, S, V)
        self.metrics["decode_s"] += time.perf_counter() - t0
        # only the verify's routes feed the expert stream and histogram:
        # the draft banks are resident by construction
        rows = [i * S + j for i, _ in active
                for j in range(depth[i] + 1)]
        self._stream_experts(self._host(route_ids), rows)
        n_tok = sum(depth[i] + 1 for i, _ in active)
        e = self.cfg.moe.num_experts
        d = self.cfg.moe.top_k * n_tok
        uniq = e * (1.0 - (1.0 - 1.0 / e) ** d)
        self.metrics["transfer_s_est"] += \
            self._miss_bytes_per_tok * uniq / self.cfg.moe.top_k \
            / self.hw.host_link_bw
        # -- acceptance -------------------------------------------------
        keep = np.full((B,), np.iinfo(np.int32).max // 2, np.int64)
        emitted: Dict[int, List[int]] = {}
        for i, st in active:
            k_i = depth[i]
            temp, top_k = self._sampling_of(st.req, temperature)
            if temp <= 0.0:
                targets = [self._greedy_np(lg[i, j])
                           for j in range(k_i + 1)]
                a = 0
                while a < k_i and drafts[i][a] == targets[a]:
                    a += 1
                out = drafts[i][:a] + [targets[a]]
            else:
                if u_acc is None:
                    u_acc = self._uniforms((B, max(K, 1)))
                    u_res = self._uniforms((B, S))
                p = np.stack([self._probs_np(lg[i, j], temp, top_k)
                              for j in range(k_i + 1)])
                q = np.stack(q_rows[i]) if k_i \
                    else np.zeros((0, p.shape[1]))
                a, final = speculative_verify(
                    np.asarray(drafts[i][:k_i], np.int64), q, p,
                    u_acc[i, :k_i], u_res[i, :k_i + 1])
                out = drafts[i][:a] + [final]
            emitted[i] = out
            keep[i] = st.position + len(out) - 1   # last accepted position
            self.metrics["spec_proposed"] += k_i
            self.metrics["spec_accepted"] += len(out) - 1
        # -- rollback of the rejected tail (tags only) ------------------
        if any(depth[i] for i, _ in active):
            if self.paged:
                self.kv_pool = self.model.paged_rollback(
                    self.kv_pool, pt, self._tensor(keep))
            else:
                self.cache = self.model.rollback_slots(
                    self.cache, self._tensor(keep))
        self._update_kv_metrics(active)
        self.metrics["iterations"] += 1
        if self.metrics["spec_proposed"]:
            self.metrics["acceptance_rate"] = \
                self.metrics["spec_accepted"] \
                / self.metrics["spec_proposed"]
        now = time.perf_counter()
        for i, st in active:
            for tok in emitted[i]:
                st.req.out_tokens.append(int(tok))
            self.metrics["tokens_generated"] += len(emitted[i])
            st.position += len(emitted[i])
            st.last_token = int(emitted[i][-1])
            if st.req.done():
                self.scheduler.retire(i, now=now)
                self._release_slot_kv(i)
                retired.append(st.req.rid)
            elif self.paged and depth[i]:
                # free pages that hold only rejected tokens (their tags
                # were invalidated above); speculative spans are pre-wrap
                # by the depth clamp, so the live ring is the prefix
                # 0..position-1
                self.kv_alloc.truncate(i, st.position)
        return retired

    def run_iteration(self, *, admit: bool = True,
                      temperature: float = 0.0) -> List[int]:
        """One scheduler iteration: join new requests into free slots,
        decode ONE token for every active slot, retire finished requests.
        Returns the rids retired this iteration."""
        if self._plan_result is None:
            raise RuntimeError(
                "no active plan: apply_target() or configure() first")
        self._require_usable()
        retired: List[int] = []
        if admit:
            for slot, req in self.scheduler.admit():
                rid = self._prefill_slot(slot, req, temperature)
                if rid is not None:
                    retired.append(rid)
        active = self.scheduler.active()
        if not active:
            return retired
        if self.speculate_k > 0:
            # ladder-draft speculation replaces the one-token body below
            return self._spec_iteration(active, temperature, retired)
        toks = np.zeros((self.max_slots, 1), np.int64)
        pos = np.full((self.max_slots,), -1, np.int64)  # idle rows masked
        for i, st in active:
            toks[i, 0] = st.last_token
            pos[i] = st.position
        if self.paged:
            # map the chunk each active slot's ring write lands in BEFORE
            # the step (host-side page table, device-side pool)
            for i, st in active:
                self.kv_alloc.ensure_index(i, st.position % self.window)
        route_ids = None
        if self.config.overlap:
            # overlap mode: the per-layer lookahead pipeline streams the
            # experts itself
            logits = self._decode_pipelined(toks, pos,
                                            [i for i, _ in active])
        else:
            t0 = time.perf_counter()
            if self.paged:
                logits, self.kv_pool, route_ids = \
                    self.model.paged_decode_step_routed(
                        self._serve_params, self.kv_pool,
                        self._page_table(), self._tensor(toks),
                        self._tensor(pos), window=self.window)
            else:
                logits, self.cache, route_ids = \
                    self.model.decode_step_routed(
                        self._serve_params, self.cache, self._tensor(toks),
                        self._tensor(pos))
            logits = self._gathered(logits)
            _sync(self.device)
            self.metrics["decode_s"] += time.perf_counter() - t0
        self._update_kv_metrics(active)
        self.metrics["iterations"] += 1
        if any(st.req.sampling is not None for _, st in active):
            new_toks = np.zeros((self.max_slots,), np.int64)
            for i, st in active:
                temp, top_k = self._sampling_of(st.req, temperature)
                new_toks[i] = int(sample(
                    logits[i:i + 1], generator=self._generator,
                    temperature=temp, top_k=top_k,
                    vocab_size=self.cfg.vocab_size)[0])
        else:
            new_toks = sample(logits, generator=self._generator,
                              temperature=temperature,
                              vocab_size=self.cfg.vocab_size).cpu().numpy()
        if route_ids is not None:     # the pipeline streams inline
            self._stream_experts(self._host(route_ids),
                                 [i for i, _ in active])
        # analytical cross-check: expected UNIQUE streamed bytes of this
        # iteration under uniform routing
        e = self.cfg.moe.num_experts
        d = self.cfg.moe.top_k * len(active)
        uniq = e * (1.0 - (1.0 - 1.0 / e) ** d)
        self.metrics["transfer_s_est"] += \
            self._miss_bytes_per_tok * uniq / self.cfg.moe.top_k \
            / self.hw.host_link_bw
        now = time.perf_counter()
        for i, st in active:
            st.req.out_tokens.append(int(new_toks[i]))
            self.metrics["tokens_generated"] += 1
            st.position += 1
            st.last_token = int(new_toks[i])
            if st.req.done():
                self.scheduler.retire(i, now=now)
                self._release_slot_kv(i)
                retired.append(st.req.rid)
        return retired

    def step(self, *, temperature: float = 0.0, seed: Optional[int] = None
             ) -> int:
        """Serve until the queue and all slots are empty; returns the
        number of requests finished by this call."""
        if self._plan_result is None:
            raise RuntimeError(
                "no active plan: apply_target() or configure() first")
        if seed is not None:
            self._generator.manual_seed(seed)
        finished = 0
        while self.scheduler.has_work():
            finished += len(self.run_iteration(temperature=temperature))
        return finished

    # ------------------------------------------------------------------
    # Reporting
    # ------------------------------------------------------------------
    def throughput_tokens_per_s(self, include_transfer: bool = True
                                ) -> float:
        """Measured tokens/s. ``include_transfer`` charges the EXPOSED
        transfer time only: for serial staging that is all of the blocked
        transfer time; in overlap mode the hidden part already overlaps
        decode and is not counted twice."""
        t = self.metrics["decode_s"]
        if include_transfer:
            t += self.metrics["transfer_exposed_s"]
        return self.metrics["tokens_generated"] / max(t, 1e-9)

    def measured_overlap_efficiency(self) -> Optional[float]:
        """Measured overlap window as a fraction of decode compute, the
        run-time counterpart of ``HardwareModel.overlap_efficiency`` (a
        LOWER bound when every transfer hid). None until any expert time
        was transferred."""
        total = self.metrics["transfer_s"] + self.metrics["prefetch_s"]
        if total <= 0 or self.metrics["decode_s"] <= 0:
            return None
        eff = self.metrics["transfer_overlapped_s"] \
            / self.metrics["decode_s"]
        return max(0.0, min(1.0, eff))

    def calibrate_overlap(self) -> Optional[float]:
        """Fold the MEASURED overlap efficiency into the analytic hardware
        model and drop the cached frontier, so later plans rank by the
        transfer time this deployment exposes. Returns the efficiency, or
        None when nothing was measured yet."""
        eff = self.measured_overlap_efficiency()
        if eff is None:
            return None
        self.hw = dataclasses.replace(self.hw, overlap_efficiency=eff)
        self.planner.recalibrate(self.hw)
        self._frontier = None
        return eff

    def close(self):
        """Release the transfer pipeline: drain, then join the async
        cache's workers (no-op for serial staging). A SHARED scoped view
        is only drained — its owner (e.g. the MultiTenantEngine) closes
        the space. Idempotent; the engine must not decode afterwards."""
        if self._owns_cache:
            self.expert_cache.close()
        else:
            self.expert_cache.drain()

    def latency_percentiles(self, qs=(50, 95),
                            last_n: Optional[int] = None
                            ) -> Dict[str, float]:
        return self.scheduler.latency_percentiles(qs, last_n=last_n)

    def reset_counters(self):
        """Zero the throughput counters (between benchmark operating
        points); plan/reconfig counters are preserved."""
        for k in ("tokens_generated", "decode_s", "prefill_s",
                  "transfer_s", "transfer_s_est", "stage_s",
                  "prefetch_s", "transfer_exposed_s",
                  "transfer_overlapped_s",
                  "expert_accesses", "expert_fetches", "iterations",
                  "kv_alloc_byte_iters", "kv_used_byte_iters",
                  "spec_proposed", "spec_accepted", "acceptance_rate"):
            self.metrics[k] = 0 if isinstance(self.metrics[k], int) else 0.0
        self.expert_cache.stats.reset()

    def summary(self) -> str:
        p = self._plan_result
        lat = self.latency_percentiles()
        m = self.metrics
        overlap = ""
        if self.config.overlap or m["prefetch_s"] \
                or m["transfer_overlapped_s"]:
            overlap = (f" xfer[prefetch={m['prefetch_s']:.3f}s"
                       f" exposed={m['transfer_exposed_s']:.3f}s"
                       f" hidden={m['transfer_overlapped_s']:.3f}s]")
        rungs = [b for b in p.plan.ladder if b < 16]
        if len(rungs) <= 1:
            knobs = (f"E{rungs[0] if rungs else 4}="
                     f"{p.plan.num_q_experts}/{p.plan.quant.size}")
        else:
            knobs = "E[" + ",".join(
                f"{b}b={int((p.plan.bits == b).sum())}"
                for b in rungs) + f"]/{p.plan.bits.size}"
        it = max(m["iterations"], 1)
        kv = (f" kv[{'paged' if self.paged else 'slots'}"
              f" alloc={m['kv_alloc_byte_iters'] / it / 2**20:.2f}MiB"
              f" used={m['kv_used_byte_iters'] / it / 2**20:.2f}MiB"
              f" waste={self.kv_waste_fraction():.0%}]")
        if m["spec_proposed"]:
            kv += (f" spec[k={self.speculate_k}"
                   f" acc={m['acceptance_rate']:.0%}"
                   f" {m['spec_accepted']}/{m['spec_proposed']}]")
        return (f"plan[{p.preference} {knobs}"
                f" res={p.plan.resident_fraction():.0%}]"
                f" gen={m['tokens_generated']}tok"
                f" decode={m['decode_s']:.2f}s"
                f" +transfer={m['transfer_s']:.3f}s"
                f" (est {m['transfer_s_est']:.3f}s)" + overlap + kv +
                f" -> {self.throughput_tokens_per_s():.2f} tok/s"
                f" p50={lat['p50']*1e3:.0f}ms p95={lat['p95']*1e3:.0f}ms")
