"""Adaptive MoE serving engine — continuous batching over fixed decode
slots (``repro.serving.engine``'s single-device, synchronous path).

  * ``ContinuousScheduler`` (serving/scheduler.py) owns requests: the
    admission queue, per-slot request state, join/retire at EVERY decode
    iteration.
  * this engine owns the model side: one slot KV cache of ``max_slots``
    rows, a decode step over the full slot count (idle slots ride along
    masked by position=-1) and prefill-into-slot, so a new request joins a
    live batch without re-padding it.
  * the runtime expert path: non-resident experts under the active
    ``PrecisionPlan`` are fetched through the ``ExpertCache``
    (core/expert_cache.py) from the routed expert ids of every decode
    iteration; ``metrics`` reports the MEASURED ``transfer_s`` /
    ``miss_rate_measured`` next to the analytical ``transfer_s_est`` /
    ``miss_rate``.

The train-layout master copy of the weights stays where the caller put it
(on the card in a real deployment). ``_fetch_expert`` quantizes an expert
there, at the rung the plan assigns it, and keeps the result as a pinned
host blob that the expert cache copies back to the card; as in the
reference on one device, the serve-layout banks stay resident, so the
transfers are measured but not consumed by the matmuls.

Reconfiguration is safe mid-flight: placement-only replans apply between
decode iterations; a bank-split change first DRAINS the active slots, then
rebuilds the serve-layout banks (``metrics["reconfig_s"]``).

Not in this slice (each raises ``NotImplementedError`` at construction):
the paged KV cache, the async overlap pipeline, the prefetching cache,
speculative decoding and expert parallelism.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import (RUNG_QUALITY_COST, HardwareModel,
                                         expert_access_stats,
                                         kv_bytes_bucketed, kv_token_bytes)
from repro_torch.core.expert_cache import ExpertCache
from repro_torch.core.pareto import FrontierPoint, ParetoFrontier, QoSTarget
from repro_torch.core.planner import AdaptivePlanner, PlanResult
from repro_torch.core.precision_plan import (HOST, PrecisionPlan,
                                             quantized_rungs)
from repro_torch.core.quantization import quantize
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, apply_precision_plan, build_model
from repro_torch.serving.api import EngineConfig, ServeRequest, ServeResult
from repro_torch.serving.metrics import base_metrics
from repro_torch.serving.sampler import sample
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
    """Continuous-batching adaptive engine on one device.

    Construct through :func:`repro_torch.serving.api.build_engine` or
    ``AdaptiveServingEngine(cfg, params, config=EngineConfig(...))``;
    ``device=None`` means the card."""

    def __init__(self, cfg: ModelConfig, params, *,
                 config: Optional[EngineConfig] = None, device=None):
        if cfg.moe is None:
            raise ValueError("the adaptive engine serves MoE models")
        self.device = resolve_device(device)
        config = config or EngineConfig()
        for flag, later in (
                (config.paged_kv, "paged_kv=True (the paged KV cache)"),
                (config.overlap, "overlap=True (the async overlap "
                                 "pipeline)"),
                (config.prefetch, "prefetch=True (the prefetching expert "
                                  "cache)"),
                (config.speculate > 0, "speculate>0 (speculative "
                                       "decoding)"),
                (config.ep > 1, "ep>1 (expert parallelism)")):
            if flag:
                raise NotImplementedError(
                    f"EngineConfig({later}) is a later slice of the "
                    "PyTorch port; this engine serves the slot KV cache "
                    "synchronously on one device (pass paged_kv=False)")
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
            self.hw = HardwareModel(
                host_link_bw=measure_host_link_bw(self.device),
                overlap_efficiency=float(config.overlap_efficiency or 0.0))
        self.planner = AdaptivePlanner(cfg, hw=self.hw, ep=1)
        self.model: Model = build_model(cfg, use_kernel=self.use_kernel)
        self._kv_token_bytes = kv_token_bytes(cfg)
        self.cache = self.model.init_cache(self.max_slots, self.max_len,
                                           device=self.device)
        self.window = int(self.cache["k"].shape[2])
        self.scheduler = ContinuousScheduler(SchedulerConfig(
            max_slots=self.max_slots, max_len=self.max_len,
            max_prompt_len=self.window,
            max_active_tokens=config.max_active_tokens,
            max_queue=config.max_queue))
        self.expert_cache = ExpertCache(
            self._fetch_expert,
            capacity_bytes=config.swap_bytes
            or 4 * max(cfg.expert_param_bytes(16), 1),
            device=self.device)
        #: accumulated routed-access histogram [L, E] over TRUE expert ids
        self.route_counts: np.ndarray = np.zeros(
            (cfg.num_layers, cfg.moe.num_experts), np.int64)
        self._host_store: Dict[Tuple[int, int], Any] = {}
        self._resident: set = set()
        self._miss_bytes_per_tok = 0.0
        self._order: Optional[np.ndarray] = None   # bank slot -> expert id
        self._serve_params = None
        self._plan_result: Optional[PlanResult] = None
        self._frontier: Optional[ParetoFrontier] = None
        self._target: Optional[QoSTarget] = None
        self._active_point: Optional[FrontierPoint] = None
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self.metrics: Dict[str, Any] = base_metrics()
        self.metrics["kv_capacity_bytes"] = kv_bytes_bucketed(
            cfg, self.max_slots, self.window)

    @property
    def queue(self):
        """The scheduler's admission queue."""
        return self.scheduler.queue

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
        point = self.frontier.select(target)
        self._target = target
        self.apply_frontier_point(point)
        return point

    def apply_frontier_point(self, point: FrontierPoint) -> PlanResult:
        """Apply one frontier point: the point's exact device footprint is
        the budget and its per-rung counts are the quality knobs."""
        counts = point.quantized_counts() if point.counts_per_rung \
            else None
        result = self._reconfigure(float(point.qos.device_bytes),
                                   "quality", point.num_q_experts,
                                   counts=counts)
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
                     counts=None) -> PlanResult:
        """Replan under new constraints; safe with requests in flight.
        Placement-only changes apply immediately; a bank-split change
        drains the active slots first."""
        t0 = time.perf_counter()
        result, _ = self.planner.replan(
            mem_budget_bytes, preference, num_q_experts,
            batch_size=self.max_slots, counts=counts)
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
            self._serve_params = None       # free the old banks first
            self._serve_params = apply_precision_plan(
                self.params_train, self.cfg, plan)
            self._host_store.clear()
            self.expert_cache.invalidate()
        self._plan_result = result
        self._order = plan.expert_order()
        newly_resident = {(int(li), int(ei)) for li, ei
                          in np.argwhere(plan.location != HOST)}
        if not rebuild:
            # same bank shapes can still assign different rungs to experts
            rung_changed = set()
            if (prev_plan.bits != plan.bits).any():
                self._serve_params = apply_precision_plan(
                    self.params_train, self.cfg, plan)
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
        hit, self._miss_bytes_per_tok = expert_access_stats(self.cfg, plan)
        self.metrics["miss_rate"] = 1.0 - hit
        self.metrics["reconfig_s"] += time.perf_counter() - t0 - drain_s
        self.metrics["reconfigs"] += 1
        return result

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
        # serial staging blocks the critical path for every transferred
        # second — all of it is EXPOSED
        self.metrics["transfer_exposed_s"] += \
            st.transfer_s + st.prefetch_s - blocked0
        self._finish_stream_metrics()

    def _finish_stream_metrics(self):
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

    # -- iteration-level serving ----------------------------------------
    @staticmethod
    def _sampling_of(req: Request, default_temperature: float
                     ) -> Tuple[float, int]:
        if req.sampling is not None:
            return req.sampling.temperature, req.sampling.top_k
        return default_temperature, 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill_slot(self, slot: int, req: Request,
                      temperature: float) -> Optional[int]:
        """Join ``req`` into ``slot``; returns its rid if it already
        retired (max_new_tokens == 1), else None."""
        s = len(req.prompt)
        sb = _bucket(s, hi=self.window)
        toks = np.zeros((1, sb), np.int64)
        pos = np.full((1, sb), -1, np.int64)
        toks[0, :s] = req.prompt
        pos[0, :s] = np.arange(s)
        t0 = time.perf_counter()
        logits, self.cache = self.model.prefill_into_slot(
            self._serve_params, self.cache, self._tensor(toks),
            self._tensor(pos), slot, s - 1)
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
        """Retire a slot's KV: invalidate the row's position tags."""
        self.cache = self.model.reset_slot(self.cache, slot)

    def _update_kv_metrics(self, active):
        tb = self._kv_token_bytes
        used = sum(min(st.position + 1, self.window)
                   for _, st in active) * tb
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

    def run_iteration(self, *, admit: bool = True,
                      temperature: float = 0.0) -> List[int]:
        """One scheduler iteration: join new requests into free slots,
        decode ONE token for every active slot, retire finished requests.
        Returns the rids retired this iteration."""
        if self._plan_result is None:
            raise RuntimeError(
                "no active plan: apply_target() or configure() first")
        retired: List[int] = []
        if admit:
            for slot, req in self.scheduler.admit():
                rid = self._prefill_slot(slot, req, temperature)
                if rid is not None:
                    retired.append(rid)
        active = self.scheduler.active()
        if not active:
            return retired
        toks = np.zeros((self.max_slots, 1), np.int64)
        pos = np.full((self.max_slots,), -1, np.int64)  # idle rows masked
        for i, st in active:
            toks[i, 0] = st.last_token
            pos[i] = st.position
        t0 = time.perf_counter()
        logits, self.cache, route_ids = self.model.decode_step_routed(
            self._serve_params, self.cache, self._tensor(toks),
            self._tensor(pos))
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
        self._stream_experts(route_ids.cpu().numpy(),
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
        """Measured tokens/s over decode time (+ exposed transfer time)."""
        t = self.metrics["decode_s"]
        if include_transfer:
            t += self.metrics["transfer_exposed_s"]
        return self.metrics["tokens_generated"] / max(t, 1e-9)

    def close(self):
        """Release the transfer pipeline (no workers in the sync cache)."""
        self.expert_cache.close()

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
        rungs = [b for b in p.plan.ladder if b < 16]
        if len(rungs) <= 1:
            knobs = (f"E{rungs[0] if rungs else 4}="
                     f"{p.plan.num_q_experts}/{p.plan.quant.size}")
        else:
            knobs = "E[" + ",".join(
                f"{b}b={int((p.plan.bits == b).sum())}"
                for b in rungs) + f"]/{p.plan.bits.size}"
        it = max(m["iterations"], 1)
        kv = (f" kv[slots alloc={m['kv_alloc_byte_iters'] / it / 2**20:.2f}"
              f"MiB used={m['kv_used_byte_iters'] / it / 2**20:.2f}MiB"
              f" waste={self.kv_waste_fraction():.0%}]")
        return (f"plan[{p.preference} {knobs}"
                f" res={p.plan.resident_fraction():.0%}]"
                f" gen={m['tokens_generated']}tok"
                f" decode={m['decode_s']:.2f}s"
                f" +transfer={m['transfer_s']:.3f}s"
                f" (est {m['transfer_s_est']:.3f}s)" + kv +
                f" -> {self.throughput_tokens_per_s():.2f} tok/s"
                f" p50={lat['p50']*1e3:.0f}ms p95={lat['p95']*1e3:.0f}ms")
