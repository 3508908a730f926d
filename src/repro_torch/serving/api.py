"""Public serving surface — declarative QoS API (``repro.serving.api``).

Callers declare *targets*, not knob values: a deployment states a
:class:`~repro_torch.core.pareto.QoSTarget` (min tokens/s, max quality
loss, memory budget), each request a :class:`RequestSLO` and
:class:`SamplingParams`; the engine picks the MoP configuration off its
:class:`~repro_torch.core.pareto.ParetoFrontier`.

    engine = build_engine(cfg, params, EngineConfig(max_slots=4))
    engine.apply_target(QoSTarget(mem_budget_bytes=40e9))
    rid = engine.submit_request(ServeRequest(prompt, max_new_tokens=8))
    engine.step()
    print(engine.result(rid))
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.pareto import (  # noqa: F401  (public re-exports)
    FrontierPoint, InfeasibleTarget, ParetoFrontier, QoSTarget,
)
from repro_torch.serving.multi import (  # noqa: F401  (public re-exports)
    MultiTenantEngine, ReplanReport, ResourceArbiter, TenantSpec,
)
from repro_torch.serving.scheduler import (  # noqa: F401  (public re-exports)
    Request, RequestSLO, SamplingParams,
)

__all__ = [
    "EngineConfig", "SamplingParams", "RequestSLO", "ServeRequest",
    "ServeResult", "QoSTarget", "FrontierPoint", "ParetoFrontier",
    "InfeasibleTarget", "build_engine",
    "MultiTenantEngine", "TenantSpec", "ResourceArbiter", "ReplanReport",
]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Typed construction parameters for the serving engine; the fields
    and defaults are the reference's.

    Capacity: ``max_slots`` (decode batch width), ``max_len`` (per-slot
    KV window), ``max_active_tokens`` / ``max_queue`` (admission control).
    Expert streaming: ``swap_bytes`` — device LRU swap capacity for
    non-resident experts; ``prefetch`` — the speculative prefetching
    cache; ``overlap`` — async overlapped streaming (DESIGN.md §12):
    transfers run on an ``AsyncExpertCache`` worker pool, each worker on
    its own CUDA stream, and decode runs the per-layer lookahead pipeline;
    ``overlap_efficiency`` seeds the analytic overlap window (``None`` =
    0.85 with overlap on, 0.0 off), refined by ``calibrate_overlap()``.
    Precision: ``ladder`` — the deployment's precision ladder (e.g.
    ``(16, 8, 4)``). ``use_kernel`` runs the expert FFN on the CUDA
    dequant-matmul kernels. KV cache (DESIGN.md §13): ``paged_kv`` (the
    default) serves through fixed-size pages and a per-slot page table,
    bit-identical to the slot cache (``paged_kv=False``); ``page_size``
    tokens per page; ``kv_pool_pages`` — the pool size incl. the null page
    (``None`` = worst case; a smaller pool derives an admission cap);
    ``kv_reserve`` credits the HBM a smaller pool reclaims to the target's
    memory budget. Speculative decode (DESIGN.md §17): ``speculate`` — the
    draft depth K of ladder-draft speculation (every expert at the lowest
    rung drafts, one verify at the serving plan accepts; greedy output is
    token-identical to plain decode). ``hw`` — analytic hardware model;
    None measures the host link on the device and uses the H100 defaults
    otherwise.

    Expert parallelism: ``ep`` — the EP shard count the planner rounds
    every bank to (DESIGN.md §16); an engine built with a mesh
    (``build_engine(..., mesh=)``, ``serving.ep.build_ep_engine``) takes
    the mesh's model size.
    """
    max_slots: int = 8
    max_len: int = 256
    use_kernel: bool = False
    max_active_tokens: Optional[int] = None
    max_queue: Optional[int] = None
    swap_bytes: Optional[int] = None
    prefetch: bool = False
    overlap: bool = False
    overlap_efficiency: Optional[float] = None
    ladder: Optional[Tuple[int, ...]] = None
    hw: Optional[HardwareModel] = None
    paged_kv: bool = True
    page_size: int = 16
    kv_pool_pages: Optional[int] = None
    kv_reserve: bool = False
    ep: int = 1
    speculate: int = 0


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One generation request on the declarative surface."""
    prompt: np.ndarray
    max_new_tokens: int = 16
    sampling: Optional[SamplingParams] = None
    slo: RequestSLO = dataclasses.field(default_factory=RequestSLO)


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """Completed request: tokens + the QoS the request actually got."""
    rid: int
    tokens: List[int]
    latency_s: float
    ttft_s: Optional[float]
    priority: int
    deadline_s: Optional[float]
    deadline_met: Optional[bool]   # None when no deadline was declared

    @classmethod
    def from_request(cls, req: Request) -> "ServeResult":
        if req.t_done is None:
            raise ValueError(f"request {req.rid} is still in flight")
        return cls(rid=req.rid, tokens=list(req.out_tokens),
                   latency_s=req.latency_s, ttft_s=req.ttft_s,
                   priority=req.slo.priority,
                   deadline_s=req.slo.deadline_s,
                   deadline_met=req.deadline_met)

    def summary(self) -> str:
        dl = ("" if self.deadline_met is None else
              f" deadline={'MET' if self.deadline_met else 'MISSED'}")
        return (f"req {self.rid} prio={self.priority}: "
                f"{len(self.tokens)} tok in {self.latency_s * 1e3:.0f} ms"
                + dl)


def results_of(requests: Sequence[Request]) -> List[ServeResult]:
    """Batch conversion helper for completed scheduler requests."""
    return [ServeResult.from_request(r) for r in requests]


def build_engine(cfg, params, config: Optional[EngineConfig] = None, *,
                 device=None, mesh=None, expert_cache=None):
    """Construct an :class:`~repro_torch.serving.engine.
    AdaptiveServingEngine` from an :class:`EngineConfig` on ``device``
    (default: the card; raises on a host without one unless
    ``device="cpu"``), or over the devices of a (data, model) ``mesh``
    (``repro_torch.launch.mesh``): the pure-EP (1, ep) mesh
    (``make_ep_mesh``) shards the expert banks and runs the rest on its
    first device; any other mesh of more than one position (``make_test_
    mesh((2, 2), devices=...)``) also splits the dense compute, the slot
    cache or page pool placed per data rank (``max_slots`` and a given
    ``kv_pool_pages`` must divide over the data ranks, and admission is
    capped per rank), the way the reference's GSPMD serves such a mesh.
    The engine's ``ep`` is the mesh's model size. ``expert_cache`` attaches
    a tenant-scoped view of a shared swap space
    (:meth:`~repro_torch.core.expert_cache.ExpertCache.scoped`) for
    multi-tenant deployments (DESIGN.md §10)."""
    from repro_torch.serving.engine import AdaptiveServingEngine
    return AdaptiveServingEngine(cfg, params, config=config or EngineConfig(),
                                 device=device, mesh=mesh,
                                 expert_cache=expert_cache)
