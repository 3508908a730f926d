"""Two MoE tenants under ONE memory envelope (``examples/multi_tenant.py``
of the reference) — the multi-tenant arbitration + partial-
reconfiguration path end to end on REAL engines (DESIGN.md §10): a
latency-hungry "chat" tenant and a quality-pinned "batch" tenant each run
their own continuous-batching engine, frontier and QoS controller; the
ResourceArbiter water-fills one shared HBM budget across them, expert
streaming goes through one tenant-namespaced swap space, and a mid-run
budget shrink triggers exactly one joint re-arbitration whose migrations
touch only the diffed experts. On the card unless ``--device cpu`` (on
the card the expert banks run the CUDA kernels); the per-tenant trace is
asserted:

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant \\
        [--device cpu]
"""
import argparse
import math

import numpy as np

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.expert_cache import ExpertCache
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serving.api import (EngineConfig, MultiTenantEngine,
                                     QoSTarget, RequestSLO, TenantSpec,
                                     build_engine)
from repro_torch.serving.qos import QoSControllerConfig

REQUESTS_PER_WAVE = 3
MAX_NEW_TOKENS = 5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(
        num_layers=4, d_model=128, vocab_size=512, vocab_pad_multiple=128)
    total_experts = cfg.num_layers * cfg.moe.num_experts
    full16 = cfg.non_expert_bytes() \
        + total_experts * cfg.expert_param_bytes(16)

    # one shared, tenant-namespaced expert swap space (DESIGN.md §10.1)
    shared = ExpertCache(capacity_bytes=max(
        8 * cfg.expert_param_bytes(16), 1 << 20), device=device)
    mt = MultiTenantEngine(
        budget_bytes=1.1 * full16, expert_cache=shared,
        controller_config=QoSControllerConfig(
            min_dwell_iterations=4, window_iterations=2), device=device)

    specs = [
        # chat: as fast as possible, quality negotiable, double weight
        TenantSpec("chat", QoSTarget(min_tokens_per_s=math.inf),
                   weight=2.0),
        # batch: zero quality loss tolerated, throughput best-effort
        TenantSpec("batch", QoSTarget(max_quality_loss=0.0)),
    ]
    for i, spec in enumerate(specs):
        params = init_params(cfg, seed=i, device=device)  # independent
        engine = build_engine(
            cfg, params, EngineConfig(max_slots=2,
                                      max_len=16 + MAX_NEW_TOKENS,
                                      use_kernel=device.type == "cuda"),
            device=device, expert_cache=shared.scoped(spec.name))
        mt.add_tenant(spec, engine)

    sel = mt.arbitrate()
    print(f"[mt] {len(specs)} tenants, budget "
          f"{mt.budget_bytes / 1e6:.1f} MB, full bf16 model "
          f"{full16 / 1e6:.1f} MB each, on {device}")
    for name, point in sel.items():
        print(f"[mt]   {name}: {point.summary()}")

    # --- asserted per-tenant trace: initial joint selection ---------------
    assert mt.metrics["arbitrations"] == 1
    assert sel["chat"] is not sel["batch"], \
        "different SLOs must land on different frontier points"
    assert sel["batch"].qos.quality_proxy == 1.0, \
        "quality-pinned tenant must stay lossless"
    assert sel["chat"].num_q_experts > 0, \
        "speed-chasing tenant should quantize experts"
    used = sum(p.qos.device_bytes for p in sel.values())
    assert used <= mt.budget_bytes

    rng = np.random.default_rng(0)

    def wave(tag):
        rids = {}
        for name, t in mt.tenants.items():
            rids[name] = [t.engine.submit(
                rng.integers(1, cfg.vocab_size, 8),
                max_new_tokens=MAX_NEW_TOKENS,
                slo=RequestSLO(priority=1 if name == "chat" else 0))
                for _ in range(REQUESTS_PER_WAVE)]
        while mt.has_work():
            mt.run_iteration(temperature=0.7)
        for name, t in mt.tenants.items():
            done = [r for r in rids[name] if r in t.engine.done]
            assert len(done) == REQUESTS_PER_WAVE, \
                f"{name}: {len(done)}/{REQUESTS_PER_WAVE} completed"
            lat = t.engine.latency_percentiles()
            print(f"[{tag}] {name}: {REQUESTS_PER_WAVE} requests done, "
                  f"{t.engine.metrics['tokens_generated']} tokens total, "
                  f"p50 {lat['p50'] * 1e3:.0f} ms | alloc "
                  f"{t.allocated_bytes / 1e6:.1f} MB")
        return rids

    wave("phase-1")

    # --- the job manager shrinks the envelope: ONE joint re-arbitration ---
    replans0 = mt.metrics["replans"]
    mt.set_budget(0.55 * full16)
    assert mt.metrics["arbitrations"] == 2, \
        "a budget shrink must trigger exactly one joint re-arbitration"
    moved = mt.reports[replans0:]
    assert moved, "the shrink must have replanned at least one tenant"
    for r in moved:
        assert 0 <= r.migrated_experts < total_experts, \
            "partial reconfiguration must not re-stream the full expert set"
        print(f"[shrink] {r.summary()}")
    for name, t in mt.tenants.items():
        assert t.point.qos.device_bytes <= t.allocated_bytes * 1.001
    used = sum(t.point.qos.device_bytes for t in mt.tenants.values())
    assert used <= mt.budget_bytes

    wave("phase-2")
    assert mt.metrics["arbitrations"] == 2, \
        "steady traffic after the shrink must not re-arbitrate (no storm)"

    # shared swap: every tenant streamed through its own namespace
    for name, t in mt.tenants.items():
        assert t.cache_view.parent is shared
    print(f"[mt] shared swap: {shared.stats.misses} misses / "
          f"{shared.stats.hits} hits, "
          f"{shared.stats.bytes_in / 1e6:.2f} MB staged, "
          f"{shared.stats.evictions} evictions")
    print(mt.summary())
    mt.close()
    print("[mt] OK — per-tenant trace asserted")


if __name__ == "__main__":
    main()
