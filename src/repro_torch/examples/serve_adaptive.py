"""Adaptive continuous-batching serving under a CHANGING memory budget
(``examples/serve_adaptive.py`` of the reference) — the paper's Fig. 1
scenario end to end, on the declarative QoS surface (DESIGN.md §9): a
multi-tenant job manager renegotiates this job's QoSTarget (HBM budget +
tokens/s floor + quality ceiling) while Poisson-arriving requests stream
in. Each phase the QoSController re-selects a Pareto-frontier point and
keeps walking it between decode iterations; placement-only moves apply
MID-FLIGHT (in-flight requests keep their outputs), bank-split moves
drain the slots gracefully first. On the card unless ``--device cpu``
(on the card the expert banks run the CUDA kernels):

    PYTHONPATH=src python -m repro_torch.examples.serve_adaptive \\
        [--device cpu]
"""
import argparse
import math
import time

import numpy as np

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serving.api import (EngineConfig, QoSTarget, RequestSLO,
                                     build_engine)
from repro_torch.serving.driver import drive_poisson
from repro_torch.serving.qos import QoSController

# (time-ordered) QoSTarget schedule; budgets as fractions of the full
# bf16 model size — a synthetic multi-tenant renegotiation trace. Each
# point is applied while the previous point's tail requests are still
# decoding.
TRACE = [
    # plenty of memory, no quality loss tolerated
    dict(frac=1.20, max_quality_loss=0.0, min_tokens_per_s=math.inf),
    # squeezed: chase speed, quality unconstrained
    dict(frac=0.50, min_tokens_per_s=math.inf),
    # same memory, quality-first: cheapest lossless point
    dict(frac=0.50, max_quality_loss=0.0, min_tokens_per_s=1.0),
    # more memory, same quality target — placement-only move, zero drain
    dict(frac=0.80, max_quality_loss=0.0, min_tokens_per_s=1.0),
    # heavy pressure
    dict(frac=0.35, min_tokens_per_s=math.inf),
    # recovered: modest tokens/s floor, mild quality budget
    dict(frac=1.00, max_quality_loss=0.02, min_tokens_per_s=5.0),
]

REQUESTS_PER_PHASE = 6
MEAN_GAP_S = 0.03                 # Poisson arrivals: exp(0.03s) inter-arrival


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(
        num_layers=4, d_model=128, vocab_size=512, vocab_pad_multiple=128)
    params = init_params(cfg, seed=0, device=device)
    engine = build_engine(cfg, params,
                          EngineConfig(max_slots=4, max_len=64,
                                       use_kernel=device.type == "cuda"),
                          device=device)
    controller = QoSController(engine)
    full = engine.planner.size_ne + \
        engine.planner.num_experts_total * engine.planner.size_e16
    rng = np.random.default_rng(0)

    print(f"model {cfg.arch_id}: full bf16 size {full/1e6:.1f} MB, "
          f"{engine.planner.num_experts_total} experts, "
          f"{engine.max_slots} decode slots, frontier of "
          f"{len(engine.frontier.points)} points, on {device}")
    for i, ph in enumerate(TRACE):
        target = QoSTarget(
            mem_budget_bytes=full * ph["frac"],
            min_tokens_per_s=ph.get("min_tokens_per_s"),
            max_quality_loss=ph.get("max_quality_loss"))
        in_flight = engine.scheduler.num_active
        phase_start = time.perf_counter()   # drain completions count here
        reconfig0 = engine.metrics["reconfig_s"]
        point = controller.set_target(target)   # mid-flight renegotiation
        # the engine's own accounting: replan/re-specialization time only
        # (a graceful drain is ordinary decoding, reported separately)
        dt = engine.metrics["reconfig_s"] - reconfig0
        d = engine.metrics.get("last_delta_traffic_gib", 0.0)
        print(f"\n[t={i}] target[{target.describe()}]"
              f" -> {point.summary()}")
        print(f"      reconfig {dt*1e3:.0f} ms with {in_flight} request(s)"
              f" in flight (delta traffic {d:.3f} GiB,"
              f" drains so far {engine.metrics['drains']})")
        # Poisson arrival process for this phase, every other request at
        # elevated priority with a deadline; the QoSController steps
        # between iterations. The LAST phase runs to empty, earlier
        # phases leave their tail in flight so the next set_target
        # exercises mid-flight reconfiguration.
        drive_poisson(engine, rng,
                      n_requests=REQUESTS_PER_PHASE,
                      mean_gap_s=MEAN_GAP_S,
                      prompt_len=lambda r: int(r.integers(6, 16)),
                      max_new_tokens=lambda r: int(r.integers(4, 13)),
                      slo=lambda r: RequestSLO(priority=int(r.integers(2)),
                                               deadline_s=20.0),
                      on_iteration=controller.step,
                      drain=(i == len(TRACE) - 1))
        # latency over requests COMPLETED during this phase only
        lats = [r.latency_s for r in engine.done.values()
                if r.t_done is not None and r.t_done >= phase_start]
        lat = {q: float(np.percentile(lats, q)) if lats else 0.0
               for q in (50, 95)}
        print(f"      {len(engine.done)} done total | {engine.summary()}")
        print(f"      {controller.summary()}")
        print(f"      phase latency p50 {lat[50]*1e3:.0f} ms "
              f"p95 {lat[95]*1e3:.0f} ms | "
              f"expert fetches {engine.metrics['expert_fetches']}"
              f"/{engine.metrics['expert_accesses']} accesses")

    met = [r.deadline_met for r in engine.done.values()
           if r.deadline_met is not None]
    m = engine.metrics
    print(f"\ntotals: {m['tokens_generated']} tokens over "
          f"{m['iterations']} iterations, "
          f"{m['reconfigs']} reconfigs ({m['reconfig_s']:.2f}s, "
          f"{m['drains']} drains), decode {m['decode_s']:.2f}s, "
          f"transfer {m['transfer_s']:.3f}s "
          f"(est {m['transfer_s_est']:.3f}s); "
          f"deadlines met {sum(met)}/{len(met)}")
    engine.close()


if __name__ == "__main__":
    main()
