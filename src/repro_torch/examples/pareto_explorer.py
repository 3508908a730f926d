"""Pareto explorer (``examples/pareto_explorer.py`` of the reference) —
the paper's core contribution as a picture.

Builds the first-class :class:`ParetoFrontier` (core/pareto.py) over the
full (Num_E4 × residency) configuration space for the REAL Mixtral-8x7B
config, prints the budget-constrained design space with its Pareto
frontier — the fine-grained configuration space of paper Figs. 2+3 — and
then resolves a few declarative :class:`QoSTarget` queries against it,
the way a deployment would (DESIGN.md §9). Host-only (planner and
frontier under the port's default ``HardwareModel``, the H100's), so it
takes no device.

With ``--ladder 16,8,4`` the configuration space opens up to per-expert
bit-widths (DESIGN.md §11): each frontier point then reports its expert
count per ladder rung instead of a single Num_E4.

    PYTHONPATH=src python -m repro_torch.examples.pareto_explorer \
        [--budget-gb 40] [--min-tps 5] [--max-ppl-x 1.05] \
        [--ladder 16,8,4]
"""
import argparse
import dataclasses
import math

from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.pareto import InfeasibleTarget, QoSTarget
from repro_torch.core.planner import AdaptivePlanner


def bar(x, lo, hi, width=32):
    n = int((x - lo) / max(hi - lo, 1e-9) * width)
    return "#" * n + "." * (width - n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget-gb", type=float, default=40.0)
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--min-tps", type=float, default=None,
                    help="demo QoSTarget: minimum tokens/s")
    ap.add_argument("--max-ppl-x", type=float, default=None,
                    help="demo QoSTarget: perplexity ceiling, e.g. 1.05")
    ap.add_argument("--ladder", default=None,
                    help="precision ladder as descending CSV rungs, e.g. "
                         "'16,8,4' — opens per-expert mixed precision "
                         "(DESIGN.md §11)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.ladder:
        ladder = tuple(int(b) for b in args.ladder.split(","))
        cfg = cfg.replace(mop=dataclasses.replace(cfg.mop, ladder=ladder))
    planner = AdaptivePlanner(cfg, hw=HardwareModel())
    frontier = planner.frontier(batch_size=args.batch)
    budget = args.budget_gb * 1e9

    results, pareto = planner.sweep(budget, batch_size=args.batch)
    lo = min(r.qos.tokens_per_s for r in results)
    hi = max(r.qos.tokens_per_s for r in results)

    ladder = frontier.ladder
    print(f"{cfg.arch_id} @ {args.budget_gb} GB budget "
          f"(H100 model, batch={args.batch}, ladder={ladder}); "
          f"frontier holds {len(frontier.points)} dominant of "
          f"{len(frontier.all_points)} enumerated configs")
    rung_hdr = " ".join(f"{'E' + str(b):>5}" for b in ladder)
    print(f"{rung_hdr} {'resident':>8} {'tok/s':>8} {'ppl-proxy':>9}  "
          f"throughput")
    for i, r in enumerate(results):
        mark = " *" if i in pareto else "  "
        q = r.qos
        counts = r.plan.rung_counts()
        rung_cols = " ".join(f"{counts[b]:5d}" for b in ladder)
        print(f"{rung_cols} "
              f"{r.plan.resident_fraction():8.0%} "
              f"{q.tokens_per_s:8.2f} {q.quality_proxy:9.3f}  "
              f"|{bar(q.tokens_per_s, lo, hi)}|{mark}")
    print("* = Pareto-optimal (throughput vs quality)")
    if len(ladder) > 2:
        print("\nper-rung expert counts per dominant frontier point "
              "(bytes-ascending):")
        for p in frontier.points[::max(1, len(frontier.points) // 12)]:
            print(f"  {p.summary()}")

    # declarative queries: what a tenant actually asks for (DESIGN.md §9)
    targets = [
        QoSTarget(min_tokens_per_s=args.min_tps,
                  max_quality_loss=(args.max_ppl_x - 1.0
                                    if args.max_ppl_x else None),
                  mem_budget_bytes=budget),
        QoSTarget(min_tokens_per_s=math.inf, mem_budget_bytes=budget),
        QoSTarget(max_quality_loss=0.0, min_tokens_per_s=1.0,
                  mem_budget_bytes=budget),
    ]
    print("\ndeclarative queries against the frontier:")
    for t in targets:
        try:
            p = frontier.select(t)
            print(f"  [{t.describe()}] -> {p.summary()}")
        except InfeasibleTarget as e:
            print(f"  [{t.describe()}] -> infeasible: {e}")

    # reconfiguration cost between adjacent Pareto points (paper §3:
    # partial reconfig instead of full reload)
    pts = [results[i] for i in pareto]
    if len(pts) >= 2:
        a, b = pts[0], pts[-1]
        planner.current = a
        counts = {k: v for k, v in b.plan.rung_counts().items() if k < 16}
        _, delta = planner.replan(budget, "quality", counts=counts)
        full = planner.size_ne \
            + planner.num_experts_total * planner.size_e16
        print(f"\nreconfig {a.plan.num_q_experts}->{b.plan.num_q_experts} "
              f"quantized experts: {len(delta['to_quantize'])} quantize, "
              f"{len(delta['to_upload'])} upload, "
              f"traffic {delta['traffic_bytes']/2**30:.2f} GiB "
              f"(vs full reload {full/2**30:.1f} GiB)")


if __name__ == "__main__":
    main()
