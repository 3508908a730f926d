"""Control-plane scenario runner (DESIGN.md §14.6).

Replays a named scenario from the catalog through the trace-driven
control plane and writes the deterministic report — same scenario +
seed, byte-identical file (run a scenario twice and ``cmp`` the
outputs). The frontier uses the port's default ``HardwareModel`` (the
H100's), so a report differs from the JAX package's, whose default is a
TPU v5e chip; given the same hardware model both write the same bytes.

Usage:
  python -m repro_torch.launch.simulate --list
  python -m repro_torch.launch.simulate --scenario diurnal-1k --smoke
  python -m repro_torch.launch.simulate --scenario golden-32 \
      --out results/x.json
  python -m repro_torch.launch.simulate --scenario steady-64 --perf

``--smoke`` shortens the horizon (scenario-declared smoke horizon,
budget shocks past it dropped); ``--perf`` appends a wall-clock scaling
section to the written file AFTER the deterministic body is produced
(perf numbers are machine-dependent by nature, so determinism checks
must compare reports produced without ``--perf``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

from repro_torch.serving.control_plane import (ControlPlane, SCENARIOS,
                                               get_scenario)

DEFAULT_OUT = Path("results") / "sim_control_plane.json"


def run(scenario_name: str, *, seed: int = None, smoke: bool = False,
        perf: bool = False) -> tuple:
    """Returns (report_bytes, plane, wall_s)."""
    scn = get_scenario(scenario_name)
    if smoke:
        scn = scn.smoke()
    if seed is not None:
        scn = dataclasses.replace(scn, seed=seed)
    t0 = time.perf_counter()
    plane = ControlPlane(scn)
    plane.run()
    wall = time.perf_counter() - t0
    body = plane.report_bytes()
    if perf:
        report = json.loads(body)
        virt = scn.horizon_s
        report["perf"] = {
            "wall_s": round(wall, 3),
            "virtual_s": virt,
            "speedup_x": round(virt / max(wall, 1e-9), 1),
            "tenant_virtual_s_per_wall_s": round(
                scn.tenants * virt / max(wall, 1e-9), 1),
        }
        body = (json.dumps(report, sort_keys=True,
                           separators=(",", ":")) + "\n").encode()
    return body, plane, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="trace-driven control-plane simulator")
    ap.add_argument("--scenario", default="steady-64",
                    help="catalog name (see --list)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the scenario's seed")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--smoke", action="store_true",
                    help="shortened horizon for CI")
    ap.add_argument("--perf", action="store_true",
                    help="append machine-dependent wall-clock section")
    ap.add_argument("--list", action="store_true",
                    help="print the scenario catalog and exit")
    ap.add_argument("--check-ceiling", action="store_true",
                    help="exit 1 if violation_rate exceeds the "
                         "scenario's declared ceiling")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(SCENARIOS):
            s = SCENARIOS[name]
            print(f"{name:12s} tenants={s.tenants:<5d} "
                  f"horizon={s.horizon_s:>9.0f}s arrival={s.arrival:8s} "
                  f"shocks={len(s.budget_shocks)} "
                  f"replicas={s.min_replicas}..{s.max_replicas} "
                  f"ceiling={s.violation_ceiling}")
        return 0

    body, plane, wall = run(args.scenario, seed=args.seed,
                            smoke=args.smoke, perf=args.perf)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_bytes(body)

    t = plane.report()["totals"]
    scn = plane.scn
    print(f"[{scn.name}] seed={scn.seed} tenants={scn.tenants} "
          f"horizon={scn.horizon_s:.0f}s wall={wall:.2f}s "
          f"({scn.horizon_s / max(wall, 1e-9):.0f}x realtime)")
    print(f"  goodput={t['goodput_tps']:.1f} tok/s "
          f"violation_rate={t['violation_rate']:.4f} "
          f"preemptions={t['preemptions']} "
          f"scale={t['scale_ups']}up/{t['scale_downs']}down "
          f"arbitrations={t['arbitrations']} replans={t['replans']}")
    print(f"  wrote {args.out}")
    if args.check_ceiling and t["violation_rate"] > scn.violation_ceiling:
        print(f"FAIL: violation_rate {t['violation_rate']:.4f} > "
              f"ceiling {scn.violation_ceiling}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
