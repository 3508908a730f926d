#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` alone on one NVIDIA card, to
iterate on a phase without the whole script:

    python3 tools/chip_phases.py poisson kimi qwen3 kimi-rows
    python3 tools/chip_phases.py families families-train
    python3 tools/chip_phases.py ep
    python3 tools/chip_phases.py ep-cards      # on a host with 4 cards
    python3 tools/chip_phases.py mesh
    python3 tools/chip_phases.py mesh-cards    # on a host with 4 cards
    python3 tools/chip_phases.py roofline dry-cell

``poisson``, ``ep`` (8) and ``ep-cards`` (8 with rank r on ``cuda:r``)
first run the serve phase (3), whose params and point they drive; ``kimi`` is 7b, ``qwen3`` 7c, ``families`` 7d, ``families-train``
7e and ``kimi-rows`` the kernel phase's B3 rows at Kimi-K2's widths;
``mesh`` is 9 (sharded training and MoE over (data, model) meshes on
repeated ``cuda:0``) and ``mesh-cards`` 9 with mesh position p on
``cuda:(p % cards)``; ``roofline`` is 10 (the anchor steps' op counts on
the card and on ``meta``, their times and shares of the bound, and the
split (2, 2) decode's count) and ``dry-cell`` one dry-run cell on the
card's host (``run_cell``, Mixtral ``decode_32k`` over the 256-position
mesh of ``meta``). It
builds the kernels first, prints what the phases print, writes their
records to ``--out`` and exits 1 if a phase failed. ``chip_smoke.py``
stays the check of record: it runs every phase and prints the result
lines.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("poisson", "ep", "ep-cards", "kimi", "qwen3", "families",
          "families-train", "kimi-rows", "mesh", "mesh-cards", "roofline",
          "dry-cell")
CARDS = ("ep-cards", "mesh-cards")              # need several cards


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*", choices=PHASES,
                    help=f"phases to run (default: all of {PHASES} "
                         f"but {CARDS}, which need four cards)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "chip_phases.json"))
    args = ap.parse_args(argv)
    phases = args.phases or [p for p in PHASES if p not in CARDS]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    card = cs.phase_device(torch)
    cs.phase_build()
    out, failed = {}, []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            out[name] = fn(*a)
        except Exception:                       # noqa: BLE001 (reported)
            failed.append(name)
            cs.log(f"PHASE FAILED: {name}\n{traceback.format_exc()}")
        cs.log(f"== {name}: {time.perf_counter() - t0:.1f} s")
        cs._release(torch)

    if {"poisson", "ep", "ep-cards"} & set(phases):
        served = cs.phase_serve(torch, np, args.seed, card)
        ctx = served[2]
        if "poisson" in phases:
            run("poisson", cs.phase_poisson, torch, np, ctx, card,
                args.seed)
        if "ep" in phases:
            run("ep", cs.phase_ep, torch, np, ctx, card, args.seed)
        if "ep-cards" in phases:
            run("ep-cards", cs.phase_ep, torch, np, ctx, card, args.seed,
                True)
        ctx["engine"].close()
        del ctx, served
        cs._release(torch)
    if "mesh" in phases:
        run("mesh", cs.phase_mesh, torch, np, args.seed, card)
    if "mesh-cards" in phases:
        run("mesh-cards", cs.phase_mesh, torch, np, args.seed, card, True)
    if "roofline" in phases:
        run("roofline", cs.phase_roofline, torch, np, args.seed, card)
    if "dry-cell" in phases:
        run("dry cell", cs.phase_dry_cell, torch)
    if "kimi" in phases:
        run("kimi", cs.phase_kimi, torch, np, args.seed, card)
    if "qwen3" in phases:
        run("qwen3", cs.phase_qwen3, torch, np, args.seed, card)
    if "families" in phases:
        run("families", cs.phase_families, torch, np, args.seed, card)
    if "families-train" in phases:
        run("families-train", cs.phase_families_train, torch, np,
            args.seed, card)
    if "kimi-rows" in phases:
        from repro_torch.kernels import grouped_matmul as gk
        from repro_torch.kernels import ops
        from repro_torch.kernels import q4_matmul as qk
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        run("kimi-rows", lambda: {
            f"{name}/{label}": row for (name, label), row in
            cs._kimi_rows(torch, gen, gk, ops, qk, args.reps).items()})
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    cs.log(f"chip_phases: failed {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
