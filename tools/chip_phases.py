#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` alone on one NVIDIA card, to
iterate on a phase without the whole script:

    python3 tools/chip_phases.py poisson kimi qwen3 kimi-rows
    python3 tools/chip_phases.py prefill kernels
    python3 tools/chip_phases.py families families-train
    python3 tools/chip_phases.py ep
    python3 tools/chip_phases.py ep-cards      # on a host with 4 cards
    python3 tools/chip_phases.py mesh
    python3 tools/chip_phases.py mesh-cards    # on a host with 4 cards
    python3 tools/chip_phases.py families-mesh
    python3 tools/chip_phases.py families-mesh-cards   # 4 cards
    python3 tools/chip_phases.py engine-mesh
    python3 tools/chip_phases.py engine-mesh-cards     # 4 cards
    python3 tools/chip_phases.py roofline dry-cell
    python3 tools/chip_phases.py timeline [--parent DIR] [--tile 128]
        [--lockstep] [--tree DIR]

``poisson``, ``ep`` (8), ``ep-cards`` (8 with rank r on ``cuda:r``),
``prefill`` (3p, long prompts through the wgmma bodies) and ``kernels`` (5,
every kernel row at the serve phase's bank sizes) first run the serve
phase (3), whose params, point and bank sizes they use; ``kimi`` is 7b, ``qwen3`` 7c, ``families`` 7d, ``families-train``
7e and ``kimi-rows`` the kernel phase's B3 rows at Kimi-K2's widths;
``mesh`` is 9 (sharded training and MoE over (data, model) meshes on
repeated ``cuda:0``) and ``mesh-cards`` 9 with mesh position p on
``cuda:(p % cards)``; ``families-mesh`` is 9e (RWKV6, Zamba2 and
SeamlessM4T split over (2, 2) of repeated ``cuda:0``) and
``families-mesh-cards`` 9e with position p on ``cuda:(p % cards)``
(no count: the card-vs-meta count runs on repeated ``cuda:0``);
``engine-mesh`` is 11 (the adaptive engine over (2, 2) of repeated
``cuda:0``, the dense compute split: paged, slot, overlap and
speculative configs) and ``engine-mesh-cards`` 11 with position p on
``cuda:(p % cards)``; ``roofline`` is 10 (the anchor steps' op counts on
the card and on ``meta``, their times and shares of the bound, and the
split (2, 2) decode's count) and ``dry-cell`` one dry-run cell on the
card's host (``run_cell``, Mixtral ``decode_32k`` over the 256-position
mesh of ``meta``); ``timeline`` counts the int wgmma consumers' SASS
per stage and reads their stage stamps from a library built with the
stamping macro into ``build/timeline/`` (``tools/consumer_timeline.py``;
``--parent`` also compares the SASS with an earlier checkout's sources,
``--tile`` runs the plans on one wgmma token tile, ``--lockstep`` stamps
the consumers with their turns compiled out, the schedule before them,
``--tree`` stamps another checkout's sources that carry the stamps). It
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
PHASES = ("poisson", "prefill", "ep", "ep-cards", "kernels", "kimi",
          "qwen3", "families",
          "families-train", "families-mesh", "families-mesh-cards",
          "kimi-rows", "mesh", "mesh-cards", "engine-mesh",
          "engine-mesh-cards", "roofline", "dry-cell", "timeline")
CARDS = ("ep-cards", "mesh-cards", "families-mesh-cards",
         "engine-mesh-cards")                              # several cards


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*", choices=PHASES,
                    help=f"phases to run (default: all of {PHASES} "
                         f"but {CARDS}, which need four cards)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="profile the serve phase's warm rerun")
    ap.add_argument("--parent", help="timeline: an unpacked earlier "
                    "checkout whose kernels' SASS is compared")
    ap.add_argument("--tile", type=int, choices=(128, 160),
                    help="timeline: run every plan on this wgmma token tile")
    ap.add_argument("--lockstep", action="store_true",
                    help="timeline: the int consumers' turns compiled out")
    ap.add_argument("--tree", help="timeline: stamp this checkout's "
                    "sources instead of this one's")
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

    sizes = None
    if {"poisson", "prefill", "ep", "ep-cards", "kernels"} & set(phases):
        served = cs.phase_serve(torch, np, args.seed, card,
                                args.profile)
        sizes, ctx = served[1], served[2]
        if "prefill" in phases:
            run("prefill", cs.phase_prefill, torch, np, ctx, card,
                args.seed)
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
    if "kernels" in phases:
        run("kernels", cs.phase_kernels, torch, np, sizes, args.seed,
            args.reps)
    if "mesh" in phases:
        run("mesh", cs.phase_mesh, torch, np, args.seed, card)
    if "mesh-cards" in phases:
        run("mesh-cards", cs.phase_mesh, torch, np, args.seed, card, True)
    if "engine-mesh" in phases:
        run("engine-mesh", cs.phase_engine_mesh, torch, np, args.seed, card)
    if "engine-mesh-cards" in phases:
        run("engine-mesh-cards", cs.phase_engine_mesh, torch, np, args.seed,
            card, True)
    if "roofline" in phases:
        run("roofline", cs.phase_roofline, torch, np, args.seed, card)
    if "timeline" in phases:
        sys.path.insert(0, str(ROOT / "tools"))
        import consumer_timeline
        run("timeline", consumer_timeline.run, torch, cs, args.parent,
            args.tile, args.tree, args.lockstep)
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
    if "families-mesh" in phases:
        run("families-mesh", cs.phase_families_mesh, torch, np, args.seed,
            card)
    if "families-mesh-cards" in phases:
        run("families-mesh-cards", cs.phase_families_mesh, torch, np,
            args.seed, card, True)
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
