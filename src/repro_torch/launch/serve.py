"""Serving launcher — the paper's adaptive MoE deployment as a CLI, on the
declarative QoS surface (``repro.launch.serve``, DESIGN.md §9), running
on the card (``--device cpu`` for the plain PyTorch versions on the CPU).
On the card every engine runs its expert banks through the CUDA
dequant-matmul kernels (``EngineConfig.use_kernel``).

Declare TARGETS, not knobs: the engine resolves them on its Pareto
frontier and the QoSController keeps the deployment on target while
requests stream:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
        --min-tps 8 --max-ppl-x 1.05 --budget-gb 40 --requests 8

``--ladder 16,8,4`` opens the per-expert mixed-precision configuration
space (DESIGN.md §11). ``--speculate K`` turns on ladder-draft
self-speculative decoding (DESIGN.md §17). ``--overlap on`` switches
expert staging to the async transfer pipeline (DESIGN.md §12).

``--calibrate`` runs the offline sensitivity pass (DESIGN.md §15) and
writes a byte-deterministic per-(layer, expert) profile — same seed,
same bytes — then exits; ``--profile FILE`` serves with it, and
``--dynamic-precision`` adds hysteresis-guarded online rung swaps:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --calibrate --calibrate-out results/sensitivity_profile.json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --profile results/sensitivity_profile.json --dynamic-precision

A profile file written by the reference's CLI loads here and vice versa.
The imperative spelling (``--preference throughput|quality --num-q N``)
is kept as a deprecated compatibility path over ``engine.configure``.

``--trace`` replays a CSV of budget points; rows are
``budget_gb,preference[,num_q[,min_tps]]`` and the optional 4th SLO
column switches that phase onto the declarative path.

``--tenants spec.json`` hosts N tenants under ONE shared budget through
the :class:`~repro_torch.serving.multi.MultiTenantEngine` (DESIGN.md
§10), with per-tenant SLO columns (min_tps / max_ppl_x / deadline_s /
priority), an arbitration weight and an optional ``budget_fracs``
schedule of global budget shifts (fractions of the SUMMED full bf16
footprint of all tenants):

    {"budget_frac": 1.1, "budget_fracs": [1.1, 0.6],
     "tenants": [
       {"name": "chat",  "min_tps": null, "weight": 2.0,
        "priority": 1, "deadline_s": 30.0, "requests": 3},
       {"name": "batch", "max_ppl_x": 1.0, "requests": 3}]}

Tenant ``i``'s params are ``init_params(cfg, seed=i)``.

``--ep N`` serves over an expert-parallel (1, N) mesh (DESIGN.md §16) and
``--dp M`` runs M such engines as autoscaled replicas behind one submit
surface; they need N*M devices, which ``--device`` lists in order (each
replica takes the next N). A device may repeat: a lone ``cpu`` repeats
(the counterpart of the reference's forced host device count), a list
like ``cuda:0,cuda:0,cuda:0,cuda:0`` runs every rank on one card, and a
lone ``cuda`` (or no ``--device``) takes distinct cards:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --ep 2 --dp 2 --temperature 0 --requests 4

``--ckpt-dir DIR`` serves trained params: the latest committed checkpoint
in DIR (the reference's layout, written by either package's trainer) is
restored onto the device; its ``params`` subtree is served in place of
``init_params(cfg, seed=0)`` (tenant 0's params in ``--tenants`` mode).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.core.dynamic_precision import DynamicPrecisionController
from repro_torch.core.expert_cache import AsyncExpertCache, ExpertCache
from repro_torch.core.sensitivity import (SensitivityProfile,
                                          calibrate_sensitivity)
from repro_torch.device import resolve_device
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.models.model import init_params
from repro_torch.serving.api import (EngineConfig, MultiTenantEngine,
                                     QoSTarget, RequestSLO, ServeRequest,
                                     TenantSpec, build_engine)
from repro_torch.serving.qos import QoSController, QoSControllerConfig


def _parse_trace(path: str):
    """budget_gb,preference[,num_q[,min_tps]] rows; '#' comments; empty
    cells allowed (e.g. ``0.8,quality,,5.0``)."""
    points = []
    for ln in Path(path).read_text().splitlines():
        parts = [p.strip() for p in ln.split(",")]
        if not parts or not parts[0] or parts[0].startswith("#"):
            continue
        points.append((
            float(parts[0]) * 1e9,
            parts[1] if len(parts) > 1 and parts[1] else "throughput",
            int(parts[2]) if len(parts) > 2 and parts[2] else None,
            float(parts[3]) if len(parts) > 3 and parts[3] else None,
        ))
    return points


def _tenant_target(t: dict, full16: float) -> QoSTarget:
    """Per-tenant SLO columns -> QoSTarget. ``min_tps`` null/absent means
    best-effort-fast (inf) unless a quality cap pins the tenant."""
    max_loss = (t["max_ppl_x"] - 1.0) if t.get("max_ppl_x") else None
    min_tps = t.get("min_tps")
    if min_tps is None and max_loss is None:
        min_tps = math.inf
    cap = t.get("budget_frac")
    return QoSTarget(
        min_tokens_per_s=min_tps, max_quality_loss=max_loss,
        mem_budget_bytes=cap * full16 if cap else None)


def _serve_tenants(args, cfg, params0, device, profile=None):
    """--tenants mode: N engines, one budget, one arbiter (DESIGN.md §10)."""
    spec = json.loads(Path(args.tenants).read_text())
    total = cfg.num_layers * cfg.moe.num_experts
    full16 = cfg.non_expert_bytes() + total * cfg.expert_param_bytes(16)
    # budget fractions are of the SUMMED full bf16 footprint of all
    # tenants (1.0 = every tenant could be fully resident in bf16)
    n_tenants = len(spec["tenants"])
    fracs = spec.get("budget_fracs") \
        or [spec.get("budget_frac", 1.1)]
    overlap = args.overlap == "on"
    # the shared swap space is async when overlap serving is on — every
    # tenant's scoped view then streams through its workers (§12)
    cache_cls = AsyncExpertCache if overlap else ExpertCache
    shared = cache_cls(capacity_bytes=max(
        8 * cfg.expert_param_bytes(16), 1 << 20), device=device)
    mt = MultiTenantEngine(
        budget_bytes=fracs[0] * full16 * n_tenants, expert_cache=shared,
        controller_config=QoSControllerConfig(
            min_dwell_iterations=4, window_iterations=2))
    for i, t in enumerate(spec["tenants"]):
        params = params0 if i == 0 else init_params(cfg, seed=i,
                                                    device=device)
        engine = build_engine(
            cfg, params,
            EngineConfig(max_slots=2, max_len=16 + args.max_new_tokens,
                         overlap=overlap, use_kernel=device.type == "cuda"),
            device=device, expert_cache=shared.scoped(t["name"]))
        if profile is not None:
            engine.planner.set_profile(profile)
        dyn = None
        if args.dynamic_precision:
            # per-tenant controller: each engine's own routing histogram
            # drives its swaps; reports fan into the arbiter's ledger
            dyn = DynamicPrecisionController(
                engine, profile if profile is not None
                else SensitivityProfile.uniform(cfg))
        mt.add_tenant(TenantSpec(t["name"], _tenant_target(t, full16),
                                 weight=float(t.get("weight", 1.0))),
                      engine, dynamic=dyn)
    rng = np.random.default_rng(0)
    for phase, frac in enumerate(fracs):
        reports0 = len(mt.reports)
        if phase == 0:
            sel = mt.arbitrate()
        else:
            mt.set_budget(frac * full16 * n_tenants)
            sel = {n: t.point for n, t in mt.tenants.items()}
        print(f"[serve] phase {phase}: budget {frac:.2f}x summed bf16 "
              f"({mt.budget_bytes / 1e6:.1f} MB), "
              f"{mt.metrics['arbitrations']:.0f} arbitrations")
        for t in spec["tenants"]:
            name = t["name"]
            tn = mt.tenants[name]
            print(f"[serve]   {name}: slo[{tn.spec.target.describe()}] "
                  f"w={tn.spec.weight:g} "
                  f"alloc={tn.allocated_bytes / 1e6:.2f}MB "
                  f"-> {sel[name].summary()}")
            for _ in range(int(t.get("requests", args.requests))):
                tn.engine.submit_request(ServeRequest(
                    prompt=rng.integers(1, cfg.vocab_size, 8),
                    max_new_tokens=args.max_new_tokens,
                    slo=RequestSLO(priority=int(t.get("priority", 0)),
                                   deadline_s=t.get("deadline_s"))))
        for r in mt.reports[reports0:]:     # this phase's migrations only
            print(f"[serve]   {r.summary()}")
        while mt.has_work():
            mt.run_iteration(temperature=args.temperature)
        for name, tn in mt.tenants.items():
            lat = tn.engine.latency_percentiles()
            print(f"[serve]   {name}: {len(tn.engine.done)} done, "
                  f"{tn.engine.metrics['tokens_generated']} tokens, "
                  f"p50 {lat['p50'] * 1e3:.0f} ms "
                  f"p95 {lat['p95'] * 1e3:.0f} ms "
                  f"kv_waste={tn.engine.kv_waste_fraction():.0%}")
    if args.dynamic_precision:
        for name, tn in mt.tenants.items():
            dm = tn.dynamic.metrics
            print(f"[serve]   {name}: dynamic precision "
                  f"{dm['swaps']:.0f} swaps "
                  f"({dm['rung_promotions']:.0f}p/"
                  f"{dm['rung_demotions']:.0f}d)")
    print("[serve] " + mt.summary().replace("\n", "\n[serve] "))
    mt.close()                  # joins the shared async transfer workers


def _serve_dp(args, cfg, params, devices, use_kernel, profile=None):
    """--dp N: a DPReplicaGroup of EP engines behind one declarative
    surface (DESIGN.md §16.3). Each replica decodes over its own (1, ep)
    device slice; the autoscaler watches the group's demand utilization
    between iterations and its replica decisions land on real engines
    (scale-down drains, no request is dropped)."""
    from repro_torch.serving.ep import make_dp_group
    group = make_dp_group(
        cfg, params,
        EngineConfig(max_slots=4, max_len=32 + args.max_new_tokens,
                     overlap=args.overlap == "on", use_kernel=use_kernel),
        ep=args.ep, dp=args.dp, max_replicas=args.dp, devices=devices)
    if profile is not None:
        for e in group.engines:
            e.planner.set_profile(profile)
    planner = group.engines[0].planner
    full = planner.size_ne + planner.num_experts_total * planner.size_e16
    budget = args.budget_gb * 1e9 if args.budget_gb else full * 0.6
    max_loss = args.max_ppl_x - 1.0 if args.max_ppl_x else None
    target = QoSTarget(
        min_tokens_per_s=(args.min_tps if args.min_tps is not None
                          else float("inf")),
        max_quality_loss=max_loss, mem_budget_bytes=budget)
    points = group.apply_target(target)
    print(f"[serve] ep={args.ep} dp={group.n_replicas} "
          f"target[{target.describe()}] -> {points[0].summary()}")
    rng = np.random.default_rng(0)
    for k in range(args.requests):
        slo = RequestSLO()
        if args.priority_split and k % 2:
            slo = RequestSLO(priority=1, deadline_s=30.0)
        group.submit_request(ServeRequest(
            prompt=rng.integers(1, cfg.vocab_size, 16),
            max_new_tokens=args.max_new_tokens, slo=slo))
    tick = 0.0
    while group.has_work():
        group.run_iteration(temperature=args.temperature)
        decision = group.autoscale_step(tick)
        if decision:
            print(f"[serve] autoscale {decision:+d} -> "
                  f"{group.n_replicas} replicas")
        tick += 1.0
    m = group.metrics
    print(f"[serve] ep={args.ep} dp={group.n_replicas} "
          f"{m['tokens_generated']:.0f} tokens across "
          f"{m['replicas']:.0f} replicas, "
          f"{group.throughput_tokens_per_s():.1f} tok/s aggregate, "
          f"{m['iterations']:.0f} engine iterations")
    for rid in range(min(2, args.requests)):
        r = group.result(rid)
        print(f"  {r.summary()} tokens={r.tokens[:12]}...")
    group.close()


def _device_list(spec, n: int):
    """``--device`` for ``n = ep * dp`` devices: ``None`` or a lone
    ``cuda`` -> None (the visible cards, distinct); a lone ``cpu`` ->
    ``["cpu"] * n``; otherwise a comma-separated list of exactly ``n``
    devices, taken in order (entries may repeat)."""
    if spec is None:
        return None
    names = [d.strip() for d in spec.split(",") if d.strip()]
    if names == ["cuda"]:
        return None
    if names == ["cpu"]:
        return names * n
    if len(names) != n:
        raise SystemExit(
            f"--device lists {len(names)} device(s) but the deployment "
            f"needs ep*dp = {n} (a device may repeat, e.g. "
            f"{','.join(['cuda:0'] * n)})")
    return names


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b", choices=list(ARCH_IDS))
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; 'cpu' runs the plain PyTorch versions); "
                         "with --ep/--dp a comma-separated list of ep*dp "
                         "devices (may repeat), a lone 'cpu' repeated, "
                         "a lone 'cuda' for distinct cards")
    # -- declarative QoS targets (DESIGN.md §9) -------------------------
    ap.add_argument("--min-tps", type=float, default=None,
                    help="SLO: minimum tokens/s; the QoSController walks "
                         "the Pareto frontier to hold it")
    ap.add_argument("--max-ppl-x", type=float, default=None,
                    help="SLO: quality ceiling as a perplexity multiplier "
                         "vs all-16-bit, e.g. 1.05 = at most +5%%")
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="HBM budget; default = full bf16 size * 0.6")
    ap.add_argument("--speculate", type=int, default=0,
                    help="ladder-draft self-speculative decoding "
                         "(DESIGN.md §17): draft depth K per iteration "
                         "(0 = plain decode)")
    ap.add_argument("--overlap", default="off", choices=("on", "off"),
                    help="async overlapped expert streaming (DESIGN.md "
                         "§12); 'off' keeps the paper's serial staging")
    ap.add_argument("--ladder", default=None,
                    help="precision ladder as descending CSV rungs, e.g. "
                         "'16,8,4' (DESIGN.md §11); default = the arch's "
                         "binary ladder (16,<bits>)")
    # -- sensitivity calibration + dynamic precision (DESIGN.md §15) ----
    ap.add_argument("--calibrate", action="store_true",
                    help="run the offline sensitivity calibration pass, "
                         "write the profile and exit; byte-deterministic "
                         "per --calibrate-seed")
    ap.add_argument("--calibrate-out",
                    default="results/sensitivity_profile.json",
                    help="where --calibrate writes the profile")
    ap.add_argument("--calibrate-seed", type=int, default=0,
                    help="seed for the calibration batch (same seed => "
                         "byte-identical profile)")
    ap.add_argument("--profile", default=None,
                    help="serve with a calibrated sensitivity profile: "
                         "the frontier prices quality per (layer, "
                         "expert) instead of the flat rung table")
    ap.add_argument("--dynamic-precision", action="store_true",
                    help="online controller (DESIGN.md §15): folds the "
                         "measured routing histogram into the profile "
                         "and issues hysteresis-guarded byte-neutral "
                         "rung swaps between decode iterations")
    # -- deprecated imperative knobs ------------------------------------
    ap.add_argument("--preference", default=None,
                    choices=("throughput", "quality"),
                    help="DEPRECATED: use --min-tps/--max-ppl-x")
    ap.add_argument("--num-q", type=int, default=None,
                    help="DEPRECATED: Num_E4 for quality preference")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--priority-split", action="store_true",
                    help="submit every other request at priority 1 with a "
                         "deadline, exercising SLO-aware admission")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the latest checkpoint in "
                         "this directory (written by a trainer of either "
                         "package)")
    ap.add_argument("--trace", default=None,
                    help="CSV of budget_gb,preference[,num_q[,min_tps]] "
                         "to replay (4th column = SLO)")
    ap.add_argument("--tenants", default=None,
                    help="JSON spec of N tenants served under ONE budget "
                         "via the multi-tenant arbiter (DESIGN.md §10); "
                         "see the module docstring for the schema")
    # -- expert-parallel mesh serving (DESIGN.md §16) -------------------
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel shard count: decode over a "
                         "(1, ep) mesh with experts sharded across the "
                         "'model' axis; the expert count must divide by "
                         "ep. Needs ep*dp devices (see --device)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replica count: dp whole engines "
                         "on disjoint (1, ep) device slices behind one "
                         "submit surface, autoscaler-driven (§16.3)")
    return ap


def main(argv=None) -> None:
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``)."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if cfg.moe is None:
        raise SystemExit(f"{args.arch} has no routed experts — the MoP "
                         "engine serves MoE archs")
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if args.ladder:
        ladder = tuple(int(b) for b in args.ladder.split(","))
        cfg = cfg.replace(mop=dataclasses.replace(cfg.mop, ladder=ladder))
        print(f"[serve] precision ladder {ladder}")
    if args.ep < 1 or args.dp < 1:
        raise SystemExit(f"--ep/--dp must be >= 1 (got ep={args.ep} "
                         f"dp={args.dp})")
    if args.ep > 1 or args.dp > 1:
        from repro_torch.serving.ep import validate_ep_layout
        try:
            # reject up front: a ladder/expert-count combo that does not
            # divide over the EP axis fails before building the model
            validate_ep_layout(cfg, args.ep)
        except ValueError as e:
            raise SystemExit(f"[serve] {e}")
        if args.tenants:
            raise SystemExit("--ep/--dp and --tenants are mutually "
                             "exclusive (one mesh per tenant engine is "
                             "not implemented; see DESIGN.md §16)")
        if args.speculate:
            raise SystemExit("--speculate over an EP/DP mesh is not "
                             "implemented (see DESIGN.md §17)")
    devices = _device_list(args.device, args.ep * args.dp)
    device = resolve_device(devices[0] if devices else None)
    use_kernel = device.type == "cuda"
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None and mgr.latest_step():
        tree, _ = mgr.restore(shardings=device)
        params = tree.get("params", tree)
        print(f"[serve] restored params from {args.ckpt_dir}")
    else:
        params = init_params(cfg, seed=0, device=device)

    if args.calibrate:
        prof = calibrate_sensitivity(cfg, params,
                                     seed=args.calibrate_seed)
        out = Path(args.calibrate_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.save(out)
        print(f"[serve] sensitivity profile -> {out} "
              f"(seed {args.calibrate_seed}, "
              f"{prof.shape[0]}x{prof.shape[1]} experts, "
              f"rungs {sorted(prof.sens)})")
        return

    profile = None
    if args.profile:
        profile = SensitivityProfile.load(args.profile)
        print(f"[serve] sensitivity profile {args.profile} "
              f"({'uniform' if profile.is_uniform() else 'calibrated'})")

    if args.tenants:
        _serve_tenants(args, cfg, params, device, profile)
        return

    if args.dp > 1:
        _serve_dp(args, cfg, params, devices, use_kernel, profile)
        return

    if args.ep > 1:
        from repro_torch.serving.ep import build_ep_engine
        engine = build_ep_engine(cfg, params, EngineConfig(
            max_slots=4, max_len=32 + args.max_new_tokens,
            overlap=args.overlap == "on", use_kernel=use_kernel),
            ep=args.ep, devices=devices)
        print(f"[serve] expert parallelism ep={args.ep}: (1, {args.ep}) "
              f"mesh over {', '.join(map(str, engine.mesh.devices))}, "
              "experts sharded (DESIGN.md §16)")
    else:
        engine = build_engine(cfg, params, EngineConfig(
            max_slots=4, max_len=32 + args.max_new_tokens,
            overlap=args.overlap == "on", use_kernel=use_kernel,
            speculate=max(0, args.speculate)), device=device)
    if args.overlap == "on":
        print("[serve] async overlapped expert streaming ON "
              "(DESIGN.md §12)")
    if args.speculate > 0:
        print(f"[serve] speculative decoding ON, draft depth "
              f"K={args.speculate} at the lowest ladder rung "
              "(DESIGN.md §17)")
    if profile is not None:
        engine.planner.set_profile(profile)
    dynamic = None
    if args.dynamic_precision:
        dynamic = DynamicPrecisionController(
            engine, profile if profile is not None
            else SensitivityProfile.uniform(cfg))
        print("[serve] dynamic precision ON (DESIGN.md §15): "
              "hysteresis-guarded rung swaps chase measured hotness")
    controller = QoSController(engine, dynamic=dynamic)
    full = engine.planner.size_ne + \
        engine.planner.num_experts_total * engine.planner.size_e16
    budget = args.budget_gb * 1e9 if args.budget_gb else full * 0.6

    if args.trace:
        points = _parse_trace(args.trace)
    elif args.preference is not None:
        points = [(budget, args.preference, args.num_q, args.min_tps)]
    else:
        # declarative default path: one QoSTarget phase. With no explicit
        # tokens/s floor the server still wants speed: inf = "as fast as
        # possible inside the budget/quality constraints" (best effort).
        points = [(budget, None, None,
                   args.min_tps if args.min_tps is not None
                   else float("inf"))]

    max_loss = args.max_ppl_x - 1.0 if args.max_ppl_x else None
    rng = np.random.default_rng(0)
    par = f"ep={args.ep} dp={args.dp} "   # parallelism columns (§16)
    for budget, pref, nq, min_tps in points:
        if pref is None or min_tps is not None:
            target = QoSTarget(min_tokens_per_s=min_tps,
                               max_quality_loss=max_loss,
                               mem_budget_bytes=budget)
            point = controller.set_target(target)
            print(f"[serve] {par}target[{target.describe()}] "
                  f"-> {point.summary()}")
        else:
            res = engine.configure(budget, pref, nq)
            # imperative phase: the controller must not keep walking the
            # previous phase's target over this plan
            controller.target = None
            controller.point = None
            print(f"[serve] {par}{res.summary()}")
        for k in range(args.requests):
            slo = RequestSLO()
            if args.priority_split and k % 2:
                slo = RequestSLO(priority=1, deadline_s=30.0)
            engine.submit_request(ServeRequest(
                prompt=rng.integers(1, cfg.vocab_size, 16),
                max_new_tokens=args.max_new_tokens,
                slo=slo))
        while engine.has_work():
            # one shared temperature -> engine-level default keeps the
            # batched sampling path
            engine.run_iteration(temperature=args.temperature)
            controller.step()          # QoS loop between iterations
        print(f"[serve] {engine.summary()}")
        m = engine.metrics
        print(f"[serve]   kv[{'paged' if engine.paged else 'slots'}] "
              f"alloc={m['kv_allocated_bytes'] / 2**20:.2f}MiB "
              f"used={m['kv_used_bytes'] / 2**20:.2f}MiB "
              f"cap={m['kv_capacity_bytes'] / 2**20:.2f}MiB "
              f"waste={engine.kv_waste_fraction():.0%}")
        if m["spec_proposed"] or engine.speculate_k:
            print(f"[serve]   spec[k={engine.speculate_k}] "
                  f"proposed={m['spec_proposed']} "
                  f"accepted={m['spec_accepted']} "
                  f"acceptance={m['acceptance_rate']:.2%} "
                  f"fallbacks={controller.metrics['spec_fallbacks']:.0f}")
        if controller.target is not None:
            print(f"[serve] {controller.summary()}")
    if dynamic is not None:
        dm = dynamic.metrics
        print(f"[serve] dynamic precision: {dm['swaps']:.0f} swaps "
              f"({dm['rung_promotions']:.0f} promotions / "
              f"{dm['rung_demotions']:.0f} demotions) over "
              f"{dm['steps']:.0f} steps, measured quality cost "
              f"{dynamic.quality_cost_measured():.5f}")
    for rid in list(engine.done)[:2]:
        r = engine.result(rid)
        print(f"  {r.summary()} tokens={r.tokens[:12]}...")
    engine.close()              # joins the async transfer workers (§12)


if __name__ == "__main__":
    main()
