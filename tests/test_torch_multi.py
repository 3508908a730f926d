"""The port's multi-tenant serving (``repro_torch.serving.multi``) and its
shared swap space (``ScopedExpertCache`` views of one ``ExpertCache`` /
``AsyncExpertCache``) against the reference's.

* Arbiter replays: every scenario of ``tests/test_multi_tenant.py`` runs
  through both packages' ``MultiTenantEngine``/``ResourceArbiter`` over
  their simulators and frontiers (one explicit hardware model) and must
  give EQUAL arbiter metrics, ``ReplanReport``\\ s, per-tenant points,
  allocations and controller metrics (exact).
* Shared swap: the namespace, eviction-credit and async-delegation cases
  of ``tests/test_expert_cache.py`` / ``tests/test_async_cache.py`` run
  on both packages' caches and must leave equal stats and resident keys.
* Two real tenants (the reference's and the port's engines on the same
  converted params) across one ``set_budget``: the same points, reports
  and greedy tokens, over a synchronous and an async shared swap space.
  The tenants run the smoke model in float32 (both packages): in bf16
  the two frameworks' router probabilities differ by up to 2.6e-3 after
  one layer, enough to flip an expert at a router near-tie, which random
  weights hit within a few hundred routed tokens; in float32 they differ
  by 2.1e-7, so the comparison tests the control loop, not bf16
  rounding. The same flow in bf16 must give the reference's points,
  reports and arbitrations, which no near-tie can move.
"""
import dataclasses
import math
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import expert_cache as jec
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.core.pareto import InfeasibleTarget as JInfeasibleTarget
from repro.core.pareto import ParetoFrontier as JParetoFrontier
from repro.core.pareto import QoSTarget as JQoSTarget
from repro.models.model import build_model as jbuild_model
from repro.serving import multi as jmulti
from repro.serving import simulator as jsim
from repro.serving.api import EngineConfig as JEngineConfig
from repro.serving.api import ServeRequest as JServeRequest
from repro.serving.engine import AdaptiveServingEngine as JEngine
from repro.serving.qos import QoSControllerConfig as JQoSControllerConfig
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import expert_cache as tec
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.pareto import InfeasibleTarget, ParetoFrontier
from repro_torch.core.precision_plan import (migrated_expert_keys,
                                             reconfig_delta)
from repro_torch.models.model import params_from_numpy
from repro_torch.serving import api, multi, simulator
from repro_torch.serving.qos import QoSControllerConfig

GIB = 2**30
JHW = JHardwareModel(host_link_bw=24e9)
HW = HardwareModel(**dataclasses.asdict(JHW))

REF = SimpleNamespace(
    name="ref", cfg=jget_config("mixtral-8x7b"), hw=JHW,
    ParetoFrontier=JParetoFrontier, QoSTarget=JQoSTarget,
    InfeasibleTarget=JInfeasibleTarget,
    CTL=JQoSControllerConfig(tolerance=0.1, min_dwell_iterations=4,
                             window_iterations=2),
    MultiTenantEngine=jmulti.MultiTenantEngine,
    TenantSpec=jmulti.TenantSpec, ResourceArbiter=jmulti.ResourceArbiter,
    GlobalBudgetInfeasible=jmulti.GlobalBudgetInfeasible,
    SimulatedEngine=jsim.SimulatedEngine, VirtualClock=jsim.VirtualClock,
    mt_kw={}, ExpertCache=jec.ExpertCache,
    AsyncExpertCache=jec.AsyncExpertCache, cache_kw={},
    blob=lambda n, fill: np.full(n, fill, np.uint8),
    first=lambda v: int(np.asarray(v)[0]))
PORT = SimpleNamespace(
    name="port", cfg=get_config("mixtral-8x7b"), hw=HW,
    ParetoFrontier=ParetoFrontier, QoSTarget=api.QoSTarget,
    InfeasibleTarget=InfeasibleTarget,
    CTL=QoSControllerConfig(tolerance=0.1, min_dwell_iterations=4,
                            window_iterations=2),
    MultiTenantEngine=multi.MultiTenantEngine,
    TenantSpec=multi.TenantSpec, ResourceArbiter=multi.ResourceArbiter,
    GlobalBudgetInfeasible=multi.GlobalBudgetInfeasible,
    SimulatedEngine=simulator.SimulatedEngine,
    VirtualClock=simulator.VirtualClock,
    mt_kw={"device": "cpu"}, ExpertCache=tec.ExpertCache,
    AsyncExpertCache=tec.AsyncExpertCache, cache_kw={"device": "cpu"},
    blob=lambda n, fill: torch.full((n,), fill, dtype=torch.uint8),
    first=lambda v: int(v[0]))


@pytest.fixture(scope="module")
def frontiers():
    return {pkg.name: pkg.ParetoFrontier(pkg.cfg, pkg.hw)
            for pkg in (REF, PORT)}


def point_key(p):
    return None if p is None else \
        (p.summary(), p.plan.bits.tobytes(), p.plan.location.tobytes())


def mt_state(mt, engines=()):
    return {
        "metrics": dict(mt.metrics),
        "reports": [dataclasses.asdict(r) for r in mt.reports],
        "tenants": {n: {"point": point_key(t.point),
                        "alloc": t.allocated_bytes, "derate": t.derate,
                        "target": t.controller.target.describe(),
                        "controller": dict(t.controller.metrics)}
                    for n, t in mt.tenants.items()},
        "applied": [[point_key(p) for p in e.applied] for e in engines],
        "summary": mt.summary()}


def make_mt(pkg, fr, budget_gib, specs_errors, **kw):
    clock = pkg.VirtualClock()
    mt = pkg.MultiTenantEngine(budget_gib * GIB, controller_config=pkg.CTL,
                               **pkg.mt_kw, **kw)
    engines = []
    for spec, err in specs_errors:
        eng = pkg.SimulatedEngine(model_error=err, clock=clock)
        mt.add_tenant(spec, eng, fr)
        engines.append(eng)
    return mt, engines


def run_joint(mt, engines, iterations):
    for _ in range(iterations):
        for eng in engines:
            eng.run_iteration()
        mt.step()


def interactive(pkg, tps=20.0):
    return pkg.TenantSpec("interactive",
                          pkg.QoSTarget(min_tokens_per_s=tps))


def batch(pkg):
    return pkg.TenantSpec("batch", pkg.QoSTarget(min_tokens_per_s=1.0,
                                                 max_quality_loss=0.0))


def sc_distinct_points(pkg, fr):
    mt, engines = make_mt(pkg, fr, 40.0,
                          [(interactive(pkg), 1.0), (batch(pkg), 1.0)])
    sel = mt.arbitrate()
    assert sel["interactive"] is not sel["batch"]
    run_joint(mt, engines, 100)
    assert mt.metrics["arbitrations"] == 1
    return mt_state(mt, engines)


def sc_budget_shrink(pkg, fr):
    mt, engines = make_mt(pkg, fr, 40.0,
                          [(interactive(pkg, 8.0), 1.0), (batch(pkg), 1.0)])
    mt.arbitrate()
    run_joint(mt, engines, 30)
    assert mt.set_budget(20.0 * GIB) is True
    assert mt.metrics["arbitrations"] == 2
    run_joint(mt, engines, 80)
    assert mt.metrics["arbitrations"] == 2
    assert mt.set_budget(20.0 * GIB) is False
    return mt_state(mt, engines)


def sc_placement_only(pkg, fr):
    spec = pkg.TenantSpec("pinned", pkg.QoSTarget(
        min_tokens_per_s=math.inf, max_quality_loss=0.0))
    mt, engines = make_mt(pkg, fr, 14.0, [(spec, 1.0)])
    mt.arbitrate()
    old = mt.tenants["pinned"].point
    mt.set_budget(25.0 * GIB)
    new = mt.tenants["pinned"].point
    report = mt.reports[-1]
    assert report.placement_only
    assert report.migrated_experts == new.resident_experts \
        - old.resident_experts
    return dict(mt_state(mt, engines), migrated=[
        list(k) for k in migrated_expert_keys(
            reconfig_delta(old.plan, new.plan), new.plan)])


def sc_qos_miss(pkg, fr):
    mt, engines = make_mt(pkg, fr, 26.0,
                          [(interactive(pkg, 8.0), 0.5), (batch(pkg), 1.0)],
                          cooldown_iterations=8)
    mt.arbitrate()
    run_joint(mt, engines, 200)
    assert mt.metrics["arbitrations"] >= 2
    assert mt.tenants["interactive"].controller.metrics["violations"] > 0
    return mt_state(mt, engines)


def sc_arbiter(pkg, fr):
    arb = pkg.ResourceArbiter()
    out = {}
    entries = [(interactive(pkg), fr, 1.0), (batch(pkg), fr, 1.0)]
    for gib in (20, 40, 60):
        sel, used = arb.arbitrate(entries, gib * GIB)
        out[gib] = ({k: point_key(v) for k, v in sel.items()}, used)
    heavy = pkg.TenantSpec("heavy", pkg.QoSTarget(min_tokens_per_s=math.inf),
                           weight=3.0)
    light = pkg.TenantSpec("light", pkg.QoSTarget(min_tokens_per_s=math.inf))
    sel, used = arb.arbitrate([(heavy, fr, 1.0), (light, fr, 1.0)],
                              20 * GIB)
    assert sel["heavy"].qos.device_bytes > sel["light"].qos.device_bytes
    out["weighted"] = ({k: point_key(v) for k, v in sel.items()}, used)
    spec = pkg.TenantSpec("t", pkg.QoSTarget(min_tokens_per_s=8.0))
    for gib, derate in ((20, 1.0), (60, 1.0), (30, 0.4)):
        sel, used = arb.arbitrate([(spec, fr, derate)], gib * GIB)
        out[f"floor{gib}/{derate}"] = (point_key(sel["t"]), used)
    chain, u = arb.chain(fr, spec.target, 0.7)
    out["chain"] = [(point_key(p), u(p)) for p in chain]
    with pytest.raises(pkg.GlobalBudgetInfeasible) as e:
        arb.arbitrate(entries, 5 * GIB)
    out["infeasible"] = str(e.value)
    capped = pkg.TenantSpec("capped", pkg.QoSTarget(mem_budget_bytes=GIB))
    with pytest.raises(pkg.InfeasibleTarget, match="capped") as e:
        arb.arbitrate([(capped, fr, 1.0)], 40 * GIB)
    out["capped"] = str(e.value)
    return out


def sc_errors(pkg, fr):
    mt = pkg.MultiTenantEngine(40 * GIB, controller_config=pkg.CTL,
                               **pkg.mt_kw)
    mt.add_tenant(batch(pkg), pkg.SimulatedEngine(), fr)
    with pytest.raises(ValueError, match="already hosted") as e1:
        mt.add_tenant(batch(pkg), pkg.SimulatedEngine(), fr)
    with pytest.raises(ValueError, match="weight") as e2:
        pkg.TenantSpec("t", pkg.QoSTarget(), weight=0.0)
    empty = pkg.MultiTenantEngine(40 * GIB, **pkg.mt_kw)
    with pytest.raises(RuntimeError, match="no tenants") as e3:
        empty.arbitrate()
    return [str(e1.value), str(e2.value), str(e3.value)]


def sc_shared_swap_namespaced(pkg, fr):
    mt, _ = make_mt(pkg, fr, 40.0,
                    [(interactive(pkg), 1.0), (batch(pkg), 1.0)])
    va = mt.tenants["interactive"].cache_view
    vb = mt.tenants["batch"].cache_view
    assert va.parent is mt.cache and vb.parent is mt.cache
    va.bind_fetch(lambda key: pkg.blob(8, 0))
    vb.bind_fetch(lambda key: pkg.blob(8, 1))
    return {"a": pkg.first(va.get((0, 0))), "b": pkg.first(vb.get((0, 0))),
            "misses": mt.cache.stats.misses}


ARBITER_SCENARIOS = [sc_distinct_points, sc_budget_shrink, sc_placement_only,
                     sc_qos_miss, sc_arbiter, sc_errors,
                     sc_shared_swap_namespaced]


@pytest.mark.parametrize("scenario", ARBITER_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_arbiter_replay_equal(frontiers, scenario):
    """Tolerance: none — equal metrics, reports, points and messages."""
    want = scenario(REF, frontiers["ref"])
    got = scenario(PORT, frontiers["port"])
    assert got == want


# ---------------------------------------------------------------------------
# The shared swap space
# ---------------------------------------------------------------------------

def cache_state(parent, views):
    return {"parent": dataclasses.asdict(parent.stats),
            "used": parent.used_bytes,
            "keys": sorted(parent.resident_keys()),
            "views": {v.owner: (dataclasses.asdict(v.stats),
                                sorted(v.resident_keys()), v.used_bytes)
                      for v in views}}


def shared(pkg, capacity_experts=4, nbytes=1024, cls="ExpertCache"):
    parent = getattr(pkg, cls)(capacity_bytes=capacity_experts * nbytes,
                               **pkg.cache_kw)
    a = parent.scoped("A", lambda k: pkg.blob(nbytes, 1))
    b = parent.scoped("B", lambda k: pkg.blob(nbytes, 2))
    return parent, a, b


def cc_no_collision(pkg):
    parent, a, b = shared(pkg)
    va, vb = a.get((0, 3)), b.get((0, 3))
    return dict(cache_state(parent, [a, b]), vals=(pkg.first(va),
                                                   pkg.first(vb)))


def cc_invalidate_and_hits(pkg):
    parent, a, b = shared(pkg)
    a.get((0, 0))
    a.get((0, 0))
    a.get((0, 1))
    b.get((0, 0))
    a.invalidate([(0, 0)])
    s1 = cache_state(parent, [a, b])
    a.invalidate()
    return [s1, cache_state(parent, [a, b])]


def cc_cross_owner_eviction(pkg):
    parent, a, b = shared(pkg, capacity_experts=2)
    a.get((0, 0))
    a.get((0, 1))
    b.get((0, 0))
    return cache_state(parent, [a, b])


def cc_update_namespaced(pkg):
    parent, a, b = shared(pkg, capacity_experts=16)
    a.get((0, 0))
    b.get((0, 0))
    delta = a.update((0, 0), pkg.blob(2048, 3))
    return dict(cache_state(parent, [a, b]), delta=delta)


def cc_late_bind_and_errors(pkg):
    parent = pkg.ExpertCache(capacity_bytes=4096, **pkg.cache_kw)
    v = parent.scoped("late")
    errs = []
    for call in (lambda: v.get((0, 0)), lambda: parent.get((0, 0)),
                 lambda: parent.scoped("late"), lambda: v.wait([(0, 0)])):
        try:
            call()
        except (RuntimeError, ValueError) as e:
            errs.append(type(e).__name__ + ": " + str(e))
    v.bind_fetch(lambda key: pkg.blob(16, 0))
    v.get((0, 0))
    v.hint([(0, 1)])
    return dict(cache_state(parent, [v]), errs=errs,
                is_async=v.is_async, capacity=v.capacity)


def cc_async_views(pkg):
    parent, a, b = shared(pkg, cls="AsyncExpertCache")
    assert a.is_async and b.is_async
    a.prefetch([(0, 0)])
    parent.drain()
    s1 = cache_state(parent, [a, b])
    n_a = a.wait([(0, 0), (0, 1)])
    n_b = b.wait([(0, 0)])
    vb = pkg.first(b.get((0, 0)))
    b.hint([(0, 2)])
    b.drain()
    delta = a.update((0, 1), pkg.blob(512, 4))
    a.close()                   # drains, leaves the shared space open
    s2 = cache_state(parent, [a, b])
    s2["parent"].pop("transfer_s")
    s2["parent"].pop("prefetch_s")
    for owner in s2["views"]:
        s2["views"][owner][0].pop("transfer_s")
    s1["parent"].pop("prefetch_s")
    parent.close()
    return [s1, s2, n_a, n_b, vb, delta]


CACHE_SCENARIOS = [cc_no_collision, cc_invalidate_and_hits,
                   cc_cross_owner_eviction, cc_update_namespaced,
                   cc_late_bind_and_errors, cc_async_views]


def _untimed(state):
    """Drop the measured seconds (wall clock) from a cache state."""
    if isinstance(state, dict):
        return {k: _untimed(v) for k, v in state.items()
                if k not in ("transfer_s", "prefetch_s")}
    if isinstance(state, (list, tuple)):
        return type(state)(_untimed(v) for v in state)
    return state


@pytest.mark.parametrize("scenario", CACHE_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_shared_swap_equal(scenario):
    """Tolerance: none on counts, bytes and keys; the transfer seconds are
    wall-clock measurements and are not compared."""
    assert _untimed(scenario(PORT)) == _untimed(scenario(REF))
    assert not [t for t in threading.enumerate()
                if t.name.startswith("expert-xfer") and t.is_alive()]


# ---------------------------------------------------------------------------
# Two real tenants
# ---------------------------------------------------------------------------

def _two_models(dtype):
    jcfg = jreduce(jget_config("mixtral-8x7b")).replace(dtype=dtype)
    tcfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(dtype=dtype)
    jmodel = jbuild_model(jcfg)
    jparams = [jmodel.init(jax.random.key(i)) for i in (0, 1)]
    tparams = [params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                 "cpu") for p in jparams]
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def two_models():
    return _two_models("float32")


#: router near-tie screen: the smallest gap between the 2nd and 3rd
#: router probability of any routed token must exceed this, ~50x the
#: largest cross-framework router-probability difference measured on the
#: float32 smoke model (2.1e-7): inside it float rounding may pick
#: another expert, which is noise at a tie, not a parity fault.
TIE_GAP = 1e-5


def route_margin(engine, prompts_and_tokens):
    """Smallest 2nd-3rd router-probability gap over every token the
    engine routed for these requests (prompt plus the generated tokens
    fed back), recomputed by one prefill of each sequence on the
    engine's serving params."""
    from repro_torch.core import mixed_moe
    m, k = engine.model, engine.cfg.moe.top_k
    gap = math.inf
    for prompt, out in prompts_and_tokens:
        seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)[None]
        n = seq.shape[1]
        with mixed_moe.capture_moe_inputs() as cap:
            m.prefill_into_slot(engine._serve_params,
                                m.init_cache(1, n + 1, device="cpu"),
                                torch.from_numpy(seq),
                                torch.arange(n)[None], 0, n - 1)
        for _, probs in cap:
            top = -np.sort(-probs[:n], axis=-1)
            gap = min(gap, float((top[:, k - 1] - top[:, k]).min()))
    return gap


def serve_tenants(pkg, cfg, params, overlap, prompts, fracs=(0.6, 0.45)):
    """The CLI's ``--tenants`` flow on one package: two tenants under one
    budget (``fracs[0]``, default 0.6x the summed bf16 footprint), one
    ``set_budget`` to ``fracs[1]`` (default 0.45x),
    ``prompts[(phase, tenant)]`` served greedily per tenant per phase."""
    real = pkg.name == "port"
    total = cfg.num_layers * cfg.moe.num_experts
    full16 = cfg.non_expert_bytes() + total * cfg.expert_param_bytes(16)
    cls = pkg.AsyncExpertCache if overlap else pkg.ExpertCache
    swap = cls(capacity_bytes=2 * cfg.expert_param_bytes(16),
               **pkg.cache_kw)
    ctl = (QoSControllerConfig if real else JQoSControllerConfig)(
        min_dwell_iterations=4, window_iterations=2)
    mt = pkg.MultiTenantEngine(0.6 * full16 * 2, expert_cache=swap,
                               controller_config=ctl)
    specs = [pkg.TenantSpec("chat", pkg.QoSTarget(
                 min_tokens_per_s=math.inf), weight=2.0),
             pkg.TenantSpec("batch", pkg.QoSTarget(max_quality_loss=0.1))]
    for spec, p in zip(specs, params):
        kw = dict(max_slots=2, max_len=24, ladder=(16, 8, 4),
                  overlap=overlap)
        if real:
            eng = api.build_engine(cfg, p, api.EngineConfig(hw=HW, **kw),
                                   device="cpu",
                                   expert_cache=swap.scoped(spec.name))
        else:
            eng = JEngine(cfg, p, config=JEngineConfig(hw=JHW, **kw),
                          expert_cache=swap.scoped(spec.name))
        mt.add_tenant(spec, eng)
    req = api.ServeRequest if real else JServeRequest
    tokens, points, margin = {}, [], math.inf
    for phase, frac in enumerate(fracs):
        if phase == 0:
            mt.arbitrate()
        else:
            assert mt.set_budget(frac * full16 * 2)
        points.append({n: point_key(t.point) for n, t in mt.tenants.items()})
        rids = {n: [t.engine.submit_request(req(pr, max_new_tokens=4))
                    for pr in prompts[(phase, n)]]
                for n, t in mt.tenants.items()}
        while mt.has_work():
            mt.run_iteration(temperature=0.0)
        for n, t in mt.tenants.items():
            tokens[(phase, n)] = [t.engine.result(r).tokens
                                  for r in rids[n]]
            if real:
                margin = min(margin, route_margin(t.engine, zip(
                    prompts[(phase, n)], tokens[(phase, n)])))
    used = sum(t.point.qos.device_bytes for t in mt.tenants.values())
    assert used <= mt.budget_bytes
    state = {"points": points, "tokens": tokens,
             "arbitrations": mt.metrics["arbitrations"],
             "reports": [dataclasses.asdict(r) for r in mt.reports],
             "route_counts": [t.engine.route_counts.tobytes()
                              for t in mt.tenants.values()]}
    mt.close()
    return state, margin


@pytest.mark.parametrize("overlap", [False, True])
def test_two_real_tenants_match_reference(two_models, overlap):
    """Tolerance: none — the same points, reports, greedy tokens and
    route counts from the reference's engines and the port's across one
    budget shift. The prompts are seeded draws, redrawn (seed order)
    until the port's routing of every served token clears the near-tie
    screen ``TIE_GAP``; the screen is on the port's side only, so it
    cannot hide a difference the reference would show."""
    jcfg, tcfg, jparams, tparams = two_models
    rng = np.random.default_rng(0)
    for _ in range(20):
        prompts = {(ph, n): [rng.integers(1, tcfg.vocab_size, 8)
                             for _ in range(2)]
                   for ph in (0, 1) for n in ("chat", "batch")}
        got, margin = serve_tenants(PORT, tcfg, tparams, overlap, prompts)
        if margin > TIE_GAP:
            break
    assert margin > TIE_GAP, "no seeded prompt draw clears the tie screen"
    want, _ = serve_tenants(REF, jcfg, jparams, overlap, prompts)
    assert got == want
    assert got["arbitrations"] == 2
    assert not [t for t in threading.enumerate()
                if t.name.startswith("expert-xfer") and t.is_alive()]


@pytest.mark.parametrize("overlap", [False, True])
def test_two_real_bf16_tenants_points_match_reference(overlap):
    """The served dtype, bf16: the outputs that no router near-tie can
    move — each phase's per-tenant points, the ``ReplanReport``\\ s and
    the arbitration count — equal the reference's across one budget
    shift, from 0.9x to 0.35x the summed bf16 footprint, which moves
    the chat tenant's point (tolerance: none). Tokens and route counts
    are held to the reference in float32 above: in bf16 the frameworks'
    router probabilities differ by up to 2.6e-3."""
    jcfg, tcfg, jparams, tparams = _two_models("bfloat16")
    rng = np.random.default_rng(0)
    prompts = {(ph, n): [rng.integers(1, tcfg.vocab_size, 8)
                         for _ in range(2)]
               for ph in (0, 1) for n in ("chat", "batch")}
    fracs = (0.9, 0.35)
    got, _ = serve_tenants(PORT, tcfg, tparams, overlap, prompts, fracs)
    want, _ = serve_tenants(REF, jcfg, jparams, overlap, prompts, fracs)
    keys = ("points", "reports", "arbitrations")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["arbitrations"] == 2
    assert got["points"][0] != got["points"][1] and got["reports"]
    assert {n: len(t) for n, t in got["tokens"].items()} \
        == {n: len(t) for n, t in want["tokens"].items()}


def test_engine_expert_cache_checks(two_models):
    """``expert_cache=`` takes a scoped view; overlap needs an async one,
    prefetch one with ``hint``; a view-backed engine's ``close`` only
    drains the shared space."""
    _, tcfg, _, tparams = two_models
    sync = tec.ExpertCache(capacity_bytes=1 << 20, device="cpu")
    with pytest.raises(ValueError, match="async expert cache"):
        api.build_engine(tcfg, tparams[0], api.EngineConfig(
            hw=HW, overlap=True), device="cpu",
            expert_cache=sync.scoped("a"))

    class NoHint:
        is_async = False

    with pytest.raises(ValueError, match="hint"):
        api.build_engine(tcfg, tparams[0], api.EngineConfig(
            hw=HW, prefetch=True), device="cpu", expert_cache=NoHint())
    shared_async = tec.AsyncExpertCache(capacity_bytes=1 << 20,
                                        device="cpu")
    view = shared_async.scoped("t")
    eng = api.build_engine(tcfg, tparams[0], api.EngineConfig(
        hw=HW, overlap=True, max_len=24, max_slots=2), device="cpu",
        expert_cache=view)
    assert eng.expert_cache is view and view._fetch == eng._fetch_expert
    eng.close()
    assert not shared_async._closed
    shared_async.close()
    assert shared_async._closed


def test_float32_model_on_quantized_banks(two_models):
    """A float32 model on int4/int8/bf16 banks: the plain expert FFN
    promotes the dequantized bf16 weights to the activations' f32 as the
    reference's einsum does (it raised a dtype error before). Tolerance:
    prefill logits within 1e-5 of the reference's."""
    import jax.numpy as jnp
    from repro.core.precision_plan import balanced_ladder_plan as jplan_fn
    from repro.models.model import apply_precision_plan as japply
    from repro_torch.core.precision_plan import balanced_ladder_plan
    from repro_torch.models.model import apply_precision_plan, build_model
    jcfg, tcfg, jparams, tparams = two_models
    kw = dict(ladder=(16, 8, 4), group_size=tcfg.mop.group_size, seed=0)
    counts = {4: 6, 8: 6}
    jserve = japply(jparams[0], jcfg, jplan_fn(2, 8, counts, **kw))
    tserve = apply_precision_plan(tparams[0], tcfg,
                                  balanced_ladder_plan(2, 8, counts, **kw))
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    toks = np.random.default_rng(3).integers(1, tcfg.vocab_size,
                                             (1, 8)).astype(np.int32)
    pos = np.arange(8, dtype=np.int32)[None]
    jl, _ = jm.prefill_into_slot(jserve, jm.init_cache(1, 16),
                                 jnp.asarray(toks), jnp.asarray(pos), 0, 7)
    tl, _ = tm.prefill_into_slot(tserve, tm.init_cache(1, 16, device="cpu"),
                                 torch.from_numpy(toks.astype(np.int64)),
                                 torch.from_numpy(pos.astype(np.int64)),
                                 0, 7)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
