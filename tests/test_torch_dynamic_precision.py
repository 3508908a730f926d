"""The port's dynamic-precision controller
(``repro_torch.core.dynamic_precision``) and the engine's
``apply_bits_update`` against the reference's.

* Controller replays: every simulator scenario of
  ``tests/test_dynamic_precision.py`` runs through both packages'
  simulator, frontier, profile and controller and must give EQUAL
  controller metrics, final bits, folded traffic, quality costs and
  ``ReplanReport``\\ s (exact: the loop is float64 numpy on both sides).
* Real engines: the reference's engine and the port's on the same
  converted params, hardware model and frontier point; one rung swap of
  two same-layer offloaded experts must give the same report dict, the
  same cache byte accounting and the same greedy tokens afterwards.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import dynamic_precision as jdp
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.core.pareto import ParetoFrontier as JParetoFrontier
from repro.core.sensitivity import SensitivityProfile as JProfile
from repro.models.model import build_model as jbuild_model
from repro.serving import simulator as jsim
from repro.serving.api import EngineConfig as JEngineConfig
from repro.serving.engine import AdaptiveServingEngine as JEngine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import cost_model
from repro_torch.core import dynamic_precision as dp
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.pareto import ParetoFrontier
from repro_torch.core.precision_plan import HOST
from repro_torch.core.sensitivity import SensitivityProfile
from repro_torch.models.model import params_from_numpy
from repro_torch.serving import simulator
from repro_torch.serving.api import EngineConfig, build_engine

JHW = JHardwareModel(host_link_bw=24e9)
HW = HardwareModel(**dataclasses.asdict(JHW))

REF = SimpleNamespace(
    name="ref", smoke=jreduce(jget_config("mixtral-8x7b")),
    full=jget_config("mixtral-8x7b"), hw=JHW,
    ParetoFrontier=JParetoFrontier, Profile=JProfile,
    Controller=jdp.DynamicPrecisionController,
    Config=jdp.DynamicPrecisionConfig,
    SimulatedEngine=jsim.SimulatedEngine, zipf_route_fn=jsim.zipf_route_fn)
PORT = SimpleNamespace(
    name="port", smoke=reduce_for_smoke(get_config("mixtral-8x7b")),
    full=get_config("mixtral-8x7b"), hw=HW,
    ParetoFrontier=ParetoFrontier, Profile=SensitivityProfile,
    Controller=dp.DynamicPrecisionController,
    Config=dp.DynamicPrecisionConfig,
    SimulatedEngine=simulator.SimulatedEngine,
    zipf_route_fn=simulator.zipf_route_fn)


@pytest.fixture(scope="module")
def frontiers():
    return {pkg.name: pkg.ParetoFrontier(pkg.smoke, pkg.hw)
            for pkg in (REF, PORT)}


def mixed_point(frontier):
    """A frontier point with both rungs present and full residency."""
    pts = [p for p in frontier.all_points
           if 0 < p.num_q_experts < p.plan.bits.size
           and p.plan.resident_fraction() == 1.0]
    assert pts
    return pts[len(pts) // 2]


def ctl_state(eng, ctl):
    return {"metrics": dict(ctl.metrics),
            "bits": eng.current_plan.bits.tobytes(),
            "engine_metrics": dict(eng.metrics),
            "ema": None if ctl.measured_freq() is None
            else ctl.measured_freq().tobytes(),
            "profile": ctl.profile.to_json_bytes(),
            "quality_cost": ctl.quality_cost_measured(),
            "reports": [dataclasses.asdict(r) for r in ctl.reports]}


def run_dynamic(pkg, fr, route_fn, iterations, config=None, **sim_kw):
    point = mixed_point(fr)
    eng = pkg.SimulatedEngine(batch=4, route_fn=route_fn, **sim_kw)
    eng.apply_frontier_point(point)
    ctl = pkg.Controller(eng, pkg.Profile.uniform(pkg.smoke),
                         config if config is not None else pkg.Config())
    swaps, flips, prev = [], np.zeros_like(point.plan.bits), \
        point.plan.bits.copy()
    for _ in range(iterations):
        eng.run_iteration()
        before = ctl.metrics["swaps"]
        ctl.step()
        swaps.append(int(ctl.metrics["swaps"] - before))
        flips += eng.current_plan.bits != prev
        prev = eng.current_plan.bits.copy()
    return eng, ctl, point, swaps, flips


def sc_zipf(pkg, fr):
    point = mixed_point(fr)
    L, E = point.plan.bits.shape
    eng, ctl, point, swaps, _ = run_dynamic(
        pkg, fr, pkg.zipf_route_fn(L, E, seed=3), 40)
    final = eng.current_plan
    assert ctl.metrics["swaps"] > 0
    assert final.bits[:, :E // 2].mean() > final.bits[:, E // 2:].mean()
    assert ctl.profile.quality_cost(final) \
        < ctl.profile.quality_cost(point.plan)
    assert all(r.placement_only for r in ctl.reports)
    return dict(ctl_state(eng, ctl), swaps=swaps)


def sc_alternating(pkg, fr):
    point = mixed_point(fr)
    L, E = point.plan.bits.shape
    eng, ctl, _, swaps, flips = run_dynamic(
        pkg, fr, pkg.zipf_route_fn(L, E, seed=3, hot_rotation=1), 40)
    assert flips.max() <= 2 and sum(swaps[20:]) == 0
    return dict(ctl_state(eng, ctl), swaps=swaps, flips=flips.tobytes())


def sc_margin(pkg, fr):
    point = mixed_point(fr)
    L, E = point.plan.bits.shape
    eng, ctl, point, _, _ = run_dynamic(
        pkg, fr, pkg.zipf_route_fn(L, E, seed=3), 20,
        config=pkg.Config(margin=1e9))
    assert ctl.metrics["swaps"] == 0
    return ctl_state(eng, ctl)


def sc_empty_window(pkg, fr):
    eng, ctl, _, _, _ = run_dynamic(pkg, fr, None, 3)
    assert ctl.metrics["swaps"] == 0 and ctl.measured_freq() is None
    return ctl_state(eng, ctl)


def sc_tuned(pkg, fr):
    """Other guard settings and a Zipf skew with more tokens: more swaps
    per step, a shorter dwell, a faster EMA."""
    point = mixed_point(fr)
    L, E = point.plan.bits.shape
    eng, ctl, _, swaps, _ = run_dynamic(
        pkg, fr, pkg.zipf_route_fn(L, E, alpha=2.0, tokens_per_iter=256,
                                   seed=11, hot_rotation=10), 50,
        config=pkg.Config(ema_decay=0.5, min_dwell_steps=2, margin=0.02,
                          max_swaps_per_step=2))
    assert ctl.metrics["swaps"] > 0
    return dict(ctl_state(eng, ctl), swaps=swaps)


def sc_route_counts_survive(pkg, fr):
    point = mixed_point(fr)
    L, E = point.plan.bits.shape
    eng = pkg.SimulatedEngine(batch=4, route_fn=pkg.zipf_route_fn(L, E))
    eng.apply_frontier_point(point)
    for _ in range(3):
        eng.run_iteration()
    counts = eng.route_counts.copy()
    eng.apply_frontier_point(point)
    assert (eng.route_counts == counts).all()
    eng.run_iteration()
    after = eng.route_counts.copy()
    eng.reset_route_counts()
    return {"counts": counts.tobytes(), "after": after.tobytes(),
            "reset": int(eng.route_counts.sum())}


SCENARIOS = [sc_zipf, sc_alternating, sc_margin, sc_empty_window, sc_tuned,
             sc_route_counts_survive]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_controller_replay_equal(frontiers, scenario):
    """Tolerance: none — equal metrics, bits, profiles and reports."""
    want = scenario(REF, frontiers["ref"])
    got = scenario(PORT, frontiers["port"])
    assert got == want


def test_uniform_profile_frontier_bit_identical():
    """A uniform profile prices exactly like the flat table: the frontier
    records (float.hex) are byte-identical with and without it."""
    prof = SensitivityProfile.uniform(PORT.full)
    assert ParetoFrontier(PORT.full, HW, profile=prof).records() \
        == ParetoFrontier(PORT.full, HW).records()


def test_sim_bits_update_rejects_count_changes(frontiers):
    eng = simulator.SimulatedEngine()
    point = mixed_point(frontiers["port"])
    eng.apply_frontier_point(point)
    bad = point.plan.bits.copy()
    bad[0, 0] = 16 if bad[0, 0] != 16 else 4
    with pytest.raises(ValueError, match="rung counts"):
        eng.apply_bits_update(bad)


# ---------------------------------------------------------------------------
# apply_bits_update on real engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = REF.smoke, PORT.smoke
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def offloaded_pair(plan):
    """(li, e_lo, e_hi): two same-layer HOST experts at different rungs."""
    for li in range(plan.bits.shape[0]):
        host = np.flatnonzero(plan.location[li] == HOST)
        rungs = sorted({int(plan.bits[li, e]) for e in host})
        if len(rungs) < 2:
            continue
        e_lo = next(int(e) for e in host if plan.bits[li, e] == rungs[0])
        e_hi = next(int(e) for e in host if plan.bits[li, e] == rungs[-1])
        return li, e_lo, e_hi
    return None


def pick_pair_point(frontier):
    for i, p in enumerate(frontier.all_points):
        if p.plan.resident_fraction() < 1.0 and offloaded_pair(p.plan):
            return i
    raise AssertionError("no frontier point with a mixed-rung HOST pair")


PROMPTS = [np.array([5, 6, 7]), np.array([9, 2, 11, 4])]


def serve(engine):
    rids = [engine.submit(p, max_new_tokens=4) for p in PROMPTS]
    engine.step()
    return [list(engine.done[r].out_tokens) for r in rids]


@pytest.mark.parametrize("cached", ["both", "low"])
@pytest.mark.parametrize("overlap", [False, True])
def test_bits_update_matches_reference(smoke, cached, overlap):
    """Tolerance: none for the report, the byte accounting and the greedy
    tokens (the engines' token streams are equal by the engine parity
    bar). ``cached`` stages both experts of the swap pair or only the
    low-rung one; ``overlap`` runs the swap over the async cache."""
    jcfg, tcfg, jparams, tparams = smoke
    kw = dict(max_slots=2, max_len=24, ladder=(16, 8, 4), overlap=overlap)
    jeng = JEngine(jcfg, jparams, config=JEngineConfig(hw=JHW, **kw))
    teng = build_engine(tcfg, tparams, EngineConfig(hw=HW, **kw),
                        device="cpu")
    i = pick_pair_point(jeng.frontier)
    assert pick_pair_point(teng.frontier) == i
    out = {}
    for name, eng in (("ref", jeng), ("port", teng)):
        point = eng.frontier.all_points[i]
        eng.apply_frontier_point(point)
        li, e_lo, e_hi = offloaded_pair(point.plan)
        eng.expert_cache.get((li, e_lo))
        if cached == "both":
            eng.expert_cache.get((li, e_hi))
        used0 = eng.expert_cache.used_bytes
        old = eng.current_plan
        bits = old.bits.copy()
        bits[li, e_lo], bits[li, e_hi] = old.bits[li, e_hi], \
            old.bits[li, e_lo]
        report = eng.apply_bits_update(bits)
        assert report["cache_bytes_delta"] \
            == eng.expert_cache.used_bytes - used0
        out[name] = {
            "report": report, "used": eng.expert_cache.used_bytes,
            "bits": eng.current_plan.bits.tobytes(),
            "order": eng._order.tobytes(),
            "qos": dataclasses.asdict(eng._plan_result.qos),
            "resident": sorted(eng.expert_cache.resident_keys()),
            "tokens": serve(eng),
            "route_counts": eng.route_counts.tobytes()}
        eng.close()
    assert out["port"] == out["ref"]
    assert out["port"]["report"]["flipped"] == 2
    assert out["port"]["report"]["restaged"] == (2 if cached == "both"
                                                 else 1)
    # byte-neutral swap: the plan's device bytes are unchanged
    assert cost_model.device_bytes(tcfg, teng.current_plan) \
        == cost_model.device_bytes(tcfg, teng.frontier.all_points[i].plan)


def test_bits_update_guards_and_stale_blobs(smoke):
    """Refused updates (rung counts, foreign rung, shape) change nothing;
    a placement-only replan after a swap drops the swapped-rung blobs;
    a no-op update reports zeros without rebuilding."""
    _, tcfg, _, tparams = smoke
    eng = build_engine(tcfg, tparams, EngineConfig(
        max_slots=2, max_len=24, ladder=(16, 8, 4), hw=HW), device="cpu")
    i = pick_pair_point(eng.frontier)
    point = eng.frontier.all_points[i]
    eng.apply_frontier_point(point)
    li, e_lo, e_hi = offloaded_pair(point.plan)
    old = eng.current_plan
    params0 = eng._serve_params
    assert eng.apply_bits_update(old.bits.copy()) == {
        "flipped": 0, "promotions": 0, "demotions": 0,
        "cache_bytes_delta": 0, "restaged": 0}
    assert eng._serve_params is params0
    bad = old.bits.copy()
    bad[li, e_lo] = old.bits[li, e_hi]
    with pytest.raises(ValueError, match="rung counts"):
        eng.apply_bits_update(bad)
    bad = old.bits.copy()
    bad[li, e_lo] = 2
    with pytest.raises(ValueError, match="not on ladder"):
        eng.apply_bits_update(bad)
    with pytest.raises(ValueError, match="shape"):
        eng.apply_bits_update(old.bits[:1])
    assert eng.current_plan is old
    eng.expert_cache.get((li, e_lo))
    bits = old.bits.copy()
    bits[li, e_lo], bits[li, e_hi] = old.bits[li, e_hi], old.bits[li, e_lo]
    eng.apply_bits_update(bits)
    assert eng.metrics["bits_updates"] == 1
    assert eng.metrics["rung_flips"] == 2
    eng.apply_frontier_point(point)          # back to the canonical bits
    assert (li, e_lo) not in eng.expert_cache.resident_keys()
    eng.expert_cache.get((li, e_lo))
    rung = int(eng.current_plan.bits[li, e_lo])
    assert rung == int(old.bits[li, e_lo])
    assert eng.expert_cache.used_bytes == tcfg.expert_param_bytes(rung)
    eng.close()


@pytest.mark.parametrize("path", ["bits_update", "bank_split"])
def test_failed_bank_rebuild_refuses_later_work(smoke, monkeypatch, path):
    """A rebuild releases the old banks before it builds the new ones, so
    one that fails (out of memory at full width) leaves nothing to serve
    on: the error propagates, and every later iteration, replan and bits
    update raises a RuntimeError that says so instead of serving on
    missing banks."""
    import repro_torch.serving.engine as tengine
    _, tcfg, _, tparams = smoke
    eng = build_engine(tcfg, tparams, EngineConfig(
        max_slots=2, max_len=24, ladder=(16, 8, 4), hw=HW), device="cpu")
    i = pick_pair_point(eng.frontier)
    point = eng.frontier.all_points[i]
    eng.apply_frontier_point(point)
    eng.submit(np.arange(1, 9), max_new_tokens=4)
    eng.run_iteration()

    def out_of_memory(*a, **k):
        raise MemoryError("no room for the new banks")

    monkeypatch.setattr(tengine, "apply_precision_plan", out_of_memory)
    if path == "bits_update":
        li, e_lo, e_hi = offloaded_pair(point.plan)
        bits = point.plan.bits.copy()
        bits[li, e_lo], bits[li, e_hi] = bits[li, e_hi], bits[li, e_lo]
        with pytest.raises(MemoryError):
            eng.apply_bits_update(bits)
    else:
        other = next(p for p in eng.frontier.points
                     if p.plan.bank_sizes() != point.plan.bank_sizes())
        with pytest.raises(MemoryError):
            eng.apply_frontier_point(other)
    assert eng._serve_params is None
    monkeypatch.undo()
    for call in (eng.run_iteration, lambda: eng.apply_frontier_point(point),
                 lambda: eng.apply_bits_update(point.plan.bits.copy())):
        with pytest.raises(RuntimeError, match="cannot serve: build a new"):
            call()
    eng.close()
