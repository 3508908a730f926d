"""The port's trace-driven control plane (``repro_torch.serving.
control_plane`` and ``repro_torch.launch.simulate``) against the
reference's.

The port's default ``HardwareModel`` is the H100's and the reference's
a TPU v5e chip's, so every comparison hands the port's frontier the
reference's field values (``PORT_HW``). With them:
* the ``golden-32`` report is byte-equal to
  ``tests/fixtures/sim_control_plane_golden.json``, and every other
  scenario run here writes the reference's report bytes;
* the ``simulate`` CLI writes the reference's file and prints the
  reference's lines (all but the wall-clock figures).
The rest are the reference's own properties, checked on the port:
determinism, the seed changes the report, single-shot runs, the
trace layer, no starvation, the autoscaler's hysteresis, one
arbitration per budget shock, and the policy seams. With the port's own
default the report differs from the reference's, by design."""
import dataclasses
import json
import re
import sys

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.core.pareto import ParetoFrontier as JParetoFrontier
from repro.launch import simulate as jsimulate
from repro.serving import control_plane as jcp
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.pareto import ParetoFrontier, QoSTarget
from repro_torch.launch import simulate as tsimulate
from repro_torch.serving import control_plane as tcp
from repro_torch.serving.control_plane import (
    DEFAULT_SLO_CLASSES, ControlPlane, ReplicaAutoscaler, Scenario,
    SLOClass, build_population, get_scenario, run_scenario, trace_events)
from repro_torch.serving.control_plane import plane as tplane
from repro_torch.serving.multi import (FloorSaturationUtility,
                                       GlobalBudgetInfeasible,
                                       ResourceArbiter, TenantSpec,
                                       UtilityPolicy)
from repro_torch.serving.qos import (BandedWalkPolicy, QoSController,
                                     WalkPolicy)
from repro_torch.serving.simulator import SimulatedEngine, run_scripted

GIB = 2**30
GOLDEN = "tests/fixtures/sim_control_plane_golden.json"
PORT_HW = HardwareModel(**dataclasses.asdict(JHardwareModel()))


@pytest.fixture(scope="module")
def frontier():
    return ParetoFrontier(get_config("mixtral-8x7b"), hw=PORT_HW)


@pytest.fixture(scope="module")
def jfrontier():
    return JParetoFrontier(jget_config("mixtral-8x7b"))


@pytest.fixture(scope="module")
def golden_plane(frontier):
    return run_scenario(get_scenario("golden-32"), frontier=frontier)


def same_report(scn, frontier, jfrontier, **kw):
    """Run ``scn`` through both packages; the report bytes must be
    equal. Returns the port's plane."""
    plane = run_scenario(scn, frontier=frontier, **kw)
    jscn = jcp.Scenario(**dataclasses.asdict(scn))
    assert plane.report_bytes() == jcp.run_scenario(
        jscn, frontier=jfrontier, **kw).report_bytes()
    return plane


# ---------------------------------------------------------------------------
# the reference's bytes
# ---------------------------------------------------------------------------
def test_golden_fixture_byte_equal(golden_plane):
    with open(GOLDEN, "rb") as f:
        assert golden_plane.report_bytes() == f.read()


@pytest.mark.parametrize("name", ["steady-64", "golden-32", "diurnal-1k",
                                  "bursty-256"])
def test_catalog_smoke_reports_equal(name, frontier, jfrontier):
    assert sorted(tcp.SCENARIOS) == sorted(jcp.SCENARIOS)
    assert str(get_scenario(name)) == str(jcp.get_scenario(name))
    same_report(get_scenario(name).smoke(), frontier, jfrontier)


def test_port_default_hardware_differs_by_design(jfrontier):
    scn = get_scenario("golden-32").smoke()
    port = run_scenario(scn).report_bytes()
    assert port == run_scenario(scn).report_bytes()
    assert port != jcp.run_scenario(scn, frontier=jfrontier).report_bytes()


def _cli_lines(out):
    """The CLI's printed lines with the wall-clock figures cut out."""
    return [re.sub(r"wall=\S+ \(\d+x realtime\)", "wall", line)
            for line in out.splitlines() if "wrote" not in line]


def test_simulate_cli_smoke_matches(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tplane, "ParetoFrontier",
                        lambda cfg: ParetoFrontier(cfg, hw=PORT_HW))
    tout, jout = tmp_path / "port.json", tmp_path / "ref.json"
    argv = ["--scenario", "golden-32", "--smoke", "--out"]
    assert tsimulate.main(argv + [str(tout)]) == 0
    tprint = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["simulate"])
    assert jsimulate.main(argv + [str(jout)]) == 0
    jprint = capsys.readouterr().out
    assert tout.read_bytes() == jout.read_bytes()
    assert _cli_lines(tprint) == _cli_lines(jprint)
    assert "goodput=" in tprint


def test_simulate_cli_list_and_perf(tmp_path, capsys):
    assert tsimulate.main(["--list"]) == 0
    assert tsimulate.main(["--list"]) == 0 and \
        jsimulate.main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    n = len(tcp.SCENARIOS)
    assert out[n:2 * n] == out[2 * n:]
    body, _, _ = tsimulate.run("golden-32", smoke=True, perf=True)
    assert set(json.loads(body)["perf"]) == {
        "wall_s", "virtual_s", "speedup_x", "tenant_virtual_s_per_wall_s"}


# ---------------------------------------------------------------------------
# trace layer
# ---------------------------------------------------------------------------
def test_population_and_events_match_reference():
    scn, jscn = get_scenario("golden-32"), jcp.get_scenario("golden-32")
    p = build_population(scn, 3, np.random.default_rng(scn.seed))
    jp = jcp.build_population(jscn, 3, np.random.default_rng(jscn.seed))
    for f in ("join_t", "leave_t", "base_rate", "cls", "phase"):
        np.testing.assert_array_equal(getattr(p, f), getattr(jp, f))
    assert [dataclasses.astuple(e) for e in trace_events(p, scn)] == \
        [dataclasses.astuple(e) for e in jcp.trace_events(jp, jscn)]


@pytest.mark.parametrize("name", ["steady-64", "diurnal-1k",
                                  "bursty-256"])
def test_arrival_counts_match_reference(name):
    """Counts over the full population each tick, some tenants inactive:
    the same draws as the reference's, zero for the inactive."""
    scn, jscn = get_scenario(name), jcp.get_scenario(name)
    pop = build_population(scn, 3, np.random.default_rng(7))
    jpop = jcp.build_population(jscn, 3, np.random.default_rng(7))
    model = tcp.make_arrival_model(scn, pop)
    jmodel = jcp.make_arrival_model(jscn, jpop)
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    model.reset(pop.n, rng)
    jmodel.reset(jpop.n, jrng)
    active = np.ones(pop.n, dtype=bool)
    active[::3] = False
    for k in range(5):
        t = k * scn.tick_s
        c = model.counts(t, scn.tick_s, pop.base_rate, active, rng)
        np.testing.assert_array_equal(
            c, jmodel.counts(t, jscn.tick_s, jpop.base_rate, active, jrng))
        assert (c[~active] == 0).all()
        np.testing.assert_array_equal(model.mean_rate(t, pop.base_rate),
                                      jmodel.mean_rate(t, jpop.base_rate))


def test_class_mix_exact():
    scn = get_scenario("diurnal-1k")
    pop = build_population(scn, 3, np.random.default_rng(0))
    for c, (_, frac) in enumerate(scn.class_mix):
        assert int((pop.cls == c).sum()) == int(round(frac * scn.tenants))


def test_mmpp_requires_reset():
    with pytest.raises(RuntimeError, match="reset"):
        tcp.MMPPArrivals(6.0, 0.04, 0.25).mean_rate(0.0, np.ones(4))


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------
def test_byte_identical_reports(frontier):
    scn = get_scenario("golden-32").smoke()
    assert run_scenario(scn, frontier=frontier).report_bytes() == \
        run_scenario(scn, frontier=frontier).report_bytes()


def test_seed_changes_report(frontier, jfrontier):
    scn = dataclasses.replace(get_scenario("golden-32").smoke(), seed=1)
    b1 = run_scenario(get_scenario("golden-32").smoke(),
                      frontier=frontier).report_bytes()
    b2 = same_report(scn, frontier, jfrontier).report_bytes()
    assert b1 != b2


def test_run_is_single_shot(frontier):
    plane = ControlPlane(get_scenario("golden-32").smoke(),
                         frontier=frontier)
    plane.run()
    with pytest.raises(RuntimeError, match="single-shot"):
        plane.run()


# ---------------------------------------------------------------------------
# the golden scenario exercises the whole control surface
# ---------------------------------------------------------------------------
def test_golden_accounting_and_surface(golden_plane):
    led = golden_plane.ledger
    backlog = float(golden_plane.queue.sum())
    assert float(led.arrived.sum()) == pytest.approx(
        float(led.served.sum()) + float(led.dropped.sum()) + backlog)
    t = golden_plane.report()["totals"]
    assert t["preemptions"] >= 1 and t["replans"] >= 1
    assert t["scale_ups"] + t["scale_downs"] >= 1
    assert t["violation_rate"] <= golden_plane.scn.violation_ceiling
    assert t["used_bytes_final"] <= golden_plane.budget_bytes
    assert t["events_recorded"] <= golden_plane.scn.max_recorded_events
    for rep in golden_plane.reports:
        assert rep.tenant.startswith("replica-")
        assert rep.migrated_bytes >= 0 and rep.downtime_s >= 0.0


def test_no_starvation(golden_plane, frontier, jfrontier):
    scn = golden_plane.scn
    aging = np.array([c.aging_s for c in DEFAULT_SLO_CLASSES])
    bound = aging[golden_plane.cls] + 2 * scn.tick_s
    assert (golden_plane.ledger.max_unserved_span_s <= bound + 1e-6).all()
    pre = golden_plane.ledger.preemptions > 0
    assert pre.any() and (golden_plane.ledger.served[pre] > 0).all()
    # a fleet pinned far below demand: only aging gives service
    spec = [("gold", 2, 4.0, 2400.0, 4.0), ("silver", 1, 1.0, 1200.0, 2.0),
            ("bronze", 0, 0.25, 600.0, 1.0)]
    classes = tuple(SLOClass(n, p, f, cap, aging_s=120.0, weight=w)
                    for (n, p, f, cap, w) in spec)
    jclasses = tuple(jcp.SLOClass(n, p, f, cap, aging_s=120.0, weight=w)
                     for (n, p, f, cap, w) in spec)
    scn = Scenario(
        name="starve", tenants=24, horizon_s=2000.0, tick_s=20.0,
        rate_range_tps=(0.8, 1.2), slots_per_replica=2,
        budget_bytes=7.0 * GIB, min_replicas=2, max_replicas=2,
        util_band=(0.01, 0.999))
    plane = ControlPlane(scn, classes=classes, frontier=frontier)
    plane.run()
    jplane = jcp.ControlPlane(jcp.Scenario(**dataclasses.asdict(scn)),
                              classes=jclasses, frontier=jfrontier)
    jplane.run()
    assert plane.report_bytes() == jplane.report_bytes()
    assert plane.report()["totals"]["forced_admissions"] >= 1
    assert (plane.ledger.max_unserved_span_s
            <= 120.0 + 2 * scn.tick_s + 1e-6).all()


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------
def test_steady_trace_never_oscillates(frontier, jfrontier):
    t = same_report(get_scenario("steady-64"), frontier,
                    jfrontier).report()["totals"]
    assert t["scale_ups"] == 0 and t["scale_downs"] == 0
    assert t["preemptions"] == 0


# (steps, kwargs): each step is (t, util, replicas[, can_add, can_remove])
HYSTERESIS = {
    "patience": (dict(band=(0.4, 0.85), patience_ticks=3, cooldown_s=0.0),
                 [(0.0, 0.95, 2), (1.0, 0.95, 2), (2.0, 0.95, 2),
                  (3.0, 0.95, 3)], [0, 0, 1, 0]),
    "dip_resets": (dict(patience_ticks=3, cooldown_s=0.0),
                   [(0.0, 0.9, 2), (1.0, 0.9, 2), (2.0, 0.5, 2),
                    (3.0, 0.9, 2)], [0, 0, 0, 0]),
    "cooldown": (dict(patience_ticks=1, cooldown_s=100.0),
                 [(0.0, 0.95, 2), (50.0, 0.95, 3), (150.0, 0.95, 3)],
                 [1, 0, 1]),
    "projection_guard": (dict(band=(0.4, 0.85), patience_ticks=1,
                              cooldown_s=0.0),
                         [(0.0, 0.35, 3), (1.0, 0.39, 2), (2.0, 0.42, 2)],
                         [-1, -1, 0]),
    "bounds": (dict(patience_ticks=1, cooldown_s=0.0, min_replicas=2,
                    max_replicas=4),
               [(0.0, 0.95, 4), (1.0, 0.95, 3, False, True),
                (2.0, 0.05, 2), (3.0, 0.05, 3, True, False)],
               [0, 0, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(HYSTERESIS))
def test_autoscaler_hysteresis(case):
    kw, steps, want = HYSTERESIS[case]
    a, ja = ReplicaAutoscaler(**kw), jcp.ReplicaAutoscaler(**kw)
    got, ref = [], []
    for s in steps:
        t, util, n = s[:3]
        flags = dict(zip(("can_add", "can_remove"), s[3:]))
        got.append(a.step(t, util, n, **flags))
        ref.append(ja.step(t, util, n, **flags))
    assert got == ref == want


def test_bad_band_rejected():
    with pytest.raises(ValueError, match="band"):
        ReplicaAutoscaler(band=(0.9, 0.5))


# ---------------------------------------------------------------------------
# exactly one re-arbitration per budget shock
# ---------------------------------------------------------------------------
def test_one_arbitration_per_shock_1k(frontier, jfrontier):
    scn = Scenario(
        name="shock-1k", tenants=1000, horizon_s=2500.0, tick_s=25.0,
        arrival="poisson", rate_range_tps=(0.05, 0.15),
        budget_bytes=400.0 * GIB, slots_per_replica=24,
        min_replicas=2, max_replicas=2,
        budget_shocks=((1000.0, 0.9), (2000.0, 1.0)),
        util_band=(0.005, 0.999))
    t = same_report(scn, frontier, jfrontier).report()["totals"]
    assert t["preemptions"] == 0
    assert t["scale_ups"] == 0 and t["scale_downs"] == 0
    assert t["arbitrations"] == 1 + len(scn.budget_shocks)


def test_infeasible_budget_raises(frontier):
    scn = Scenario(name="tiny", tenants=4, horizon_s=100.0, tick_s=10.0,
                   budget_bytes=1.0 * GIB, min_replicas=2)
    with pytest.raises(GlobalBudgetInfeasible):
        run_scenario(scn, frontier=frontier)


def test_deep_shock_retires_replicas(frontier):
    cheapest = min(p.qos.device_bytes for p in frontier.points)
    scn = Scenario(
        name="crunch", tenants=32, horizon_s=600.0, tick_s=20.0,
        rate_range_tps=(0.05, 0.15), slots_per_replica=4,
        budget_bytes=8.0 * cheapest, min_replicas=2, max_replicas=4,
        budget_shocks=((300.0, 0.3),), util_band=(0.005, 0.999))
    plane = ControlPlane(scn, frontier=frontier)
    for _ in range(2):
        plane._add_replica(0.0)          # start with 4 replicas
    plane.run()
    t = plane.report()["totals"]
    assert t["replicas_final"] == 2
    assert t["scale_downs"] >= 2
    assert t["arbitrations"] == 1 + 1    # initial + the shock


# ---------------------------------------------------------------------------
# pluggable policy seams
# ---------------------------------------------------------------------------
def test_custom_walk_policy_drives_controller(frontier):
    class Pin(WalkPolicy):
        def decide(self, ctl, measured):
            return max(ctl.frontier.points,
                       key=lambda p: p.qos.tokens_per_s)

    eng = SimulatedEngine(model_error=0.5)
    ctl = QoSController(eng, frontier, policy=Pin())
    ctl.set_target(QoSTarget(min_tokens_per_s=1.0))
    run_scripted(eng, ctl, 40)
    assert ctl.point is max(frontier.points,
                            key=lambda p: p.qos.tokens_per_s)
    assert isinstance(QoSController(SimulatedEngine(), frontier).policy,
                      BandedWalkPolicy)


def test_custom_utility_changes_arbitration(frontier):
    class CheapestWins(UtilityPolicy):
        def build(self, feas, target, derate):
            return lambda p: -float(p.qos.device_bytes)

    specs = [(TenantSpec(f"t{i}", QoSTarget(min_tokens_per_s=20.0)),
              frontier, 1.0) for i in range(3)]
    _, used_default = ResourceArbiter().arbitrate(specs, 200.0 * GIB)
    _, used_cheap = ResourceArbiter(utility=CheapestWins()).arbitrate(
        specs, 200.0 * GIB)
    cheapest = min(p.qos.device_bytes for p in frontier.points)
    assert used_cheap == pytest.approx(3 * cheapest)
    assert used_default > used_cheap
    u = FloorSaturationUtility().build(
        frontier.points, QoSTarget(min_tokens_per_s=0.0), 1.0)
    assert all(np.isfinite(u(p)) for p in frontier.points)
    plane = ControlPlane(dataclasses.replace(get_scenario("steady-64"),
                                             floor_weight=123.0),
                         frontier=frontier)
    assert plane.arbiter.floor_weight == 123.0
