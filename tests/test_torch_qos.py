"""The port's QoS controller (``repro_torch.serving.qos``) and simulator
(``repro_torch.serving.simulator``) against the reference's: every
controller scenario of ``tests/test_qos.py`` replays through both
packages' simulator, controller and Pareto frontier (one explicit hardware
model for both) and must give EQUAL controller metrics, engine metrics,
virtual clocks and applied-plan sequences — exact equality, the numpy
control loop has no tolerance to grant. The scenarios' own assertions run
on the port's side. Then the controller on a real port engine on the CPU:
a best-effort walk, one feasibility replan after a budget drop, and the
adapted engine bit-equal to a fresh engine at its final point."""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.core.pareto import ParetoFrontier as JParetoFrontier
from repro.core.pareto import QoSTarget as JQoSTarget
from repro.serving import qos as jqos
from repro.serving import simulator as jsim
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.pareto import ParetoFrontier, QoSTarget
from repro_torch.models.model import init_params
from repro_torch.serving import qos, simulator
from repro_torch.serving.api import EngineConfig, ServeRequest, build_engine

GIB = 2**30
JHW = JHardwareModel(host_link_bw=24e9)
HW = HardwareModel(**dataclasses.asdict(JHW))

REF = SimpleNamespace(
    name="ref", cfg=jget_config("mixtral-8x7b"), hw=JHW,
    ParetoFrontier=JParetoFrontier, QoSTarget=JQoSTarget,
    QoSController=jqos.QoSController,
    QoSControllerConfig=jqos.QoSControllerConfig,
    SimulatedEngine=jsim.SimulatedEngine, VirtualClock=jsim.VirtualClock,
    run_scripted=jsim.run_scripted, budget_shock=jsim.budget_shock)
PORT = SimpleNamespace(
    name="port", cfg=get_config("mixtral-8x7b"), hw=HW,
    ParetoFrontier=ParetoFrontier, QoSTarget=QoSTarget,
    QoSController=qos.QoSController,
    QoSControllerConfig=qos.QoSControllerConfig,
    SimulatedEngine=simulator.SimulatedEngine,
    VirtualClock=simulator.VirtualClock,
    run_scripted=simulator.run_scripted, budget_shock=simulator.budget_shock)


@pytest.fixture(scope="module")
def frontiers():
    return {pkg.name: pkg.ParetoFrontier(pkg.cfg, pkg.hw)
            for pkg in (REF, PORT)}


def point_key(p):
    return (p.summary(), p.plan.bits.tobytes(), p.plan.location.tobytes())


def state(eng, ctl):
    """Everything a scenario's outcome consists of, comparable across the
    two packages."""
    return {"engine_metrics": dict(eng.metrics),
            "controller_metrics": dict(ctl.metrics) if ctl else None,
            "clock": eng.clock.now(), "replans": eng.replans,
            "applied": [point_key(p) for p in eng.applied],
            "point": point_key(eng.point) if eng.point else None}


def ctl_cfg(pkg, **kw):
    return pkg.QoSControllerConfig(**kw)


def sc_converges(pkg, fr):
    eng = pkg.SimulatedEngine(model_error=0.5)
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, tolerance=0.1, min_dwell_iterations=4, window_iterations=2))
    first = ctl.set_target(pkg.QoSTarget(min_tokens_per_s=5.0,
                                         mem_budget_bytes=60 * GIB))
    assert first.qos.tokens_per_s >= 5.0
    pkg.run_scripted(eng, ctl, 200)
    assert ctl.metrics["last_measured_tps"] >= 5.0 * 0.9
    assert eng.point.qos.device_bytes <= 60 * GIB
    return state(eng, ctl)


def sc_no_action(pkg, fr):
    eng = pkg.SimulatedEngine(model_error=1.0)
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, tolerance=0.1, min_dwell_iterations=4, window_iterations=2))
    ctl.set_target(pkg.QoSTarget(min_tokens_per_s=5.0,
                                 mem_budget_bytes=60 * GIB))
    pkg.run_scripted(eng, ctl, 100)
    assert eng.replans == 1
    return state(eng, ctl)


def sc_hysteresis(pkg, fr):
    eng = pkg.SimulatedEngine(model_error=1e-6)
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, tolerance=0.1, min_dwell_iterations=16, window_iterations=2))
    ctl.set_target(pkg.QoSTarget(min_tokens_per_s=5.0,
                                 mem_budget_bytes=60 * GIB))
    replan_iters = []
    for _ in range(150):
        eng.run_iteration()
        if ctl.step():
            replan_iters.append(eng.metrics["iterations"])
    assert replan_iters and (np.diff([0] + replan_iters) >= 16).all()
    return dict(state(eng, ctl), replan_iters=replan_iters)


def sc_budget_drop(pkg, fr):
    eng = pkg.SimulatedEngine(model_error=1.0)
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, tolerance=0.1, min_dwell_iterations=8, window_iterations=2))
    ctl.set_target(pkg.QoSTarget(min_tokens_per_s=math.inf,
                                 mem_budget_bytes=60 * GIB))
    pkg.run_scripted(eng, ctl, 30)
    before = eng.replans
    pkg.run_scripted(eng, ctl, 60,
                     events={0: pkg.budget_shock(ctl, 20 * GIB)})
    assert eng.replans == before + 1
    assert eng.point.qos.device_bytes <= 20 * GIB
    return dict(state(eng, ctl), replans_before=before)


def sc_quality_recovery(pkg, fr):
    eng = pkg.SimulatedEngine(model_error=1.0)
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, tolerance=0.1, min_dwell_iterations=2, window_iterations=2))
    t = pkg.QoSTarget(min_tokens_per_s=2.0, mem_budget_bytes=60 * GIB)
    fast = fr.feasible(t)[-1]
    ctl.target = t
    ctl._apply(fast)
    pkg.run_scripted(eng, ctl, 200)
    assert eng.point.qos.quality_proxy < fast.qos.quality_proxy
    return state(eng, ctl)


def sc_inf_target(pkg, fr):
    eng = pkg.SimulatedEngine(model_error=1.0)
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, tolerance=0.1, min_dwell_iterations=2, window_iterations=2))
    ctl.set_target(pkg.QoSTarget(min_tokens_per_s=math.inf,
                                 mem_budget_bytes=60 * GIB))
    pkg.run_scripted(eng, ctl, 60)
    assert ctl.metrics["violations"] == 0 and ctl.metrics["decisions"] > 0
    return state(eng, ctl)


def sc_p95(pkg, fr):
    eng = pkg.SimulatedEngine(
        model_error=1.0, latency_fn=lambda p, it: 4.0 / p.qos.tokens_per_s)
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, tolerance=0.1, min_dwell_iterations=2, window_iterations=2))
    p0 = ctl.set_target(pkg.QoSTarget(min_tokens_per_s=1.0,
                                      mem_budget_bytes=60 * GIB))
    ctl.target = pkg.QoSTarget(min_tokens_per_s=1.0,
                               mem_budget_bytes=60 * GIB,
                               max_p95_latency_s=2.0 / p0.qos.tokens_per_s)
    pkg.run_scripted(eng, ctl, 120)
    assert ctl.metrics["violations"] > 0
    return dict(state(eng, ctl),
                p95=eng.latency_percentiles((50, 95), last_n=16))


def sc_violation_hook(pkg, fr):
    fired = []
    eng = pkg.SimulatedEngine(model_error=1e-6)
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, tolerance=0.1, min_dwell_iterations=2, window_iterations=2),
        on_violation=lambda: fired.append(1))
    ctl.set_target(pkg.QoSTarget(min_tokens_per_s=5.0,
                                 mem_budget_bytes=60 * GIB))
    pkg.run_scripted(eng, ctl, 40)
    assert len(fired) == ctl.metrics["violations"] > 0
    return dict(state(eng, ctl), fired=len(fired))


def sc_shocked_replay(pkg, fr):
    eng = pkg.SimulatedEngine(model_error=0.7)
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, tolerance=0.1, min_dwell_iterations=4, window_iterations=2))
    ctl.set_target(pkg.QoSTarget(min_tokens_per_s=4.0,
                                 mem_budget_bytes=60 * GIB))
    pkg.run_scripted(eng, ctl, 80,
                     events={40: pkg.budget_shock(ctl, 30 * GIB)})
    return state(eng, ctl)


def sc_throughput_schedule(pkg, fr):
    point = fr.points[len(fr.points) // 2]
    tps = point.qos.tokens_per_s
    eng = pkg.SimulatedEngine(
        throughput_fn=lambda p, it: tps * (1.0 if it < 10 else 0.5))
    eng.apply_frontier_point(point)
    for _ in range(20):
        eng.run_iteration()
    return state(eng, None)


def sc_overlap_and_spec(pkg, fr):
    """The scripted-transfer and speculative knobs with the acceptance
    fallback (``set_speculation(0)``) under the controller."""
    eng = pkg.SimulatedEngine(
        model_error=0.8, overlap=True, overlap_efficiency=0.5,
        transfer_fn=lambda p, it: 0.01 * (1 + it % 3), spec_k=2,
        acceptance=0.2, clock=pkg.VirtualClock(1.5))
    ctl = pkg.QoSController(eng, fr, ctl_cfg(
        pkg, min_dwell_iterations=4, window_iterations=2,
        spec_min_proposed=8))
    ctl.set_target(pkg.QoSTarget(min_tokens_per_s=6.0,
                                 mem_budget_bytes=40 * GIB))
    pkg.run_scripted(eng, ctl, 60)
    assert ctl.metrics["spec_fallbacks"] == 1 and eng.spec_k == 0
    return dict(state(eng, ctl), summary=ctl.summary())


SCENARIOS = [sc_converges, sc_no_action, sc_hysteresis, sc_budget_drop,
             sc_quality_recovery, sc_inf_target, sc_p95, sc_violation_hook,
             sc_shocked_replay, sc_throughput_schedule, sc_overlap_and_spec]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_controller_replay_equal(frontiers, scenario):
    """Tolerance: none — equal dicts, equal applied-plan sequences."""
    want = scenario(REF, frontiers["ref"])
    got = scenario(PORT, frontiers["port"])
    assert got == want


def test_port_replay_is_bit_identical(frontiers):
    assert sc_shocked_replay(PORT, frontiers["port"]) \
        == sc_shocked_replay(PORT, frontiers["port"])


def test_virtual_clock_guards():
    clk = simulator.VirtualClock()
    with pytest.raises(ValueError):
        clk.advance(-1.0)
    with pytest.raises(ValueError):
        clk.advance(float("nan"))
    clk.advance(2.0)
    with pytest.raises(ValueError):
        clk.advance_to(1.0)
    clk.schedule_at(3.0, "b")
    clk.schedule_at(2.5, "a")
    clk.schedule_at(3.0, "c")
    assert clk.peek() == 2.5 and clk.pending() == 3
    clk.advance_to(3.0)
    assert clk.pop_due() == ["a", "b", "c"]
    with pytest.raises(ValueError):
        clk.schedule_at(1.0, "past")


# ---------------------------------------------------------------------------
# The controller on a real port engine (CPU)
# ---------------------------------------------------------------------------

LADDER = (16, 8, 4)


def serve_tokens(eng, prompts, n, ctl=None, drop=None, drop_at=12):
    """Serve ``prompts`` (greedy, ``n`` tokens each) with ``ctl.step()``
    between iterations; ``drop()`` fires once, before the first iteration
    that starts with at least ``drop_at`` engine iterations done (drain
    iterations of bank-split replans included)."""
    rids = [eng.submit_request(ServeRequest(p, max_new_tokens=n))
            for p in prompts]
    while eng.has_work():
        if drop is not None and eng.metrics["iterations"] >= drop_at:
            drop()
            drop = None
        eng.run_iteration()
        if ctl is not None:
            ctl.step()
    return [eng.result(r).tokens for r in rids]


def test_real_engine_walk_and_budget_drop():
    """A best-effort target adopted at the slowest point walks the real
    engine toward the fast end one adjacent point at a time (decided by
    iteration counts, not clocks; each bank-split step drains the active
    slots first); a budget drop to the middle of the feasible range costs
    exactly one replan and lands inside the budget; and the adapted
    engine serves the same greedy tokens as a fresh engine built at its
    final plan."""
    cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    params = init_params(cfg, seed=0, device="cpu")
    conf = EngineConfig(max_slots=4, max_len=48, ladder=LADDER, hw=HW)
    eng = build_engine(cfg, params, conf, device="cpu")
    fr = eng.frontier
    ctl = qos.QoSController(eng, config=qos.QoSControllerConfig(
        window_iterations=2, min_dwell_iterations=4))
    target = QoSTarget(min_tokens_per_s=math.inf,
                       mem_budget_bytes=max(p.qos.device_bytes
                                            for p in fr.points))
    ctl.adopt(target, fr.points[0])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=16) for _ in range(8)]
    shock = {}

    def drop():
        shock["replans"] = ctl.metrics["replans"]
        smallest = min(p.qos.device_bytes for p in fr.points)
        shock["budget"] = 0.5 * (smallest + ctl.point.qos.device_bytes)
        simulator.budget_shock(ctl, shock["budget"])()

    serve_tokens(eng, prompts, 24, ctl, drop=drop)
    assert shock["replans"] >= 2            # adopt + at least one walk step
    assert fr.points.index(ctl.point) > 0
    # exactly one replan for the drop: select() under the new budget lands
    # on the fastest feasible point, which a best-effort walk never leaves
    assert ctl.metrics["replans"] == shock["replans"] + 1
    assert ctl.point.qos.device_bytes <= shock["budget"]
    assert eng.current_plan.bits.tobytes() == ctl.point.plan.bits.tobytes()
    fresh = build_engine(cfg, params, conf, device="cpu")
    fresh.apply_frontier_point(ctl.point)
    more = [rng.integers(1, cfg.vocab_size, size=16) for _ in range(4)]
    assert serve_tokens(eng, more, 6) == serve_tokens(fresh, more, 6)
    eng.close()
    fresh.close()
