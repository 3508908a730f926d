"""The port's expert-parallel and data-parallel serving
(``repro_torch.serving.ep``, the engine's ``mesh=``) on the CPU, with
devices given as ``["cpu"] * n``:

* the reference's engine parity script, ported: an engine over a (1, 2)
  mesh serves the same greedy tokens as the single-device engine, across
  a replan that migrates experts between ranks (paged, slot, overlap and
  speculative configs);
* an EP frontier point applied through ``apply_frontier_point``: its
  exact (resident, peer) split is pinned, and the plan and the greedy
  tokens are the reference engine's at ``EngineConfig(ep=2)``;
* the reference's ``TestDPReplicaGroup`` cases on fake engines, and
  ``make_dp_group(dp=2, ep=2)`` on real engines through an autoscaler
  scale-down that drains a replica with a request in flight;
* ``build_ep_engine``: ep = 1 is the plain engine, a conflicting
  ``EngineConfig.ep`` and a layout that does not divide raise."""
import dataclasses
import warnings

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.models.model import build_model as jbuild_model
from repro.serving.api import EngineConfig as JEngineConfig
from repro.serving.engine import AdaptiveServingEngine as JEngine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.precision_plan import HOST, PEER
from repro_torch.launch.mesh import make_ep_mesh
from repro_torch.models.model import init_params, params_from_numpy
from repro_torch.serving.api import (EngineConfig, ServeRequest, ServeResult,
                                     build_engine)
from repro_torch.serving.control_plane.autoscale import ReplicaAutoscaler
from repro_torch.serving.ep import (DPReplicaGroup, build_ep_engine,
                                    make_dp_group)

JHW = JHardwareModel(host_link_bw=24e9)
HW = HardwareModel(**dataclasses.asdict(JHW))


def cpus(n):
    return ["cpu"] * n


@pytest.fixture(scope="module")
def smoke():
    cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    return cfg, init_params(cfg, 0, device="cpu")


def _configure(eng, num_q):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        full = eng.planner.size_ne \
            + eng.planner.num_experts_total * eng.planner.size_e16
        return eng.configure(full, "quality", num_q)


# ---------------------------------------------------------------------------
# the EP engine: the reference's engine parity script
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    {}, {"paged_kv": False}, {"overlap": True}, {"speculate": 2}],
    ids=["paged", "slot", "overlap", "speculate"])
def test_engine_tokens_identical_across_ep(smoke, extra):
    cfg, params = smoke
    outs, shards = {}, {}
    for ep in (1, 2):
        eng = build_ep_engine(
            cfg, params, EngineConfig(max_slots=2, max_len=16, hw=HW,
                                      **extra),
            ep=ep, devices=cpus(ep))
        assert (eng.mesh is None) == (ep == 1)
        _configure(eng, 4 * cfg.num_layers)
        before = eng.current_plan.device_assignment(2)
        rng = np.random.default_rng(0)
        rids = [eng.submit(rng.integers(1, cfg.vocab_size, 6),
                           max_new_tokens=4) for _ in range(3)]
        eng.step(temperature=0.0)
        # mid-deployment replan: every expert drops to int4, bank
        # membership changes, experts migrate between EP ranks
        _configure(eng, 8 * cfg.num_layers)
        after = eng.current_plan.device_assignment(2)
        assert (before != after).any()
        rids2 = [eng.submit(rng.integers(1, cfg.vocab_size, 6),
                            max_new_tokens=4) for _ in range(3)]
        eng.step(temperature=0.0)
        outs[ep] = ([eng.result(r).tokens for r in rids],
                    [eng.result(r).tokens for r in rids2])
        if ep == 2:
            shards = eng._serve_params["layers"]["moe"]["banks"]
        eng.close()
    assert outs[1] == outs[2], outs
    # the rebuilt banks are rank shards: every rank holds half of the
    # int4 bank of every layer
    assert len(shards) == 2 and all(
        s["q4"]["w_up"].q.shape[:2] == (cfg.num_layers,
                                        cfg.moe.num_experts // 2)
        for s in shards)


def test_ep_frontier_point_pins_its_peer_split_like_the_reference():
    """The EP apply path: a frontier point with PEER experts is applied
    with its exact (resident, peer) split; plan and greedy tokens equal
    the reference engine's at ``EngineConfig(ep=2)``."""
    jcfg = jreduce(jget_config("mixtral-8x7b"))
    tcfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    jparams = jbuild_model(jcfg).init(jax.random.key(1))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    jeng = JEngine(jcfg, jparams, config=JEngineConfig(
        max_slots=2, max_len=16, hw=JHW, ep=2))
    teng = build_engine(tcfg, tparams, EngineConfig(
        max_slots=2, max_len=16, hw=HW),
        mesh=make_ep_mesh(2, devices=cpus(2)))
    assert teng.config.ep == 2 and teng.planner.ep == 2
    jpts, tpts = jeng.frontier.points, teng.frontier.points
    assert [p.summary() for p in tpts] == [p.summary() for p in jpts]
    i = max(i for i, p in enumerate(tpts) if p.peer_experts > 0)
    point = tpts[i]
    jeng.apply_frontier_point(jpts[i])
    teng.apply_frontier_point(point)
    plan = teng.current_plan
    assert int((plan.location == PEER).sum()) == point.peer_experts > 0
    assert int((plan.location != HOST).sum()) == point.resident_experts
    np.testing.assert_array_equal(plan.bits, jeng.current_plan.bits)
    np.testing.assert_array_equal(plan.location,
                                  jeng.current_plan.location)
    # PEER experts are served by their rank: never streamed
    assert all(int(plan.location[li, ei]) != HOST
               for li, ei in teng._resident)
    prompts = [np.arange(3, 9), np.array([9, 2, 11, 4, 6])]
    got, want = [], []
    for p in prompts:
        got.append(teng.submit(p, max_new_tokens=4))
        want.append(jeng.submit(p, max_new_tokens=4))
    teng.step(temperature=0.0)
    jeng.step(temperature=0.0)
    assert [teng.result(r).tokens for r in got] \
        == [jeng.result(r).tokens for r in want]
    teng.close()
    jeng.close()


def test_build_ep_engine_layouts(smoke):
    cfg, params = smoke
    plain = build_ep_engine(cfg, params, EngineConfig(max_slots=2,
                                                      max_len=16),
                            ep=1, devices=cpus(1))
    assert plain.mesh is None and plain.planner.ep == 1
    with pytest.raises(ValueError, match="conflicts"):
        build_ep_engine(cfg, params, EngineConfig(ep=4), ep=2,
                        devices=cpus(2))
    with pytest.raises(ValueError, match="does not divide"):
        build_ep_engine(cfg, params, ep=3, devices=cpus(3))
    with pytest.raises(ValueError, match="mesh's first device"):
        build_engine(cfg, params, mesh=make_ep_mesh(2, devices=cpus(2)),
                     device="meta")
    # replica 1 of a (1, 2) layout takes the second pair of devices
    eng = build_ep_engine(cfg, params, EngineConfig(max_slots=2,
                                                    max_len=16),
                          ep=2, replica=1, devices=cpus(4))
    assert eng.mesh.devices == tuple(eng.mesh.devices[:1]) * 2
    eng.close()


# ---------------------------------------------------------------------------
# the DP replica group (the reference's TestDPReplicaGroup, fake engines)
# ---------------------------------------------------------------------------

class _FakeScheduler:
    def __init__(self):
        self.queue = []
        self.num_active = 0


class _FakeEngine:
    """Engine-shaped stub: one queued request retires per iteration."""

    def __init__(self, slot):
        self.slot = slot
        self.scheduler = _FakeScheduler()
        self.max_slots = 2
        self.metrics = {"tokens_generated": 0, "iterations": 0}
        self.closed = False
        self.target = None
        self._next = 0

    def submit_request(self, request):
        rid = self._next
        self._next += 1
        self.scheduler.queue.append(rid)
        return rid

    def has_work(self):
        return bool(self.scheduler.queue)

    def run_iteration(self, **kw):
        self.metrics["iterations"] += 1
        if not self.scheduler.queue:
            return []
        rid = self.scheduler.queue.pop(0)
        self.metrics["tokens_generated"] += 4
        return [rid]

    def result(self, rid):
        return ServeResult(rid=rid, tokens=[1, 2, 3, 4], latency_s=0.1,
                           ttft_s=None, priority=0, deadline_s=None,
                           deadline_met=None)

    def apply_target(self, target):
        self.target = target
        return ("point", self.slot)

    def throughput_tokens_per_s(self, include_transfer=True):
        return 10.0

    def close(self):
        self.closed = True


class TestDPReplicaGroup:
    def _group(self, n=2, max_replicas=4):
        return DPReplicaGroup(_FakeEngine, replicas=n,
                              max_replicas=max_replicas)

    def test_least_loaded_routing_and_global_rids(self):
        g = self._group(2)
        rids = [g.submit_request(object()) for _ in range(4)]
        assert rids == [0, 1, 2, 3]
        # balanced: 2 requests per replica
        assert [len(e.scheduler.queue) for e in g.engines] == [2, 2]
        retired = []
        while g.has_work():
            retired += g.run_iteration()
        assert sorted(retired) == rids
        # results survive with the GLOBAL rid, no cross-replica collision
        assert [g.result(r).rid for r in rids] == rids
        with pytest.raises(KeyError):
            g.result(99)

    def test_scale_down_drains_never_drops(self):
        g = self._group(2)
        for _ in range(4):
            g.submit_request(object())
        g.scale_to(1)
        assert g.n_replicas == 1          # victim no longer serves...
        assert len(g.engines) == 2        # ...but finishes its work
        new_rid = g.submit_request(object())
        done = []
        while g.has_work():
            done += g.run_iteration()
        assert len(g.engines) == 1 and g.n_replicas == 1
        assert sorted(done) == [0, 1, 2, 3, new_rid]

    def test_scale_up_inherits_target_and_reuses_slots(self):
        g = self._group(2)
        g.apply_target("TARGET")
        g.scale_to(1)
        g.run_iteration()
        assert len(g.engines) == 1
        g.scale_to(3)
        assert sorted(e.slot for e in g.engines) == [0, 1, 2]
        assert all(e.target == "TARGET" for e in g.engines)
        with pytest.raises(ValueError):
            g.scale_to(5)                 # beyond max_replicas
        with pytest.raises(ValueError):
            g.scale_to(0)

    def test_metrics_and_throughput_aggregate(self):
        g = self._group(2)
        for _ in range(2):
            g.submit_request(object())
        while g.has_work():
            g.run_iteration()
        m = g.metrics
        assert m["tokens_generated"] == 8
        assert m["replicas"] == 2 and m["draining"] == 0
        assert g.throughput_tokens_per_s() == 20.0

    def test_autoscaler_decisions_drive_real_engines(self):
        g = self._group(1, max_replicas=2)
        auto = ReplicaAutoscaler(patience_ticks=2, cooldown_s=10.0,
                                 max_replicas=2)
        # saturate: queue >> capacity -> util 1.0 -> +1 after patience
        for _ in range(6):
            g.submit_request(object())
        assert g.demand_util() == 1.0
        decisions = [g.autoscale_step(float(t), auto) for t in range(3)]
        assert 1 in decisions and g.n_replicas == 2
        # drain the queue, then idle -> -1 after cooldown + patience
        while g.has_work():
            g.run_iteration()
        assert g.demand_util() == 0.0
        decisions = [g.autoscale_step(100.0 + t, auto) for t in range(4)]
        assert -1 in decisions and g.n_replicas == 1

    def test_close_closes_every_replica(self):
        g = self._group(2)
        engines = list(g.engines)
        g.close()
        assert all(e.closed for e in engines) and not g.engines


def test_dp_group_of_ep_engines_drains_through_a_scale_down(smoke):
    """``make_dp_group(dp=2, ep=2)`` over four CPU entries: two requests
    per replica, one long and one short; once the short ones retire the
    demand falls below the band and the autoscaler's -1 drains a replica
    that still serves its long request. Every request retires with its
    full token count, with the greedy tokens of one plain engine."""
    cfg, params = smoke
    config = EngineConfig(max_slots=4, max_len=32, hw=HW)
    g = make_dp_group(cfg, params, config, ep=2, dp=2, devices=cpus(4))
    assert [e.mesh.sizes["model"] for e in g.engines] == [2, 2]
    from repro_torch.core.pareto import QoSTarget
    target = QoSTarget(mem_budget_bytes=1e12)
    points = g.apply_target(target)
    assert len(points) == 2
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 6) for _ in range(4)]
    lengths = [10, 10, 3, 3]
    rids = [g.submit_request(ServeRequest(p, max_new_tokens=n))
            for p, n in zip(prompts, lengths)]
    auto = ReplicaAutoscaler(patience_ticks=1, cooldown_s=0.0,
                             max_replicas=2)
    drained_with_work, tick = False, 0.0
    while g.has_work():
        g.run_iteration(temperature=0.0)
        if g.autoscale_step(tick, auto) == -1:
            drained_with_work = g.metrics["draining"] == 1
        tick += 1.0
    assert drained_with_work and g.n_replicas == 1 and len(g.engines) == 1
    tokens = [g.result(r).tokens for r in rids]
    assert [len(t) for t in tokens] == lengths
    g.close()
    plain = build_engine(cfg, params, dataclasses.replace(config, ep=2),
                         device="cpu")
    plain.apply_target(target)
    want = [plain.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, lengths)]
    plain.step(temperature=0.0)
    assert tokens == [plain.result(r).tokens for r in want]
