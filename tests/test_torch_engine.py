"""The port's serving engine against the reference's: the same converted
params, the same explicit hardware model, the same frontier point (q4, q8
and bf16 experts, some experts off the device) and the same three greedy
requests give equal token streams, with the dequant-matmul kernels off and
on (both engines on the slot KV cache, ``paged_kv=False``). Also: the
port's frontier and planner copies equal the reference's, and the engine's
error paths."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.core.pareto import ParetoFrontier as JParetoFrontier
from repro.core.planner import AdaptivePlanner as JAdaptivePlanner
from repro.models.model import build_model as jbuild_model
from repro.serving.api import EngineConfig as JEngineConfig
from repro.serving.engine import AdaptiveServingEngine as JEngine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.pareto import ParetoFrontier
from repro_torch.core.planner import AdaptivePlanner
from repro_torch.models.model import params_from_numpy
from repro_torch.serving.api import (EngineConfig, QoSTarget, ServeRequest,
                                     build_engine)

LADDER = (16, 8, 4)
JHW = JHardwareModel(host_link_bw=24e9)
HW = HardwareModel(**dataclasses.asdict(JHW))
PROMPTS = [(np.arange(3, 8), 5), (np.array([9, 2, 11, 4, 6, 1, 8]), 4),
           (np.array([5, 5, 7]), 6)]


@pytest.fixture(scope="module")
def smoke():
    jcfg = jreduce(jget_config("mixtral-8x7b"))
    tcfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    jparams = jbuild_model(jcfg).init(jax.random.key(1))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def pick(frontier, total):
    """The most resident point below full residency with all three rungs."""
    cand = [i for i, p in enumerate(frontier.points)
            if all(c > 0 for c in p.counts_per_rung)
            and p.resident_experts < total]
    return max(cand, key=lambda i: frontier.points[i].resident_experts)


def serve(engine, point):
    engine.apply_frontier_point(point)
    rids = [engine.submit_request(ServeRequest(p, max_new_tokens=n))
            for p, n in PROMPTS]
    assert engine.step() == len(PROMPTS)
    return [engine.result(r).tokens for r in rids]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_token_streams_equal(smoke, use_kernel):
    jcfg, tcfg, jparams, tparams = smoke
    kw = dict(max_slots=2, max_len=24, use_kernel=use_kernel, ladder=LADDER,
              paged_kv=False)
    jeng = JEngine(jcfg, jparams, config=JEngineConfig(hw=JHW, **kw))
    teng = build_engine(tcfg, tparams, EngineConfig(hw=HW, **kw),
                        device="cpu")
    total = tcfg.num_layers * tcfg.moe.num_experts
    i = pick(jeng.frontier, total)
    assert pick(teng.frontier, total) == i
    jpoint, tpoint = jeng.frontier.points[i], teng.frontier.points[i]
    assert tpoint.summary() == jpoint.summary()
    want = serve(jeng, jpoint)
    got = serve(teng, tpoint)
    assert got == want
    np.testing.assert_array_equal(teng.current_plan.bits,
                                  jeng.current_plan.bits)
    np.testing.assert_array_equal(teng.route_counts, jeng.route_counts)
    for key in ("tokens_generated", "iterations", "expert_accesses",
                "expert_fetches", "miss_rate"):
        assert teng.metrics[key] == jeng.metrics[key], key
    assert teng.metrics["expert_fetches"] > 0       # the cache streamed
    assert teng.throughput_tokens_per_s() > 0
    assert "tok/s" in teng.summary()
    teng.close()
    jeng.close()


def test_frontier_and_planner_copies_equal():
    for arch in ("mixtral-8x7b", "mixtral-mop"):
        jcfg = jget_config(arch)
        tcfg = get_config(arch)
        jcfg = jcfg.replace(mop=dataclasses.replace(jcfg.mop, ladder=LADDER))
        tcfg = tcfg.replace(mop=dataclasses.replace(tcfg.mop, ladder=LADDER))
        jf = JParetoFrontier(jcfg, JHW, batch_size=4)
        tf = ParetoFrontier(tcfg, HW, batch_size=4)
        assert tf.records() == jf.records()
        jplanner = JAdaptivePlanner(jcfg, hw=JHW)
        tplanner = AdaptivePlanner(tcfg, hw=HW)
        for frac in (0.3, 0.6, 1.2):
            budget = jplanner.size_ne \
                + frac * jplanner.num_experts_total * jplanner.size_e16
            for pref, nq in (("throughput", None), ("quality", 64)):
                jr = jplanner.plan(budget, pref, nq)
                tr = tplanner.plan(budget, pref, nq)
                np.testing.assert_array_equal(tr.plan.bits, jr.plan.bits)
                np.testing.assert_array_equal(tr.plan.location,
                                              jr.plan.location)
                assert dataclasses.asdict(tr.qos) \
                    == dataclasses.asdict(jr.qos)


def test_h100_defaults():
    hw = HardwareModel()
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes) == (989e12, 3.35e12,
                                                       80e9)


def test_engine_error_paths(smoke, monkeypatch):
    _, tcfg, _, tparams = smoke
    cfg = EngineConfig(max_slots=2, max_len=24, hw=HW, paged_kv=False)
    eng = build_engine(tcfg, tparams, cfg, device="cpu")
    eng.submit(np.array([1, 2, 3]), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no active plan"):
        eng.step()
    eng.queue.clear()
    with pytest.raises(ValueError):
        eng.submit(np.arange(1, 30), max_new_tokens=2)
    eng.apply_target(QoSTarget(mem_budget_bytes=1e12))
    assert eng.active_point is not None and eng.target is not None
    for bad in (dict(paged_kv=True), dict(overlap=True),
                dict(prefetch=True), dict(speculate=2), dict(ep=2)):
        with pytest.raises(NotImplementedError, match="later slice"):
            build_engine(tcfg, tparams, dataclasses.replace(cfg, **bad),
                         device="cpu")
    # no device= means the card; without one the engine refuses to start
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(tcfg, tparams, cfg)


def test_replans_mid_flight(smoke):
    """A bank-split change with requests in flight drains them on the old
    banks first; the deprecated ``configure`` shim still plans."""
    _, tcfg, _, tparams = smoke
    eng = build_engine(tcfg, tparams, EngineConfig(
        max_slots=2, max_len=24, hw=HW, ladder=LADDER, paged_kv=False),
        device="cpu")
    pts = eng.frontier.points
    eng.apply_frontier_point(pts[-1])
    rids = [eng.submit_request(ServeRequest(p, max_new_tokens=n))
            for p, n in PROMPTS[:2]]
    eng.run_iteration()
    other = next(p for p in pts
                 if p.plan.bank_sizes() != pts[-1].plan.bank_sizes())
    eng.apply_frontier_point(other)
    assert eng.metrics["drains"] == 1
    assert [len(eng.result(r).tokens) for r in rids] == [5, 4]
    with pytest.warns(DeprecationWarning):
        eng.configure(1e12, "quality", num_q_experts=0)
    assert eng.current_plan.num_q_experts == 0
    assert eng.target.max_quality_loss == 0.0
