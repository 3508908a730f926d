"""The port's serving engine against the reference's: the same converted
params, the same explicit hardware model, the same frontier point (q4, q8
and bf16 experts, some experts off the device) and the same three greedy
requests give equal token streams, with the dequant-matmul kernels off and
on. The grid covers the KV layout (paged, slot) x streaming (serial,
async overlap) x speculation (0, 2) with kernels off, and the default
paged config, overlap and ``speculate=2`` with kernels on (the reference's
Pallas kernels in interpret mode); the integer metrics (KV bytes, expert
accesses, route counts) equal the reference's too. Also: the port's
frontier and planner copies equal the reference's, and the engine's error
paths."""
import dataclasses
import threading

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
from repro_torch.core.expert_cache import (AsyncExpertCache,
                                           PrefetchingExpertCache)
from repro_torch.core.pareto import ParetoFrontier
from repro_torch.core.planner import AdaptivePlanner
from repro_torch.launch.mesh import make_ep_mesh
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


INT_METRICS = ("tokens_generated", "expert_accesses", "kv_allocated_bytes",
               "kv_used_bytes", "spec_proposed", "spec_accepted")


def pick_half(frontier, total):
    """The most resident point with all three rungs and at least half of
    the experts off the device."""
    cand = [i for i, p in enumerate(frontier.points)
            if all(c > 0 for c in p.counts_per_rung)
            and p.resident_experts <= total // 2]
    return max(cand, key=lambda i: frontier.points[i].resident_experts)


def serve_both(smoke, choose=pick, **kw):
    """The reference's and the port's engine on one config and frontier
    point (``choose``): returns both engines after serving PROMPTS."""
    jcfg, tcfg, jparams, tparams = smoke
    kw = dict(max_slots=2, max_len=24, ladder=LADDER, page_size=4, **kw)
    jeng = JEngine(jcfg, jparams, config=JEngineConfig(hw=JHW, **kw))
    teng = build_engine(tcfg, tparams, EngineConfig(hw=HW, **kw),
                        device="cpu")
    i = choose(jeng.frontier, tcfg.num_layers * tcfg.moe.num_experts)
    want = serve(jeng, jeng.frontier.points[i])
    got = serve(teng, teng.frontier.points[i])
    assert got == want
    return jeng, teng


def assert_same_metrics(jeng, teng):
    for key in INT_METRICS:
        assert teng.metrics[key] == jeng.metrics[key], key
    assert teng.kv_reclaimed_bytes() == jeng.kv_reclaimed_bytes()
    np.testing.assert_array_equal(teng.route_counts, jeng.route_counts)


@pytest.mark.parametrize("speculate", [0, 2])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("paged", [True, False])
def test_grid_token_streams_equal(smoke, paged, overlap, speculate):
    """Kernels off: every (KV layout, streaming, speculation) config gives
    the reference's greedy tokens and integer metrics."""
    jeng, teng = serve_both(smoke, use_kernel=False, paged_kv=paged,
                            overlap=overlap, speculate=speculate)
    assert_same_metrics(jeng, teng)
    assert teng.paged == paged
    assert ("kv[paged" in teng.summary()) == paged
    if speculate:
        assert teng.metrics["spec_proposed"] > 0
        assert "spec[k=2" in teng.summary()
    if overlap:
        assert isinstance(teng.expert_cache, AsyncExpertCache)
        assert "xfer[" in teng.summary()
    teng.close()
    jeng.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("expert-xfer") and t.is_alive()]


@pytest.mark.parametrize("kw", [{}, {"overlap": True}, {"speculate": 2}],
                         ids=["default", "overlap", "speculate"])
def test_kernels_on_token_streams_equal(smoke, kw):
    """Kernels on (the reference's Pallas kernels in interpret mode, the
    port's plain versions on the CPU): the default paged config, overlap
    and speculation give the reference's tokens and metrics."""
    jeng, teng = serve_both(smoke, use_kernel=True, **kw)
    assert_same_metrics(jeng, teng)
    teng.close()
    jeng.close()


def test_default_config_serves(smoke):
    """``build_engine(cfg, params, device="cpu")`` with a default
    ``EngineConfig()`` serves on the paged cache."""
    _, tcfg, _, tparams = smoke
    eng = build_engine(tcfg, tparams, EngineConfig(hw=HW), device="cpu")
    assert eng.paged and EngineConfig().paged_kv
    eng.apply_target(QoSTarget(mem_budget_bytes=1e12))
    rid = eng.submit_request(ServeRequest(np.arange(1, 6), max_new_tokens=3))
    assert eng.step() == 1
    assert len(eng.result(rid).tokens) == 3
    assert eng.metrics["kv_allocated_bytes"] > 0
    eng.close()


def test_prefetch_hints_stage_speculatively(smoke):
    """``prefetch=True``: the previous iteration's experts are hinted to a
    PrefetchingExpertCache before each demand; speculative traffic stays
    out of the demand counters, and tokens do not change."""
    tcfg = smoke[1]
    # half of the experts off the device and a swap cache of one int4
    # expert: the hinted experts keep re-staging
    jeng, teng = serve_both(smoke, choose=pick_half, use_kernel=False,
                            prefetch=True,
                            swap_bytes=tcfg.expert_param_bytes(4))
    assert isinstance(teng.expert_cache, PrefetchingExpertCache)
    st = teng.expert_cache.stats
    assert st.prefetch_bytes > 0
    assert teng.metrics["prefetch_s"] == st.prefetch_s
    assert teng.metrics["transfer_exposed_s"] == pytest.approx(
        st.transfer_s + st.prefetch_s)
    assert_same_metrics(jeng, teng)
    assert teng.metrics["expert_fetches"] == jeng.metrics["expert_fetches"]


def test_overlap_metrics_and_calibration(smoke):
    """The pipeline splits blocked from hidden transfer time, throughput
    charges only the exposed part, and calibrate_overlap folds the
    measured window into the hardware model (dropping the frontier)."""
    _, teng = serve_both(smoke, use_kernel=False, overlap=True)
    m = teng.metrics
    assert m["expert_fetches"] > 0
    assert m["transfer_overlapped_s"] == pytest.approx(max(
        m["transfer_s"] + m["prefetch_s"] - m["transfer_exposed_s"], 0.0))
    assert teng.throughput_tokens_per_s() == pytest.approx(
        m["tokens_generated"] / (m["decode_s"] + m["transfer_exposed_s"]))
    eff = teng.measured_overlap_efficiency()
    assert eff is not None and 0.0 <= eff <= 1.0
    teng.frontier
    assert teng.calibrate_overlap() == eff
    assert teng.hw.overlap_efficiency == eff and teng._frontier is None
    teng.close()
    teng.close()                                # idempotent


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
    # every config builds; expert parallelism too: ep=2 over a (1, 2)
    # mesh builds and serves, and an expert count that does not divide
    # over ep raises the reference's ValueError
    for ok in (dict(paged_kv=True), dict(overlap=True),
               dict(prefetch=True), dict(speculate=2)):
        build_engine(tcfg, tparams, dataclasses.replace(cfg, **ok),
                     device="cpu").close()
    ep2 = build_engine(tcfg, tparams, dataclasses.replace(cfg, ep=2),
                       mesh=make_ep_mesh(2, devices=["cpu"] * 2))
    ep2.apply_target(QoSTarget(mem_budget_bytes=1e12))
    rid = ep2.submit(np.array([1, 2, 3]), max_new_tokens=2)
    ep2.step()
    assert len(ep2.result(rid).tokens) == 2
    with pytest.raises(ValueError, match="ep=3"):
        build_engine(tcfg, tparams, dataclasses.replace(cfg, ep=3),
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
