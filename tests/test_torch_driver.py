"""The port's ``drive_poisson`` against the reference's on a virtual
clock: both driver modules see one fake ``time`` whose ``perf_counter``
advances a fixed step per call (one call per pass of the driver's loop)
and whose ``sleep`` advances it by the time asked. The arrivals, the
batches and so the token streams are then the same run to run and
between the packages: the test holds the returned rids, the order and
contents of the submitted prompts, each request's SLO and ``max_new_tokens``
and its greedy tokens equal to the reference's (smoke Mixtral, the
reference's params crossed by ``params_from_numpy``, the same frontier
point; engines built through the flat constructor keywords). The model
runs in float32 in both packages, as the real-engine comparisons of
``tests/test_torch_multi.py`` do and for its reason: over ~30 routed
tokens per request, bf16 rounding between the frameworks flips router
near-ties; the test is of the driver, not of bf16 rounding."""
import dataclasses
import types

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.models.model import build_model as jbuild_model
from repro.serving import driver as jdriver
from repro.serving.api import RequestSLO as JRequestSLO
from repro.serving.engine import AdaptiveServingEngine as JEngine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.cost_model import HardwareModel
from repro_torch.models.model import params_from_numpy
from repro_torch.serving import driver as tdriver
from repro_torch.serving.api import RequestSLO
from repro_torch.serving.engine import AdaptiveServingEngine

JHW = JHardwareModel(host_link_bw=24e9)
HW = HardwareModel(**dataclasses.asdict(JHW))


class VirtualTime:
    """``perf_counter`` returns the clock and then advances it by
    ``step``; ``sleep`` advances it by the time asked."""

    def __init__(self, step: float):
        self.t, self.step, self.sleeps = 0.0, step, 0

    def perf_counter(self) -> float:
        t = self.t
        self.t += self.step
        return t

    def sleep(self, dt: float) -> None:
        self.sleeps += 1
        self.t += dt


@pytest.fixture(scope="module")
def engines():
    jcfg = jreduce(jget_config("mixtral-8x7b")).replace(dtype="float32")
    tcfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(
        dtype="float32")
    jparams = jbuild_model(jcfg).init(jax.random.key(2))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")

    def build():
        kw = dict(max_batch=3, max_len=40)
        return (JEngine(jcfg, jparams, hw=JHW, **kw),
                AdaptiveServingEngine(tcfg, tparams, hw=HW, device="cpu",
                                      **kw))
    return build


def drive(mod, engine, slo_cls, monkeypatch, *, step, drain, seed=0):
    clock = VirtualTime(step)
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter, sleep=clock.sleep))
    submitted = []
    submit = engine.submit

    def spy(prompt, **kw):
        submitted.append((np.asarray(prompt).tolist(), kw["max_new_tokens"],
                          kw["slo"].priority, kw["slo"].deadline_s))
        return submit(prompt, **kw)
    monkeypatch.setattr(engine, "submit", spy)
    iters = []
    rids = mod.drive_poisson(
        engine, np.random.default_rng(seed), n_requests=7, mean_gap_s=0.02,
        prompt_len=lambda r: int(r.integers(3, 12)),
        max_new_tokens=lambda r: int(r.integers(2, 7)),
        slo=lambda r: slo_cls(priority=int(r.integers(2)), deadline_s=5.0),
        on_iteration=lambda: iters.append(engine.scheduler.num_active),
        drain=drain)
    return rids, submitted, iters, clock


@pytest.mark.parametrize("drain", [True, False])
def test_virtual_clock_drive_matches_reference(engines, monkeypatch, drain):
    jeng, teng = engines()
    point = jeng.frontier.points[len(jeng.frontier.points) // 2]
    jeng.apply_frontier_point(point)
    teng.apply_frontier_point(teng.frontier.points[
        len(teng.frontier.points) // 2])
    assert teng.active_point.summary() == point.summary()
    jrun = drive(jdriver, jeng, JRequestSLO, monkeypatch, step=0.004,
                 drain=drain)
    trun = drive(tdriver, teng, RequestSLO, monkeypatch, step=0.004,
                 drain=drain)
    jrids, jsub, jiters, jclock = jrun
    trids, tsub, titers, tclock = trun
    assert trids == jrids and len(trids) == 7
    assert tsub == jsub
    assert titers == jiters          # the same batch widths, iteration
    assert tclock.sleeps == jclock.sleeps > 0   # by iteration
    if not drain:
        assert teng.has_work()       # the tail is left in flight
        while jeng.has_work():
            jeng.run_iteration()
        while teng.has_work():
            teng.run_iteration()
    for rid in trids:
        want = jeng.result(rid)
        got = teng.result(rid)
        assert got.tokens == want.tokens
        assert len(got.tokens) == next(
            n for r, (_, n, _, _) in zip(trids, tsub) if r == rid)
        assert got.priority == want.priority
    jeng.close()
    teng.close()


def test_driver_is_deterministic_on_the_virtual_clock(engines, monkeypatch):
    """Two port runs on fresh engines give the same rids, prompts,
    batches and tokens."""
    runs = []
    for _ in range(2):
        _, teng = engines()
        teng.apply_frontier_point(teng.frontier.points[0])
        rids, sub, iters, _ = drive(tdriver, teng, RequestSLO, monkeypatch,
                                    step=0.004, drain=True)
        runs.append((rids, sub, iters,
                     [teng.result(r).tokens for r in rids]))
        teng.close()
    assert runs[0] == runs[1]
