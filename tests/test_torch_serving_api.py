"""The engine's flat constructor keywords, its ``max_batch`` property,
``api.results_of`` and ``build_mixed_banks`` against the reference's:
the flat spelling builds the ``EngineConfig`` the reference builds from
the same keywords, ``config=`` wins over them, completed requests
convert to the reference's ``ServeResult`` fields, and the legacy binary
bank builder gives the reference's banks and order byte for byte."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import mixed_moe as jm
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.models.model import build_model as jbuild_model
from repro.serving import api as japi
from repro.serving.engine import AdaptiveServingEngine as JEngine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import mixed_moe as tm
from repro_torch.core.cost_model import HardwareModel
from repro_torch.models.model import params_from_numpy, tensor_from_numpy
from repro_torch.serving import api
from repro_torch.serving.engine import AdaptiveServingEngine

JHW = JHardwareModel(host_link_bw=24e9)
HW = HardwareModel(**dataclasses.asdict(JHW))
FLAT = dict(max_batch=3, max_len=40, use_kernel=False,
            max_active_tokens=64, max_queue=5, swap_bytes=1 << 20,
            prefetch=True)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jreduce(jget_config("mixtral-8x7b"))
    tcfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def test_flat_keywords_build_the_reference_config(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    jeng = JEngine(jcfg, jparams, hw=JHW, **FLAT)
    teng = AdaptiveServingEngine(tcfg, tparams, hw=HW, device="cpu", **FLAT)
    want = dataclasses.asdict(jeng.config)
    got = dataclasses.asdict(teng.config)
    assert got.pop("hw") == dataclasses.asdict(HW)
    want.pop("hw")
    assert got == want
    assert teng.max_batch == jeng.max_batch == 3 == teng.max_slots
    assert teng.max_len == 40 and teng.hw == HW
    jeng.close()
    teng.close()


def test_config_wins_over_flat_keywords(smoke):
    _, tcfg, _, tparams = smoke
    cfg = api.EngineConfig(max_slots=2, max_len=24, hw=HW)
    eng = AdaptiveServingEngine(tcfg, tparams, config=cfg, device="cpu",
                                max_batch=7, max_len=99)
    assert eng.config is cfg and eng.max_batch == 2 and eng.max_len == 24
    eng.close()


def test_results_of(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    out = []
    for eng, mod in ((JEngine(jcfg, jparams, hw=JHW, max_batch=2,
                              max_len=32), japi),
                     (AdaptiveServingEngine(tcfg, tparams, hw=HW,
                                            device="cpu", max_batch=2,
                                            max_len=32), api)):
        eng.apply_frontier_point(eng.frontier.points[0])
        for prio, (p, n) in enumerate([(np.arange(2, 7), 3),
                                       (np.array([4, 1, 9]), 4)]):
            eng.submit(p, max_new_tokens=n,
                       slo=mod.RequestSLO(priority=prio, deadline_s=30.0))
        eng.step()
        res = mod.results_of(sorted(eng.done.values(),
                                    key=lambda r: r.rid))
        out.append([(r.rid, r.tokens, r.priority, r.deadline_s,
                     r.deadline_met) for r in res])
        assert all(isinstance(r, mod.ServeResult) for r in res)
        eng.close()
    assert out[1] == out[0]
    pending = api.Request(rid=9, prompt=np.arange(3), max_new_tokens=2)
    with pytest.raises(ValueError, match="still in flight"):
        api.results_of([pending])


def test_build_mixed_banks_byte_equal():
    rng = np.random.default_rng(0)
    e, d, f = 6, 64, 32
    arrays = {"w_gate": rng.standard_normal((e, d, f)),
              "w_up": rng.standard_normal((e, d, f)),
              "w_down": rng.standard_normal((e, f, d))}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in arrays.items()}
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    mask = np.array([1, 0, 1, 1, 0, 0], bool)
    jbanks, jorder = jm.build_mixed_banks(jp, mask, bits=4, group_size=16)
    tbanks, torder = tm.build_mixed_banks(tp, mask, bits=4, group_size=16)
    np.testing.assert_array_equal(torder, np.asarray(jorder))
    assert sorted(tbanks) == sorted(jbanks) == ["f16", "q4"]
    for k in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(tbanks["q4"][k].q.numpy(),
                                      np.asarray(jbanks["q4"][k].q))
        np.testing.assert_array_equal(
            tbanks["q4"][k].scales.view(torch.int16).numpy(),
            np.asarray(jbanks["q4"][k].scales).view(np.int16))
        np.testing.assert_array_equal(
            tbanks["f16"][k].view(torch.int16).numpy(),
            np.asarray(jbanks["f16"][k]).view(np.int16))
