"""qk-norm in the port's attention against the reference's: with
``qk_norm=True`` the q and k heads go through ``rms_norm`` with the
``attn/q_norm`` and ``attn/k_norm`` scales after the projections and
before rope, on every path (no-cache forward, prefill, decode, the
speculative verify).

The smoke Mixtral and the smoke Qwen3-8B run in float32 with the
reference's params crossed by ``params_from_numpy`` and the q/k norm
scales drawn away from 1 (uniform in [0.25, 3)), so a skipped norm
shows. Bars: ``loss_fn`` within 1e-5 relative of the reference's (the
float32 rounding of the two frameworks; a port that skips the norms
misses by ~4e-3 relative), the q/k norm gradients within 1e-4 of the
leaf's largest and nonzero, and the engine's greedy tokens equal to the
reference engine's (default paged engine and ``speculate=2``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.models import model as jmodel
from repro.serving.api import EngineConfig as JEngineConfig
from repro.serving.engine import AdaptiveServingEngine as JEngine
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.cost_model import HardwareModel
from repro_torch.models import model as tmodel
from repro_torch.serving.api import EngineConfig, ServeRequest, build_engine
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

JHW = JHardwareModel(host_link_bw=24e9)
HW = HardwareModel(**dataclasses.asdict(JHW))
PROMPTS = [(np.arange(3, 10), 6), (np.array([9, 2, 11, 4, 6]), 5),
           (np.array([5, 5, 7, 1]), 7)]


def qk_pair(arch):
    def on(cfg):
        return cfg.replace(dtype="float32", attention=dataclasses.replace(
            cfg.attention, qk_norm=True))
    return on(jreduce(jget_config(arch))), on(reduce_for_smoke(
        get_config(arch)))


def scaled_norms(jparams, seed):
    """The reference's params with every q/k norm scale drawn in
    [0.25, 3) (``init`` sets them to 1, where the norm is nearly a
    no-op on the scale of the heads)."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, jparams)
    attn = p["layers"]["attn"]
    for name in ("q_norm", "k_norm"):
        attn[name] = rng.uniform(0.25, 3.0, attn[name].shape).astype(
            attn[name].dtype)
    return p


@pytest.fixture(scope="module", params=["mixtral-8x7b", "qwen3-8b"])
def pair(request):
    jcfg, tcfg = qk_pair(request.param)
    jm = jmodel.build_model(jcfg)
    jp = scaled_norms(jm.init(jax.random.key(0)), seed=1)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 16)),
             "labels": rng.integers(-1, jcfg.vocab_size, (2, 16))}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp),
        {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, batch=batch, loss=float(jl),
                grads=jax.tree_util.tree_map(np.asarray, jg))


def test_params_carry_the_norms(pair):
    tp = tmodel.params_from_numpy(pair["jp"], "cpu")
    attn = tp["layers"]["attn"]
    for name in ("q_norm", "k_norm"):
        np.testing.assert_array_equal(attn[name].numpy(),
                                      pair["jp"]["layers"]["attn"][name])
    init = tmodel.init_params(pair["tcfg"], seed=0, device="cpu")
    hd = pair["tcfg"].attention.head_dim
    for name in ("q_norm", "k_norm"):
        assert tuple(init["layers"]["attn"][name].shape) == (
            pair["tcfg"].num_layers, hd)


def test_loss_and_norm_grads_match(pair):
    tp = tmodel.params_from_numpy(pair["jp"], "cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in pair["batch"].items()}
    loss, _, grads = TT.value_and_grad(
        tmodel.build_model(pair["tcfg"]).loss_fn, tp, batch)
    assert float(loss) == pytest.approx(pair["loss"], rel=1e-5)
    got = dict(TO.tree_leaves(grads))
    for name in ("q_norm", "k_norm"):
        want = pair["grads"]["layers"]["attn"][name]
        g = got[("layers", "attn", name)].numpy()
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("speculate", [0, 2])
def test_engine_greedy_tokens_match(speculate):
    jcfg, tcfg = qk_pair("mixtral-8x7b")
    jp = scaled_norms(jmodel.build_model(jcfg).init(jax.random.key(3)),
                      seed=4)
    kw = dict(max_slots=2, max_len=32, ladder=(16, 8, 4),
              speculate=speculate)
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                   config=JEngineConfig(hw=JHW, **kw))
    teng = build_engine(tcfg, tmodel.params_from_numpy(jp, "cpu"),
                        EngineConfig(hw=HW, **kw), device="cpu")
    i = len(jeng.frontier.points) // 2
    jeng.apply_frontier_point(jeng.frontier.points[i])
    teng.apply_frontier_point(teng.frontier.points[i])
    out = []
    for eng in (jeng, teng):
        rids = [eng.submit_request(ServeRequest(p, max_new_tokens=n))
                for p, n in PROMPTS]
        eng.step()
        out.append([eng.result(r).tokens for r in rids])
        eng.close()
    assert out[1] == out[0]
    assert [len(t) for t in out[1]] == [n for _, n in PROMPTS]
