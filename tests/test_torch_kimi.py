"""Kimi-K2's routed-expert layer in the port against the reference's, at
its real expert count: 384 experts, top-8, capacity factor 1.25, on a
narrow model (d_model 64, d_ff_expert 64, head_dim 112 as in the config,
2 layers); ``reduce_for_smoke`` would cut the experts to 8 and top-k to
2, which hides the capacity drops and the 8-way combine.

Bars:
* dispatch at E = 384 with skewed routing (some experts over capacity):
  the packed expert buffer, the slot of every assignment and the dropped
  set byte-equal to the reference's; the combine of one expert output
  byte-equal in bf16 and float32 (each token's 8 contributions added in
  the reference's sorted-expert order);
* the MoE layer on q4 | q8 | bf16 ladder banks within atol 2e-2 of the
  reference's (bf16 activations; the test_torch_moe bar), kernels off
  and on (the reference's Pallas kernels in interpret mode, the port's
  wrappers on their plain versions);
* the engine in float32 on a frontier point of two rungs, kernels off:
  greedy tokens, route counts and expert accesses equal to the
  reference engine's. float32 because with 384 experts the 8th/9th
  router probabilities are near-tied often enough that bf16 rounding
  between the frameworks flips an expert within a few hundred routed
  tokens (measured here: a flip in layer 1 of 4 x 24 tokens). With the
  kernels on, every matmul output is rounded to bf16 in both packages,
  so the same near-ties decide: there the engine is held by the layer
  test above, and each rung bank must reach its grouped wrapper with
  G = the bank's expert count per layer;
* the planner and ladder at full Kimi scale (61 layers x 384 experts):
  the reference's ``tests/test_planner.py`` and ``tests/test_ladder.py``
  kimi-scale cases on the port, the planner's plan equal to the
  reference's."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import mixed_moe as jm
from repro.core.cost_model import HardwareModel as JHardwareModel
from repro.core.planner import AdaptivePlanner as JAdaptivePlanner
from repro.models.model import build_model as jbuild_model
from repro.serving.api import EngineConfig as JEngineConfig
from repro.serving.engine import AdaptiveServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core import mixed_moe as tm
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.pareto import ParetoFrontier
from repro_torch.core.planner import AdaptivePlanner
from repro_torch.kernels import ops
from repro_torch.models.model import params_from_numpy, tensor_from_numpy
from repro_torch.serving.api import EngineConfig, build_engine

GIB = 2**30
E, K, D, F = 384, 8, 64, 64
JHW = JHardwareModel(host_link_bw=24e9)
HW = HardwareModel(**dataclasses.asdict(JHW))


def to_t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                else t.numpy())
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def skewed_ids(t, seed):
    """Top-8 ids over 384 experts where half of the tokens share their
    first four experts, so those experts see t/2 + a few assignments
    against a capacity of 4."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(E, K, replace=False) for _ in range(t)])
    hot = np.array([5, 77, 200, 383])
    for i in range(0, t, 2):
        rest = [e for e in ids[i] if e not in hot][:K - 4]
        ids[i] = np.concatenate([hot, rest])
    return ids.astype(np.int32), rng.random((t, K)).astype(np.float32)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_dispatch_and_combine_bit_equal_at_384(dtype):
    t, cap = 16, 4
    ids, w = skewed_ids(t, seed=0)
    rng = np.random.default_rng(1)
    jx = jnp.asarray(rng.standard_normal((t, D)), dtype)
    jxb, jdest, jtok, jw = jm._dispatch_local(
        jx, jnp.asarray(ids), jnp.asarray(w), rank=0, totals=(E,),
        locs=(E,), capacity=cap)
    txb, tdest, order, tw = tm._dispatch_local(
        to_t(jx), torch.from_numpy(ids), torch.from_numpy(w), rank=0,
        totals=(E,), locs=(E,), capacity=cap)
    np.testing.assert_array_equal(bits(txb), bits(jxb))
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal((order // K).numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    dropped = int((tdest.numpy() == E * cap).sum())
    assert dropped >= 4            # the hot experts overflowed
    jy = jnp.asarray(rng.standard_normal((E, cap, D)), dtype)
    want = jm._combine_local(jy, jdest, jtok, jw, t, D)
    got = tm._combine_local(to_t(jy), tdest, order, tw, t, D, K)
    np.testing.assert_array_equal(bits(got), bits(want))


def moe_pair(seed=0):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    return jp, {k: to_t(v) for k, v in jp.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_layer_on_ladder_banks_matches(use_kernel):
    jp, tp = moe_pair()
    bits_row = np.random.default_rng(2).choice([4, 8, 16], E,
                                               p=[0.7, 0.2, 0.1])
    jbanks, jorder = jm.build_ladder_banks(jp, bits_row, ladder=(16, 8, 4),
                                           group_size=64)
    tbanks, torder = tm.build_ladder_banks(tp, bits_row, ladder=(16, 8, 4),
                                           group_size=64)
    np.testing.assert_array_equal(torder, np.asarray(jorder))
    jcfg = JMoEConfig(num_experts=E, top_k=K, d_ff_expert=F,
                      capacity_factor=1.25)
    tcfg = MoEConfig(num_experts=E, top_k=K, d_ff_expert=F,
                     capacity_factor=1.25)
    rng = np.random.default_rng(3)
    jx = jnp.asarray(rng.standard_normal((48, D)), jnp.bfloat16)
    router = jp["router"][:, jnp.asarray(jorder)]
    jw, jids, _ = jm.route(router, jx, jcfg, train=False)
    tw, tids = tm.route(to_t(router), to_t(jx), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    par = jm.MoEParallelism(mesh=mesh, dp_axes=("data",), fsdp_axis="data")
    want = jm.moe_apply(jbanks, jx, jw, jids, jcfg, par=par,
                        use_kernel=use_kernel)
    got = tm.moe_apply(tbanks, to_t(jx), tw, tids, tcfg,
                       use_kernel=use_kernel)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def narrow(cfg):
    """Kimi-K2 at 384 experts, top-8, capacity 1.25 and head_dim 112,
    narrowed to d_model 64, d_ff_expert 64, 2 layers, vocab 512."""
    return cfg.replace(
        num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        vocab_pad_multiple=64, dtype="float32",
        attention=dataclasses.replace(cfg.attention, num_heads=4,
                                      num_kv_heads=2),
        moe=dataclasses.replace(cfg.moe, d_ff_expert=F))


@pytest.fixture(scope="module")
def kimi():
    jcfg = narrow(jget_config("kimi-k2-1t-a32b"))
    tcfg = narrow(get_config("kimi-k2-1t-a32b"))
    assert str(tcfg) == str(jcfg)
    assert (tcfg.moe.num_experts, tcfg.moe.top_k,
            tcfg.attention.head_dim) == (E, K, 112)
    jparams = jbuild_model(jcfg).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, jcfg.vocab_size, 16) for _ in range(4)]
    return jcfg, tcfg, jparams, tparams, prompts


def two_rung_point(frontier):
    """The most resident frontier point with experts at two or more
    rungs (the first such point in frontier order)."""
    cand = [i for i, p in enumerate(frontier.points)
            if sum(c > 0 for c in p.counts_per_rung) >= 2]
    top = max(frontier.points[i].resident_experts for i in cand)
    return next(i for i in cand if frontier.points[i].resident_experts
                == top)


def serve(eng, i, prompts):
    eng.apply_frontier_point(eng.frontier.points[i])
    rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.step()
    return [eng.result(r).tokens for r in rids]


def test_engine_matches_reference(kimi):
    jcfg, tcfg, jparams, tparams, prompts = kimi
    kw = dict(max_slots=4, max_len=32, ladder=(16, 8, 4))
    jeng = JEngine(jcfg, jparams, config=JEngineConfig(hw=JHW, **kw))
    teng = build_engine(tcfg, tparams, EngineConfig(hw=HW, **kw),
                        device="cpu")
    i = two_rung_point(jeng.frontier)
    assert two_rung_point(teng.frontier) == i
    assert teng.frontier.points[i].summary() == \
        jeng.frontier.points[i].summary()
    want = serve(jeng, i, prompts)
    got = serve(teng, i, prompts)
    assert got == want
    np.testing.assert_array_equal(teng.current_plan.bits,
                                  jeng.current_plan.bits)
    np.testing.assert_array_equal(teng.route_counts, jeng.route_counts)
    assert teng.metrics["expert_accesses"] == \
        jeng.metrics["expert_accesses"]
    jeng.close()
    teng.close()


def test_engine_kernels_reach_every_bank(kimi, monkeypatch):
    """With the kernels on, each rung bank of the plan reaches its
    grouped wrapper (B3 or B4) with G = the bank's expert count per
    layer, three matrices per layer on every forward; the greedy tokens
    are well formed."""
    _, tcfg, _, tparams, prompts = kimi
    teng = build_engine(tcfg, tparams, EngineConfig(
        hw=HW, max_slots=4, max_len=32, ladder=(16, 8, 4), use_kernel=True),
        device="cpu")
    calls = collections.Counter()
    for name in ("grouped_q_matmul", "grouped_bf16_matmul"):
        def spy(x, w, *a, _fn=getattr(ops, name), **k):
            key = f"q{w.bits}" if hasattr(w, "bits") else "f16"
            calls[(key, x.shape[0])] += 1
            return _fn(x, w, *a, **k)
        monkeypatch.setattr(ops, name, spy)
    tokens = serve(teng, two_rung_point(teng.frontier), prompts)
    assert all(len(t) == 8 and all(0 <= x < tcfg.vocab_size for x in t)
               for t in tokens)
    plan = teng.current_plan
    names = {4: "q4", 8: "q8", 16: "f16"}
    banks = {(names[b], g) for b, g in zip(sorted(plan.ladder),
                                           plan.bank_sizes()) if g}
    assert len(banks) >= 2 and max(g for _, g in banks) >= 128
    assert set(calls) == banks
    n = set(calls.values())
    assert len(n) == 1 and n.pop() % (3 * tcfg.num_layers) == 0
    teng.close()


# ---------------------------------------------------------------------------
# kimi-scale twins of tests/test_planner.py and tests/test_ladder.py
# ---------------------------------------------------------------------------
def test_planner_kimi_scale():
    pl = AdaptivePlanner(get_config("kimi-k2-1t-a32b"))
    r = pl.plan(100 * GIB, "throughput")
    assert r.plan.num_q_experts == 61 * 384       # all 4-bit
    assert 0 < r.plan.resident_fraction() < 0.5
    assert r.qos.device_bytes <= 100 * GIB
    jr = JAdaptivePlanner(jget_config("kimi-k2-1t-a32b"),
                          hw=JHardwareModel()).plan(100 * GIB, "throughput")
    tr = AdaptivePlanner(get_config("kimi-k2-1t-a32b"),
                         hw=HardwareModel(**dataclasses.asdict(
                             JHardwareModel()))).plan(100 * GIB,
                                                      "throughput")
    np.testing.assert_array_equal(tr.plan.bits, jr.plan.bits)
    np.testing.assert_array_equal(tr.plan.location, jr.plan.location)
    assert dataclasses.asdict(tr.qos) == dataclasses.asdict(jr.qos)


def test_pruned_enumeration_stays_tractable_at_kimi_scale():
    cfg = get_config("kimi-k2-1t-a32b")
    cfg = cfg.replace(mop=dataclasses.replace(cfg.mop, ladder=(16, 8, 4)))
    f = ParetoFrontier(cfg, HardwareModel(), residency_step=None,
                       max_enum_points=4096)
    assert len(f.all_points) <= 4096
    e = cfg.moe.num_experts
    for levels in f.count_levels.values():
        assert levels[0] == 0 and levels[-1] == e


def test_serve_cli_kimi_matches_reference(monkeypatch, capsys):
    """``--arch kimi-k2-1t-a32b`` through both serve CLIs at ``--smoke``
    (float32, the reference's weights and hardware model, as in
    ``tests/test_torch_serve_cli.py``): the same target, plan and token
    lines."""
    from test_torch_serve_cli import _clis, compared
    run = _clis(monkeypatch, capsys, "float32")
    argv = ["--arch", "kimi-k2-1t-a32b", "--ladder", "16,8,4",
            "--temperature", "0", "--requests", "2", "--max-new-tokens", "4"]
    got, want = compared(run("port", argv)), compared(run("ref", argv))
    assert got == want
    assert sum("tokens=[" in ln for ln in got) == 2
