"""The port's expert parallelism (``repro_torch.launch.mesh``, the sharded
``mixed_moe.moe_apply``, ``build_model(cfg, mesh)``) against its own
single-device path and against the reference's EP.

One process drives every rank; the devices are ``["cpu"] * ep``, the
counterpart of the reference's forced host device count.

* mesh builders: the actionable too-few-devices error, ep = 1 on one
  device, repeated devices, a replica's device slice;
* ``validate_ep_layout`` raises where the reference's does, with its
  words;
* the sharded ``moe_apply`` gives output bytes equal to one device at
  ep in {2, 4} (kernels off; bf16 and quantized ladder banks, with and
  without capacity drops); a (2, 2) mesh and the TP layout run the
  reference's regimes (``test_torch_mesh_moe.py`` holds them against
  the reference);
* the reference's decode parity script, ported: prefill + 4 greedy decode
  steps of the smoke Mixtral give logits BYTES equal across ep in
  {1, 2, 4} on binary, mixed (16, 8, 4) and replanned plans, with the
  banks placed by ``apply_precision_plan(mesh=)`` and sharded inside
  ``moe_apply``, plus the rank-migration assertion;
* in subprocesses that force the host device count before importing jax
  (as the reference's EP tests do): the port's ep = 2 decode against the
  reference's ep = 2 decode on converted params — greedy ids equal, each
  package's ep = 2 bytes its ep = 1 bytes, and in float32 the logits
  within 5e-2 (the bar of ``test_torch_model.py``) — and at top-8 with
  exact expert products the port's EP output bytes equal to the
  reference's EP at ep in {1, 2, 4, 8}.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.serving.ep.mesh_engine import \
    validate_ep_layout as jvalidate_ep_layout
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import MoEConfig
from repro_torch.core import mixed_moe as tm
from repro_torch.core.precision_plan import balanced_ladder_plan
from repro_torch.launch.mesh import (make_ep_mesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models.model import (apply_precision_plan, build_model,
                                      init_params)
from repro_torch.serving.ep import validate_ep_layout

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
E, D, F, GROUP = 8, 64, 64, 16


def cpus(n):
    return ["cpu"] * n


# ---------------------------------------------------------------------------
# mesh builders
# ---------------------------------------------------------------------------

def test_mesh_builders_raise_the_actionable_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: make_ep_mesh(4), lambda: make_test_mesh((2, 2)),
                  lambda: make_production_mesh()):
        with pytest.raises(RuntimeError, match=r"devices=\['cpu'\]"):
            build()
    # replica 1 needs devices [1, 2)
    with pytest.raises(RuntimeError, match="need 2 devices"):
        make_ep_mesh(1, replica=1, devices=cpus(1))
    with pytest.raises(ValueError):
        make_ep_mesh(0, devices=cpus(1))
    with pytest.raises(ValueError):
        make_ep_mesh(1, replica=-1, devices=cpus(1))
    # an explicit card on a host without one is refused, not re-routed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ep_mesh(2, devices=["cuda:0"] * 2)


def test_ep1_mesh_on_one_device_and_repeated_devices():
    mesh = make_ep_mesh(1, devices=cpus(1))
    assert mesh.sizes == {"data": 1, "model": 1}
    mesh = make_ep_mesh(2, replica=1, devices=cpus(4))
    assert mesh.shape == (1, 2) and mesh.axis_names == ("data", "model")
    assert mesh.devices == (torch.device("cpu"),) * 2
    mesh = make_test_mesh((2, 2), devices=cpus(4))
    assert mesh.sizes == {"data": 2, "model": 2}
    with pytest.raises(ValueError):
        type(mesh)((1, 2), ("data", "model"), (torch.device("cpu"),))


# ---------------------------------------------------------------------------
# validate_ep_layout: the reference's errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,moe,ep", [
    ("mixtral-8x7b", True, 1), ("mixtral-8x7b", True, 2),
    ("mixtral-8x7b", True, 4), ("mixtral-8x7b", True, 3),
    ("mixtral-8x7b", True, 0), ("mixtral-8x7b", False, 2),
    ("kimi-k2-1t-a32b", True, 8)])
def test_validate_ep_layout_like_the_reference(arch, moe, ep):
    jcfg = jreduce(jget_config(arch))
    tcfg = reduce_for_smoke(get_config(arch))
    if not moe:
        jcfg, tcfg = jcfg.replace(moe=None), tcfg.replace(moe=None)
    try:
        jvalidate_ep_layout(jcfg, ep)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        validate_ep_layout(tcfg, ep)
    else:
        with pytest.raises(ValueError) as got:
            validate_ep_layout(tcfg, ep)
        assert str(got.value) == want


# ---------------------------------------------------------------------------
# the sharded moe_apply
# ---------------------------------------------------------------------------

def _moe_inputs(t, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn(D, E, generator=g) / D ** 0.5}
    for k, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)),
                     ("w_down", (E, F, D))):
        p[k] = (torch.randn(shape, generator=g) / shape[1] ** 0.5).to(
            torch.bfloat16)
    x = torch.randn(t, D, generator=g).to(torch.bfloat16)
    return p, x


def _par(mesh):
    return tm.MoEParallelism(mesh=mesh, dp_axes=("data",),
                             fsdp_axis="data")


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("banks_kind", ["f16", "ladder"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_sharded_moe_apply_bytes_equal_one_device(ep, banks_kind,
                                                  capacity_factor):
    """At top-2 every token's output is one rank's exact contribution
    plus exact zeros: the bytes of one device, also where the capacity
    drops assignments (factor 0.5)."""
    p, x = _moe_inputs(24)
    moe = MoEConfig(num_experts=E, top_k=2, d_ff_expert=F,
                    capacity_factor=capacity_factor)
    if banks_kind == "f16":
        banks = tm.train_banks(p)
    else:   # 4 int4, 2 int8, 2 bf16 experts: every bank splits over 2
        bits = np.array([4, 4, 8, 16, 4, 8, 16, 4]) if ep == 2 \
            else np.array([4, 4, 4, 16, 4, 16, 16, 16])
        banks, order = tm.build_ladder_banks(p, bits, ladder=(16, 8, 4),
                                             group_size=GROUP)
        p = dict(p, router=p["router"][:, torch.as_tensor(order).long()])
    weights, ids = tm.route(p["router"], x, moe)
    want = tm.moe_apply(banks, x, weights, ids, moe)
    mesh = make_ep_mesh(ep, devices=cpus(ep))
    got = tm.moe_apply(banks, x, weights, ids, moe, _par(mesh))
    placed = tm.moe_apply(tm.shard_banks(banks, mesh), x, weights, ids, moe,
                          _par(mesh))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(placed.view(torch.int16), want.view(torch.int16))
    # a (1, 1) mesh is the single-device path
    one = tm.moe_apply(banks, x, weights, ids, moe,
                       _par(make_ep_mesh(1, devices=cpus(1))))
    assert torch.equal(one.view(torch.int16), want.view(torch.int16))


def test_sharded_moe_apply_refuses_what_serving_never_builds():
    """The (2, 2) mesh and the TP layout, which the serving slice
    refused, now run the reference's regimes: data x EP at top-2 gives
    one device's bytes; token-gather and TP sum partial d_ff products,
    so they agree within bf16 rounding. A bank that does not split
    evenly still raises the reference's ValueError."""
    p, x = _moe_inputs(8)
    moe = MoEConfig(num_experts=E, top_k=2, d_ff_expert=F)
    weights, ids = tm.route(p["router"], x, moe)
    banks = tm.train_banks(p)
    want = tm.moe_apply(banks, x, weights, ids, moe)
    mesh = make_test_mesh((2, 2), devices=cpus(4))
    dxep = tm.moe_apply(banks, x, weights, ids, moe, tm.MoEParallelism(
        mesh=mesh, dp_axes=("data",)))
    assert torch.equal(dxep.view(torch.int16), want.view(torch.int16))
    gathered = tm.moe_apply(banks, x, weights, ids, moe, _par(mesh))
    bar = 2 ** -7 * float(want.float().abs().max())
    assert float((gathered.float() - want.float()).abs().max()) <= bar
    # fewer experts than ranks: the TP regime
    small = MoEConfig(num_experts=2, top_k=1, d_ff_expert=F)
    two = {"q4": None, "f16": {k: v[:2] for k, v in banks["f16"].items()}}
    w2, i2 = tm.route(p["router"][:, :2], x, small)
    one = tm.moe_apply(two, x, w2, i2, small)
    tp = tm.moe_apply(two, x, w2, i2, small,
                      _par(make_ep_mesh(4, devices=cpus(4))))
    bar = 2 ** -7 * float(one.float().abs().max())
    assert float((tp.float() - one.float()).abs().max()) <= bar
    # a bank that does not split evenly: the reference's ValueError
    bits = np.array([4, 4, 4, 16, 16, 16, 16, 16])       # 3 int4, 5 bf16
    odd, _ = tm.build_ladder_banks(p, bits, ladder=(16, 4), group_size=GROUP)
    with pytest.raises(ValueError, match="EP banks must split evenly"):
        tm.moe_apply(odd, x, weights, ids, moe,
                     _par(make_ep_mesh(2, devices=cpus(2))))


def test_fsdp_inactive_without_axis():
    """The reference's regime gate: token-gather never activates on a
    (1, ep) serving mesh, whose fsdp axis has size 1."""
    p, _ = _moe_inputs(8)
    moe = MoEConfig(num_experts=E, top_k=2, d_ff_expert=F)
    for ep in (1, 2):
        par = _par(make_ep_mesh(ep, devices=cpus(ep)))
        assert par.fsdp_size == 1 and par.ep_size == ep
        assert not tm._fsdp_active(tm.train_banks(p), moe, par, ep=True)
    par = _par(make_test_mesh((2, 2), devices=cpus(4)))
    assert par.fsdp_size == 2
    assert tm._fsdp_active(tm.train_banks(p), moe, par, ep=True)


# ---------------------------------------------------------------------------
# the model over a (1, ep) mesh: the reference's decode parity script
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    return cfg, init_params(cfg, 0, device="cpu")


def _plans(cfg):
    L, E_, gs = cfg.num_layers, cfg.moe.num_experts, cfg.mop.group_size
    # per-layer bank sizes divide by the largest ep under test (4)
    return {
        "binary": balanced_ladder_plan(L, E_, {4: 4 * L}, ladder=(16, 4),
                                       group_size=gs),
        "mixed": balanced_ladder_plan(L, E_, {4: 4 * L, 8: 4 * L},
                                      ladder=(16, 8, 4), group_size=gs),
        "replan": balanced_ladder_plan(L, E_, {4: 8 * L}, ladder=(16, 4),
                                       group_size=gs),
    }


def _decode_bytes(cfg, sp, mesh, tok):
    model = build_model(cfg, mesh)
    cache = model.init_cache(2, 24, device="cpu")
    logits, cache = model.prefill(sp, {"tokens": tok}, cache)
    chunks = [logits.numpy().tobytes()]
    cur = logits.argmax(-1)[:, None]
    pos = torch.full((2,), tok.shape[1])
    for step in range(4):
        logits, cache = model.decode_step(sp, cache, cur, pos + step)
        chunks.append(logits.numpy().tobytes())
        cur = logits.argmax(-1)[:, None]
    return b"".join(chunks)


@pytest.mark.parametrize("plan_name", ["binary", "mixed", "replan"])
def test_decode_bit_identical_across_ep(smoke, plan_name):
    cfg, params = smoke
    plan = _plans(cfg)[plan_name]
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 8)))
    ref = _decode_bytes(cfg, apply_precision_plan(params, cfg, plan), None,
                        tok)
    for ep in (2, 4):
        mesh = make_ep_mesh(ep, devices=cpus(ep))
        placed = apply_precision_plan(params, cfg, plan, mesh=mesh)
        shards = placed["layers"]["moe"]["banks"]
        assert len(shards) == ep
        for key, bank in shards[0].items():
            if bank is not None:
                assert bank["w_up"].shape[1] \
                    == int((plan.bits[0] == tm._bank_bits(key)).sum()) // ep
        assert _decode_bytes(cfg, placed, mesh, tok) == ref, \
            f"{plan_name}: ep={ep} (placed banks) diverges from ep=1"
        unplaced = apply_precision_plan(params, cfg, plan)
        assert _decode_bytes(cfg, unplaced, mesh, tok) == ref, \
            f"{plan_name}: ep={ep} (banks sharded in moe_apply) diverges"


def test_replan_migrates_experts_between_ranks(smoke):
    """The replan moves every bf16 expert into the int4 bank: bank
    membership changes, so the contiguous per-bank sharding moves experts
    between ranks (and decode stayed bit-identical on both sides)."""
    cfg, params = smoke
    plans = _plans(cfg)
    a = plans["binary"].device_assignment(4)
    b = plans["replan"].device_assignment(4)
    assert (a != b).any(), "replan migrated no expert between EP ranks"
    # each rank's shard holds exactly the experts device_assignment gives it
    mesh = make_ep_mesh(4, devices=cpus(4))
    for plan in (plans["binary"], plans["replan"]):
        order = plan.expert_order()
        ranks = plan.device_assignment(4)
        offs = 0
        for bits in sorted(plan.ladder):
            n = int((plan.bits[0] == bits).sum())
            for r in range(4):
                held = order[0, offs + r * n // 4: offs + (r + 1) * n // 4]
                assert (ranks[0, held] == r).all()
            offs += n
        apply_precision_plan(params, cfg, plan, mesh=mesh)


def test_loss_fn_over_the_mesh_equals_one_device(smoke):
    cfg, params = smoke
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (2, 8)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    want, _ = build_model(cfg).loss_fn(params, batch)
    got, _ = build_model(cfg, make_ep_mesh(2, devices=cpus(2))).loss_fn(
        params, batch)
    assert got.item() == want.item()


# ---------------------------------------------------------------------------
# against the reference's EP (subprocesses with the forced device count)
# ---------------------------------------------------------------------------

_VS_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import contextlib
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs import get_config, reduce_for_smoke
from repro.core.precision_plan import balanced_ladder_plan
from repro.launch.mesh import make_ep_mesh as jmesh, use_mesh
from repro.models.model import apply_precision_plan as japply
from repro.models.model import build_model as jbuild
import repro_torch.configs as tconfigs
from repro_torch.launch.mesh import make_ep_mesh
from repro_torch.models.model import (apply_precision_plan, build_model,
                                      params_from_numpy)


def reference(cfg, params, plan, tok, ep):
    mesh = None if ep == 1 else jmesh(ep)
    model = jbuild(cfg, mesh)
    with use_mesh(mesh) if mesh else contextlib.nullcontext():
        sp = japply(params, cfg, plan)
        cache = model.init_cache(2, 24)
        jl, cache = model.prefill(sp, {"tokens": jnp.asarray(tok)}, cache)
        out = [np.asarray(jl, np.float32)]
        cur = jnp.argmax(jl, -1)[:, None]
        feed = [np.asarray(cur)]
        pos = jnp.full((2,), tok.shape[1], jnp.int32)
        for step in range(4):
            jl, cache = model.decode_step(sp, cache, cur, pos + step)
            out.append(np.asarray(jl, np.float32))
            cur = jnp.argmax(jl, -1)[:, None]
            feed.append(np.asarray(cur))
    return np.stack(out), feed


def port(cfg, params, plan, tok, feed, ep):
    mesh = None if ep == 1 else make_ep_mesh(ep, devices=["cpu"] * ep)
    sp = apply_precision_plan(params, cfg, plan, mesh=mesh)
    model = build_model(cfg, mesh)
    cache = model.init_cache(2, 24, device="cpu")
    tl, cache = model.prefill(sp, {"tokens": torch.from_numpy(tok)}, cache)
    out = [tl.float().numpy()]
    for step in range(4):
        tl, cache = model.decode_step(
            sp, cache, torch.from_numpy(feed[step]).long(),
            torch.full((2,), tok.shape[1] + step))
        out.append(tl.float().numpy())
    return np.stack(out)


for dtype in ("bfloat16", "float32"):
    cfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(dtype=dtype)
    tcfg = tconfigs.reduce_for_smoke(
        tconfigs.get_config("mixtral-8x7b")).replace(dtype=dtype)
    L, E, gs = cfg.num_layers, cfg.moe.num_experts, cfg.mop.group_size
    params = jbuild(cfg).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    tok = np.array(jax.random.randint(jax.random.key(1), (2, 8), 1,
                                      cfg.vocab_size))
    for counts, ladder in (({4: 4 * L}, (16, 4)),
                           ({4: 4 * L, 8: 2 * L}, (16, 8, 4))):
        plan = balanced_ladder_plan(L, E, counts, ladder=ladder,
                                    group_size=gs)
        ref1, feed = reference(cfg, params, plan, tok, 1)
        ref2, feed2 = reference(cfg, params, plan, tok, 2)
        got1 = port(tcfg, tparams, plan, tok, feed, 1)
        got2 = port(tcfg, tparams, plan, tok, feed, 2)
        # each package's EP is its single device, bit for bit, so the
        # port's ep=2 gap to the reference's ep=2 is its ep=1 gap
        assert ref2.tobytes() == ref1.tobytes(), "reference EP drifted"
        assert got2.tobytes() == got1.tobytes(), "port EP drifted"
        assert (got2.argmax(-1) == ref2.argmax(-1)).all(), "greedy differ"
        gap = float(np.abs(got2 - ref2).max())
        print(f"{dtype} {ladder}: max |port ep=2 - reference ep=2| "
              f"{gap:.3e}, max |logit| {float(np.abs(ref2).max()):.3f}")
        if dtype == "float32":
            assert gap <= 5e-2, gap
print("OK")
"""

_TOP8_VS_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs.base import MoEConfig as JMoE
from repro.core import mixed_moe as JM
from repro.launch.mesh import make_ep_mesh as jmesh, use_mesh
from repro_torch.configs.base import MoEConfig
from repro_torch.core import mixed_moe as TM
from repro_torch.launch.mesh import make_ep_mesh
from repro_torch.models.model import tensor_from_numpy

# ternary weights and tokens with the relu^2 activation: every expert
# product is exact in both frameworks, so only the combine and the closing
# sum over ranks can differ
E, k, d, f, t = 8, 8, 64, 64, 24
rng = np.random.default_rng(0)
def tern(shape):
    return jnp.asarray(rng.integers(-1, 2, shape).astype(np.float32),
                       jnp.bfloat16)
p = {"w_gate": tern((E, d, f)), "w_up": tern((E, d, f)),
     "w_down": tern((E, f, d))}
x = tern((t, d))
router = jnp.asarray(rng.standard_normal((d, E)), jnp.float32)
jmoe = JMoE(num_experts=E, top_k=k, d_ff_expert=f, capacity_factor=8.0)
tmoe = MoEConfig(num_experts=E, top_k=k, d_ff_expert=f, capacity_factor=8.0)
w, ids, _ = JM.route(router, x, jmoe, train=False)
tb = {"q4": None, "f16": {n: tensor_from_numpy(np.asarray(v), "cpu")
                          for n, v in p.items()}}
tx = tensor_from_numpy(np.asarray(x), "cpu")
tw = torch.from_numpy(np.array(w))
tids = torch.from_numpy(np.array(ids)).long()
single = TM.moe_apply(tb, tx, tw, tids, tmoe, act="relu2")
for ep in (1, 2, 4, 8):
    mesh = jmesh(ep)
    par = JM.MoEParallelism(mesh=mesh, dp_axes=("data",), fsdp_axis="data")
    with use_mesh(mesh):
        want = np.asarray(JM.moe_apply({"q4": None, "f16": p}, x, w, ids,
                                       jmoe, par, act="relu2")).view(
                                           np.uint16)
    tpar = TM.MoEParallelism(mesh=make_ep_mesh(ep, devices=["cpu"] * ep),
                             dp_axes=("data",), fsdp_axis="data")
    got = TM.moe_apply(tb, tx, tw, tids, tmoe, tpar, act="relu2")
    got = got.view(torch.int16).numpy().view(np.uint16)
    assert (got == want).all(), f"ep={ep}: {(got != want).sum()} differ"
    n = int((got != single.view(torch.int16).numpy().view(np.uint16)).sum())
    print(f"EP {ep} equal to the reference's EP; {n} elements differ "
          "from one device")
print("OK")
"""


def _run_sub(script, timeout):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_ep2_logits_match_the_reference_ep2():
    """The reference decodes over a (1, 2) mesh of forced host devices,
    the port over ``["cpu"] * 2``, on converted params and binary and
    three-rung plans (prefill + 4 greedy steps, the reference's tokens
    fed to both): greedy ids equal, each package's ep = 2 bytes equal to
    its ep = 1 bytes, and in float32 the logits within 5e-2 (observed
    ~1e-6). In bf16 the two frameworks' logits for this prompt differ by
    up to 0.18 at the last step, at ep = 1 as at ep = 2 with equal
    routes: bf16 rounding of another summation order, not EP."""
    r = _run_sub(_VS_REFERENCE, timeout=600)
    assert "OK" in r.stdout, r.stdout + r.stderr


def test_top8_ep_bytes_equal_the_reference_ep():
    """At top-8 a token's outputs are summed per rank and then across
    ranks, so EP is not one device's bytes; it is the reference's EP's,
    whose bf16 psum on XLA:CPU sums in f32 and rounds once."""
    r = _run_sub(_TOP8_VS_REFERENCE, timeout=300)
    assert "OK" in r.stdout, r.stdout + r.stderr
