"""The port's mixed-precision MoE layer against the reference's
(``repro.core.mixed_moe``) on one device: routing, ladder banks and the
full dispatch -> N-bank FFN -> combine, with the kernels off and on.

Bars: route ids equal, route weights within 1e-6 (f32 softmax), banks and
bank order byte-equal, MoE outputs within atol 2e-2 (bf16 activations;
with kernels on both packages dequantize in f32, with kernels off both
round the dequantized weights to bf16)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import mixed_moe as jm
from repro.core.quantization import QTensor as JQTensor
from repro_torch.configs.base import MoEConfig
from repro_torch.core import mixed_moe as tm
from repro_torch.core.quantization import QTensor
from repro_torch.models.model import tensor_from_numpy

E, D, F, GROUP = 8, 64, 64, 16
LADDER = (16, 8, 4)


def to_t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def bits16(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def single_device_par():
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    return jm.MoEParallelism(mesh=mesh, dp_axes=("data",),
                             fsdp_axis="data")


def moe_params(seed=0):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    return jp, {k: to_t(v) for k, v in jp.items()}


def tokens(t, seed=1):
    rng = np.random.default_rng(seed)
    jx = jnp.asarray(rng.standard_normal((t, D)), jnp.bfloat16)
    return jx, to_t(jx)


def cfgs(capacity_factor=1.25):
    return (JMoEConfig(num_experts=E, top_k=2, d_ff_expert=F,
                       capacity_factor=capacity_factor),
            MoEConfig(num_experts=E, top_k=2, d_ff_expert=F,
                      capacity_factor=capacity_factor))


def test_route_matches():
    jp, tp = moe_params()
    jx, tx = tokens(24)
    jcfg, tcfg = cfgs()
    jw, jids, _ = jm.route(jp["router"], jx, jcfg, train=False)
    with tm.capture_routing() as trace:
        tw, tids = tm.route(tp["router"], tx, tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_array_equal(trace[0], np.asarray(jids))


def bits_row(seed):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.array([4, 4, 4, 8, 8, 8, 16, 16]))


@pytest.mark.parametrize("seed", [0, 1])
def test_build_ladder_banks_byte_equal(seed):
    jp, tp = moe_params(seed)
    row = bits_row(seed)
    jb, jorder = jm.build_ladder_banks(jp, row, ladder=LADDER,
                                       group_size=GROUP)
    tb, torder = tm.build_ladder_banks(tp, row, ladder=LADDER,
                                       group_size=GROUP)
    np.testing.assert_array_equal(torder, jorder)
    assert set(tb) == set(jb) and tm.bank_keys(tb) == jm.bank_keys(jb)
    for key, bank in jb.items():
        for name, w in bank.items():
            got = tb[key][name]
            if isinstance(w, JQTensor):
                np.testing.assert_array_equal(got.q.numpy(), np.asarray(w.q))
                np.testing.assert_array_equal(bits16(got.scales),
                                              bits16(w.scales))
            else:
                np.testing.assert_array_equal(bits16(got), bits16(w))


def apply_both(jbanks, tbanks, t, use_kernel, invalid=(), capacity=None,
               capacity_factor=1.25):
    jp, tp = moe_params(5)
    jx, tx = tokens(t, seed=t)
    jcfg, tcfg = cfgs(capacity_factor)
    jw, jids, _ = jm.route(jp["router"], jx, jcfg, train=False)
    if invalid:
        mask = np.zeros((t, 1), bool)
        mask[list(invalid)] = True
        jids = jnp.where(mask, E, jids)
        jw = jnp.where(mask, 0.0, jw)
    want = jax.jit(functools.partial(
        jm.moe_apply, moe=jcfg, par=single_device_par(),
        use_kernel=use_kernel, capacity=capacity))(jbanks, jx, jw, jids)
    got = tm.moe_apply(tbanks, tx, to_t(jw), to_t(jids).long(), tcfg,
                       use_kernel=use_kernel, capacity=capacity)
    return got, want


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("t", [4, 13])
def test_moe_apply_ladder_matches(use_kernel, t):
    jp, tp = moe_params(2)
    row = bits_row(2)
    jb, _ = jm.build_ladder_banks(jp, row, ladder=LADDER, group_size=GROUP)
    tb, _ = tm.build_ladder_banks(tp, row, ladder=LADDER, group_size=GROUP)
    got, want = apply_both(jb, tb, t, use_kernel, invalid=(1,))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (t, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)
    assert bool((got[1].float() == 0).all())     # invalid token: no expert


def test_moe_apply_capacity_drops_match():
    """Over-capacity assignments are dropped identically (stable sort):
    12 tokens x top-2 over 8 experts with 4 slots each."""
    jp, tp = moe_params(3)
    jb = jm.train_banks(jp)
    tb = tm.train_banks(tp)
    got, want = apply_both(jb, tb, 12, False, capacity=4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_moe_apply_train_layout_matches():
    """The train layout (one bf16 bank of all experts), no kernel."""
    jp, tp = moe_params(4)
    got, want = apply_both(jm.train_banks(jp), tm.train_banks(tp), 9, False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)
    assert got.shape == want.shape


def test_dense_oracle_matches():
    jp, tp = moe_params(6)
    jx, tx = tokens(8, seed=6)
    jcfg, tcfg = cfgs()
    want = jm.moe_dense_ref(jp, jx, jcfg)
    got = tm.moe_dense_ref(tp, tx, tcfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)
    # with enough capacity the dispatched layer equals the dense oracle
    moe = tm.moe_apply(tm.train_banks(tp), tx, *tm.route(tp["router"], tx,
                                                          tcfg), tcfg,
                       capacity=16)
    np.testing.assert_allclose(moe.float().numpy(), got.float().numpy(),
                               atol=2e-2)


def test_qtensor_banks_keep_layout():
    _, tp = moe_params(7)
    tb, order = tm.build_ladder_banks(tp, bits_row(7), ladder=LADDER,
                                      group_size=GROUP)
    assert isinstance(tb["q4"]["w_up"], QTensor)
    assert tuple(tb["q4"]["w_up"].q.shape) == (3, D // 2, F)
    assert tuple(tb["q8"]["w_down"].q.shape) == (3, F, D)
    assert tuple(tb["f16"]["w_gate"].shape) == (2, D, F)
    assert sorted(order.tolist()) == list(range(E))
