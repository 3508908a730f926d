"""The port's model functions against the reference's on the smoke-size
Mixtral (2 layers, d_model 64) with the reference's params converted by
``params_from_numpy``.

Bars: ``apply_precision_plan`` banks and router byte-equal; prefill and
4 decode steps give logits within atol 5e-2 (bf16 activations over 2
layers; matmuls sum in another order) and equal route ids."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.precision_plan import balanced_ladder_plan as jplan
from repro.core.quantization import QTensor as JQTensor
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.precision_plan import balanced_ladder_plan
from repro_torch.core.quantization import QTensor
from repro_torch.models import model as tmodel

LADDER = (16, 8, 4)
COUNTS = {4: 6, 8: 4}      # global counts over 2 layers x 8 experts


def bits16(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jreduce(jget_config("mixtral-8x7b"))
    tcfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    jparams = jmodel.build_model(jcfg).init(jax.random.key(0))
    tparams = tmodel.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    args = dict(ladder=LADDER, group_size=jcfg.mop.group_size, seed=0)
    jp = jplan(jcfg.num_layers, jcfg.moe.num_experts, COUNTS, **args)
    tp = balanced_ladder_plan(tcfg.num_layers, tcfg.moe.num_experts, COUNTS,
                              **args)
    np.testing.assert_array_equal(tp.bits, jp.bits)
    return (jcfg, tcfg, jmodel.apply_precision_plan(jparams, jcfg, jp),
            tmodel.apply_precision_plan(tparams, tcfg, tp), jparams, tparams)


def test_configs_equal():
    for arch in ("mixtral-8x7b", "mixtral-mop"):
        assert str(get_config(arch)) == str(jget_config(arch))
    assert str(reduce_for_smoke(get_config("mixtral-8x7b"))) \
        == str(jreduce(jget_config("mixtral-8x7b")))
    assert str(get_config("rwkv6-3b")) == str(jget_config("rwkv6-3b"))
    with pytest.raises(KeyError):
        get_config("rwkv7-3b")


def test_params_from_numpy_round_trip(smoke):
    _, tcfg, _, _, jparams, tparams = smoke
    table = tparams["embed"]["table"]
    assert table.dtype == torch.bfloat16
    assert tuple(table.shape) == (tcfg.padded_vocab, tcfg.d_model)
    np.testing.assert_array_equal(bits16(table),
                                  bits16(jparams["embed"]["table"]))


def test_apply_precision_plan_byte_equal(smoke):
    _, _, jserve, tserve, _, _ = smoke
    jm, tm = jserve["layers"]["moe"], tserve["layers"]["moe"]
    np.testing.assert_array_equal(bits16(tm["router"]),
                                  bits16(jm["router"]))
    assert set(tm["banks"]) == set(jm["banks"])
    for key, bank in jm["banks"].items():
        assert (bank is None) == (tm["banks"][key] is None)
        for name, w in (bank or {}).items():
            got = tm["banks"][key][name]
            if isinstance(w, JQTensor):
                assert isinstance(got, QTensor) and got.bits == w.bits
                np.testing.assert_array_equal(got.q.numpy(), np.asarray(w.q))
                np.testing.assert_array_equal(bits16(got.scales),
                                              bits16(w.scales))
            else:
                np.testing.assert_array_equal(bits16(got), bits16(w))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match(smoke, use_kernel):
    jcfg, tcfg, jserve, tserve, _, _ = smoke
    jm = jmodel.build_model(jcfg, use_kernel=use_kernel)
    tm = tmodel.build_model(tcfg, use_kernel=use_kernel)
    jprefill = jax.jit(jm.prefill_into_slot)
    jdecode = jax.jit(jm.decode_step_routed)
    jcache = jm.init_cache(2, 24)
    tcache = tm.init_cache(2, 24, device="cpu")
    s, sb = 6, 8                        # right-padded to the bucket
    rng = np.random.default_rng(0)
    toks = np.zeros((1, sb), np.int32)
    pos = np.full((1, sb), -1, np.int32)
    toks[0, :s] = rng.integers(1, jcfg.vocab_size, s)
    pos[0, :s] = np.arange(s)
    jl, jcache = jprefill(jserve, jcache, jnp.asarray(toks),
                          jnp.asarray(pos), jnp.int32(1), jnp.int32(s - 1))
    tl, tcache = tm.prefill_into_slot(tserve, tcache, torch.from_numpy(toks),
                                      torch.from_numpy(pos), 1, s - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for step in range(4):
        tok = int(np.argmax(np.asarray(jl)[0, :jcfg.vocab_size]))
        dt = np.array([[0], [tok]], np.int32)
        dp = np.array([-1, s + step], np.int32)      # slot 0 idle
        jl, jcache, jids = jdecode(jserve, jcache, jnp.asarray(dt),
                                   jnp.asarray(dp))
        tl, tcache, tids = tm.decode_step_routed(
            tserve, tcache, torch.from_numpy(dt), torch.from_numpy(dp))
        np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl)[1],
                                   atol=5e-2)
        np.testing.assert_array_equal(tids[:, 1].numpy(),
                                      np.asarray(jids)[:, 1])
        assert tuple(tids.shape) == tuple(jids.shape)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    tcache = tm.reset_slot(tcache, 1)
    assert bool((tcache["pos"][:, 1] == -1).all())


def test_init_params_shapes_and_generator(monkeypatch):
    cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    a = tmodel.init_params(cfg, 3, device="cpu")
    b = tmodel.init_params(cfg, 3, device="cpu")
    for name, shape in cfg.param_shapes():
        node_a, node_b = a, b
        for part in name.split("/"):
            node_a, node_b = node_a[part], node_b[part]
        assert tuple(node_a.shape) == shape
        assert torch.equal(node_a, node_b)
    assert bool((a["final_norm"]["scale"] == 1).all())
    # the default device is the card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(cfg, 3)
