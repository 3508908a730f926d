"""The port's sharding rules (``repro_torch.dist.sharding``,
``training.train_loop.opt_state_specs``) against the reference's
``repro.dist.sharding``.

The reference's rules read only a mesh's axis sizes, so its side runs on
a ``jax.sharding.AbstractMesh`` (no devices); the port's on a ``Mesh`` of
repeated CPU devices. For every registered arch, at smoke size and at
full size (shapes only: ``abstract_params`` on both sides), on (2, 2),
(4, 1), (1, 4) and (2, 2, 2) meshes:

* ``param_specs`` of the train layout, and of the serve layout for the
  MoE archs (the reference's through ``jax.eval_shape``);
* ``opt_state_specs`` for AdamW, Adafactor and int8 compression;
* ``batch_axes``, the activation rules and ``full_grouped_ok``;
* ``input_specs`` and ``cache_specs`` (shapes, dtypes and specs);
* ``shard_tree``: every position's shard has the shape the reference's
  ``NamedSharding.shard_shape`` gives, holds that block of the tensor,
  and replicas are equal; ``Sharded.full`` gives the tensor back.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.precision_plan import balanced_ladder_plan as jplan
from repro.dist import sharding as JS
from repro.models import model as JMOD
from repro.training import train_loop as JT
from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.configs.base import SHAPES
from repro_torch.core.precision_plan import balanced_ladder_plan
from repro_torch.core.quantization import QTensor
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.models.model import (abstract_params, apply_precision_plan,
                                      init_params)
from repro_torch.training import train_loop as TT

MESHES = {(2, 2): ("data", "model"), (4, 1): ("data", "model"),
          (1, 4): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}
MESH_IDS = [f"{'x'.join(map(str, s))}" for s in MESHES]


def meshes(shape):
    axes = MESHES[shape]
    n = int(np.prod(shape))
    return (AbstractMesh(shape, axes),
            make_test_mesh(shape, axes, devices=["cpu"] * n))


def norm(spec):
    """A spec as a tuple, one-name tuples as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def jspecs(tree):
    """The reference's spec tree as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: jspecs(v) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, (JP, NamedSharding)):
        return norm(tree.spec if isinstance(tree, NamedSharding) else tree)
    # a reference QTensor of specs
    return {"q": norm(tree.q), "scales": norm(tree.scales)}


def tspecs(tree):
    if isinstance(tree, dict):
        return {k: tspecs(v) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, SH.Placement):
        return norm(tree.spec)
    if isinstance(tree, QTensor):
        return {"q": tspecs(tree.q), "scales": tspecs(tree.scales)}
    return norm(tree)


def configs(arch, size):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if size == "smoke":
        jcfg, tcfg = jreduce(jcfg), reduce_for_smoke(tcfg)
    return jcfg, tcfg


def test_registries_agree():
    """Every arch the reference registers is covered here (the port's
    registry adds the paper's ``mixtral-mop`` serving config, which the
    reference builds through ``get_config`` too)."""
    assert set(J_ARCH_IDS) <= set(ARCH_IDS)
    for arch in ARCH_IDS:
        assert jget_config(arch).arch_id == get_config(arch).arch_id
    assert set(SHAPES) == set(JSHAPES)


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_like_the_reference(arch, size, mesh_shape):
    jcfg, tcfg = configs(arch, size)
    jm, tm = meshes(mesh_shape)
    want = jspecs(JS.param_specs(jcfg, jm, JMOD.abstract_params(jcfg)))
    got = tspecs(SH.param_specs(tcfg, tm, abstract_params(tcfg)))
    assert got == want
    placements = SH.param_shardings(tcfg, tm, abstract_params(tcfg))
    assert tspecs(placements) == want


@functools.lru_cache(maxsize=None)
def _serve_trees(arch):
    jcfg, tcfg = configs(arch, "smoke")
    L, E = jcfg.num_layers, jcfg.moe.num_experts
    counts = {4: (E // 2) * L, 8: (E // 4) * L}
    args = dict(ladder=(16, 8, 4), group_size=jcfg.mop.group_size)
    jtree = jax.eval_shape(
        lambda p: JMOD.apply_precision_plan(
            p, jcfg, jplan(L, E, counts, **args)),
        JMOD.abstract_params(jcfg))
    ttree = apply_precision_plan(init_params(tcfg, 0, device="cpu"), tcfg,
                                 balanced_ladder_plan(L, E, counts, **args))
    return jcfg, tcfg, jtree, ttree


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-mop",
                                  "kimi-k2-1t-a32b"])
def test_serve_layout_param_specs_like_the_reference(arch, mesh_shape):
    """The N-bank serve layout: the QTensor banks get one spec for their
    codes and one for their scales, whose packed dims differ."""
    jcfg, tcfg, jtree, ttree = _serve_trees(arch)
    jm, tm = meshes(mesh_shape)
    assert tspecs(SH.param_specs(tcfg, tm, ttree)) == \
        jspecs(JS.param_specs(jcfg, jm, jtree))


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("opt", ["adamw", "adafactor", "adamw+int8",
                                 "adafactor+int8"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-3b", "zamba2-7b",
                                  "smollm-360m"])
def test_opt_state_specs_like_the_reference(arch, opt, mesh_shape):
    jcfg, tcfg = configs(arch, "full")
    jm, tm = meshes(mesh_shape)
    name, _, comp = opt.partition("+")
    jt = JT.TrainConfig(optimizer=name, grad_compression=comp or None)
    tt = TT.TrainConfig(optimizer=name, grad_compression=comp or None)
    jp = JMOD.abstract_params(jcfg)
    tp = abstract_params(tcfg)
    want = jspecs(JT.opt_state_specs(JS.param_specs(jcfg, jm, jp), jt, jp))
    got = tspecs(TT.opt_state_specs(SH.param_specs(tcfg, tm, tp), tt, tp))
    assert got == want


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_activation_rules_and_attention_choice_like_the_reference(
        arch, mesh_shape):
    jcfg, tcfg = configs(arch, "full")
    jm, tm = meshes(mesh_shape)
    for batch in (1, 2, 3, 4, 8, 256):
        assert SH.batch_axes(tm, batch) == JS.batch_axes(jm, batch)
    dp = SH.batch_axes(tm, 8)
    for train in (False, True):
        want = {k: norm(v) for k, v in
                JS._activation_rules(jcfg, jm, dp, train=train).items()}
        got = {k: norm(v) for k, v in
               SH._activation_rules(tcfg, tm, dp, train=train).items()}
        assert got == want
        for rule in want.values():        # what constrain would apply
            jeff = JS._effective_spec(JP(*rule), jm)
            teff = SH._effective_spec(SH.P(*rule), tm)
            assert (teff is None) == (jeff is None)
            assert teff is None or norm(teff) == norm(jeff)
    heads = [(tcfg.attention.num_heads, tcfg.attention.num_kv_heads)] \
        if tcfg.attention else []
    heads += [(32, 8), (15, 5), (4, 4), (6, 2)]
    for h, hkv in heads:
        assert SH.full_grouped_ok(h, hkv) == JS.full_grouped_ok(h, hkv)
        with JS.activation_constraints(jcfg, jm, dp), \
                SH.activation_constraints(tcfg, tm, dp):
            assert SH.full_grouped_ok(h, hkv) == JS.full_grouped_ok(h, hkv)
        with use_mesh(tm):
            assert SH.full_grouped_ok(h, hkv) == (
                hkv != h and h % tm.sizes["model"] != 0)
    # constrain changes no value, inside a context and outside
    x = torch.arange(24.0).reshape(2, 3, 4)
    with SH.activation_constraints(tcfg, tm, dp):
        assert SH.constrain(x, "residual") is x
        assert SH.constrain(x, "kv_cache") is x       # rule of higher rank
    assert SH.constrain(x, "residual") is x


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_like_the_reference(arch, size, mesh_shape):
    jcfg, tcfg = configs(arch, size)
    jm, tm = meshes(mesh_shape)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        if size == "smoke":
            shape = type(shape)(name, 32, shape.global_batch, shape.kind)
            jshape = type(jshape)(name, 32, jshape.global_batch, jshape.kind)
        jin, jsh = JS.input_specs(jcfg, jshape, jm)
        tin, tsh = SH.input_specs(tcfg, shape, tm)
        assert sorted(tin) == sorted(jin)
        for k in jin:
            assert tuple(tin[k].shape) == tuple(jin[k].shape), k
            assert str(tin[k].dtype).removeprefix("torch.") == \
                str(jin[k].dtype), k
            assert tin[k].device.type == "meta"
            assert norm(tsh[k].spec) == norm(jsh[k].spec), k
        if shape.kind != "decode":
            continue
        jc, jcs = JS.cache_specs(jcfg, jshape, jm)
        tc, tcs = SH.cache_specs(tcfg, shape, tm)
        jflat = jax.tree_util.tree_leaves_with_path(jc)
        assert tspecs(tcs) == jspecs(jcs)
        tflat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
                 for path, leaf in jflat}
        for key, leaf in tflat.items():
            node = tc
            for part in key.split("/"):
                node = node[part]
            assert tuple(node.shape) == tuple(leaf.shape), key
            assert node.device.type == "meta"


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-8b", "rwkv6-3b"])
def test_shard_tree_blocks_and_replicas(arch, mesh_shape):
    """Each position holds the block the spec gives it, of the shape the
    reference's ``NamedSharding.shard_shape`` gives; replicas are equal
    copies in storage of their own; ``full`` reassembles the tensor."""
    _, tcfg = configs(arch, "smoke")
    jm, tm = meshes(mesh_shape)
    params = init_params(tcfg, 0, device="cpu")
    placements = SH.param_shardings(tcfg, tm, params)
    placed = SH.shard_tree(params, placements)
    from repro_torch.training.optimizer import tree_leaves
    flat = dict(tree_leaves(params))
    for path, leaf in tree_leaves(placed):
        x = flat[path]
        want = NamedSharding(jm, JP(*leaf.spec)).shard_shape(tuple(x.shape))
        assert leaf.shape == tuple(x.shape)
        for pos, s in enumerate(leaf.shards):
            assert tuple(s.shape) == tuple(want), path
            blk = leaf.layout.block(leaf.shape, leaf.layout.index[pos])
            assert torch.equal(s, x[blk])
        for _, group in leaf.layout.groups:
            ptrs = {leaf.shards[p].data_ptr() for p in group}
            assert len(ptrs) == len(group), path
        assert torch.equal(leaf.full("cpu"), x)
    # a reshard onto another mesh keeps every value
    other = make_test_mesh((1, 2), devices=["cpu"] * 2)
    again = SH.shard_tree(placed, SH.param_shardings(tcfg, other, params))
    for path, leaf in tree_leaves(again):
        assert torch.equal(leaf.full(), flat[path])


def test_indivisible_dims_stay_replicated():
    """Every rule degrades to replication when a dim does not divide."""
    mesh = make_test_mesh((1, 3), devices=["cpu"] * 3)
    cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    specs = SH.param_specs(cfg, mesh, abstract_params(cfg))
    assert specs["layers"]["attn"]["wq"] == (None, None, None)   # 64 / 3
    assert specs["layers"]["moe"]["w_up"] == (None,) * 4
    with pytest.raises(ValueError, match="does not split"):
        SH.shard(torch.zeros(4, 5), SH.Placement(mesh, SH.P(None, "model")))
