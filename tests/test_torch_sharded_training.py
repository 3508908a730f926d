"""Sharded training in the port (``dist.sharding.shard_tree``,
``build_model(cfg, mesh)``, ``make_train_step``, ``opt_state_specs``,
``CheckpointManager.restore(shardings=)``, the train CLI's ``--mesh``)
against the reference's jitted sharded train step.

One subprocess forces eight host devices before importing JAX, trains the
smoke Mixtral (2 layers, d 64, 8 experts, top-2) on 4 x 16 batches over
(2, 2), (4, 1) and (1, 4) meshes and writes its params, per-device
shard blocks, gradients, metrics and a checkpoint; the tests run the same
params and batches through the port on ``["cpu"] * 4``:

* float32 AdamW, 2 steps: loss, gradients (first step) and params within
  1e-5 of max |ref| of each leaf; bf16: the nll within 1e-2;
* each position's shard is the block the reference's device holds
  (``addressable_shards``), and replicas stay equal after every step;
* 2 microbatches, Adafactor and int8 compression on the (2, 2) mesh
  against the reference's steps;
* ``restore(shardings=)`` across mesh shapes and across the packages,
  with equal bytes; the train CLI with ``--mesh 2,2 --device
  cpu,cpu,cpu,cpu`` and a resume of its checkpoint on ``--mesh 1,1``.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.dist import sharding as SH
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import build_model
from repro_torch.training import train_loop as TL
from repro_torch.training.optimizer import tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = [(2, 2), (4, 1), (1, 4)]
# name: (dtype, mesh, optimizer, grad compression, microbatches)
CASES = {f"{dt} adamw {m[0]}x{m[1]}": (dt, m, "adamw", None, 1)
         for dt in ("float32", "bfloat16") for m in MESHES}
CASES.update({
    "float32 adamw 2 microbatches 2x2": ("float32", (2, 2), "adamw", None, 2),
    "float32 adafactor 2x2": ("float32", (2, 2), "adafactor", None, 1),
    "float32 adamw int8 2x2": ("float32", (2, 2), "adamw", "int8", 1),
})

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduce_for_smoke
from repro.dist import sharding as SH
from repro.ft.checkpoint import CheckpointManager
from repro.launch.mesh import make_test_mesh, use_mesh
from repro.models.model import build_model
from repro.training.train_loop import TrainConfig, init_train_state, \
    make_train_step

CASES = %(cases)r
out = {}
rng = np.random.default_rng(0)
batches = [{k: rng.integers(1, 512, (4, 16)).astype(np.int32)
            for k in ("tokens", "labels")} for _ in range(2)]
for i, b in enumerate(batches):
    for k, v in b.items():
        out[f"batch/{i}/{k}"] = v


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def flat(tree):
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


for ci, (name, (dtype, shape, opt, comp, micro)) in enumerate(CASES.items()):
    cfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(dtype=dtype)
    mesh = make_test_mesh(shape)
    model = build_model(cfg, mesh)
    params = model.init(jax.random.key(0))
    pre = f"{ci}/"
    for k, v in flat(params).items():
        out[pre + "p0/" + k] = bits(v)
    tcfg = TrainConfig(optimizer=opt, grad_compression=comp,
                       num_microbatches=micro)
    with use_mesh(mesh):
        params = jax.tree_util.tree_map(
            jax.device_put, params, SH.param_shardings(cfg, mesh, params))
        order = [d.id for d in mesh.devices.reshape(-1)]
        for k, v in flat(params).items():
            by_dev = {s.device.id: s.index for s in v.addressable_shards}
            out[pre + "blocks/" + k] = np.array(
                [[(sl.start or 0, v.shape[d] if sl.stop is None else sl.stop)
                  for d, sl in enumerate(by_dev[i])] for i in order],
                np.int64).reshape(len(order), v.ndim, 2)
        state = init_train_state(params, tcfg)
        (_, m0), grads = jax.jit(jax.value_and_grad(
            model.loss_fn, has_aux=True))(params, {
                k: jnp.asarray(v) for k, v in batches[0].items()})
        for k, v in flat(grads).items():
            out[pre + "g0/" + k] = bits(v)
        step = jax.jit(make_train_step(model.loss_fn, tcfg))
        for i, b in enumerate(batches):
            params, state, m = step(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()})
            for k in ("nll", "loss", "grad_norm"):
                out[pre + f"m{i}/" + k] = np.asarray(m[k], np.float32)
    for k, v in flat(params).items():
        out[pre + "p2/" + k] = bits(v)
    if ci == 0:
        CheckpointManager(sys.argv[2], keep=3).save(
            2, {"params": params}, block=True)
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_training")
    script = _SCRIPT % {"cases": CASES}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, str(tmp / "ref.npz"),
                        str(tmp / "ckpt")], env=env, capture_output=True,
                       text=True, timeout=900)
    assert "OK" in r.stdout, r.stdout + r.stderr
    return dict(np.load(tmp / "ref.npz")), tmp / "ckpt"


def _tree(flat_np, prefix, bf16):
    """The reference's leaves under ``prefix`` as a nested dict of CPU
    tensors."""
    out = {}
    for key, v in flat_np.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = torch.from_numpy(np.array(v))
        node[parts[-1]] = t.view(torch.bfloat16) if bf16 and \
            v.dtype == np.uint16 else t
    return out


def _batch(ref, i):
    return {k: torch.from_numpy(ref[f"batch/{i}/{k}"]).long()
            for k in ("tokens", "labels")}


def _close(got, want, rel, what):
    want = want.to(torch.float32)
    bar = rel * max(float(want.abs().max()), 1e-30)
    err = float((got.to(torch.float32) - want).abs().max())
    assert err <= bar, f"{what}: {err:.3e} > {bar:.3e}"


def _replicas_equal(tree):
    for path, leaf in tree_leaves(tree):
        if isinstance(leaf, SH.Sharded):
            for _, group in leaf.layout.groups:
                for p in group[1:]:
                    assert torch.equal(leaf.shards[p],
                                       leaf.shards[group[0]]), path


def _train(ref, ci, case):
    dtype, shape, opt, comp, micro = case
    cfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(dtype=dtype)
    mesh = make_test_mesh(shape, devices=["cpu"] * 4)
    bf16 = dtype == "bfloat16"
    params = _tree(ref, f"{ci}/p0/", bf16)
    sp = SH.shard_tree(params, SH.param_shardings(cfg, mesh, params))
    tcfg = TL.TrainConfig(optimizer=opt, grad_compression=comp,
                          num_microbatches=micro)
    state = TL.init_train_state(sp, tcfg)
    model = build_model(cfg, mesh)
    step = TL.make_train_step(model.loss_fn, tcfg)
    return cfg, mesh, sp, state, model, step


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_like_the_reference(reference, case):
    ref, _ = reference
    ci = list(CASES).index(case)
    dtype = CASES[case][0]
    cfg, mesh, sp, state, model, step = _train(ref, ci, CASES[case])
    # each position holds the block the reference's device holds
    for path, leaf in tree_leaves(sp):
        blocks = ref[f"{ci}/blocks/" + "/".join(path)]
        for pos, idx in enumerate(leaf.layout.index):
            want = tuple(slice(int(a), int(b)) for a, b in blocks[pos])
            assert leaf.layout.block(leaf.shape, idx) == want, path
    f32 = dtype == "float32"
    if f32 and CASES[case][4] == 1:
        _, m0, grads = TL.value_and_grad(model.loss_fn, sp, _batch(ref, 0))
        _close(m0["loss"], torch.from_numpy(np.array(ref[f"{ci}/m0/loss"])),
               1e-5, "loss")
        want = dict(tree_leaves(_tree(ref, f"{ci}/g0/", False)))
        for path, g in tree_leaves(grads):
            _close(g.full(), want[path], 1e-5, f"grad {path}")
    for i in range(2):
        sp, state, m = step(sp, state, _batch(ref, i))
        _replicas_equal(sp)
        _replicas_equal(state)
        want = float(ref[f"{ci}/m{i}/nll"])
        if f32:
            assert abs(float(m["nll"]) - want) <= 1e-5 * abs(want), i
            _close(m["grad_norm"], torch.tensor(
                float(ref[f"{ci}/m{i}/grad_norm"])), 1e-5, "grad norm")
        else:
            assert abs(float(m["nll"]) - want) <= 1e-2, i
    if f32:
        want = dict(tree_leaves(_tree(ref, f"{ci}/p2/", False)))
        for path, p in tree_leaves(sp):
            _close(p.full(), want[path], 1e-5, f"param {path}")


def test_restore_across_meshes_and_packages(reference, tmp_path):
    ref, ckpt = reference
    ci = 0
    cfg, mesh, sp, state, model, step = _train(ref, ci, CASES[
        list(CASES)[ci]])
    # the reference's (2, 2)-sharded checkpoint onto the port's meshes
    saved = dict(tree_leaves(_tree(ref, f"{ci}/p2/", False)))
    for shape in [(1, 4), (4, 1), (1, 1)]:
        other = make_test_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
        where = SH.param_shardings(cfg, other, sp)
        tree, _ = CheckpointManager(str(ckpt)).restore(
            shardings={"params": where})
        for path, leaf in tree_leaves(tree["params"]):
            assert isinstance(leaf, SH.Sharded) and leaf.mesh == other
            assert torch.equal(leaf.full().view(torch.uint8),
                               saved[path].view(torch.uint8)), path
    # the port's sharded params and state, saved whole, onto another mesh
    sp, state, _ = step(sp, state, _batch(ref, 0))
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    mgr.save(1, {"params": sp, "opt": state}, block=True)
    other = make_test_mesh((4, 1), devices=["cpu"] * 4)
    specs = SH.param_specs(cfg, other, sp)
    where = {"params": SH.shardings(other, specs),
             "opt": SH.shardings(other, TL.opt_state_specs(
                 specs, TL.TrainConfig(), sp))}
    tree, _ = mgr.restore(shardings=where)
    for name, src in (("params", sp), ("opt", state)):
        back = dict(tree_leaves(tree[name]))
        for path, leaf in tree_leaves(src):
            assert tuple(back[path].mesh.shape) == (4, 1)
            assert torch.equal(back[path].full(), leaf.full()), path
    # and the reference reads it: the gathered bytes of every leaf
    from repro.ft.checkpoint import CheckpointManager as JManager
    jtree, _ = JManager(str(tmp_path / "port")).restore()
    for path, leaf in tree_leaves(sp):
        node = jtree["params"]
        for p in path:
            node = node[p]
        assert np.asarray(node).tobytes() == \
            leaf.full().numpy().tobytes(), path


def test_cli_trains_on_a_mesh_and_resumes_on_another(tmp_path, capsys):
    common = ["--arch", "mixtral-8x7b", "--batch", "4", "--seq", "16",
              "--log-every", "1"]
    T.main(common + ["--steps", "4", "--ckpt-every", "2", "--mesh", "2,2",
                     "--device", "cpu,cpu,cpu,cpu", "--ckpt-dir",
                     str(tmp_path / "a")])
    straight = capsys.readouterr().out
    assert "mesh=2x2" in straight
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_2", tmp_path / "b" / "step_2")
    (tmp_path / "b" / "step_2.COMMITTED").touch()
    T.main(common + ["--steps", "4", "--mesh", "1,1", "--device", "cpu",
                     "--resume", "--ckpt-dir", str(tmp_path / "b")])
    resumed = capsys.readouterr().out
    assert "mesh=1x1" in resumed and "[train] resumed from step 2" in resumed

    def nll(out):
        return [float(v) for v in re.findall(r"nll=([0-9.]+)", out)]
    # the same steps on another mesh: bf16 reduction orders differ
    assert len(nll(resumed)) == 2
    assert np.allclose(nll(resumed), nll(straight)[2:], atol=1e-2)
    with pytest.raises(SystemExit, match="needs 4"):
        T.main(common + ["--mesh", "2,2", "--device", "cpu,cpu"])
