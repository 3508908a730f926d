"""The SSM, hybrid and enc-dec families' dense compute split over (data,
model) meshes (``ssm.rwkv6_*_split``, ``ssm.mamba2_block_split``,
``layers.attention_split``'s encoder and cross-attention,
``transformer.rwkv_forward_split`` / ``hybrid_forward_split``,
``encdec.encdec_forward_split``, ``build_model(cfg, mesh)`` on placed
params) against the reference's GSPMD program on the same mesh.

One subprocess forces eight host devices before importing JAX, places
the smoke configs' params by the reference's ``param_shardings`` on the
meshes below and writes its loss, prefill and one greedy decode step
(and on Zamba2's (2, 2) the gradients and one AdamW step), each case and
mesh one jitted program; the port runs the same params and inputs on
``["cpu"] * 4``. The prompts are 20 tokens, so the chunked scans run two
chunks of 16.

* float32: the loss, the logits, the gradients and the stepped params
  within 1e-5 of max |ref|. RWKV6 has 4 heads of 16 (they divide every
  model axis here) and, cut to 2 heads of 32 on (1, 4), heads that do
  not divide it (each rank's 16 columns are half a head: r, k and v are
  gathered and every rank runs both heads). Zamba2 runs 4 layers, so its
  shared block serves two applications and its gradient sums over them;
  its Mamba2 ``w_in`` has 296 columns (74 or 148 a rank), so every
  rank's shard crosses the ``xin | z | B | C | dt`` boundaries (at 128,
  256, 272 and 288) and the projection is gathered. Its 8 Mamba2 heads
  of 16 divide every model axis; cut to 2 heads of 64 on (1, 4) they do
  not (``w_in``'s 290 columns do not divide either and stay whole).
  SeamlessM4T runs its non-causal encoder and the decoder's
  cross-attention split;
* placement: on the split path no :class:`dist.sharding.Sharded` leaf is
  gathered (``Sharded.full`` raises) and ``model._mesh_params`` is not
  reached; each position's cache holds its data rank's rows, and the
  split cache is the whole-batch run's;
* counts: on a (2, 2) mesh of ``meta`` positions the op count's
  per-position FLOPs and argument bytes are within 1.2x of each other,
  and the model-axis sums and the state and K/V gathers are booked per
  layer.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduce_for_smoke
from repro_torch.dist import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.models import model as M
from repro_torch.models.model import build_model
from repro_torch.training import train_loop as TL
from repro_torch.training.optimizer import tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, S, MAX_LEN = 4, 20, 24
# name: (arch, config overrides (ssm fields under "ssm"), meshes, what to
# run; "step": the gradients and one AdamW step, on the first mesh)
CASES = {
    "rwkv6": ("rwkv6-3b", {}, [(2, 2), (1, 4)], ("loss", "serve")),
    "rwkv6 2 heads": ("rwkv6-3b", {"ssm": {"head_dim": 32}}, [(1, 4)],
                      ("loss", "serve")),
    "zamba2": ("zamba2-7b", {"num_layers": 4}, [(2, 2), (4, 1), (1, 4)],
               ("loss", "serve", "step")),
    "zamba2 2 heads": ("zamba2-7b", {"ssm": {"head_dim": 64}}, [(1, 4)],
                       ("loss", "serve")),
    "seamless": ("seamless-m4t-medium", {}, [(2, 2)], ("loss", "serve")),
}

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduce_for_smoke
from repro.dist import sharding as SH
from repro.launch.mesh import make_test_mesh, use_mesh
from repro.models.model import build_model
from repro.training.train_loop import TrainConfig, init_train_state, \
    make_train_step

CASES = %(cases)r
B, S, MAX_LEN = %(b)d, %(s)d, %(max_len)d
out = {}


def flat(tree):
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


for name, (arch, over, shapes, what) in CASES.items():
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    over = dict(over)
    if "ssm" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
    cfg = cfg.replace(**over)
    params = build_model(cfg).init(jax.random.key(0))
    for k, v in flat(params).items():
        out[f"{name}/p0/{k}"] = np.asarray(v)
    rng = np.random.default_rng(1)
    tok = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    if cfg.family == "encdec":
        batch["src"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    for k, v in batch.items():
        out[f"{name}/batch/{k}"] = v
    for shape in shapes:
        mesh = make_test_mesh(shape)
        model = build_model(cfg, mesh)
        tag = f"{name}/{shape[0]}x{shape[1]}"

        def run(sp, jb, state=None):
            # everything this case holds the port to, in one program
            res = {"loss": model.loss_fn(sp, jb)[0]}
            if state is not None:
                (res["loss"], _), res["g"] = jax.value_and_grad(
                    model.loss_fn, has_aux=True)(sp, jb)
                res["p1"], _, _ = make_train_step(
                    model.loss_fn, TrainConfig())(sp, state, jb)
            pin = {k: v for k, v in jb.items() if k != "labels"}
            lg, cache = model.prefill(sp, pin, model.init_cache(B, MAX_LEN))
            cur = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
            lg2, cache = model.decode_step(sp, cache, cur,
                                           jnp.full((B,), S, jnp.int32))
            res["logits"] = jnp.stack([lg, lg2]).astype(jnp.float32)
            res["feed"] = cur
            return res

        with use_mesh(mesh):
            sp = jax.tree_util.tree_map(
                jax.device_put, params, SH.param_shardings(cfg, mesh, params))
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            state = init_train_state(sp, TrainConfig()) \
                if "step" in what and shape == shapes[0] else None
            res = jax.jit(run)(sp, jb, state)
        for key, v in res.items():
            if isinstance(v, dict):
                for k, leaf in flat(v).items():
                    out[f"{tag}/{key}/{k}"] = np.asarray(leaf)
            else:
                out[f"{tag}/{key}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ssm_split")
    script = _SCRIPT % {"cases": CASES, "b": B, "s": S, "max_len": MAX_LEN}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, str(tmp / "ref.npz")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert "OK" in r.stdout, r.stdout + r.stderr
    return dict(np.load(tmp / "ref.npz"))


def _config(name):
    import dataclasses
    arch, over, _, _ = CASES[name]
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    over = dict(over)
    if "ssm" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
    return cfg.replace(**over)


def _tree(ref, prefix):
    out = {}
    for key, v in ref.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return out


def _close(got, want, what):
    want = torch.as_tensor(want).to(torch.float32)
    bar = 1e-5 * max(float(want.abs().max()), 1e-30)
    err = float((torch.as_tensor(got).to(torch.float32) - want).abs().max())
    assert err <= bar, f"{what}: {err:.3e} > {bar:.3e}"


def _setup(ref, name, shape):
    cfg = _config(name)
    mesh = make_test_mesh(shape, devices=["cpu"] * 4)
    params = _tree(ref, f"{name}/p0/")
    sp = SH.shard_tree(params, SH.param_shardings(cfg, mesh, params))
    batch = {k: v.long() if k != "src" else v
             for k, v in _tree(ref, f"{name}/batch/").items()}
    return cfg, mesh, params, sp, batch


@pytest.fixture
def no_gather(monkeypatch):
    """Fail any gather of a sharded leaf, and the whole-batch forwards'
    param gather, while the split path runs."""
    def refuse(*a, **k):
        raise AssertionError("a sharded leaf was gathered")

    def arm(on: bool):
        if on:
            monkeypatch.setattr(SH.Sharded, "full", refuse)
            monkeypatch.setattr(M, "_mesh_params", refuse)
        else:
            monkeypatch.undo()
    return arm


def _serve(model, params, batch, feed, device=None):
    """Prefill and one decode step fed ``feed``: (the two logits, the
    cache)."""
    cache = model.init_cache(B, MAX_LEN, device=device)
    pin = {k: v for k, v in batch.items() if k != "labels"}
    lg, cache = model.prefill(params, pin, cache)
    lg2, cache = model.decode_step(params, cache, feed, torch.full((B,), S))
    return [lg, lg2], cache


def _batch_dim(leaf):
    """The dim of a cache leaf that the data axis splits."""
    return next(i for i, e in enumerate(leaf.spec) if e is not None)


FORWARD = [(n, m) for n, c in CASES.items() for m in c[2]]


@pytest.mark.parametrize("name,shape", FORWARD,
                         ids=[f"{n} {m[0]}x{m[1]}" for n, m in FORWARD])
def test_forward_like_the_reference(reference, no_gather, name, shape):
    ref = reference
    cfg, mesh, params, sp, batch = _setup(ref, name, shape)
    assert SH.splits_dense(cfg, mesh) and SH.splits_dense(cfg, mesh, True)
    model = build_model(cfg, mesh)
    tag = f"{name}/{shape[0]}x{shape[1]}"
    feed = torch.from_numpy(ref[f"{tag}/feed"]).long()
    no_gather(True)
    loss, _ = model.loss_fn(sp, batch)
    logits, cache = _serve(model, sp, batch, feed)
    no_gather(False)
    _close(loss, ref[f"{tag}/loss"], "loss")
    assert all(isinstance(lg, SH.Sharded) for lg in logits)
    _close(torch.stack([lg.full() for lg in logits]),
           ref[f"{tag}/logits"], "logits")
    # each position holds its data rank's rows of every cache leaf, and
    # together they are the whole-batch run's cache
    _, want = _serve(build_model(cfg), params, batch, feed, device="cpu")
    n_dp = mesh.shape[0]
    for path, leaf in tree_leaves(cache):
        assert isinstance(leaf, SH.Sharded), path
        dim = _batch_dim(leaf)
        assert leaf.shape[dim] == B, path
        for shard in leaf.shards:
            assert shard.shape[dim] == B // n_dp, path
        whole = dict(tree_leaves(want))[path]
        if whole.dtype == torch.int32:
            assert torch.equal(leaf.full(), whole), path
        else:
            _close(leaf.full(), whole, f"cache {'/'.join(path)}")


def test_one_training_step_like_the_reference(reference, no_gather):
    ref = reference
    name, shape = "zamba2", (2, 2)
    tag = f"{name}/2x2"
    cfg, mesh, _, sp, batch = _setup(ref, name, shape)
    model = build_model(cfg, mesh)
    no_gather(True)
    loss, _, grads = TL.value_and_grad(model.loss_fn, sp, batch)
    no_gather(False)
    _close(loss, ref[f"{tag}/loss"], "loss")
    want = dict(tree_leaves(_tree(ref, f"{tag}/g/")))
    got = dict(tree_leaves(grads))
    assert set(got) == set(want)
    for path, g in got.items():
        _close(g.full(), want[path], f"grad {path}")
    tcfg = TL.TrainConfig()
    state = TL.init_train_state(sp, tcfg)
    sp, state, _ = TL.make_train_step(model.loss_fn, tcfg)(sp, state, batch)
    want = dict(tree_leaves(_tree(ref, f"{tag}/p1/")))
    for path, p in tree_leaves(sp):
        for _, group in p.layout.groups:      # replicas stay equal
            for q in group[1:]:
                assert torch.equal(p.shards[q], p.shards[group[0]]), path
        _close(p.full(), want[path], f"param {path}")


# per family, (all-reduces, all-gathers, reduce-scatters) of one split
# decode step on (2, 2) at smoke size, from its layers: the embedding's
# sum, then per RWKV layer the time mix's w_o sum and state gather and
# the channel mix's reduce-scatter and gather; per Mamba2 layer the
# projection's gather, the norm's and w_out's sums and the state gather,
# per shared-attention application (two in 4 layers) attention's and the
# MLP's sums and the K and V gathers; per enc-dec decoder layer
# self- and cross-attention's sums and K/V gathers and the MLP's sum
COUNTED = {
    "rwkv6-3b": (2, lambda n: (n + 1, 2 * n, n)),
    "zamba2-7b": (4, lambda n: (1 + 2 * n + 2 * 2, 2 * n + 2 * 2, 0)),
    "seamless-m4t-medium": (2, lambda n: (1 + 3 * n, 4 * n, 0)),
}


@pytest.mark.parametrize("arch", list(COUNTED))
def test_meta_counts_are_balanced(arch):
    layers, expect = COUNTED[arch]
    cfg = reduce_for_smoke(get_config(arch)).replace(num_layers=layers)
    mesh = make_test_mesh((2, 2), devices=["meta"] * 4)
    shape = ShapeConfig("decode", 32, 4, "decode")
    with use_mesh(mesh):
        step, args = D.build_cell(cfg, shape, mesh)
        c, _ = D.count_step(step, args, 4)
    flops = c.cost_summary()["per_position"]["flops"]
    assert min(flops) > 0 and max(flops) <= 1.2 * min(flops), flops
    assert max(c.args) <= 1.2 * min(c.args), c.args
    coll = c.collective_summary()
    n_ar, n_ag, n_rs = expect(layers)
    assert coll["all-reduce_count"] == n_ar, coll
    assert coll["all-gather_count"] == n_ag, coll
    assert coll.get("reduce-scatter_count", 0) == n_rs, coll
    assert coll.get("scatter_count", 0) == 0, coll   # inputs placed per rank
