"""The decoders' dense compute split over (data, model) meshes
(``dist.sharding.Split``, ``layers.*_split``, ``transformer.
decoder_forward_split``, ``build_model(cfg, mesh)`` on placed params)
against the reference's GSPMD program on the same mesh.

One subprocess forces eight host devices before importing JAX, places
the smoke configs' params by the reference's ``param_shardings`` on
(2, 2), (4, 1) and (1, 4) meshes and writes its loss, prefill and one
greedy decode step (and on (2, 2) the gradients and one AdamW step),
each case and mesh one jitted program;
the port runs the same params and inputs on ``["cpu"] * 4``:

* float32: the loss, the logits, the gradients and the stepped params
  within 1e-5 of max |ref| (Mixtral's MoE, Qwen3's qk-norm, PaliGemma's
  vision frontend, and a SmolLM cut to 3 heads, whose heads do not
  divide the model axis: its query blocks split instead);
* bfloat16 (Mixtral): greedy ids and the routed experts of every layer
  equal to the reference's, the logits within 2**-6 of max |ref|;
* placement: on the split path no :class:`dist.sharding.Sharded` leaf is
  gathered (``Sharded.full`` raises), each position's cache holds its
  data rank's rows, and the logits come back as per-position shards;
* refusals: on such a mesh unplaced params and a plain cache raise; the
  slot, paged and speculative serving hooks run split there;
* counts: on a (2, 2) mesh of ``meta`` positions the op count's
  per-position FLOPs and argument bytes are within 1.2x of each other,
  and the model-axis all-reduces (attention, MoE, embedding) and the K/V
  all-gathers are booked per layer;
* ``init_kv_cache`` against the reference's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduce_for_smoke
from repro_torch.core import mixed_moe
from repro_torch.dist import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh, use_mesh
from repro_torch.models.model import build_model, init_kv_cache
from repro_torch.training import train_loop as TL
from repro_torch.training.optimizer import tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, S, STEPS = 4, 8, 1
# name: (arch, dtype, (heads, kv heads) or None, meshes, what to run;
# "step": the gradients and one AdamW step, on the first mesh)
CASES = {
    "mixtral f32": ("mixtral-8x7b", "float32", None,
                    [(2, 2), (4, 1), (1, 4)], ("loss", "serve", "step")),
    "mixtral bf16": ("mixtral-8x7b", "bfloat16", None,
                     [(2, 2), (4, 1), (1, 4)], ("serve", "routes")),
    "qwen3 f32": ("qwen3-8b", "float32", None, [(1, 4)], ("loss", "serve")),
    "paligemma f32": ("paligemma-3b", "float32", None, [(2, 2)],
                      ("loss", "serve")),
    "smollm 3 heads f32": ("smollm-360m", "float32", (3, 1), [(2, 2)],
                           ("loss", "serve")),
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
B, S, STEPS = %(b)d, %(s)d, %(steps)d
out = {}


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def flat(tree):
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


for name, (arch, dtype, heads, shapes, what) in CASES.items():
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype=dtype)
    if heads:
        cfg = cfg.replace(attention=dataclasses.replace(
            cfg.attention, num_heads=heads[0], num_kv_heads=heads[1]))
    params = build_model(cfg).init(jax.random.key(0))
    for k, v in flat(params).items():
        out[f"{name}/p0/{k}"] = bits(v)
    rng = np.random.default_rng(1)
    tok = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    front = cfg.frontend_len if cfg.frontend == "vision" else 0
    if front:
        batch["frontend"] = rng.standard_normal(
            (B, front, cfg.d_model)).astype(np.float32)
    for k, v in batch.items():
        out[f"{name}/batch/{k}"] = v
    for shape in shapes:
        mesh = make_test_mesh(shape)
        model = build_model(cfg, mesh)
        tag = f"{name}/{shape[0]}x{shape[1]}"

        def run(sp, jb, state=None):
            # everything this case holds the port to, in one program
            res = {}
            if "loss" in what:
                res["loss"] = model.loss_fn(sp, jb)[0]
            if state is not None:
                (res["loss"], _), res["g"] = jax.value_and_grad(
                    model.loss_fn, has_aux=True)(sp, jb)
                res["p1"], _, _ = make_train_step(
                    model.loss_fn, TrainConfig())(sp, state, jb)
            if "serve" not in what:
                return res
            pin = {k: v for k, v in jb.items() if k != "labels"}
            lg, cache = model.prefill(sp, pin, model.init_cache(B, 24))
            logits, feed, routes = [lg], [], []
            for i in range(STEPS):
                cur = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
                feed.append(cur)
                pos = jnp.full((B,), S + front + i, jnp.int32)
                if "routes" in what:
                    lg, cache, ids = model.decode_step_routed(sp, cache, cur,
                                                              pos)
                    routes.append(ids)
                else:
                    lg, cache = model.decode_step(sp, cache, cur, pos)
                logits.append(lg)
            res["logits"] = jnp.stack(logits).astype(jnp.float32)
            res["feed"] = jnp.stack(feed)
            if routes:
                res["routes"] = jnp.stack(routes)
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
                    out[f"{tag}/{key}/{k}"] = bits(leaf)
            else:
                out[f"{tag}/{key}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dense_split")
    script = _SCRIPT % {"cases": CASES, "b": B, "s": S, "steps": STEPS}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, str(tmp / "ref.npz")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert "OK" in r.stdout, r.stdout + r.stderr
    return dict(np.load(tmp / "ref.npz"))


def _config(name):
    arch, dtype, heads, _, _ = CASES[name]
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype=dtype)
    if heads:
        import dataclasses
        cfg = cfg.replace(attention=dataclasses.replace(
            cfg.attention, num_heads=heads[0], num_kv_heads=heads[1]))
    return cfg


def _tree(ref, prefix, bf16):
    out = {}
    for key, v in ref.items():
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


def _close(got, want, what):
    want = torch.as_tensor(want).to(torch.float32)
    bar = 1e-5 * max(float(want.abs().max()), 1e-30)
    err = float((torch.as_tensor(got).to(torch.float32) - want).abs().max())
    assert err <= bar, f"{what}: {err:.3e} > {bar:.3e}"


def _whole(x):
    return x.full() if isinstance(x, SH.Sharded) else x


def _setup(ref, name, shape):
    cfg = _config(name)
    mesh = make_test_mesh(shape, devices=["cpu"] * 4)
    params = _tree(ref, f"{name}/p0/", cfg.dtype == "bfloat16")
    sp = SH.shard_tree(params, SH.param_shardings(cfg, mesh, params))
    batch = {k: torch.from_numpy(np.array(v)).long() if k != "frontend"
             else torch.from_numpy(np.array(v))
             for k, v in _tree(ref, f"{name}/batch/", False).items()}
    return cfg, mesh, sp, batch


@pytest.fixture
def no_gather(monkeypatch):
    """Fail any gather of a sharded leaf while the split path runs."""
    def refuse(*a, **k):
        raise AssertionError("a sharded leaf was gathered")

    def arm(on: bool):
        if on:
            monkeypatch.setattr(SH.Sharded, "full", refuse)
        else:
            monkeypatch.undo()
    return arm


def _serve(model, sp, batch, feed, front, routes=False):
    """Prefill and the reference's greedy tokens through decode_step:
    (the logits stacked, the per-position route ids captured)."""
    cache = model.init_cache(B, 24, device="cpu")
    pin = {k: v for k, v in batch.items() if k != "labels"}
    with mixed_moe.capture_routing() as ids:
        lg, cache = model.prefill(sp, pin, cache)
        n_prefill = len(ids)
        out = [lg]
        for i in range(STEPS):
            lg, cache = model.decode_step(
                sp, cache, torch.from_numpy(feed[i]).long(),
                torch.full((B,), S + front + i))
            out.append(lg)
    return out, cache, ids[n_prefill:]


SERVE = [(n, m) for n, c in CASES.items() for m in c[3] if "serve" in c[4]]


@pytest.mark.parametrize("name,shape", SERVE,
                         ids=[f"{n} {m[0]}x{m[1]}" for n, m in SERVE])
def test_forward_like_the_reference(reference, no_gather, name, shape):
    ref = reference
    cfg, mesh, sp, batch = _setup(ref, name, shape)
    model = build_model(cfg, mesh)
    tag = f"{name}/{shape[0]}x{shape[1]}"
    split = SH.splits_dense(cfg, mesh)
    front = cfg.frontend_len if cfg.frontend == "vision" else 0
    no_gather(split)
    if f"{tag}/loss" in ref:
        loss, _ = model.loss_fn(sp, batch)
        _close(loss, ref[f"{tag}/loss"], "loss")
    logits, cache, ids = _serve(model, sp, batch, ref[f"{tag}/feed"], front)
    no_gather(False)
    assert all(isinstance(lg, SH.Sharded) == split for lg in logits)
    got = torch.stack([_whole(lg) for lg in logits]).float()
    want = torch.from_numpy(ref[f"{tag}/logits"])
    if cfg.dtype == "float32":
        _close(got, want, "logits")
    else:
        assert torch.equal(got[:STEPS].argmax(-1)[..., None],
                           torch.from_numpy(ref[f"{tag}/feed"]).long())
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        # 2**-6, not the 2**-7 that tests/test_torch_ep.py holds one MoE
        # layer to: over the whole model the port's bf16 rounding is
        # 0.0067-0.0092 of max |ref| from the reference on these meshes
        # on ONE device already (0.0081-0.0092 split)
        err = float((got - want).abs().max())
        assert err <= 2 ** -6 * float(want.abs().max()), \
            (err, float(want.abs().max()))
    if split:                 # each position's cache: its data rank's rows
        n_dp = mesh.shape[0]
        for leaf in cache.values():
            assert isinstance(leaf, SH.Sharded)
            for shard in leaf.shards:
                assert shard.shape[1] == B // n_dp
    if f"{tag}/routes" in ref:
        want = ref[f"{tag}/routes"]           # (steps, L, B, k)
        L = cfg.num_layers
        per_call = len(ids) // (STEPS * L)
        for i in range(STEPS):
            for li in range(L):
                calls = ids[(i * L + li) * per_call:(i * L + li + 1)
                            * per_call]
                if split:                     # the data ranks' leads
                    sp_ = SH.split_of(mesh, ("data",))
                    calls = [calls[p] for p in sp_.lead]
                got_ids = np.sort(np.concatenate(calls), -1)
                assert (got_ids == np.sort(want[i, li], -1)).all(), (i, li)


def test_one_training_step_like_the_reference(reference, no_gather):
    ref = reference
    name, shape = "mixtral f32", (2, 2)
    tag = f"{name}/2x2"
    cfg, mesh, sp, batch = _setup(ref, name, shape)
    model = build_model(cfg, mesh)
    no_gather(True)
    loss, _, grads = TL.value_and_grad(model.loss_fn, sp, batch)
    no_gather(False)
    _close(loss, ref[f"{tag}/loss"], "loss")
    want = dict(tree_leaves(_tree(ref, f"{tag}/g/", False)))
    for path, g in tree_leaves(grads):
        _close(g.full(), want[path], f"grad {path}")
    tcfg = TL.TrainConfig()
    state = TL.init_train_state(sp, tcfg)
    sp, state, _ = TL.make_train_step(model.loss_fn, tcfg)(sp, state, batch)
    want = dict(tree_leaves(_tree(ref, f"{tag}/p1/", False)))
    for path, p in tree_leaves(sp):
        for _, group in p.layout.groups:      # replicas stay equal
            for q in group[1:]:
                assert torch.equal(p.shards[q], p.shards[group[0]]), path
        _close(p.full(), want[path], f"param {path}")


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_meta_counts_are_balanced(kind):
    cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    mesh = make_test_mesh((2, 2), devices=["meta"] * 4)
    shape = ShapeConfig(kind, 32, 4, kind)
    with use_mesh(mesh):
        step, args = D.build_cell(cfg, shape, mesh)
        c, _ = D.count_step(step, args, 4)
    flops = c.cost_summary()["per_position"]["flops"]
    assert min(flops) > 0 and max(flops) <= 1.2 * min(flops), flops
    assert max(c.args) <= 1.2 * min(c.args), c.args
    coll = c.collective_summary()
    L = cfg.num_layers
    # attention's and the MoE's closing sums per layer, the embedding's
    assert coll["all-reduce_count"] == 2 * L + 1, coll
    # K and V per layer (a KV head per two model ranks), the token
    # gather of the MoE's regime per layer (x and weights)
    assert coll["all-gather_count"] >= 2 * L, coll
    assert coll["scatter_count"] == 0, coll      # inputs placed per rank


def test_whole_paths_refuse_a_splitting_mesh():
    """On a mesh that splits the dense compute, unplaced params and a
    plain cache raise instead of running whole; the pure-EP (1, 4)
    serving mesh keeps the whole-batch hooks."""
    from repro_torch.models.model import init_cache, init_params
    cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    params = init_params(cfg, 0, device="cpu")
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    model = build_model(cfg, mesh)
    tok = torch.ones((4, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="not placed on the mesh"):
        model.prefill(params, {"tokens": tok}, model.init_cache(4, 24))
    sp = SH.shard_tree(params, SH.param_shardings(cfg, mesh, params))
    with pytest.raises(ValueError, match="make it with Model.init_cache"):
        model.decode_step_routed(sp, init_cache(cfg, 4, 24, device="cpu"),
                                 tok[:, :1], torch.full((4,), 8))
    ep = build_model(cfg, make_test_mesh((1, 4), devices=["cpu"] * 4))
    pool, meta = ep.init_paged_cache(2, 24, page_size=8, device="cpu")
    assert pool["k"].shape[0] == cfg.num_layers
    assert not isinstance(pool["k"], SH.Sharded) and meta.data_ranks == 1


HOOKS = ("prefill_into_slot", "decode_step_routed", "init_paged_cache",
         "paged_decode_step_routed", "spec_step_routed", "reset_slot")


@pytest.mark.parametrize("hook", HOOKS)
def test_serving_hook_runs_split(no_gather, hook):
    """Each serving hook runs split on a (2, 2) mesh: each position
    computes and writes only its data rank's slot rows or pages, and the
    logits and route ids come back as shards (the engine over such a
    mesh: ``tests/test_torch_engine_split.py``)."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.paged_kv import PageAllocator
    cfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(
        dtype="float32")
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    params = init_params(cfg, 0, device="cpu")
    sp = SH.shard_tree(params, SH.param_shardings(cfg, mesh, params))
    model = build_model(cfg, mesh)
    split = SH.split_of(mesh, ("data",))
    cache = model.init_cache(4, 24)
    tok = torch.arange(1, 5)[:, None]
    pos = torch.tensor([3, -1, 5, 2])
    no_gather(True)
    if hook in ("prefill_into_slot", "reset_slot"):
        t = torch.arange(1, 9)[None]
        q = torch.arange(8)[None].masked_fill(torch.arange(8)[None] > 5, -1)
        lg, cache = model.prefill_into_slot(sp, cache, t, q, 3, 5)
        assert isinstance(lg, SH.Sharded) and lg.shape == (1,
                                                           cfg.padded_vocab)
        if hook == "reset_slot":
            cache = model.reset_slot(cache, 3)
        for p in range(split.n):           # slot 3 is data rank 1's row 1
            tags = cache["pos"].shards[p]
            live = bool((tags[:, 1] >= 0).any())
            assert live == (split.dp[p] == 1 and hook != "reset_slot")
            assert not (tags[:, 0] >= 0).any()
    elif hook == "init_paged_cache":
        pool, meta = model.init_paged_cache(4, 24, page_size=8)
        assert meta.data_ranks == 2 and meta.num_pages == 2 * (2 * 3 + 1)
        for leaf in pool.values():
            assert isinstance(leaf, SH.Sharded)
            assert [s.shape[1] for s in leaf.shards] == [7] * 4
    elif hook == "spec_step_routed":
        toks = torch.cat([tok, tok + 1], 1)
        poss = torch.where(pos[:, None] >= 0, pos[:, None] + torch.arange(2),
                           -1)
        lg, cache, ids = model.spec_step_routed(sp, cache, toks, poss)
        assert lg.shape == (4, 2, cfg.padded_vocab)
        assert ids.shape == (cfg.num_layers, 8, cfg.moe.top_k)
        assert all(s.shape[1] == 4 for s in ids.shards)
    else:
        lg, cache, ids = model.decode_step_routed(sp, cache, tok, pos)
        assert isinstance(lg, SH.Sharded) and isinstance(ids, SH.Sharded)
        assert ids.shape == (cfg.num_layers, 4, cfg.moe.top_k)
        if hook == "paged_decode_step_routed":
            pool, meta = model.init_paged_cache(4, 24, page_size=8)
            al = PageAllocator(4, meta.chunks_per_slot, meta.num_pages, 8,
                               meta.data_ranks)
            for slot, p in enumerate(pos.tolist()):
                if p >= 0:
                    al.ensure_index(slot, p)
            lg2, pool, ids2 = model.paged_decode_step_routed(
                sp, pool, model.page_table(al.table, "cpu", meta=meta), tok,
                pos, window=meta.window)
            no_gather(False)
            live = pos >= 0
            assert torch.equal(lg.full()[live], lg2.full()[live])
            assert torch.equal(ids.full(), ids2.full())
    no_gather(False)


def test_init_kv_cache_like_the_reference():
    from repro.models.layers import init_kv_cache as jinit
    import jax.numpy as jnp
    want = jinit(3, 5, 2, 4, jnp.bfloat16)
    got = init_kv_cache(3, 5, 2, 4, torch.bfloat16, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert np.array_equal(got[k].float().numpy(),
                              np.asarray(want[k]).astype(np.float32)), k
    assert (got["pos"] == -1).all()
