"""The adaptive engine over (data, model) meshes that split the dense
compute (``build_engine(..., mesh=)`` with ``dist.sharding.splits_dense``):
the split slot, paged, overlap and speculative hooks of ``build_model``,
the page pool placed per data rank, and the engine serving from split
logits and route ids.

One subprocess forces four host devices before importing JAX, builds
the reference's ``AdaptiveServingEngine`` on ``jax.sharding.Mesh`` of
shape (2, 2) and (4, 1) with ``EngineConfig(ep=<model size>)`` and
writes its greedy tokens for the paged default, float32 and bfloat16,
across a mid-run ``configure`` that moves experts between rungs. The
port serves the same params (``params_from_numpy``) on ``["cpu"] * 4``:

* its tokens equal the reference's on the same mesh in float32 for the
  paged, slot, overlap and ``speculate=2`` (paged and slot) engines, and
  in bfloat16 for the paged one (the reference's own configs give its
  paged tokens, which its tests hold);
* through the hooks, paged and slot prefill and decode, the overlap
  pipeline's per-layer decode and a speculative verify's columns give
  bit-equal logits and route ids;
* placement: serving never gathers a cache or pool leaf (in the float32
  runs above), each position's pool holds its data rank's page range
  (the pool's pages over the data ranks) and only its slots' pages are
  written there, and a sub-worst-case pool caps admission per data rank;
* unplaced params, a plain cache or pool and a pool that does not split
  over the data ranks raise.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.precision_plan import balanced_ladder_plan
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import (apply_precision_plan, build_model,
                                      init_params, params_from_numpy)
from repro_torch.serving.api import EngineConfig, build_engine
from repro_torch.serving.near_ties import EngineRecorder, hold_tokens

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
HW = dict(host_link_bw=24e9)
SLOTS, MAX_LEN = 4, 24
MESHES = [(2, 2), (4, 1)]
DTYPES = ["float32", "bfloat16"]

_SCRIPT = r"""
import os, sys, warnings
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax, numpy as np
from repro.configs import get_config, reduce_for_smoke
from repro.core.cost_model import HardwareModel
from repro.models.model import build_model
from repro.serving.api import EngineConfig
from repro.serving import engine as RE
from repro.serving.engine import AdaptiveServingEngine

SLOTS, MAX_LEN, MESHES, DTYPES, HW = %(slots)d, %(max_len)d, %(meshes)r, \
    %(dtypes)r, %(hw)r
out = {}


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# each sampled row's logits (f32, the vocabulary's columns) as
# <tag>/row/<request id>/<token index>
def record(eng, tag, vocab):
    prefill, sample, now = eng._prefill_slot, RE.sample, {}

    def pre(slot, req, temperature):
        now["prefill"] = req
        try:
            return prefill(slot, req, temperature)
        finally:
            now.pop("prefill")

    def samp(logits, **kw):
        lg = np.asarray(logits).astype(np.float32)
        reqs = {0: now["prefill"]} if "prefill" in now else {
            i: st.req for i, st in eng.scheduler.active()}
        for r, req in reqs.items():
            out[f"{tag}/row/{req.rid}/{len(req.out_tokens)}"] = \
                lg[r, :vocab]
        return sample(logits, **kw)
    eng._prefill_slot = pre
    RE.sample = samp


def configure(eng, nq):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        full = eng.planner.size_ne \
            + eng.planner.num_experts_total * eng.planner.size_e16
        eng.configure(full, "quality", nq)


for dtype in DTYPES:
    cfg = reduce_for_smoke(get_config("mixtral-8x7b")).replace(dtype=dtype)
    params = build_model(cfg).init(jax.random.key(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        out[dtype + "/p/" + "/".join(str(p.key) for p in path)] = bits(leaf)
    sample = RE.sample
    # bfloat16 also serves on one device: its tokens witness that the
    # reference's own meshes part from it at near-ties
    for shape in MESHES + ([(1, 1)] if dtype == "bfloat16" else []):
        mesh = None if shape == (1, 1) else jax.sharding.Mesh(
            np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
        eng = AdaptiveServingEngine(cfg, params, mesh=mesh, config=EngineConfig(
            max_slots=SLOTS, max_len=MAX_LEN, hw=HardwareModel(**HW),
            ep=shape[1]))
        tag = f"{dtype}/{shape[0]}x{shape[1]}"
        if dtype == "bfloat16":
            record(eng, tag, cfg.vocab_size)
        configure(eng, 4 * cfg.num_layers)
        rng = np.random.default_rng(0)
        rids = [eng.submit(rng.integers(1, cfg.vocab_size, 6 + i),
                           max_new_tokens=4) for i in range(3)]
        eng.step(temperature=0.0)
        configure(eng, 8 * cfg.num_layers)
        rids += [eng.submit(rng.integers(1, cfg.vocab_size, 5),
                            max_new_tokens=5) for _ in range(5)]
        eng.step(temperature=0.0)
        for i, r in enumerate(rids):
            out[f"{tag}/{i}"] = np.asarray(eng.result(r).tokens)
        eng.close()
        RE.sample = sample
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module so the
    port-only tests run while it works; ``reference`` waits for it."""
    path = tmp_path_factory.mktemp("engine_split") / "ref.npz"
    script = _SCRIPT % {"slots": SLOTS, "max_len": MAX_LEN,
                        "meshes": MESHES, "dtypes": DTYPES, "hw": HW}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", script, str(path)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True, scope="module")
def _start_reference(reference_run):
    """Start the reference's subprocess with the module, and run the
    module's smoke-size engines on one intra-op thread: their ops are
    tiny, and beside other test processes the default thread pool's
    threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield reference_run
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, path = reference_run
    stdout, stderr = proc.communicate(timeout=600)
    assert "OK" in stdout, stdout + stderr[-4000:]
    return dict(np.load(path))


def _config(dtype="float32"):
    return reduce_for_smoke(get_config("mixtral-8x7b")).replace(dtype=dtype)


def _cpus(shape):
    return make_test_mesh(shape, devices=["cpu"] * 4)


def _configure(eng, num_q):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        full = eng.planner.size_ne \
            + eng.planner.num_experts_total * eng.planner.size_e16
        return eng.configure(full, "quality", num_q)


def _serve(cfg, params, mesh, hook=None, **extra):
    """The reference script's traffic: 3 requests, a replan that drops
    every expert to int4, 5 more (queued behind the 4 slots). ``hook``
    sees the engine before it serves. Returns (the tokens, the engine)."""
    eng = build_engine(cfg, params, EngineConfig(
        max_slots=SLOTS, max_len=MAX_LEN, hw=HardwareModel(**HW), **extra),
        device="cpu", mesh=mesh)
    if hook is not None:
        hook(eng)
    _configure(eng, 4 * cfg.num_layers)
    before = eng.current_plan.bits.copy()
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(1, cfg.vocab_size, 6 + i),
                       max_new_tokens=4) for i in range(3)]
    eng.step(temperature=0.0)
    _configure(eng, 8 * cfg.num_layers)
    assert (eng.current_plan.bits != before).any()   # experts changed rung
    rids += [eng.submit(rng.integers(1, cfg.vocab_size, 5),
                        max_new_tokens=5) for _ in range(5)]
    eng.step(temperature=0.0)
    assert rids == list(range(1, len(rids) + 1))
    tokens = [eng.result(r).tokens for r in rids]
    eng.close()
    return tokens, eng


def _ref_params(ref, dtype):
    """The reference's params from the npz, through ``params_from_numpy``
    (bf16 leaves as ml_dtypes arrays, as ``jax.tree.map(np.asarray)``
    gives them)."""
    import ml_dtypes
    tree = {}
    prefix = f"{dtype}/p/"
    for key, v in ref.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v.view(ml_dtypes.bfloat16) \
            if dtype == "bfloat16" and v.dtype == np.uint16 else v
    return params_from_numpy(tree, "cpu")


# ---------------------------------------------------------------------------
# the port alone: the hooks' bits, placement, admission, refusals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def placed():
    """The smoke Mixtral's serve params placed on (2, 2) at a plan with
    every rung, and its split model."""
    cfg = _config("float32")
    mesh = _cpus((2, 2))
    params = init_params(cfg, 3, device="cpu")
    L, E = cfg.num_layers, cfg.moe.num_experts
    plan = balanced_ladder_plan(L, E, {4: 4 * L, 8: 2 * L},
                                ladder=(16, 8, 4),
                                group_size=cfg.mop.group_size)
    sp = apply_precision_plan(params, cfg, plan, mesh=mesh)
    return cfg, mesh, sp, build_model(cfg, mesh)


def _whole(x):
    return x.full() if isinstance(x, SH.Sharded) else x


def _eq(a, b):
    a, b = _whole(a), _whole(b)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_hooks_paged_slot_overlap_and_verify_bit_equal(placed):
    """Slot and paged prefill into both data ranks' slots, then decode
    through the whole step and the per-layer pipeline, and a speculative
    verify whose first column is that decode: equal bits throughout."""
    from repro_torch.serving.paged_kv import PageAllocator
    cfg, mesh, sp, m = placed
    rng = np.random.default_rng(1)
    cache = m.init_cache(SLOTS, MAX_LEN)
    pool, meta = m.init_paged_cache(SLOTS, MAX_LEN, page_size=8)
    al = PageAllocator(SLOTS, meta.chunks_per_slot, meta.num_pages, 8,
                       meta.data_ranks)
    window = meta.window
    toks = np.zeros((SLOTS, 1), np.int64)
    pos = np.full((SLOTS,), -1, np.int64)
    for slot, n in ((0, 5), (3, 7), (2, 6)):          # both data ranks
        t = np.zeros((1, 8), np.int64)
        q = np.full((1, 8), -1, np.int64)
        t[0, :n] = rng.integers(1, cfg.vocab_size, n)
        q[0, :n] = np.arange(n)
        a, cache = m.prefill_into_slot(sp, cache, torch.from_numpy(t),
                                       torch.from_numpy(q), slot, n - 1)
        al.ensure_prefix(slot, n)
        b, pool = m.paged_prefill_into_slot(
            sp, pool, m.page_table(al.table, "cpu", meta=meta, slot=slot),
            torch.from_numpy(t), torch.from_numpy(q), n - 1, window=window)
        assert isinstance(a, SH.Sharded) and _eq(a, b)
        toks[slot, 0] = int(_whole(a).argmax())
        pos[slot] = n
        al.ensure_index(slot, n % window)
        al.ensure_index(slot, (n + 1) % window)
    tk, ps = torch.from_numpy(toks), torch.from_numpy(pos)
    # the verify's first column is this decode; its other columns drafts
    vt = torch.cat([tk, tk.roll(1, 0), tk.roll(2, 0)], 1)
    vp = torch.where(ps[:, None] >= 0, ps[:, None] + torch.arange(3), -1)
    spec_cache = {k: SH.Sharded(v.placement, v.shape,
                                [s.clone() for s in v.shards])
                  for k, v in cache.items()}
    lg, cache, ids = m.decode_step_routed(sp, cache, tk, ps)
    lg2, pool, ids2 = m.paged_decode_step_routed(
        sp, pool, m.page_table(al.table, "cpu", meta=meta), tk, ps,
        window=window)
    assert _eq(lg, lg2) and _eq(ids, ids2)
    assert isinstance(ids, SH.Sharded) and \
        tuple(ids.shape) == (cfg.num_layers, SLOTS, cfg.moe.top_k)
    # the overlap pipeline's per-layer hooks, one step on: a slot cache
    # and the pool, both at the same state
    tk2 = _whole(lg).argmax(-1)[:, None]
    whole = {k: SH.Sharded(v.placement, v.shape,
                           [s.clone() for s in v.shards])
             for k, v in cache.items()}
    step_lg, _, step_ids = m.decode_step_routed(sp, whole, tk2, ps + 1)
    outs = []
    for paged in (False, True):
        x = m.decode_embed(sp, tk2)
        layer_ids = []
        for li in range(cfg.num_layers):
            if paged:
                x, pool, i = m.paged_decode_layer_routed(
                    sp, pool, m.page_table(al.table, "cpu", meta=meta), x,
                    ps + 1, li, window=window)
            else:
                x, cache, i = m.decode_layer_routed(sp, cache, x, ps + 1,
                                                    li)
            layer_ids.append(_whole(i))
        outs.append((m.decode_logits(sp, x), torch.stack(layer_ids)))
    assert _eq(outs[0][0], outs[1][0]) and _eq(outs[0][1], outs[1][1])
    assert _eq(outs[0][0], step_lg) and _eq(outs[0][1], step_ids)
    vl, _, vids = m.spec_step_routed(sp, spec_cache, vt, vp)
    assert tuple(vl.shape) == (SLOTS, 3, cfg.padded_vocab)
    live = (ps >= 0).nonzero()[:, 0]          # an idle row's logits are
    assert _eq(_whole(vl)[live, 0], _whole(lg)[live])   # junk in both
    assert torch.equal(_whole(vids).reshape(cfg.num_layers, SLOTS, 3, -1)[
        :, live, 0], _whole(ids)[:, live])


def test_pool_is_placed_per_data_rank():
    cfg = _config()
    mesh = _cpus((2, 2))
    params = init_params(cfg, 0, device="cpu")
    eng = build_engine(cfg, params, EngineConfig(
        max_slots=SLOTS, max_len=MAX_LEN, hw=HardwareModel(**HW)),
        device="cpu", mesh=mesh)
    _configure(eng, 4 * cfg.num_layers)
    pool, meta, al = eng.kv_pool, eng.kv_meta, eng.kv_alloc
    split = SH.split_of(mesh, ("data",))
    per = meta.num_pages // 2
    assert meta.data_ranks == 2 and al.ranks == 2
    total = 0
    for leaf in pool.values():
        assert leaf.shape[1] == meta.num_pages
        total += leaf.shards[0].numel() * leaf.dtype.itemsize * 2
        for p, shard in enumerate(leaf.shards):
            assert shard.shape[1] == per and shard.device == mesh.devices[p]
    for p in range(split.n):                # the pool's bytes over d
        assert 2 * sum(v.shards[p].numel() * v.dtype.itemsize
                       for v in pool.values()) == total
    # slot 0 (data rank 0) in flight alone: rank 1's positions stay
    # untouched, rank 0's write only the pages its slot maps
    eng.submit(np.arange(1, 8), max_new_tokens=8)
    eng.run_iteration()
    eng.run_iteration()
    pages = al.table[0][al.table[0] > 0]
    assert len(pages) and ((pages > 0) & (pages < per)).all()
    for p in range(split.n):
        live = (pool["pos"].shards[p] >= 0).any(-1).any(0)   # local pages
        want = torch.zeros(per, dtype=torch.bool)
        if split.dp[p] == 0:
            want[torch.from_numpy(pages.astype(np.int64))] = True
        assert torch.equal(live, want), p
    # then every slot: each takes its own data rank's page range
    for _ in range(3):
        eng.submit(np.arange(1, 6), max_new_tokens=4)
    eng.run_iteration()
    for slot in range(SLOTS):
        r = slot // (SLOTS // 2)
        pages = al.table[slot][al.table[slot] > 0]
        assert len(pages) and ((pages > r * per)
                               & (pages < (r + 1) * per)).all(), slot
    eng.step()
    eng.close()


def test_admission_cap_holds_per_data_rank():
    """A sub-worst-case pool on (2, 2) caps each data rank's claims: every
    request finishes with the tokens of a worst-case pool's engine."""
    cfg = _config()
    params = init_params(cfg, 0, device="cpu")
    mesh = _cpus((2, 2))
    outs = {}
    for pages in (None, 10):            # 10: 5 a rank, 4 usable, 2 slots
        eng = build_engine(cfg, params, EngineConfig(
            max_slots=SLOTS, max_len=MAX_LEN, page_size=8,
            kv_pool_pages=pages, hw=HardwareModel(**HW)),
            device="cpu", mesh=mesh)
        _configure(eng, 4 * cfg.num_layers)
        if pages:
            assert eng.scheduler.cfg.max_group_tokens == (5 - 1 - 2) * 8
            assert eng.scheduler.cfg.max_active_tokens is None
            assert eng.metrics["kv_capacity_bytes"] == \
                8 * 8 * eng._kv_token_bytes
        rng = np.random.default_rng(2)
        rids = [eng.submit(rng.integers(1, cfg.vocab_size, 5),
                           max_new_tokens=5) for _ in range(6)]
        peak = 0
        while eng.has_work():
            eng.run_iteration()
            for r in range(2):
                claim = sum(s.req.token_claim for s in
                            eng.scheduler.slots[2 * r:2 * r + 2] if s)
                peak = max(peak, claim)
        outs[pages] = [eng.result(r).tokens for r in rids]
        if pages:
            assert peak <= 16
        eng.close()
    assert outs[None] == outs[10]


def test_split_serving_refuses_what_it_cannot_place(placed):
    cfg, mesh, sp, m = placed
    from repro_torch.models.model import init_cache, init_paged_cache
    plain = init_cache(cfg, SLOTS, MAX_LEN, device="cpu")
    tok = torch.ones((SLOTS, 1), dtype=torch.long)
    pos = torch.full((SLOTS,), 3)
    with pytest.raises(ValueError, match="make it with Model.init_cache"):
        m.decode_step_routed(sp, plain, tok, pos)
    pool, meta = init_paged_cache(cfg, SLOTS, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="page pool is placed per data"):
        m.paged_reset_pages(pool, [1])
    with pytest.raises(ValueError, match="does not split over 2 data"):
        m.init_paged_cache(SLOTS, MAX_LEN, num_pages=9)
    whole = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="not placed on the mesh"):
        m.decode_step_routed(whole, m.init_cache(SLOTS, MAX_LEN), tok, pos)
    with pytest.raises(ValueError, match="split over"):
        build_engine(cfg, whole, EngineConfig(max_slots=3, max_len=MAX_LEN,
                                              hw=HardwareModel(**HW)),
                     device="cpu", mesh=mesh)


# ---------------------------------------------------------------------------
# against the reference engine (its subprocess ran beside the tests above)
# ---------------------------------------------------------------------------

CONFIGS = {"paged": {}, "slot": {"paged_kv": False},
           "overlap": {"overlap": True},
           "speculate paged": {"speculate": 2},
           "speculate slot": {"speculate": 2, "paged_kv": False}}
CASES = [(m, c) for m in MESHES for c in CONFIGS]


def _want(ref, dtype, shape, n):
    tag = f"{dtype}/{shape[0]}x{shape[1]}"
    return [ref[f"{tag}/{i}"].tolist() for i in range(n)]


@pytest.mark.parametrize("shape,config", CASES,
                         ids=[f"float32 {m[0]}x{m[1]} {c}" for m, c in CASES])
def test_tokens_equal_the_reference_engine(reference, monkeypatch, shape,
                                           config):
    """float32: the reference engine's greedy tokens; and serving never
    gathers a cache or pool leaf, only the logits and the route ids."""
    cfg = _config("float32")
    mesh = _cpus(shape)
    assert SH.splits_dense(cfg, mesh)
    gathered = []
    full = SH.Sharded.full

    def spy(self, *a, **k):
        gathered.append(self)
        return full(self, *a, **k)
    monkeypatch.setattr(SH.Sharded, "full", spy)
    got, eng = _serve(cfg, _ref_params(reference, "float32"), mesh,
                      **CONFIGS[config])
    assert eng.config.ep == shape[1] and eng.planner.ep == shape[1]
    assert got == _want(reference, "float32", shape, len(got))
    if config.startswith("speculate"):
        assert eng.metrics["spec_proposed"] > 0
    kv = eng.kv_pool if eng.paged else eng.cache
    assert all(isinstance(v, SH.Sharded) for v in kv.values())
    leaves = {id(v) for v in kv.values()}
    assert gathered and not any(id(x) in leaves for x in gathered)
    assert all(x.shape[-1] in (cfg.padded_vocab, cfg.moe.top_k)
               for x in gathered)


#: a router near-tie: a live row's k-th minus (k+1)-th probability
ROUTER_TIE = 2 ** -8
#: the bf16 logits bar of tests/test_torch_dense_split.py, of max |logit|
BF16_BAR = 2 ** -6


def _ref_rows(ref, dtype, shape):
    """The reference's sampled rows, by (request id, token index)."""
    tag = f"{dtype}/{shape[0]}x{shape[1]}/row/"
    out = {}
    for key, v in ref.items():
        if key.startswith(tag):
            rid, i = key[len(tag):].split("/")
            out[(int(rid), int(i))] = v
    return out


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x1"])
def test_bf16_tokens_equal_the_reference_up_to_near_ties(reference, shape):
    """bfloat16, the paged default, held to the reference engine on the
    same mesh by ``near_ties.hold_tokens``: over the rows both computed
    from the same tokens, less those whose own row met a router near-tie
    in the port, the logits stay within ``BF16_BAR`` of max |logit| and
    the greedy ids are equal wherever the reference's top-2 margin
    exceeds twice that gap; at least 6 of the 8 requests are equal."""
    cfg = _config("bfloat16")
    recs = []

    def watch(eng):
        recs.append(EngineRecorder(eng, ROUTER_TIE).__enter__())
    try:
        got, eng = _serve(cfg, _ref_params(reference, "bfloat16"),
                          _cpus(shape), hook=watch)
    finally:
        for rec in recs:
            rec.__exit__()
    (rec,) = recs
    want = _want(reference, "bfloat16", shape, len(got))
    held = hold_tokens(got, want, rec.rows,
                       _ref_rows(reference, "bfloat16", shape),
                       bar=BF16_BAR, exempt=rec.ties)
    assert not held.faults(min_equal=6), (held.summary(), got, want,
                                          sorted(rec.ties))


def test_reference_bf16_meshes_part_from_its_one_device(reference):
    """The reference's own bf16 engines hold to its one-device engine by
    the same rule (with no near-tie left out), and its (2, 2) engine's
    tokens part from it: the split's rounding alone moves a token where
    the margin is within the gap."""
    one = _want(reference, "bfloat16", (1, 1), 8)
    rows = _ref_rows(reference, "bfloat16", (1, 1))
    parted = {}
    for shape in MESHES:
        want = _want(reference, "bfloat16", shape, 8)
        held = hold_tokens(want, one, _ref_rows(reference, "bfloat16", shape),
                           rows, bar=BF16_BAR)
        assert not held.faults(min_equal=6), (shape, held.summary())
        parted[shape] = want != one
    assert parted[(2, 2)], "the reference's (2, 2) engine equals one device"


def test_prefill_pads_tokens_that_do_not_split_over_the_data_ranks():
    """A (4, 1) engine whose KV window (22) does not divide by 4: a
    17-token prompt's prefill bucket is cut to the window, and its MoE
    tokens are padded to a multiple of the data ranks. Paged and slot
    engines serve the one-device engine's float32 tokens."""
    cfg = _config("float32")
    params = init_params(cfg, 4, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (17, 21, 9, 3)]
    outs = {}
    for name, mesh, extra in (("one device", None, {}),
                              ("paged", _cpus((4, 1)), {}),
                              ("slot", _cpus((4, 1)), {"paged_kv": False})):
        eng = build_engine(cfg, params, EngineConfig(
            max_slots=SLOTS, max_len=22, hw=HardwareModel(**HW), **extra),
            device="cpu", mesh=mesh)
        _configure(eng, 4 * cfg.num_layers)
        assert eng.window == 22
        rids = [eng.submit(p, max_new_tokens=1 if len(p) == 21 else 4)
                for p in prompts]
        eng.step(temperature=0.0)
        outs[name] = [eng.result(r).tokens for r in rids]
        eng.close()
    assert outs["paged"] == outs["one device"] == outs["slot"]
