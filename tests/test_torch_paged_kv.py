"""The port's paged KV cache against the reference's (DESIGN.md §13) on the
smoke-size Mixtral (2 layers, d_model 64), params crossed by
``params_from_numpy``.

Bars: the page allocator's tables byte-equal to the reference's for the
same calls; the pool's position tags byte-equal to the reference's after
prefill, decode, ``paged_reset_pages`` and ``paged_rollback``, its k/v
within 5e-2 (bf16 activations over 2 layers, matmuls summed in another
order) and the logits within 5e-2. Inside the port, bit for bit: paged ==
slot, per-layer == whole-stack decode, and ``paged_decode_layer_routed``
== ``paged_decode_step_routed``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.precision_plan import balanced_ladder_plan as jplan
from repro.models import model as jmodel
from repro.serving.paged_kv import PageAllocator as JPageAllocator
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.precision_plan import balanced_ladder_plan
from repro_torch.models import model as tmodel
from repro_torch.serving.api import (EngineConfig, QoSTarget, ServeRequest,
                                     build_engine)
from repro_torch.serving.paged_kv import PageAllocator

LADDER = (16, 8, 4)
COUNTS = {4: 6, 8: 4}
PAGE, MAX_LEN = 4, 16
TOL = 5e-2
HW = HardwareModel(host_link_bw=24e9)


def bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# --------------------------------------------------------------------------
# PageAllocator: a copy, held to the reference call for call
# --------------------------------------------------------------------------

def _ops(seed, slots, chunks, ps):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        op = rng.integers(5)
        slot = int(rng.integers(slots))
        if op == 0:
            yield "ensure", (slot, int(rng.integers(chunks)))
        elif op == 1:
            yield "ensure_prefix", (slot, int(rng.integers(1, chunks * ps)))
        elif op == 2:
            yield "ensure_index", (slot, int(rng.integers(chunks * ps)))
        elif op == 3:
            yield "truncate", (slot, int(rng.integers(-1, chunks * ps)))
        else:
            yield "free_slot", (slot,)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_tables_byte_equal(seed):
    args = (3, 4, 9, 4)             # slots, chunks, pages (8 usable), page
    ours, ref = PageAllocator(*args), JPageAllocator(*args)
    for name, a in _ops(seed, 3, 4, 4):
        try:
            want = getattr(ref, name)(*a)
        except RuntimeError as e:          # pool exhausted
            with pytest.raises(RuntimeError, match="exhausted"):
                getattr(ours, name)(*a)
            assert "exhausted" in str(e)
        else:
            assert getattr(ours, name)(*a) == want, (name, a)
        assert ours.table.dtype == ref.table.dtype
        assert ours.table.tobytes() == ref.table.tobytes(), (name, a)
        assert (ours.free_pages, ours.pages_in_use) == \
            (ref.free_pages, ref.pages_in_use)
        assert ours.slot_pages(a[0]) == ref.slot_pages(a[0])


def test_paged_pool_init_equal():
    jcfg = jreduce(jget_config("mixtral-8x7b"))
    tcfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    jpool, jmeta = jmodel.init_paged_cache(jcfg, 2, 24, page_size=PAGE)
    tpool, tmeta = tmodel.init_paged_cache(tcfg, 2, 24, page_size=PAGE,
                                           device="cpu")
    assert vars(tmeta) == vars(jmeta)
    assert tmeta.num_pages == 2 * tmeta.chunks_per_slot + 1
    for key in ("k", "v", "pos"):
        assert tuple(tpool[key].shape) == tuple(jpool[key].shape)
        np.testing.assert_array_equal(bits(tpool[key]), bits(jpool[key]))
    with pytest.raises(ValueError, match="cannot hold"):
        tmodel.init_paged_cache(tcfg, 2, 24, page_size=PAGE, num_pages=2,
                                device="cpu")


# --------------------------------------------------------------------------
# The paged model hooks against the reference's
# --------------------------------------------------------------------------

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
    return (jcfg, tcfg, jmodel.apply_precision_plan(jparams, jcfg, jp),
            tmodel.apply_precision_plan(tparams, tcfg, tp), jparams, tparams)


PROMPTS = [np.array([3, 9, 4, 1, 7]), np.array([5, 2, 8, 8, 6, 1, 11])]


def _assert_pool_close(tpool, jpool):
    np.testing.assert_array_equal(bits(tpool["pos"]), bits(jpool["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(f32(tpool[key]), f32(jpool[key]),
                                   atol=TOL, rtol=0)


def test_pool_tags_follow_the_reference(smoke):
    """Prefill two slots, decode two steps (the reference's greedy tokens
    fed to both), free a slot, roll one back: tags byte-equal, k/v and
    logits within 5e-2, route ids equal."""
    jcfg, tcfg, jserve, tserve, _, _ = smoke
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jpool, meta = jm.init_paged_cache(2, MAX_LEN, page_size=PAGE)
    tpool, _ = tm.init_paged_cache(2, MAX_LEN, page_size=PAGE, device="cpu")
    w = meta.window
    jal = JPageAllocator(2, meta.chunks_per_slot, meta.num_pages, PAGE)
    tal = PageAllocator(2, meta.chunks_per_slot, meta.num_pages, PAGE)
    last = []
    for slot, pr in enumerate(PROMPTS):
        sb = 8
        toks = np.zeros((1, sb), np.int32)
        pos = np.full((1, sb), -1, np.int32)
        toks[0, :len(pr)] = pr
        pos[0, :len(pr)] = np.arange(len(pr))
        for al in (jal, tal):
            al.ensure_prefix(slot, len(pr))
        jl, jpool = jm.paged_prefill_into_slot(
            jserve, jpool, jnp.asarray(jal.table[slot]), jnp.asarray(toks),
            jnp.asarray(pos), jnp.int32(len(pr) - 1), window=w)
        tl, tpool = tm.paged_prefill_into_slot(
            tserve, tpool, tmodel.page_table(tal.table[slot], "cpu"),
            torch.from_numpy(toks).long(), torch.from_numpy(pos).long(),
            len(pr) - 1, window=w)
        np.testing.assert_allclose(f32(tl), f32(jl), atol=TOL, rtol=0)
        last.append(int(np.argmax(np.asarray(jl)[0])))
    _assert_pool_close(tpool, jpool)
    positions = np.array([len(p) for p in PROMPTS])
    for _ in range(2):
        for slot in range(2):
            for al in (jal, tal):
                al.ensure_index(slot, int(positions[slot]) % w)
        toks = np.array(last, np.int32)[:, None]
        jl, jpool, jids = jm.paged_decode_step_routed(
            jserve, jpool, jnp.asarray(jal.table), jnp.asarray(toks),
            jnp.asarray(positions.astype(np.int32)), window=w)
        tl, tpool, tids = tm.paged_decode_step_routed(
            tserve, tpool, tmodel.page_table(tal.table, "cpu"),
            torch.from_numpy(toks).long(), torch.from_numpy(positions),
            window=w)
        np.testing.assert_allclose(f32(tl), f32(jl), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        _assert_pool_close(tpool, jpool)
        last = list(np.argmax(np.asarray(jl), axis=-1))
        positions = positions + 1
    keep = np.array([positions[0] - 2, 1 << 30], np.int32)
    jpool = jm.paged_rollback(jpool, jnp.asarray(jal.table),
                              jnp.asarray(keep))
    tpool = tm.paged_rollback(tpool, tmodel.page_table(tal.table, "cpu"),
                              torch.from_numpy(keep).long())
    _assert_pool_close(tpool, jpool)
    freed_j, freed_t = jal.free_slot(1), tal.free_slot(1)
    assert freed_j == freed_t
    buf = np.zeros(meta.chunks_per_slot, np.int32)
    buf[:len(freed_j)] = freed_j
    jpool = jm.paged_reset_pages(jpool, jnp.asarray(buf))
    tpool = tm.paged_reset_pages(tpool, buf)
    _assert_pool_close(tpool, jpool)
    # the null page stays all-invalid and never written
    assert (tpool["pos"][:, 0] == -1).all()
    assert not tpool["k"][:, 0].float().abs().sum()


# --------------------------------------------------------------------------
# Inside the port: bit for bit
# --------------------------------------------------------------------------

def _prefilled(tm, tserve, n_steps=3):
    """Slot cache and paged pool prefilled with PROMPTS; returns both, the
    allocator and the first tokens."""
    cache = tm.init_cache(2, MAX_LEN, device="cpu")
    pool, meta = tm.init_paged_cache(2, MAX_LEN, page_size=PAGE,
                                     device="cpu")
    al = PageAllocator(2, meta.chunks_per_slot, meta.num_pages, PAGE)
    first = []
    for slot, pr in enumerate(PROMPTS):
        toks = torch.from_numpy(pr[None]).long()
        pos = torch.arange(len(pr))[None]
        ls, cache = tm.prefill_into_slot(tserve, cache, toks, pos, slot,
                                         len(pr) - 1)
        al.ensure_prefix(slot, len(pr))
        lp, pool = tm.paged_prefill_into_slot(
            tserve, pool, tmodel.page_table(al.table[slot], "cpu"), toks,
            pos, len(pr) - 1, window=meta.window)
        assert torch.equal(ls, lp)
        first.append(int(torch.argmax(ls[0])))
    return cache, pool, al, meta, first


def _ring_of(pool, al, meta):
    return tmodel._gather_paged(pool, tmodel.page_table(al.table, "cpu"),
                                meta.window)


def test_paged_equals_slot_bitwise(smoke):
    """Three decode steps (slot 1 idle in the last): paged logits, route
    ids and every mapped ring entry bit-equal to the slot cache's; the
    gathered ring has the slot cache's shape, dtype and strides."""
    _, tcfg, _, tserve, _, _ = smoke
    tm = tmodel.build_model(tcfg)
    cache, pool, al, meta, tok = _prefilled(tm, tserve)
    positions = torch.tensor([len(p) for p in PROMPTS])
    tok = torch.tensor(tok)[:, None]
    for step in range(3):
        if step == 2:
            positions[1] = -1                  # an idle slot rides along
        for slot in range(2):
            if positions[slot] >= 0:
                al.ensure_index(slot, int(positions[slot]) % meta.window)
        ls, cache, ids_s = tm.decode_step_routed(tserve, cache, tok,
                                                 positions)
        lp, pool, ids_p = tm.paged_decode_step_routed(
            tserve, pool, tmodel.page_table(al.table, "cpu"), tok,
            positions, window=meta.window)
        assert torch.equal(ls, lp) and torch.equal(ids_s, ids_p)
        tok = torch.argmax(ls, -1)[:, None]
        positions = torch.where(positions >= 0, positions + 1, positions)
    ring = _ring_of(pool, al, meta)
    for key in ("k", "v", "pos"):
        assert ring[key].shape == cache[key].shape
        assert ring[key].dtype == cache[key].dtype
        assert ring[key].stride() == cache[key].stride()
    live = ring["pos"] >= 0
    assert torch.equal(ring["pos"][live], cache["pos"][live])
    assert torch.equal(ring["k"][live], cache["k"][live])
    assert torch.equal(ring["v"][live], cache["v"][live])


def test_per_layer_equals_scanned(smoke):
    """decode_embed -> decode_layer_routed per layer -> decode_logits is
    bit-identical to decode_step_routed (logits, cache, route ids)."""
    _, tcfg, _, tserve, _, _ = smoke
    tm = tmodel.build_model(tcfg)
    cache, _, _, _, tok = _prefilled(tm, tserve)
    layered = {k: v.clone() for k, v in cache.items()}
    positions = torch.tensor([len(p) for p in PROMPTS])
    tok = torch.tensor(tok)[:, None]
    want, cache, ids = tm.decode_step_routed(tserve, cache, tok, positions)
    x = tm.decode_embed(tserve, tok)
    for li in range(tcfg.num_layers):
        x, layered, lids = tm.decode_layer_routed(tserve, layered, x,
                                                  positions, li)
        assert torch.equal(lids, ids[li])
    assert torch.equal(tm.decode_logits(tserve, x), want)
    for key in cache:
        assert torch.equal(layered[key], cache[key])


def test_paged_layer_equals_paged_step(smoke):
    """paged_decode_layer_routed over the layers is bit-identical to
    paged_decode_step_routed (logits, the whole pool)."""
    _, tcfg, _, tserve, _, _ = smoke
    tm = tmodel.build_model(tcfg)
    _, pool, al, meta, tok = _prefilled(tm, tserve)
    layered = {k: v.clone() for k, v in pool.items()}
    positions = torch.tensor([len(p) for p in PROMPTS])
    for slot in range(2):
        al.ensure_index(slot, int(positions[slot]) % meta.window)
    pt = tmodel.page_table(al.table, "cpu")
    tok = torch.tensor(tok)[:, None]
    want, pool, ids = tm.paged_decode_step_routed(
        tserve, pool, pt, tok, positions, window=meta.window)
    x = tm.decode_embed(tserve, tok)
    for li in range(tcfg.num_layers):
        x, layered, lids = tm.paged_decode_layer_routed(
            tserve, layered, pt, x, positions, li, window=meta.window)
        assert torch.equal(lids, ids[li])
    assert torch.equal(tm.decode_logits(tserve, x), want)
    for key in pool:
        assert torch.equal(layered[key], pool[key])


# --------------------------------------------------------------------------
# The engine on the paged cache
# --------------------------------------------------------------------------

def _run_stream(tcfg, tparams, **kw):
    """3 requests over 2 slots (one slot retires and is rejoined
    mid-flight); returns the token lists and the engine."""
    engine = build_engine(tcfg, tparams, EngineConfig(
        max_slots=2, max_len=24, page_size=PAGE, hw=HW, **kw), device="cpu")
    engine.apply_target(QoSTarget(mem_budget_bytes=1e12))
    rng = np.random.default_rng(0)
    rids = [engine.submit_request(ServeRequest(
        rng.integers(1, tcfg.vocab_size, 5 + 2 * i), max_new_tokens=6))
        for i in range(3)]
    engine.step()
    toks = [engine.result(r).tokens for r in rids]
    engine.close()
    return toks, engine


def test_engine_paged_equals_slot(smoke):
    """Paged engine tokens == slot engine tokens with retire/rejoin, for
    serial and overlapped streaming; paged waste < slot waste."""
    tcfg, tparams = smoke[1], smoke[5]
    for overlap in (False, True):
        paged, ep = _run_stream(tcfg, tparams, overlap=overlap)
        slots, es = _run_stream(tcfg, tparams, overlap=overlap,
                                paged_kv=False)
        assert paged == slots
        assert ep.paged and not es.paged
    assert 0.0 <= ep.kv_waste_fraction() < es.kv_waste_fraction()
    assert "kv[paged" in ep.summary() and "kv[slots" in es.summary()
    assert ep.metrics["kv_capacity_bytes"] <= es.metrics["kv_capacity_bytes"]
    assert ep.kv_alloc.pages_in_use == 0       # every page came back


def test_sub_worst_case_pool_admission_cap(smoke):
    """A pool below worst case derives an admission cap, never exhausts
    mid-flight and serves the same tokens; kv_reserve credits the
    reclaimed HBM to the target's budget."""
    tcfg, tparams = smoke[1], smoke[5]
    paged, ep = _run_stream(tcfg, tparams, kv_pool_pages=8)
    slots, _ = _run_stream(tcfg, tparams, paged_kv=False)
    assert paged == slots
    assert ep.scheduler.cfg.max_active_tokens == (8 - 1 - 2) * PAGE
    assert ep.kv_reclaimed_bytes() > 0
    mk = lambda reserve: build_engine(tcfg, tparams, EngineConfig(
        max_slots=2, max_len=24, page_size=PAGE, kv_pool_pages=8, hw=HW,
        kv_reserve=reserve), device="cpu")
    ea, eb = mk(False), mk(True)
    full = ea.planner.size_ne + ea.planner.num_experts_total \
        * ea.planner.size_e16
    target = QoSTarget(min_tokens_per_s=float("inf"),
                       mem_budget_bytes=full * 0.7)
    pa, pb = ea.apply_target(target), eb.apply_target(target)
    assert eb.target.mem_budget_bytes == \
        full * 0.7 + eb.kv_reclaimed_bytes()
    assert pb.plan.resident_fraction() >= pa.plan.resident_fraction()
