"""Ladder-draft speculative decoding in the port (DESIGN.md §17) against
the reference, on the smoke-size Mixtral (2 layers, d_model 64) with the
reference's params converted by ``params_from_numpy``.

Bars: ``sample_probs`` within 1e-6 of the reference's (f32 softmax);
``speculative_verify`` the same (accepted, token) pairs; the dropping ring
write ``_spec_update_cache`` and the rollbacks byte-equal; the multi-token
``attention(spec=True)`` and ``spec_step_routed`` within 5e-2 (bf16
activations over 2 layers) with equal route ids and byte-equal position
tags. Inside the port, bit for bit: the verify's logits at each position
equal plain decode's there, through slots and pages. The engine: greedy
speculation token-identical to plain decode (also under a garbage draft),
``speculate=0`` is the plain engine, ``set_speculation`` mid-flight, and
the temperature > 0 path completes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.precision_plan import balanced_ladder_plan as jplan
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serving import sampler as jsampler
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.cost_model import HardwareModel
from repro_torch.core.precision_plan import (DEVICE, balanced_ladder_plan,
                                             quantized_rungs)
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import layer_slice
from repro_torch.serving import sampler as tsampler
from repro_torch.serving.api import (EngineConfig, QoSTarget, ServeRequest,
                                     build_engine)
from repro_torch.serving.paged_kv import PageAllocator

LADDER = (16, 8, 4)
COUNTS = {4: 6, 8: 4}
TOL = 5e-2
HW = HardwareModel(host_link_bw=24e9)


def f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# --------------------------------------------------------------------------
# The sampler's verify primitives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k", [(0.7, 0), (1.3, 5)])
def test_sample_probs_matches_reference(temperature, top_k):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 40)).astype(np.float32) * 3
    want = jsampler.sample_probs(jnp.asarray(logits), temperature=temperature,
                                 top_k=top_k, vocab_size=37)
    got = tsampler.sample_probs(torch.from_numpy(logits),
                                temperature=temperature, top_k=top_k,
                                vocab_size=37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got[:, 37:].abs().max()) == 0.0      # vocab pad masked
    with pytest.raises(ValueError, match="temperature>0"):
        tsampler.sample_probs(torch.from_numpy(logits), temperature=0.0)


def test_speculative_verify_is_the_reference():
    rng = np.random.default_rng(1)
    for k in (0, 1, 3):
        for _ in range(40):
            v = 12
            q = rng.dirichlet(np.ones(v), size=k)
            p = rng.dirichlet(np.ones(v) * 0.5, size=k + 1)
            if k and rng.random() < 0.2:
                p[:k] = q                       # p == q: the z <= 0 branch
            draft = np.array([rng.choice(v, p=q[j]) for j in range(k)],
                             np.int64)
            ua, ur = rng.random(k), rng.random(k + 1)
            assert tsampler.speculative_verify(draft, q, p, ua, ur) == \
                jsampler.speculative_verify(draft, q, p, ua, ur)


# --------------------------------------------------------------------------
# The multi-token cache path against the reference's
# --------------------------------------------------------------------------

def _ring(rng, b, w, hkv, hd, live):
    k = rng.normal(size=(b, w, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, w, hkv, hd)).astype(np.float32)
    pos = np.full((b, w), -1, np.int32)
    pos[:, :live] = np.arange(live)
    return k, v, pos


def _both(k, v, pos):
    j = {"k": jnp.asarray(k, jnp.bfloat16), "v": jnp.asarray(v, jnp.bfloat16),
         "pos": jnp.asarray(pos)}
    t = {"k": torch.from_numpy(k).to(torch.bfloat16),
         "v": torch.from_numpy(v).to(torch.bfloat16),
         "pos": torch.from_numpy(pos)}
    return j, t


def test_spec_update_cache_drops_dead_rows_like_the_reference():
    rng = np.random.default_rng(2)
    b, w, s = 3, 8, 3
    jc, tc = _both(*_ring(rng, b, w, 2, 4, 5))
    kn = rng.normal(size=(b, s, 2, 4)).astype(np.float32)
    vn = rng.normal(size=(b, s, 2, 4)).astype(np.float32)
    # a live span, a right-padded draft tail, an idle slot
    positions = np.array([[5, 6, 7], [5, -1, -1], [-1, -1, -1]], np.int32)
    want = jlayers._spec_update_cache(
        jc, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
        jnp.asarray(positions))
    got = tlayers._spec_update_cache(
        tc, torch.from_numpy(kn).to(torch.bfloat16),
        torch.from_numpy(vn).to(torch.bfloat16),
        torch.from_numpy(positions).long())
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(bits(got[key]), bits(want[key]))
    assert got["pos"][2].tolist() == [0, 1, 2, 3, 4, -1, -1, -1]


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
            tmodel.apply_precision_plan(tparams, tcfg, tp), tparams)


def test_spec_attention_matches_reference(smoke):
    jcfg, tcfg, jserve, tserve, _ = smoke
    a = tcfg.attention
    rng = np.random.default_rng(3)
    b, w, s = 2, 16, 3
    jc, tc = _both(*_ring(rng, b, w, a.num_kv_heads, a.head_dim, 6))
    x = rng.normal(size=(b, s, tcfg.d_model)).astype(np.float32)
    positions = np.array([[6, 7, 8], [6, -1, -1]], np.int32)
    jp = jax.tree_util.tree_map(lambda t: t[0], jserve["layers"]["attn"])
    tp = layer_slice(tserve["layers"]["attn"], 0)
    jy, jnew = jlayers.attention(jp, jnp.asarray(x, jnp.bfloat16),
                                 jcfg.attention,
                                 positions=jnp.asarray(positions), cache=jc,
                                 spec=True)
    ty, tnew = tlayers.attention(tp, torch.from_numpy(x).to(torch.bfloat16),
                                 a, positions=torch.from_numpy(positions)
                                 .long(), cache=tc, spec=True)
    np.testing.assert_allclose(f32(ty)[0], f32(jy)[0], atol=TOL, rtol=0)
    np.testing.assert_allclose(f32(ty)[1, 0], f32(jy)[1, 0], atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(bits(tnew["pos"]), bits(jnew["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(f32(tnew[key]), f32(jnew[key]), atol=TOL,
                                   rtol=0)


def _prefill_slots(model, serve, cache, prompts, to_backend):
    firsts = []
    for slot, pr in enumerate(prompts):
        sb = 8
        toks = np.zeros((1, sb), np.int32)
        pos = np.full((1, sb), -1, np.int32)
        toks[0, :len(pr)] = pr
        pos[0, :len(pr)] = np.arange(len(pr))
        lg, cache = model.prefill_into_slot(
            serve, cache, to_backend(toks), to_backend(pos),
            *((jnp.int32(slot), jnp.int32(len(pr) - 1))
              if to_backend is jnp.asarray else (slot, len(pr) - 1)))
        firsts.append(lg)
    return firsts, cache


PROMPTS = [np.array([3, 9, 4, 1, 7]), np.array([5, 2, 8, 8, 6, 1, 11])]


def _torch_long(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_spec_step_and_rollback_match_reference(smoke):
    """One verify step over (B, 3) tokens with a padded tail, then a
    rollback: logits within 5e-2, route ids equal, tags byte-equal."""
    jcfg, tcfg, jserve, tserve, _ = smoke
    jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg)
    jcache = jm.init_cache(2, 16)
    tcache = tm.init_cache(2, 16, device="cpu")
    jf, jcache = _prefill_slots(jm, jserve, jcache, PROMPTS, jnp.asarray)
    _, tcache = _prefill_slots(tm, tserve, tcache, PROMPTS, _torch_long)
    first = [int(np.argmax(np.asarray(lg)[0])) for lg in jf]
    toks = np.array([[first[0], 4, 9], [first[1], 0, 0]], np.int32)
    pos = np.array([[5, 6, 7], [7, -1, -1]], np.int32)
    jl, jcache, jids = jm.spec_step_routed(jserve, jcache, jnp.asarray(toks),
                                           jnp.asarray(pos))
    tl, tcache, tids = tm.spec_step_routed(tserve, tcache, _torch_long(toks),
                                           _torch_long(pos))
    np.testing.assert_allclose(f32(tl)[0], f32(jl)[0], atol=TOL, rtol=0)
    np.testing.assert_allclose(f32(tl)[1, 0], f32(jl)[1, 0], atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(bits(tcache["pos"]), bits(jcache["pos"]))
    keep = np.array([6, 1 << 30], np.int32)
    jcache = jm.rollback_slots(jcache, jnp.asarray(keep))
    tcache = tm.rollback_slots(tcache, _torch_long(keep))
    np.testing.assert_array_equal(bits(tcache["pos"]), bits(jcache["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(f32(tcache[key]), f32(jcache[key]),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_rows_equal_plain_decode_bitwise(smoke, paged):
    """Inside the port: the verify's logits at each of its K+1 positions
    are bit-equal to plain decode's at that position (DESIGN.md §17.1)."""
    _, tcfg, _, tserve, _ = smoke
    tm = tmodel.build_model(tcfg)
    s = 3
    if paged:
        pool, meta = tm.init_paged_cache(2, 16, page_size=4, device="cpu")
        al = PageAllocator(2, meta.chunks_per_slot, meta.num_pages, 4)
    cache = tm.init_cache(2, 16, device="cpu")
    firsts, cache = _prefill_slots(tm, tserve, cache, PROMPTS, _torch_long)
    if paged:
        for slot, pr in enumerate(PROMPTS):
            al.ensure_prefix(slot, len(pr) + s)
        pt = tmodel.page_table(al.table, "cpu")
        tmodel._scatter_paged(pool, pt, cache, meta.window)
    spec = pool if paged else {k: v.clone() for k, v in cache.items()}
    pos0 = torch.tensor([len(p) for p in PROMPTS])
    fed = [torch.stack([torch.argmax(lg[0]) for lg in firsts])]
    plain = []
    for j in range(s):
        lg, cache, _ = tm.decode_step_routed(tserve, cache, fed[-1][:, None],
                                             pos0 + j)
        plain.append(lg)
        fed.append(torch.argmax(lg, -1))
    toks = torch.stack(fed[:s], 1)
    pos = pos0[:, None] + torch.arange(s)[None]
    if paged:
        lg, _, _ = tm.paged_spec_step_routed(tserve, spec, pt, toks, pos,
                                             window=meta.window)
    else:
        lg, _, _ = tm.spec_step_routed(tserve, spec, toks, pos)
    for j in range(s):
        assert torch.equal(lg[:, j], plain[j]), j


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

def _engine(tcfg, tparams, **kw):
    engine = build_engine(tcfg, tparams, EngineConfig(
        max_slots=2, max_len=24, page_size=4, ladder=LADDER, hw=HW, **kw),
        device="cpu")
    # the all-bf16 resident plan: the int4 draft is then another model
    engine.apply_target(QoSTarget(mem_budget_bytes=1e12,
                                  max_quality_loss=0.0))
    return engine


def _serve(engine, tcfg, temperature=0.0):
    """3 requests over 2 slots: one slot retires and is rejoined."""
    rng = np.random.default_rng(0)
    rids = [engine.submit_request(ServeRequest(
        rng.integers(1, tcfg.vocab_size, 5 + 2 * i), max_new_tokens=7))
        for i in range(3)]
    engine.step(temperature=temperature)
    return [engine.result(r).tokens for r in rids]


@pytest.fixture(scope="module")
def plain_tokens(smoke):
    tcfg, tparams = smoke[1], smoke[4]
    e = _engine(tcfg, tparams)
    toks = _serve(e, tcfg)
    e.close()
    return toks, e.metrics["iterations"]


@pytest.mark.parametrize("paged,overlap", [
    (False, False), (True, False), (False, True), (True, True)])
def test_greedy_speculation_token_identical(smoke, plain_tokens, paged,
                                            overlap):
    tcfg, tparams = smoke[1], smoke[4]
    e = _engine(tcfg, tparams, paged_kv=paged, overlap=overlap, speculate=3)
    assert _serve(e, tcfg) == plain_tokens[0]
    m = e.metrics
    assert m["spec_proposed"] > 0 and 0.0 <= m["acceptance_rate"] <= 1.0
    assert m["iterations"] <= plain_tokens[1]
    assert "spec[k=3" in e.summary()
    if paged:
        assert e.kv_alloc.pages_in_use == 0
    e.close()


def test_garbage_draft_still_exact(smoke, plain_tokens):
    """A draft from other random weights drives acceptance down; the
    output is still plain decode's, so verify and rollback are exact
    whatever the draft."""
    tcfg, tparams = smoke[1], smoke[4]
    e = _engine(tcfg, tparams, speculate=3)
    plan = e.current_plan
    low = quantized_rungs(plan.ladder)[0]
    draft_plan = dataclasses.replace(
        plan, bits=np.full_like(plan.bits, low),
        location=np.full_like(plan.location, DEVICE))
    other = tmodel.init_params(tcfg, 9, device="cpu")
    e._draft_params = tmodel.apply_precision_plan(other, tcfg, draft_plan)
    e._draft_sig = (tuple(plan.ladder), plan.group_size, low)
    assert _serve(e, tcfg) == plain_tokens[0]
    assert e.metrics["spec_proposed"] > 0
    assert e.metrics["acceptance_rate"] < 0.5
    e.close()


def test_speculate_zero_is_plain_and_set_speculation(smoke, plain_tokens):
    tcfg, tparams = smoke[1], smoke[4]
    e = _engine(tcfg, tparams, speculate=0)
    assert _serve(e, tcfg) == plain_tokens[0]
    assert e.metrics["spec_proposed"] == 0 and "spec[" not in e.summary()
    assert e.metrics["iterations"] == plain_tokens[1]
    e.close()
    # speculation switched off mid-flight keeps the stream exact
    e = _engine(tcfg, tparams, speculate=3)
    rng = np.random.default_rng(0)
    rids = [e.submit_request(ServeRequest(
        rng.integers(1, tcfg.vocab_size, 5 + 2 * i), max_new_tokens=7))
        for i in range(3)]
    e.run_iteration()
    e.set_speculation(0)
    proposed = e.metrics["spec_proposed"]
    assert proposed > 0
    e.step()
    assert e.metrics["spec_proposed"] == proposed
    assert [e.result(r).tokens for r in rids] == plain_tokens[0]
    e.close()


def test_rejection_sampled_run_completes(smoke):
    tcfg, tparams = smoke[1], smoke[4]
    e = _engine(tcfg, tparams, speculate=2)
    for toks in _serve(e, tcfg, temperature=0.8):
        assert len(toks) == 7
        assert all(0 <= t < tcfg.vocab_size for t in toks)
    m = e.metrics
    assert 0 < m["spec_proposed"] and m["spec_accepted"] <= m["spec_proposed"]
    assert m["acceptance_rate"] == pytest.approx(
        m["spec_accepted"] / m["spec_proposed"])
    e.close()
