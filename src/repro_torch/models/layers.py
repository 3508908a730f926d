"""Shared neural layers (plain functions over parameter dicts).

Conventions (as in ``repro.models.layers``):
  * params are nested dicts keyed by the names in ModelConfig.param_shapes()
  * activations are bf16, reductions/norms/softmax in f32
  * attention supports GQA (kv < heads), sliding-window ring-buffer KV
    caches whose entries carry absolute-position tags (-1 = empty), so
    sliding-window masks stay exact after the ring wraps, causal and
    bidirectional self-attention, and cross-attention

Attention has the reference's cached branches (prefill-from-empty and
decode over the ring buffer). Grouped-query attention contracts without
expanding K/V, as the reference does on one device; under an active mesh
whose model axis divides the heads, full attention takes the reference's
flat spelling (K/V repeated per head), which ``dist.sharding.
full_grouped_ok`` chooses. Decode always groups.

The ``*_split`` functions are the same layers over a (data, model) mesh
(``dist.sharding.Split``): lists of one tensor per mesh position, each
position computing with its own shards of the weights on its data rank's
rows, as the reference's ``param_specs`` and activation rules place them,
and the model axis closing row-parallel products with
``dist.sharding.all_reduce``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import full_grouped_ok
from repro_torch.roofline import op_count as OC


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
            ).to(x.dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of :func:`rope` at ``positions`` (..., S): (.., S, 1,
    hd/2) f32, the same for every layer of a forward."""
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         tables=None) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S);
    ``tables``: their :func:`rope_tables`, made here when not given."""
    half = x.shape[-1] // 2
    cos, sin = tables if tables is not None else \
        rope_tables(positions.to(x.device), x.shape[-1], theta)
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# KV cache: fixed-size ring buffer (window = sliding_window or max length),
# slots tagged with absolute positions (-1 = empty).
# --------------------------------------------------------------------------

def _update_cache(cache, k_new, v_new, positions):
    """Insert S_new entries at slots ``position % window``. Writes IN PLACE
    into the cache tensors (the engine holds the only reference, and the
    multi-layer cache is never copied per token); returns the same dict."""
    window = cache["k"].shape[1]
    slots = positions % window                                 # (B, S_new)
    b_idx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    cache["k"][b_idx, slots] = k_new.to(cache["k"].dtype)
    cache["v"][b_idx, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][b_idx, slots] = positions.to(cache["pos"].dtype)
    return cache


def _spec_update_cache(cache, k_new, v_new, positions):
    """Ring-buffer insert that DROPS rows tagged position < 0.

    The speculative paths (draft + batched verify, DESIGN.md §17) carry
    right-padded draft tails and idle decode slots as position -1; the
    plain modulo write would alias them onto slot ``window - 1`` and
    clobber a live entry. The reference drops them with a scatter
    ``mode="drop"``, which torch lacks, and a boolean index would sync
    the host; instead every ring slot takes the new row that targets it,
    if a live one does, and keeps its entry otherwise (live rows of one
    slot never share a ring index: the engine's depth clamp keeps a
    speculative span inside the window). Writes IN PLACE."""
    window = cache["k"].shape[1]
    live = positions >= 0                                      # (B, S)
    ring = torch.arange(window, device=positions.device)
    hit = live[:, :, None] & (positions[:, :, None] % window == ring)
    written = hit.any(dim=1)                                   # (B, W)
    src = hit.to(torch.int64).argmax(dim=1)                    # (B, W)

    def put(dst, new):
        idx = src.reshape(src.shape + (1,) * (new.ndim - 2))
        taken = torch.gather(new.to(dst.dtype), 1,
                             idx.expand((-1, -1) + tuple(new.shape[2:])))
        mask = written.reshape(written.shape + (1,) * (new.ndim - 2))
        dst.copy_(torch.where(mask, taken, dst))

    put(cache["k"], k_new)
    put(cache["v"], v_new)
    put(cache["pos"], positions)
    return cache


def _prefill_cache(cache, k_new, v_new, positions):
    """Prefill-from-empty cache contents: positions are contiguous
    0..S-1, so the ring buffer is a (rolled) slice of k/v."""
    b, s, hkv, hd = k_new.shape
    window = cache["k"].shape[1]
    if s >= window:
        shift = (s - window) % window      # slot of the first kept entry
        def cut(a):
            return torch.roll(a[:, -window:], shift, dims=1)
        k, v, pos = cut(k_new), cut(v_new), cut(positions)
    else:
        k = F.pad(k_new, (0, 0, 0, 0, 0, window - s))
        v = F.pad(v_new, (0, 0, 0, 0, 0, window - s))
        pos = F.pad(positions, (0, window - s), value=-1)
    return {"k": k.to(cache["k"].dtype),
            "v": v.to(cache["v"].dtype),
            "pos": pos.to(torch.int32)}


_Q_CHUNK = 512      # query-block size for long-sequence attention


def _sdpa_grouped_block(q, k, v, mask, scale) -> torch.Tensor:
    """GQA without materializing repeated K/V: queries are reshaped to
    (B, Sq, Hkv, G, hd) and contract the SHARED kv head dim directly."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q5 = q.reshape(b, sq, hkv, g, hd)
    logits = torch.einsum("bqcgd,bkcd->bcgqk", q5.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = torch.where(mask[:, :, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    # probs rounded to the model dtype as in the reference, then its
    # f32-accumulated product with v, rounded once
    out = torch.einsum("bcgqk,bkcd->bqcgd", probs.to(torch.float32),
                       v.to(torch.float32)).to(q.dtype)
    return out.reshape(b, sq, h, hd)


def _sdpa_block(q, k, v, mask, scale) -> torch.Tensor:
    """The flat contraction over (B, H, Sq, Sk) scores: K/V have a head
    per query head."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)


def _full_grouped(h: int, hkv: int) -> bool:
    """Full attention's spelling: the reference's ``full_grouped_ok``,
    except that multi-head attention (hkv == h) keeps the grouped
    spelling, the same contraction with groups of one."""
    return hkv == h or full_grouped_ok(h, hkv)


def _sdpa(q, k, v, mask, grouped: bool = True,
          chunk: int = _Q_CHUNK) -> torch.Tensor:
    """q: (B,Sq,H,hd) k,v: (B,Sk,Hkv,hd) mask: (B,1,Sq,Sk) bool.

    ``grouped=False`` repeats K/V per query head and contracts flat.
    Long queries are processed in blocks of ``chunk`` so the score tensor
    is O(chunk x Sk), never O(Sq x Sk); exact softmax (each block sees all
    of K)."""
    sq, h, hd = q.shape[1], q.shape[2], q.shape[3]
    if not grouped:
        rep = h // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    block = _sdpa_grouped_block if grouped else _sdpa_block
    scale = hd ** -0.5
    if sq <= 2 * chunk or sq % chunk:
        return block(q, k, v, mask, scale)
    outs = [block(q[:, i:i + chunk], k, v, mask[:, :, i:i + chunk], scale)
            for i in range(0, sq, chunk)]
    return torch.cat(outs, dim=1)


_SCORE_BLOCK = 1 << 28   # f32 scores per query block of a split position


def _split_chunk(b: int, h: int, sk: int) -> int:
    """A mesh position's query block: the largest power-of-two multiple
    of ``_Q_CHUNK`` whose (B, H, block, Sk) f32 scores stay within
    ``_SCORE_BLOCK`` (1 GiB). A position holds a fraction of the batch
    and heads, so its blocks are longer than one device's and the single
    controller issues fewer of them."""
    chunk = _Q_CHUNK
    while b * h * 2 * chunk * sk <= _SCORE_BLOCK:
        chunk *= 2
    return chunk


def _full_mask(acfg: AttentionConfig, positions: torch.Tensor,
              cached: bool) -> torch.Tensor:
    """(B, 1, S, S) mask of attention over its own (B, S) ``positions``:
    causal (none for an encoder's full attention), a sliding window, and
    with a cache (a prefill) pads tagged -1 never attended."""
    b, s = positions.shape
    qpos = positions
    causal = acfg.causal or cached
    mask = qpos[:, None, :, None] >= qpos[:, None, None, :] if causal \
        else torch.ones((b, 1, s, s), dtype=torch.bool,
                        device=positions.device)
    if cached:                  # right-padded slot prefills tag pads -1
        mask &= qpos[:, None, None, :] >= 0
    if causal and acfg.sliding_window:
        mask &= (qpos[:, None, :, None] - qpos[:, None, None, :]
                 < acfg.sliding_window)
    return mask


def _cache_mask(acfg: AttentionConfig, kpos: torch.Tensor,
                qpos: torch.Tensor) -> torch.Tensor:
    """(B, 1, S, W) mask of (B, S) queries over a ring's (B, W) position
    tags: live entries at or before the query, within the window (exact
    for S > 1 speculative queries too)."""
    valid = kpos[:, None, None, :] >= 0
    causal = kpos[:, None, None, :] <= qpos[:, None, :, None]
    mask = valid & causal
    if acfg.sliding_window:
        mask &= (qpos[:, None, :, None] - kpos[:, None, None, :]
                 < acfg.sliding_window)
    return mask


def _attend(p, q, k, v, acfg: AttentionConfig, positions, cache, *,
            cross: bool = False, spec: bool = False, tables=None,
            kv_heads=slice(None), rows=slice(None), chunk: int = _Q_CHUNK):
    """:func:`attention`'s work after the projections: q (B, S, H, hd)
    and k/v (B, S_kv, Hkv, hd) through the qk-norm, rope (not for
    ``cross``), the cache write and the masked softmax. Returns (out
    (B, S', H, hd), the new cache or ``None``).

    ``tables`` (:func:`position_tables`) gives the rope tables and, with
    no decode cache, the mask, made once per forward; ``kv_heads`` are
    the KV heads the query heads group with, ``rows`` the query rows
    computed (S' of them) with no decode cache and ``chunk`` the query
    block: what :func:`attention_split`'s positions narrow."""
    if acfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    g_full = _full_grouped(acfg.num_heads, acfg.num_kv_heads)
    if cross:
        q = q[:, rows]
        mask = torch.ones((q.shape[0], 1, q.shape[1], k.shape[1]),
                          dtype=torch.bool, device=q.device)
        return _sdpa(q, k[:, :, kv_heads], v[:, :, kv_heads], mask, g_full,
                     chunk), None
    rt = None if tables is None else tables["rope"]
    q = rope(q, positions, acfg.rope_theta, rt)
    k = rope(k, positions, acfg.rope_theta, rt)
    if cache is None or (q.shape[1] > 1 and not spec):
        new = None if cache is None else \
            _prefill_cache(cache, k, v, positions)
        mask = tables["mask"] if tables is not None else \
            _full_mask(acfg, positions, cache is not None)
        out = _sdpa(q[:, rows], k[:, :, kv_heads], v[:, :, kv_heads],
                    mask[:, :, rows], g_full, chunk)
        return out, new
    # decode (S == 1) or speculative draft/verify (spec, S >= 1)
    writer = _spec_update_cache if spec else _update_cache
    new = writer(cache, k, v, positions)
    mask = _cache_mask(acfg, new["pos"], positions)
    return _sdpa(q, new["k"][:, :, kv_heads], new["v"][:, :, kv_heads],
                 mask), new


def attention(p: Dict[str, Any], x: torch.Tensor, acfg: AttentionConfig, *,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]],
              kv_x: Optional[torch.Tensor] = None,
              spec: bool = False,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self- or cross-attention, through a ring-buffer KV cache or none.

    x: (B, S, d); positions: (B, S) absolute positions of x (-1 = pad).
    kv_x (B, S_src, d) -> cross-attention: K and V from ``kv_x``, no rope
    on q or k (qk-norm still applies), every source position attended, no
    cache written.
    cache=None -> full attention over x with the causal/SWA mask (or none
    where ``acfg.causal`` is false: the encoder), no cache (the no-cache
    forward of ``Model.loss_fn``); returns ``None`` as the new cache.
    S > 1 -> prefill-from-empty: attend over the in-context k/v and return
    the freshly written ring buffer.
    S == 1 -> decode: the new k/v go into the ring buffer (in place) and
    attention runs over it with position-tag masking.
    spec -> speculative multi-token decode (DESIGN.md §17): S >= 1 new
    tokens extend the LIVE cache in place (never the prefill rewrite), and
    rows tagged position -1 are dropped instead of aliased by the modulo.
    """
    b, s, d = x.shape
    h, hkv, hd = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    src = kv_x if kv_x is not None else x
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (src @ p["wk"]).reshape(b, src.shape[1], hkv, hd)
    v = (src @ p["wv"]).reshape(b, src.shape[1], hkv, hd)
    out, new_cache = _attend(p, q, k, v, acfg, positions, cache,
                             cross=kv_x is not None, spec=spec)
    return out.reshape(b, s, h * hd) @ p["wo"], new_cache


def _kv_heads(h: int, hkv: int, hl: int, j: int) -> slice:
    """The KV heads that model rank ``j``'s ``hl`` query heads
    ``[j*hl, (j+1)*hl)`` group with."""
    g = h // hkv
    if hl % g and g % hl:
        raise ValueError(f"{hl} query heads per rank do not group with "
                         f"{hkv} KV heads of {h}")
    first = (j * hl) // g
    return slice(first, first + max(hl // g, 1))


def position_tables(acfg: AttentionConfig, poss, split: "SH.Split",
                    cached: bool):
    """Per position, what every layer's :func:`attention_split` of one
    forward shares: the rope tables and, without a decode cache, the
    mask (a decode step's mask reads each layer's cache tags)."""
    def one(p, pos):
        out = {"rope": rope_tables(pos, acfg.head_dim, acfg.rope_theta)}
        if not (cached and pos.shape[1] == 1):
            out["mask"] = _full_mask(acfg, pos, cached)
        return out
    return split.each(one, poss)


def attention_split(ps, xs, acfg: AttentionConfig, *, poss, caches,
                    split: "SH.Split", tables, kv_xs=None, spec=False):
    """:func:`attention` per mesh position: ``ps``, ``xs``
    (B_i, S, d), ``poss`` (B_i, S) and ``caches`` (each position's ring
    {k, v, pos} of its data rank's rows, all KV heads; ``None``: no
    cache) are per-position lists. Returns (the outputs, the new rings or
    ``None``). An encoder's self-attention is ``acfg.causal=False`` with
    no cache (its ``tables`` carry the open mask). ``kv_xs`` (each
    position's data-rank rows of ``enc_out``) makes it cross-attention: K
    and V from ``kv_xs``, no rope, every source position attended, no
    cache (``poss``, ``caches`` and ``tables`` are not read).

    Where ``wq`` is column-sharded over the model axis and the heads
    divide it, position (i, j) projects query heads slice j, and its
    ``wo`` row shard's partial product is closed by the model sum.
    Column-sharded ``wk``/``wv`` (Mixtral's 8 KV heads over 16 ranks give
    each half a head) are all-gathered over model before rope, the norm
    and the cache write, so each position's cache holds its data rank's
    whole K/V, and its query heads read the KV heads they group with.
    Where the heads do not divide (SmolLM's 15), ``q`` is all-gathered
    too: with no cache or at prefill, rank j runs query block j (the
    reference's ``attn_scores_full_g``) when the model axis divides the
    sequence and the blocks are all-gathered back; decode runs every
    head on every rank (``attn_scores_cache``). Unsharded weights run
    whole at every position. The rest is :func:`attention`'s own work
    (``_attend``), with the query blocks of ``_split_chunk``. ``tables``:
    the forward's :func:`position_tables`."""
    h, hkv, hd = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    groups, devs = split.model_groups, split.devices
    m = split.msize
    q_split = ps[0]["wq"].shape[-1] < h * hd
    kv_split = ps[0]["wk"].shape[-1] < hkv * hd
    heads = q_split and h % m == 0
    hl = h // m if heads else h
    cross = kv_xs is not None
    if cross:
        xq = xs
        xkv = split.each(lambda p, x: SH.fan_out(x, 2), kv_xs)
    else:
        xqkv = split.each(lambda p, x: SH.fan_out(x, 3), xs)
        xq = [a[0] for a in xqkv]
        xkv = [a[1:] for a in xqkv]
    q = split.each(lambda p, x, w: x @ w["wq"], xq, ps)
    k = split.each(lambda p, x, w: x[0] @ w["wk"], xkv, ps)
    v = split.each(lambda p, x, w: x[1] @ w["wv"], xkv, ps)
    if kv_split:
        k = SH.all_gather(k, groups, devs, -1)
        v = SH.all_gather(v, groups, devs, -1)
    if q_split and not heads:
        q = SH.all_gather(q, groups, devs, -1)
    s, sk = xs[0].shape[1], k[0].shape[1]
    block = q_split and not heads and m > 1 and s % m == 0 and \
        (caches is None or (s > 1 and not spec))
    nothing = [None] * split.n

    def one(p, x, w, qp, kp, vp, pos, cache, tab):
        b, j = x.shape[0], split.rank[p]
        n = s // m if block else s
        out, new = _attend(
            w, qp.reshape(b, s, hl, hd), kp.reshape(b, sk, hkv, hd),
            vp.reshape(b, sk, hkv, hd), acfg, pos, cache, cross=cross,
            spec=spec, tables=tab,
            kv_heads=_kv_heads(h, hkv, hl, j) if heads else slice(None),
            rows=slice(j * n, (j + 1) * n) if block else slice(None),
            chunk=_split_chunk(b, hl, sk))
        return out, new

    done = split.each(one, xs, ps, q, k, v, poss or nothing,
                      caches or nothing, tables or nothing)
    outs = [o for o, _ in done]
    if block:
        outs = SH.all_gather(outs, groups, devs, 1)

    def close(p, o, w):
        o = o.reshape(o.shape[0], s, -1)
        if q_split and not heads:        # this rank's rows of wo
            c = w["wo"].shape[0]
            o = o[..., split.rank[p] * c:(split.rank[p] + 1) * c]
        return o @ w["wo"]

    outs = split.each(close, outs, ps)
    if q_split:
        outs = SH.all_reduce(outs, groups, devs)
    return outs, (None if caches is None else [n for _, n in done])


def mlp_split(ps, xs, act: str, d_ff: int, split: "SH.Split"):
    """:func:`mlp` per mesh position: column shards of ``w_gate``/
    ``w_up`` and the row shard of ``w_down`` (whole where ``d_ff`` does
    not divide the model axis), the partial outputs closed by the model
    sum."""
    outs = split.each(lambda p, x, w: mlp(w, x, act), xs, ps)
    if ps[0]["w_up"].shape[-1] < d_ff:
        outs = SH.all_reduce(outs, split.model_groups, split.devices)
    return outs


def mlp(p: Dict[str, Any], x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if act == "gelu":
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    if act == "relu_sq":
        return torch.square(F.relu(x @ p["w_up"])) @ p["w_down"]
    raise ValueError(act)


class _Embed(torch.autograd.Function):
    """``table[ids]`` whose backward sums the rows of repeated ids as a
    product with the one-hot matrix of ``ids`` (in cuBLAS's fixed order),
    not as an index backward's scatter-add, whose order of adds PyTorch
    does not fix: two identical train steps give the same bits."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        grad = grad.reshape(-1, grad.shape[-1])
        flat = ids.reshape(-1)
        onehot = (flat[:, None] == torch.arange(
            ctx.rows, device=flat.device)).to(grad.dtype)
        return onehot.t() @ grad, None


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return _Embed.apply(table, ids)


def embed_split(tables, ids, rows: int, split: "SH.Split"):
    """:func:`embed` per mesh position from a vocab-sharded table: each
    position looks up the ids in its slice of ``rows`` (zeros for the
    others), and the sum over the model axis gives every row exactly (one
    rank holds it). A whole table is looked up at every position."""
    n = tables[0].shape[0]
    if n == rows:
        return split.each(lambda p, t, i: embed(t, i), tables, ids)

    def local(p, table, i):
        i = i - split.rank[p] * n
        hit = (i >= 0) & (i < n)
        got = embed(table, torch.clamp(i, 0, n - 1))
        return torch.where(hit[..., None], got, torch.zeros(
            (), dtype=got.dtype, device=got.device))

    return SH.all_reduce(split.each(local, tables, ids), split.model_groups,
                         split.devices)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (V,d)^T -> (B,S,V) logits in f32 (f32 products and sums,
    like the reference's ``preferred_element_type=f32``)."""
    return torch.einsum("bsd,vd->bsv", x.to(torch.float32),
                        table.to(torch.float32))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean NLL with padded-vocab masking (positions with label < 0 are
    ignored), in f32."""
    total, count = xent_sums(logits, labels, vocab_size)
    return total / torch.clamp(count, min=1)


def softmax_xent_split(logits, labels, vocab_size: int,
                       split: "SH.Split") -> torch.Tensor:
    """:func:`softmax_xent` of per-position vocab slices of the logits:
    each data rank's slices gathered in rank order at its first position
    (``dist.sharding.to_lead``), its NLL sum and label count taken there,
    and those summed in data-rank order at position 0."""
    whole = SH.to_lead(logits, split, -1)
    parts = []
    for p, lg in zip(split.lead, whole):
        with OC.at_position(p):
            parts.append(xent_sums(lg, labels[p], vocab_size))
    dev = split.devices[0]
    if OC.counting():
        sent = {p: OC.nbytes(t) + OC.nbytes(c)
                for p, (t, c) in zip(split.lead, parts)}
        OC.collective("reduce", {0: sum(sent.values())}, sent)
    with OC.at_position(0):
        total = SH.rank_sum([t for t, _ in parts], dev)
        count = parts[0][1].to(dev)
        for _, c in parts[1:]:
            count = count + c.to(dev)
        return total / torch.clamp(count, min=1)


def xent_sums(logits: torch.Tensor, labels: torch.Tensor,
              vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the f32 NLL summed over the labels >= 0, their count)."""
    v_pad = logits.shape[-1]
    logits = logits.to(torch.float32)
    if v_pad > vocab_size:
        pad = torch.arange(v_pad, device=logits.device) >= vocab_size
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).to(torch.long)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * valid).sum(), valid.sum()
