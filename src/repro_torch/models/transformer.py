"""Decoder stacks (``repro.models.transformer``): the dense/MoE
transformer (with cross-attention for the enc-dec family), RWKV6 and the
Zamba2 hybrid. PyTorch runs eagerly, so the reference's scan over stacked
layer params is a Python loop over the leading layer axis. Every stack
shares the reference's cache protocol:

    forward(params, cfg, x, positions, caches) -> (y, new_caches, aux)

``caches=None`` is the full-sequence forward (``Model.loss_fn``). With a
cache, the dense/MoE stack's prefill (S > 1) writes fresh ring buffers,
and its decode (S == 1) and speculative step (``spec=True``, S >= 1)
update ``caches`` in place; the RWKV and hybrid stacks write every layer's
new state into ``caches`` in place, prefill and decode alike, and return
it. ``decoder_block`` is the one block body of the dense/MoE stack: the
stack runs it layer by layer, and the per-layer decode hooks of
``models/model.py`` run it one layer per call, so the two spellings give
the same bits.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mixed_moe
from repro_torch.core.quantization import QTensor
from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def layer_slice(tree, li: int):
    """Index every tensor (and QTensor) of a stacked param tree at layer
    ``li``; ``None`` leaves stay ``None``."""
    if isinstance(tree, QTensor):
        return tree.map(lambda t: t[li])
    if isinstance(tree, dict):
        return {k: layer_slice(v, li) for k, v in tree.items()}
    if isinstance(tree, list):          # per-rank bank shards on a mesh
        return [layer_slice(v, li) for v in tree]
    if tree is None:
        return None
    return tree[li]


def by_column(fn, x: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
    """``fn`` on each column ``x[:, j:j+1]`` (made contiguous, so it has
    plain decode's (B, 1, ...) shape and strides) and the same column of
    each of ``rest``, concatenated back along the column axis."""
    return torch.cat([fn(x[:, j:j + 1].contiguous(),
                         *(r[:, j:j + 1].contiguous() for r in rest))
                      for j in range(x.shape[1])], dim=1)


def _ffn_or_moe(p, xn, cfg: ModelConfig, use_kernel, token_valid=None,
                moe_capacity=None, spec=False, aux=None, par=None):
    """Returns (y, route_ids|None) — ids are the (T, k) routed expert slots
    in BANK order (the serve layout permutes experts q4-first).

    ``token_valid`` (B, S) bool masks idle decode slots / prefill pads out
    of the dispatch: their ids become the out-of-range sentinel
    ``num_experts`` (dropped by ``_local_slot``), so they never occupy
    expert capacity and displace real tokens. ``par`` (a mesh) runs the
    expert FFN through ``moe_apply``'s mesh regimes."""
    if cfg.moe is None:
        return L.mlp(p["mlp"], xn, cfg.act), None
    b, s, d = xn.shape
    x2 = xn.reshape(b * s, d)
    if spec and s > 1:
        # the router column by column, at plain decode's M = B
        routed = [mixed_moe.route(p["moe"]["router"],
                                  xn[:, j].contiguous(), cfg.moe)
                  for j in range(s)]
        weights = torch.stack([w for w, _ in routed], 1).reshape(b * s, -1)
        ids = torch.stack([i for _, i in routed], 1).reshape(b * s, -1)
    else:
        weights, ids = mixed_moe.route(p["moe"]["router"], x2, cfg.moe,
                                       aux=aux)
    if token_valid is not None:
        v = token_valid.reshape(b * s)[:, None]
        ids = torch.where(v, ids, torch.full_like(ids, cfg.moe.num_experts))
        weights = torch.where(v, weights, torch.zeros_like(weights))
    banks = p["moe"].get("banks")
    if banks is None:
        banks = mixed_moe.train_banks(p["moe"])
    y = mixed_moe.moe_apply(banks, x2, weights, ids, cfg.moe, par,
                            act=cfg.act, use_kernel=use_kernel,
                            capacity=moe_capacity)
    return y.reshape(b, s, d), ids


def decoder_block(p, cfg: ModelConfig, x, positions, cache, *,
                  use_kernel=False, spec=False, moe_capacity=None,
                  aux=None, enc_out=None, par=None):
    """One decoder block on layer params ``p`` and that layer's ring
    ``cache`` {k, v, pos} (``None``: the no-cache training forward, whose
    router losses accumulate into ``aux``). Returns (x', the layer's new
    ring, route ids (B*S, top_k) or None).

    ``spec`` with S > 1 (the speculative verify) runs the ops whose bits
    can depend on the row count — the norms, the projections, attention
    and the router — column by column at plain decode's shapes, and only
    the expert FFN once over all B*S tokens: the CUDA kernels are
    row-invariant, cuBLAS is not (it picks its algorithm by M; see
    ``chip_smoke.py``'s verify-row probe). Column j attends the ring after
    columns 0..j are written, as decode at that position would, so a
    verify row gets plain decode's bits and greedy speculation stays
    token-identical to plain decode (DESIGN.md §17.1).

    ``enc_out`` (the enc-dec family) adds cross-attention to it after the
    self-attention, under ``cross_attn_norm``."""
    token_valid = (positions >= 0) \
        if cfg.moe is not None and cache is not None else None
    new_kv = cache           # the spec and decode writes go in place

    def attend(xc, pc):
        nonlocal new_kv
        h, new_kv = L.attention(
            p["attn"], L.rms_norm(xc, p["attn_norm"]["scale"]),
            cfg.attention, positions=pc, cache=cache, spec=spec)
        return xc + h

    def norm(xc):
        return L.rms_norm(xc, p["ffn_norm"]["scale"])

    if spec and x.shape[1] > 1:
        x = by_column(attend, x, positions)
        xn = by_column(norm, x)
    else:
        x = attend(x, positions)
        if enc_out is not None:
            h, _ = L.attention(
                p["cross_attn"],
                L.rms_norm(x, p["cross_attn_norm"]["scale"]),
                cfg.attention, positions=positions, cache=None,
                kv_x=enc_out)
            x = x + h
        xn = norm(x)
    h, ids = _ffn_or_moe(p, xn, cfg, use_kernel, token_valid=token_valid,
                         moe_capacity=moe_capacity, spec=spec, aux=aux,
                         par=par)
    return x + h, new_kv, ids


def _norm_split(xs, ps, name: str, split):
    """Each position's ``rms_norm`` of its rows by its ``name`` scale."""
    return split.each(lambda i, x, p: L.rms_norm(x, p[name]["scale"]),
                      xs, ps)


def _add_split(xs, hs, split):
    return split.each(lambda i, x, h: x + h, xs, hs)


def _columns(fn, split, xs, *rest):
    """:func:`by_column` over per-position lists: ``fn`` on each column
    ``j`` (each position's ``x[:, j:j+1]``, contiguous, and the same
    column of each list of ``rest``), the per-position results
    concatenated back along the column axis."""
    def col(lst, j):
        return [x[:, j:j + 1].contiguous() for x in lst]

    cols = [fn(col(xs, j), *(col(r, j) for r in rest))
            for j in range(xs[0].shape[1])]
    return split.each(lambda p: torch.cat([c[p] for c in cols], dim=1))


def decoder_block_split(ps, cfg: ModelConfig, xs, poss, rings, split,
                        tables, *, use_kernel=False, stats=None, par=None,
                        enc_outs=None, spec=False, capacity=None,
                        owner=None, banks=None):
    """:func:`decoder_block` over a (data, model) mesh: ``ps`` (each
    position's layer params: its shards), ``xs`` (its data rank's
    residual rows), ``poss`` and ``rings`` (its cache rows, or ``None``)
    are per-position lists (``dist.sharding.Split``). Attention, the MLP
    and the MoE run their split forms; norms and the router run on every
    position's copy of its rows. ``stats`` (the training forward)
    collects the lead positions' router sums; ``tables`` are the
    forward's ``layers.position_tables``; ``enc_outs`` (the enc-dec
    family: each position's rows of the encoder output) adds
    cross-attention after the self-attention, under ``cross_attn_norm``.

    ``spec`` with S > 1 (the speculative verify) runs attention, the
    norms and the router column by column at plain decode's shapes, as
    :func:`decoder_block` does, and the expert FFN once over all tokens
    with ``capacity`` (B*S of the whole batch: drop-free). ``owner``
    (``dist.sharding.Owner``; ``split`` is then its ``sub``) runs one
    row at a data rank's model group and the MoE's tokens over the whole
    mesh, whose positions' layer banks ``banks`` gives. Returns (x', the
    new rings, each position's route ids (B_i*S, top_k) in bank order,
    idle slots and pads remapped to the sentinel ``num_experts``, or
    ``None`` for a dense block)."""
    lead = set(split.lead)

    def attend(xs, poss):
        hs, new = L.attention_split(
            [p["attn"] for p in ps], _norm_split(xs, ps, "attn_norm", split),
            cfg.attention, poss=poss, caches=rings, split=split,
            tables=None if spec else tables, spec=spec)
        return _add_split(xs, hs, split), new

    def norm(xs):
        return _norm_split(xs, ps, "ffn_norm", split)

    columns = spec and xs[0].shape[1] > 1
    if columns:                 # each column's ring write goes in place
        xs, new = _columns(lambda x, q: attend(x, q)[0], split, xs,
                           poss), rings
        xns = _columns(norm, split, xs)
    else:
        xs, new = attend(xs, poss)
        if enc_outs is not None:
            hs, _ = L.attention_split(
                [p["cross_attn"] for p in ps],
                _norm_split(xs, ps, "cross_attn_norm", split),
                cfg.attention, poss=None, caches=None, split=split,
                tables=None, kv_xs=enc_outs)
            xs = _add_split(xs, hs, split)
        xns = norm(xs)
    if cfg.moe is None:
        ys = L.mlp_split([p["mlp"] for p in ps], xns, cfg.act, cfg.d_ff,
                         split)
        return split.each(lambda i, x, y: x + y, xs, ys), new, None

    def routed(i, xn, p, pos):
        b, s, d = xn.shape
        router = p["moe"]["router"]
        if columns:             # the router at plain decode's M = B_i
            got = [mixed_moe.route(router, xn[:, j].contiguous(), cfg.moe)
                   for j in range(s)]
            w = torch.stack([g[0] for g in got], 1).reshape(b * s, -1)
            ids = torch.stack([g[1] for g in got], 1).reshape(b * s, -1)
        else:
            w, ids = mixed_moe.route(
                router, xn.reshape(b * s, d), cfg.moe,
                stats=stats if stats is not None and i in lead else None)
        if rings is not None:       # idle slots and pads take no capacity
            v = (pos >= 0).reshape(-1)[:, None]
            ids = torch.where(v, ids, torch.full_like(ids,
                                                      cfg.moe.num_experts))
            w = torch.where(v, w, torch.zeros_like(w))
        return xn.reshape(b * s, d), w, ids

    r = split.each(routed, xns, ps, poss)
    x2s, ws, ids = ([t[k] for t in r] for k in range(3))
    if banks is None:
        banks = [p["moe"]["banks"] for p in ps]
    if owner is not None:
        rows = x2s[0].shape[0]
        x2s, ws = owner.spread(x2s), owner.spread(ws)
        tok_ids = owner.spread(ids, cfg.moe.num_experts)
    else:
        tok_ids = ids
    ys = mixed_moe.moe_apply(banks, x2s, ws, tok_ids, cfg.moe, par,
                             act=cfg.act, use_kernel=use_kernel,
                             capacity=capacity)
    if owner is not None:
        ys = owner.collect(ys, rows)
    return split.each(lambda i, x, y: x + y.reshape(x.shape), xs, ys), \
        new, ids


def decoder_layer_split(pos_params, cfg: ModelConfig, li: int, xs, poss,
                        rings, split, tables, *, owner=None, **kw):
    """Layer ``li`` of :func:`decoder_forward_split` (the overlap
    pipeline's one-layer entry, and the stack's body): each position's
    layer params sliced from ``pos_params``, the dense ones of
    ``owner``'s group where one is given, the MoE banks of every
    position. Returns what :func:`decoder_block_split` returns."""
    ps = [layer_slice(t["layers"], li) for t in pos_params]
    banks = None
    if owner is not None:
        if cfg.moe is not None:
            banks = [p["moe"]["banks"] for p in ps]
        ps = [ps[p] for p in owner.group]
    return decoder_block_split(ps, cfg, xs, poss, rings, split, tables,
                               owner=owner, banks=banks, **kw)


def decoder_forward_split(pos_params, cfg: ModelConfig, xs, poss, *,
                          caches, split, use_kernel=False, train=False,
                          par=None, enc_outs=None, collect_routes=False,
                          spec=False, owner=None):
    """:func:`decoder_forward` over a (data, model) mesh: ``pos_params``
    (each position's param tree of its own shards), ``xs``, ``poss``,
    ``caches`` (each position's {k, v, pos} stacks of its data rank's
    rows) and ``enc_outs`` (the enc-dec decoder's cross-attention source)
    are per-position lists, and the residual stays per position through
    the layers. Returns (ys, new caches, aux): the router losses of the
    whole batch (``train``) at position 0.

    ``collect_routes`` puts each position's per-layer route ids (L,
    B_i*S, top_k) under ``aux["route_ids"]``; ``spec`` is
    :func:`decoder_forward`'s speculative step (S >= 1 new tokens into
    the live caches, the MoE capacity pinned at the whole batch's B*S).
    ``owner`` (``dist.sharding.Owner`` over ``split``) runs one batch row
    (a slot prefill): ``xs``, ``poss`` and ``caches`` are then lists over
    its group's positions, which compute the dense layers, and the MoE
    runs over every position of ``split``."""
    if collect_routes and (cfg.moe is None or caches is None):
        raise ValueError("collect_routes needs routed experts and a cache")
    dense = split if owner is None else owner.sub
    aux: Dict[str, Any] = {}
    if train and cfg.moe is not None:
        zero = torch.zeros((), dtype=torch.float32, device=split.devices[0])
        aux.update(load_balance=zero, router_z=zero)

    tables = L.position_tables(cfg.attention, poss, dense,
                               caches is not None)
    # every layer's cross-attention reads enc_out: its gradient sums over
    # the layers in their order
    encs = None if enc_outs is None else list(zip(*dense.each(
        lambda p, e: SH.fan_out(e, cfg.num_layers), enc_outs)))

    def train_block(xs, ps, enc=None):
        stats: list = []
        xs, _, _ = decoder_block_split(ps, cfg, xs, poss, None, split,
                                       tables, use_kernel=use_kernel,
                                       stats=stats if train else None,
                                       par=par, enc_outs=enc)
        if not stats:
            return xs, {}
        lb, z = mixed_moe.router_losses(stats, split.lead, cfg.moe,
                                        split.devices[0])
        return xs, {"load_balance": lb, "router_z": z}

    train_body = _maybe_remat(train_block, cfg)
    capacity = xs[0].shape[0] * dense.n_dp * xs[0].shape[1] if spec \
        else None
    new = [[] for _ in range(dense.n)]
    routes = [[] for _ in range(dense.n)]
    for li in range(cfg.num_layers):
        enc = None if encs is None else list(encs[li])
        if caches is None:
            ps = [layer_slice(t["layers"], li) for t in pos_params]
            xs, layer_aux = train_body(xs, ps, enc)
            for k, v in layer_aux.items():
                aux[k] = aux[k] + v
            continue
        rings = [{k: c[k][li] for k in ("k", "v", "pos")} for c in caches]
        xs, rings, ids = decoder_layer_split(
            pos_params, cfg, li, xs, poss, rings, dense, tables,
            owner=owner, use_kernel=use_kernel, par=par, enc_outs=enc,
            spec=spec, capacity=capacity)
        for p, ring in enumerate(rings):
            new[p].append(ring)
        if collect_routes:
            for p, i in enumerate(ids):
                routes[p].append(i)
    if collect_routes:
        aux["route_ids"] = dense.each(lambda p, r: torch.stack(r), routes)
    if caches is None:
        return xs, None, aux
    if xs[0].shape[1] == 1 or spec:
        return xs, caches, aux          # written in place layer by layer
    stacked = dense.each(lambda p, rs: {k: torch.stack([r[k] for r in rs])
                                        for k in ("k", "v", "pos")}, new)
    return xs, stacked, aux


def _maybe_remat(fn, cfg: ModelConfig):
    """``cfg.remat`` as activation checkpointing of a block while a graph
    is recorded: "full" recomputes the whole block in the backward
    (``jax.checkpoint``), "dots" saves the matmul outputs and recomputes
    the rest (``jax.checkpoint_policies.checkpoint_dots``). The recompute
    runs under the activation rules of the forward that recorded it
    (``dist.sharding.under_current_rules``). The blocks draw no random
    numbers, so it keeps no RNG state (saving and restoring it would copy
    the card's generator state on the host in every backward)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils import checkpoint as ckpt
    fn = SH.under_current_rules(fn)
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if cfg.remat == "dots":
        aten = torch.ops.aten
        dots = [aten.mm.default, aten.bmm.default, aten.addmm.default,
                aten.baddbmm.default]
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, dots))
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def decoder_forward(params, cfg: ModelConfig, x, positions, *,
                    caches, use_kernel=False, collect_routes=False,
                    spec=False, train=False, enc_out=None, par=None):
    """x: (B,S,d) embedded input. Returns (y, new_caches, aux).

    ``caches=None`` is the no-cache full-sequence forward (``Model.
    loss_fn``); ``train=True`` adds the router's load-balance and router-z
    losses to ``aux``.

    ``collect_routes=True`` stacks the per-layer routed expert ids into
    ``aux["route_ids"]`` (L, T, k) so the engine can drive the runtime
    expert cache. A decode step (S == 1) updates ``caches`` in place and
    returns it; a prefill returns freshly written ring buffers.

    ``spec=True`` (speculative decode, DESIGN.md §17) runs S >= 1 new
    tokens through the live-cache attention path and pins the MoE
    capacity at the token count B*S, so the batched verify is drop-free
    (plain decode and verify then score the same distributions).

    ``par`` (a ``mixed_moe.MoEParallelism`` over a (data, model) mesh)
    runs every MoE layer through ``moe_apply``'s mesh regimes."""
    if collect_routes and (cfg.moe is None or caches is None):
        raise ValueError("collect_routes needs routed experts and a cache")
    moe_capacity = x.shape[0] * x.shape[1] if spec else None
    aux: Dict[str, Any] = {}
    if train and cfg.moe is not None:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux.update(load_balance=zero, router_z=zero)
    new_kvs, route_ids = [], []

    def train_block(x, p):
        layer_aux: Dict[str, Any] = {}
        x, _, _ = decoder_block(p, cfg, x, positions, None,
                                use_kernel=use_kernel,
                                aux=layer_aux if train else None,
                                enc_out=enc_out, par=par)
        return x, layer_aux

    train_body = _maybe_remat(train_block, cfg)
    for li in range(cfg.num_layers):
        p = layer_slice(params["layers"], li)
        if caches is None:                  # the no-cache train forward
            x, layer_aux = train_body(x, p)
            for k, v in layer_aux.items():
                aux[k] = aux[k] + v
            continue
        cache = {k: caches[k][li] for k in ("k", "v", "pos")}
        x, new_kv, ids = decoder_block(
            p, cfg, x, positions, cache, use_kernel=use_kernel, spec=spec,
            moe_capacity=moe_capacity, enc_out=enc_out, par=par)
        new_kvs.append(new_kv)
        route_ids.append(ids)
    if caches is None:
        new_caches = None
    elif x.shape[1] == 1 or spec:
        new_caches = caches              # written in place layer by layer
    else:
        new_caches = {k: torch.stack([kv[k] for kv in new_kvs])
                      for k in ("k", "v", "pos")}
    if collect_routes:
        aux["route_ids"] = torch.stack(route_ids)
    return x, new_caches, aux


def _write_layer(caches, li: int, new) -> None:
    """Copy a layer's new cache entries into row ``li`` of the stacked
    ``caches`` (a decode write that already went in place is skipped: the
    same storage at the same offset, which holds on ``meta`` tensors too,
    whose ``data_ptr`` is always 0)."""
    for k, v in new.items():
        if v is None:
            continue
        row = caches[k][li]
        if v.untyped_storage()._cdata != row.untyped_storage()._cdata \
                or v.storage_offset() != row.storage_offset():
            row.copy_(v)


# ---------------------------------------------------------------------------
# RWKV6 stack
# ---------------------------------------------------------------------------

def rwkv_forward(params, cfg: ModelConfig, x, positions, *, caches=None,
                 **_):
    """caches: {state (L,B,H,K,V) f32, x_att, x_ffn (L,B,d)}, written in
    place."""
    def block(x, p, cache):
        tm_cache = None if cache is None else \
            {"state": cache["state"], "x_att": cache["x_att"]}
        h, tm_new = S.rwkv6_timemix(
            p["rwkv"], L.rms_norm(x, p["attn_norm"]["scale"]), cfg.ssm,
            tm_cache)
        x = x + h
        cm_cache = None if cache is None else {"x_ffn": cache["x_ffn"]}
        h, cm_new = S.rwkv6_channelmix(
            p["rwkv"], L.rms_norm(x, p["ffn_norm"]["scale"]), cm_cache)
        return x + h, {**tm_new, **cm_new}

    train_body = _maybe_remat(lambda x, p: block(x, p, None)[0], cfg)
    for li in range(cfg.num_layers):
        p = layer_slice(params["layers"], li)
        if caches is None:
            x = train_body(x, p)
            continue
        x, new = block(x, p, {k: v[li] for k, v in caches.items()})
        _write_layer(caches, li, new)
    return x, caches, {}


def _layer_caches(caches, li: int):
    """Each position's cache rows of layer ``li``."""
    return [{k: v[li] for k, v in c.items()} for c in caches]


def _write_layers(caches, li: int, new) -> None:
    for c, n in zip(caches, new):
        _write_layer(c, li, n)


def rwkv_forward_split(pos_params, cfg: ModelConfig, xs, poss, *,
                       caches, split, **_):
    """:func:`rwkv_forward` over a (data, model) mesh: ``pos_params``,
    ``xs`` and ``caches`` (each position's {state, x_att, x_ffn} stacks
    of its data rank's rows, every head) are per-position lists; the time
    and channel mixes run their split forms (``ssm.rwkv6_*_split``).
    Every position's cache is written in place."""
    def block(xs, ps, cs):
        rw = [p["rwkv"] for p in ps]
        hs, tm = S.rwkv6_timemix_split(
            rw, _norm_split(xs, ps, "attn_norm", split), cfg.ssm,
            None if cs is None else [{k: c[k] for k in ("state", "x_att")}
                                     for c in cs], split)
        xs = _add_split(xs, hs, split)
        hs, cm = S.rwkv6_channelmix_split(
            rw, _norm_split(xs, ps, "ffn_norm", split), cfg.d_ff,
            None if cs is None else [{"x_ffn": c["x_ffn"]} for c in cs],
            split)
        return _add_split(xs, hs, split), \
            None if cs is None else [{**a, **b} for a, b in zip(tm, cm)]

    train_body = _maybe_remat(lambda xs, ps: block(xs, ps, None)[0], cfg)
    for li in range(cfg.num_layers):
        ps = [layer_slice(t["layers"], li) for t in pos_params]
        if caches is None:
            xs = train_body(xs, ps)
            continue
        xs, new = block(xs, ps, _layer_caches(caches, li))
        _write_layers(caches, li, new)
    return xs, caches, {}


# ---------------------------------------------------------------------------
# Zamba2 hybrid: [shared-attn, 6x mamba2] x 13 + [shared-attn, 3x mamba2]
# ---------------------------------------------------------------------------

def _hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(num_full_groups, group_size, remainder_layers)."""
    g = cfg.attn_every
    full = cfg.num_layers // g
    rem = cfg.num_layers - full * g
    if rem == 0:           # keep >=1 layer in the tail for the final attn
        full -= 1
        rem = g
    return full, g, rem


def _shared_attn_block(shared, cfg, x, positions, cache):
    h, new_kv = L.attention(
        shared["attn"], L.rms_norm(x, shared["attn_norm"]["scale"]),
        cfg.attention, positions=positions, cache=cache)
    x = x + h
    x = x + L.mlp(shared["mlp"],
                  L.rms_norm(x, shared["ffn_norm"]["scale"]), cfg.act)
    return x, new_kv


def hybrid_forward(params, cfg: ModelConfig, x, positions, *, caches=None,
                   **_):
    """``full`` groups of [shared attention, ``g`` Mamba2 layers], then a
    tail of [shared attention, ``rem`` Mamba2 layers]; the one shared
    block's params serve all ``full + 1`` attention applications (their
    gradients sum over the uses). caches: {mamba: {state (L,B,H,P,N) f32,
    conv (L,B,3,C)}, attn: {k, v, pos} with ``full + 1`` rows: row ``i``
    is group ``i``'s, row ``full`` the tail's}, written in place. With
    ``num_layers % attn_every == 0`` the last group is the tail, so the
    smoke config (2 layers, ``attn_every`` 2) has no full group."""
    full, g, rem = _hybrid_layout(cfg)
    shared = params["shared"]

    def mamba(x, p, cache):
        h, new = S.mamba2_block(
            p["mamba"], L.rms_norm(x, p["attn_norm"]["scale"]), cfg.ssm,
            cache)
        return x + h, new

    train_body = _maybe_remat(lambda x, p: mamba(x, p, None)[0], cfg)
    li = 0
    for row in range(full + 1):
        if caches is None:
            x, _ = _shared_attn_block(shared, cfg, x, positions, None)
        else:
            a_cache = {k: v[row] for k, v in caches["attn"].items()}
            x, new_kv = _shared_attn_block(shared, cfg, x, positions,
                                           a_cache)
            _write_layer(caches["attn"], row, new_kv)
        for _ in range(g if row < full else rem):
            p = layer_slice(params["layers"], li)
            if caches is None:
                x = train_body(x, p)
            else:
                x, new = mamba(x, p, {k: v[li] for k, v
                                      in caches["mamba"].items()})
                _write_layer(caches["mamba"], li, new)
            li += 1
    return x, caches, {}


def _fanned(tree, n: int):
    """``n`` copies of a param tree whose leaves are ``dist.sharding.
    fan_out`` aliases: the gradients of the ``n`` uses add in order."""
    if isinstance(tree, dict):
        sub = {k: _fanned(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in sub.items()} for i in range(n)]
    return list(SH.fan_out(tree, n))


def _shared_attn_block_split(shareds, cfg, xs, poss, rings, split, tables):
    hs, new = L.attention_split(
        [p["attn"] for p in shareds],
        _norm_split(xs, shareds, "attn_norm", split), cfg.attention,
        poss=poss, caches=rings, split=split, tables=tables)
    xs = _add_split(xs, hs, split)
    hs = L.mlp_split([p["mlp"] for p in shareds],
                     _norm_split(xs, shareds, "ffn_norm", split), cfg.act,
                     cfg.d_ff, split)
    return _add_split(xs, hs, split), new


def hybrid_forward_split(pos_params, cfg: ModelConfig, xs, poss, *,
                         caches, split, **_):
    """:func:`hybrid_forward` over a (data, model) mesh: ``pos_params``,
    ``xs``, ``poss`` and ``caches`` (each position's {mamba: {state,
    conv}, attn: {k, v, pos}} stacks of its data rank's rows) are
    per-position lists. The shared block runs ``layers.attention_split``
    and ``mlp_split`` on each position's shards of it, one
    ``dist.sharding.fan_out`` alias per application, so its gradient sums
    over the ``full + 1`` applications in their order; the Mamba2 layers
    run ``ssm.mamba2_block_split``. Every position's cache is written in
    place."""
    full, g, rem = _hybrid_layout(cfg)
    shared = list(zip(*split.each(lambda p, t: _fanned(t["shared"], full + 1),
                                  pos_params)))
    tables = L.position_tables(cfg.attention, poss, split,
                               caches is not None)

    def mamba(xs, ps, cs):
        hs, new = S.mamba2_block_split(
            [p["mamba"] for p in ps], _norm_split(xs, ps, "attn_norm", split),
            cfg.ssm, cs, split)
        return _add_split(xs, hs, split), new

    train_body = _maybe_remat(lambda xs, ps: mamba(xs, ps, None)[0], cfg)
    li = 0
    for row in range(full + 1):
        rings = None if caches is None else \
            _layer_caches([c["attn"] for c in caches], row)
        xs, new = _shared_attn_block_split(list(shared[row]), cfg, xs, poss,
                                           rings, split, tables)
        if caches is not None:
            _write_layers([c["attn"] for c in caches], row, new)
        for _ in range(g if row < full else rem):
            ps = [layer_slice(t["layers"], li) for t in pos_params]
            if caches is None:
                xs = train_body(xs, ps)
            else:
                mc = [c["mamba"] for c in caches]
                xs, new = mamba(xs, ps, _layer_caches(mc, li))
                _write_layers(mc, li, new)
            li += 1
    return xs, caches, {}


FORWARDS = {
    "dense": decoder_forward,
    "moe": decoder_forward,
    "vlm": decoder_forward,
    "ssm": rwkv_forward,
    "hybrid": hybrid_forward,
}

FORWARDS_SPLIT = {
    "dense": decoder_forward_split,
    "moe": decoder_forward_split,
    "vlm": decoder_forward_split,
    "ssm": rwkv_forward_split,
    "hybrid": hybrid_forward_split,
}
