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


def decoder_block_split(ps, cfg: ModelConfig, xs, poss, rings, split,
                        tables, *, use_kernel=False, stats=None, par=None):
    """:func:`decoder_block` over a (data, model) mesh: ``ps`` (each
    position's layer params: its shards), ``xs`` (its data rank's
    residual rows), ``poss`` and ``rings`` (its cache rows, or ``None``)
    are per-position lists (``dist.sharding.Split``). Attention, the MLP
    and the MoE run their split forms; norms and the router run on every
    position's copy of its rows. ``stats`` (the training forward)
    collects the lead positions' router sums; ``tables`` are the
    forward's ``layers.position_tables``. Returns (x', the new rings)."""
    lead = set(split.lead)
    hs, new = L.attention_split(
        [p["attn"] for p in ps],
        split.each(lambda i, x, p: L.rms_norm(x, p["attn_norm"]["scale"]),
                   xs, ps),
        cfg.attention, poss=poss, caches=rings, split=split, tables=tables)
    xs = split.each(lambda i, x, h: x + h, xs, hs)
    xns = split.each(lambda i, x, p: L.rms_norm(x, p["ffn_norm"]["scale"]),
                     xs, ps)
    if cfg.moe is None:
        ys = L.mlp_split([p["mlp"] for p in ps], xns, cfg.act, cfg.d_ff,
                         split)
        return split.each(lambda i, x, y: x + y, xs, ys), new

    def routed(i, xn, p, pos):
        x2 = xn.reshape(-1, xn.shape[-1])
        w, ids = mixed_moe.route(
            p["moe"]["router"], x2, cfg.moe,
            stats=stats if stats is not None and i in lead else None)
        if rings is not None:       # idle slots and pads take no capacity
            v = (pos >= 0).reshape(-1)[:, None]
            ids = torch.where(v, ids, torch.full_like(ids,
                                                      cfg.moe.num_experts))
            w = torch.where(v, w, torch.zeros_like(w))
        return x2, w, ids

    r = split.each(routed, xns, ps, poss)
    ys = mixed_moe.moe_apply([p["moe"]["banks"] for p in ps],
                             [a for a, _, _ in r], [w for _, w, _ in r],
                             [i for _, _, i in r], cfg.moe, par,
                             act=cfg.act, use_kernel=use_kernel)
    return split.each(lambda i, x, y: x + y.reshape(x.shape), xs, ys), new


def decoder_forward_split(pos_params, cfg: ModelConfig, xs, poss, *,
                          caches, split, use_kernel=False, train=False,
                          par=None):
    """:func:`decoder_forward` over a (data, model) mesh: ``pos_params``
    (each position's param tree of its own shards), ``xs``, ``poss`` and
    ``caches`` (each position's {k, v, pos} stacks of its data rank's
    rows) are per-position lists, and the residual stays per position
    through the layers. Returns (ys, new caches, aux): the router losses
    of the whole batch (``train``) at position 0."""
    aux: Dict[str, Any] = {}
    if train and cfg.moe is not None:
        zero = torch.zeros((), dtype=torch.float32, device=split.devices[0])
        aux.update(load_balance=zero, router_z=zero)

    tables = L.position_tables(cfg.attention, poss, split,
                               caches is not None)

    def train_block(xs, ps):
        stats: list = []
        xs, _ = decoder_block_split(ps, cfg, xs, poss, None, split, tables,
                                    use_kernel=use_kernel,
                                    stats=stats if train else None,
                                    par=par)
        if not stats:
            return xs, {}
        lb, z = mixed_moe.router_losses(stats, split.lead, cfg.moe,
                                        split.devices[0])
        return xs, {"load_balance": lb, "router_z": z}

    train_body = _maybe_remat(train_block, cfg)
    new = [[] for _ in range(split.n)]
    for li in range(cfg.num_layers):
        ps = [layer_slice(t["layers"], li) for t in pos_params]
        if caches is None:
            xs, layer_aux = train_body(xs, ps)
            for k, v in layer_aux.items():
                aux[k] = aux[k] + v
            continue
        rings = [{k: c[k][li] for k in ("k", "v", "pos")} for c in caches]
        xs, rings = decoder_block_split(ps, cfg, xs, poss, rings, split,
                                        tables, use_kernel=use_kernel,
                                        par=par)
        for p, ring in enumerate(rings):
            new[p].append(ring)
    if caches is None:
        return xs, None, aux
    if xs[0].shape[1] == 1:
        return xs, caches, aux          # written in place layer by layer
    stacked = split.each(lambda p, rs: {k: torch.stack([r[k] for r in rs])
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


FORWARDS = {
    "dense": decoder_forward,
    "moe": decoder_forward,
    "vlm": decoder_forward,
    "ssm": rwkv_forward,
    "hybrid": hybrid_forward,
}
